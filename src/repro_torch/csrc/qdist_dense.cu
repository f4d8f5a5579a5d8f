// Dense asymmetric distance: fp32 queries against every candidate's 4-bit
// codes, unpacked (one uint8 per dim) or nibble-packed (eight per word).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/qdist/kernel.py:
//   qdist_u8_kernel (:120, pallas_call :134; wrapper qdist in
//     src/repro/kernels/qdist/ops.py), launcher qdist_u8_launch;
//   qdist_packed_kernel (:149, pallas_call :164; wrapper qdist_from_packed),
//     launcher qdist_packed_launch.
// Contract: queries (Q, D) f32, codes (C, D) uint8 or (C, W=ceil(D/8))
// 32-bit words with dim 8w+s in nibble s of word w, centroids (D, L) f32
// -> (Q, C) f32 sum over d of (q_d - centroids[d, code_d])^2, for any
// Q, C, D, L >= 1 (L = 16 for packed codes).  A code >= L reconstructs to
// 0, as the TPU kernel's select chain gives.  A ragged last word and
// ragged tiles add nothing.  The launch goes on the given stream,
// allocates nothing and returns its cudaError_t.
//
// Bound on the H100 at the kernel bench's shape (Q=512, C=16384, D=384):
// operations.  The bench counts a sub, a mul and an add a term, 3*Q*C*D =
// 9.66 G, over the 67 TFLOP/s of non-tensor fp32: 0.144 ms.  This form
// issues two fp32 instructions a term (FADD for q - r, FFMA to add its
// square), 6.44 G, and the card issues one fp32 warp instruction a clock
// on each of its 4 x 132 sub-partitions: 6.44 G / (132 SMs x 128 lanes x
// 1.98 GHz) = 0.193 ms is the floor of the direct form.  The bytes (34 MB
// of output, 6.3 MB of u8 or 3.1 MB of packed codes) take ~0.012 ms.
//
// No tensor cores.  The direct form has no matrix product in it.  The
// TPU's expanded |q|^2 - 2 q.r + |r|^2 would run on them, but TF32 breaks
// the rtol 1e-5 contract, and in any fp32 split its error scales with
// |q|^2 + |r|^2 rather than with the distance: a query equal to a
// dequantized row would read ~1e-5..1e-4 instead of 0 (the contract's atol
// is 1e-6), and near-duplicates are the pairs a ranking needs.
//
// Design: a register-tiled CUDA-core kernel shaped like an SGEMM whose
// inner product is a squared difference (the variants measured are in
// PERF.md section 6).
// - Tiles.  128 queries x 128 candidates a block, 256 threads of 8 x 8
//   outputs: queries ty + 16 i, candidates 64 h + 4 tx + j.  A warp is 4
//   (query) x 8 (candidate) threads.  Every 4 dims a thread reads 8 query
//   float4 (4 dims of each of its rows; a warp's 4 rows lie 36 floats
//   apart, in distinct banks, broadcast along its candidates), and every
//   dim 2 candidate float4 (a warp's 8 consecutive float4 cover the 32
//   banks), for 64 sub + 64 fma a dim.  The loop runs 8 dims an
//   iteration, unrolled.
// - A ring in shared memory filled with 16-byte cp.async copies: query
//   rows as they lie in memory (three stages: computed, landed, in
//   flight), packed codes as 4 words a candidate, u8 codes as 16 bytes,
//   and the stage's centroid rows (two stages each).  Stage s + 2's copies
//   are in flight while stage s computes; one __syncthreads a stage.  Rows
//   that are not 16-byte aligned (D % 4 for queries, W % 4 for packed
//   codes, D % 16 for u8 codes, L % 4 for centroids, or a base pointer
//   off 16 bytes, as a view into a larger buffer gives) take a slower
//   copy: queries, packed codes and centroids 4 bytes at a time, u8 codes
//   as plain byte loads.  The launcher decides this and passes it in.
// - Dequantize once a stage.  After the barrier, before stage s's
//   arithmetic, each thread turns 16 dims of one candidate of stage s + 1
//   into fp32 through the staged centroid rows, into a dim-major tile (two
//   stages); a warp's stores cover 32 consecutive candidates of one dim,
//   so they do not conflict.  The queries need no transposition.
// - Two-level sum.  Each stage's 32 dims are summed into fresh registers
//   that are then added to the total, which keeps the fp32 sum within the
//   contract of the plain version's reduction.  The direct (q - r)^2 reads
//   exactly 0 for a query equal to a reconstructed row.
// - Registers.  64 partial sums, 64 totals and the fragments leave room
//   for one block (8 warps) an SM.  ptxas would keep every copy's global
//   address live across the stage loop; an opaque copy of the thread index
//   each stage makes it recompute them instead, which keeps the kernel
//   within its registers without spilling.
// Dims past D stage zero queries and zero centroid rows (a ragged last
// word adds nothing); rows past Q or C stage zeros and are not written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 8;   // queries a thread: rows ty + kThreadsQ i
constexpr int kTN = 8;   // candidates a thread: groups of 4 columns
constexpr int kThreadsQ = 16;  // threads along the queries (ty)
constexpr int kThreadsC = 16;  // threads along the candidates (tx)
constexpr int kThreads = kThreadsQ * kThreadsC;
constexpr int kTileQ = kThreadsQ * kTM;  // queries a block
constexpr int kTileC = kThreadsC * kTN;  // candidates a block
constexpr int kDims = 32;  // dims a stage
constexpr int kStep = 8;   // dims an iteration of the arithmetic loop, unrolled
constexpr int kRawStride = kDims + 4;  // floats a staged query row
constexpr int kConvDims = kDims * kTileC / kThreads;  // dims a thread dequantizes
static_assert(kConvDims == 16, "a thread dequantizes 64 (packed) or 128 (u8) bits");
// Operands whose rows all start on 16 bytes (the kernel's `vec` argument).
constexpr unsigned kVecQueries = 1, kVecCodes = 2, kVecCentroids = 4, kVecOut = 8;

template <bool kPacked>
__host__ __device__ constexpr int code_words() {  // 32-bit words of a stage's codes
  return kPacked ? kTileC * kDims / 8 : kTileC * kDims / 4;
}

// Shared memory of one block, in floats: dequantized candidate tiles
// (dim-major, two stages), raw query rows (three stages), raw codes and
// centroid rows (two stages, `tab_cols` levels a dim).
template <bool kPacked>
size_t smem_bytes(int tab_cols) {
  return sizeof(float) * (2 * kDims * kTileC + 3 * kTileQ * kRawStride +
                          2 * code_words<kPacked>() + 2 * kDims * tab_cols);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Global -> shared without registers; zero-fill (the source is not read)
// when !ok.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// f(i) for i = tid, tid + kThreads, ... below kN, unrolled.
template <int kN, typename F>
__device__ __forceinline__ void for_each(int tid, F f) {
#pragma unroll
  for (int j = 0; j < (kN + kThreads - 1) / kThreads; ++j) {
    const int i = tid + j * kThreads;
    if (kN % kThreads == 0 || i < kN) f(i);
  }
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
qdist_dense_kernel(const float* __restrict__ q,      // (Q, D)
                   const void* __restrict__ codes,   // (C, D) u8 | (C, W) u32
                   const float* __restrict__ cent,   // (D, L)
                   float* __restrict__ out,          // (Q, C)
                   int n_q, int n_c, int d, int levels, int staged, int tab_shift,
                   unsigned vec) {  // kVec* bits: which operands take 16-byte access
  constexpr int kWords = code_words<kPacked>();
  constexpr int kBits = kPacked ? 4 : 8;  // bits a code
  constexpr uint32_t kMask = (1u << kBits) - 1;
  const int tab_cols = 1 << tab_shift;
  extern __shared__ __align__(16) float smem[];
  float* rt = smem;                                 // 2 x kDims x kTileC, dim-major
  float* qraw = rt + 2 * kDims * kTileC;            // 3 x kTileQ x kRawStride
  uint32_t* craw = reinterpret_cast<uint32_t*>(qraw + 3 * kTileQ * kRawStride);
  float* tab = reinterpret_cast<float*>(craw + 2 * kWords);  // 2 x kDims x tab_cols

  int tid = threadIdx.x;
  const int lane_id = tid & 31, warp = tid >> 5;
  // A warp is 4 x 8 threads: its query reads (4 consecutive rows, stride
  // kRawStride) and its candidate reads (8 consecutive float4) hit
  // distinct banks.  Thread (ty, tx) owns queries ty + kThreadsQ i and
  // candidates 4 kThreadsC h + 4 tx + j.
  constexpr int kWarpsC = kThreadsC / 8;
  const int ty = 4 * (warp / kWarpsC) + (lane_id >> 3);
  const int tx = 8 * (warp % kWarpsC) + (lane_id & 7);
  const int q0 = blockIdx.y * kTileQ;
  const int c0 = blockIdx.x * kTileC;
  const int n_stages = (d + kDims - 1) / kDims;
  const int words = (d + 7) / 8;
  const bool q_vec = vec & kVecQueries;
  const bool c_vec = vec & kVecCodes;
  const bool t_vec = vec & kVecCentroids;

  // Start the copies of stage s: queries into slot s % 3, codes and
  // centroid rows into slot s & 1 (one commit group).
  auto issue = [&](int s) {
    const int d0 = s * kDims;
    float* qr = qraw + (s % 3) * kTileQ * kRawStride;
    if (q_vec) {
      for_each<kTileQ * kDims / 4>(tid, [&](int i) {
        const int r = i / (kDims / 4), g = i % (kDims / 4);
        const int gd = d0 + 4 * g;
        const bool ok = q0 + r < n_q && gd < d;
        copy16(qr + r * kRawStride + 4 * g,
               ok ? q + static_cast<long long>(q0 + r) * d + gd : q, ok);
      });
    } else {
      for_each<kTileQ * kDims>(tid, [&](int i) {
        const int r = i / kDims, k = i % kDims;
        const bool ok = q0 + r < n_q && d0 + k < d;
        copy4(qr + r * kRawStride + k,
              ok ? q + static_cast<long long>(q0 + r) * d + d0 + k : q, ok);
      });
    }
    uint32_t* cr = craw + (s & 1) * kWords;
    if (kPacked) {
      const uint32_t* p = static_cast<const uint32_t*>(codes);
      const int w0 = d0 / 8;
      if (c_vec) {
        for_each<kTileC * kDims / 32>(tid, [&](int i) {
          const int r = i / (kDims / 32), g = i % (kDims / 32);
          const bool ok = c0 + r < n_c && w0 + 4 * g < words;
          copy16(cr + r * (kDims / 8) + 4 * g,
                 ok ? p + static_cast<long long>(c0 + r) * words + w0 + 4 * g : p, ok);
        });
      } else {
        for_each<kWords>(tid, [&](int i) {
          const int r = i / (kDims / 8), k = i % (kDims / 8);
          const bool ok = c0 + r < n_c && w0 + k < words;
          copy4(cr + i, ok ? p + static_cast<long long>(c0 + r) * words + w0 + k : p, ok);
        });
      }
    } else {
      const uint8_t* u = static_cast<const uint8_t*>(codes);
      uint8_t* cb = reinterpret_cast<uint8_t*>(cr);
      if (c_vec) {
        for_each<kTileC * kDims / 16>(tid, [&](int i) {
          const int r = i / (kDims / 16), g = i % (kDims / 16);
          const int gd = d0 + 16 * g;
          const bool ok = c0 + r < n_c && gd < d;
          copy16(cb + r * kDims + 16 * g,
                 ok ? u + static_cast<long long>(c0 + r) * d + gd : u, ok);
        });
      } else {  // rows not 16-byte aligned: plain byte loads
        for_each<kTileC * kDims>(tid, [&](int i) {
          const int r = i / kDims, k = i % kDims;
          cb[i] = (c0 + r < n_c && d0 + k < d)
              ? u[static_cast<long long>(c0 + r) * d + d0 + k] : uint8_t{0};
        });
      }
    }
    float* tb = tab + (s & 1) * kDims * tab_cols;
    if (t_vec) {
      for (int i = tid; i < (kDims * tab_cols) / 4; i += kThreads) {
        const int k = (4 * i) >> tab_shift, l = (4 * i) & (tab_cols - 1);
        const bool ok = d0 + k < d;
        copy16(tb + 4 * i,
               ok ? cent + static_cast<long long>(d0 + k) * levels + l : cent, ok);
      }
    } else {
      for (int i = tid; i < kDims * tab_cols; i += kThreads) {
        const int k = i >> tab_shift, l = i & (tab_cols - 1);
        const bool ok = d0 + k < d && l < staged;
        copy4(tb + i, ok ? cent + static_cast<long long>(d0 + k) * levels + l : cent, ok);
      }
    }
    copy_commit();
  };

  // Dequantization of stage s: this thread turns dims k0 .. k0 + kConvDims
  // - 1 of candidate `cand` into fp32 through the staged centroid rows, in
  // the dim-major tile of that stage.  Its codes are read as a 64- or
  // 128-bit shift register, lowest dim first; a warp's stores cover 32
  // consecutive candidates of one dim.
  const int cand = tid % kTileC;
  const int k0 = (tid / kTileC) * kConvDims;
  auto convert = [&](int s) {
    const uint32_t* cr = craw + (s & 1) * kWords + cand * (kDims * kBits / 32) +
                         k0 * kBits / 32;
    const uint64_t lo = cr[0] | (static_cast<uint64_t>(cr[1]) << 32);
    const uint64_t hi = kPacked ? 0 : cr[2] | (static_cast<uint64_t>(cr[3]) << 32);
    const float* tb = tab + (s & 1) * kDims * tab_cols;
    float* rd = rt + (s & 1) * kDims * kTileC + cand;
#pragma unroll
    for (int e = 0; e < kConvDims; ++e) {
      const uint32_t code = static_cast<uint32_t>(
          e * kBits < 64 ? lo >> (e * kBits) : hi >> (e * kBits - 64)) & kMask;
      const int k = k0 + e;
      rd[k * kTileC] = code < static_cast<uint32_t>(staged)
          ? tb[(k << tab_shift) + code] : 0.f;
    }
  };

  float tot[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) tot[i][j] = 0.f;

  // Stage s's arithmetic, summed into fresh registers.
  auto compute = [&](int s) {
    const float* a = qraw + (s % 3) * kTileQ * kRawStride + ty * kRawStride;
    const float* b = rt + (s & 1) * kDims * kTileC + 4 * tx;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int m = 0; m < kDims / kStep; ++m) {
#pragma unroll
      for (int g = 0; g < kStep / 4; ++g) {
        const int kq = m * kStep + 4 * g;  // first of 4 dims
        float4 qa[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          qa[i] = *reinterpret_cast<const float4*>(a + kThreadsQ * i * kRawStride + kq);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float4 rb[kTN / 4];
#pragma unroll
          for (int h = 0; h < kTN / 4; ++h)
            rb[h] = *reinterpret_cast<const float4*>(b + (kq + c) * kTileC + 4 * kThreadsC * h);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float av = lane(qa[i], c);
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
              const float diff = av - lane(rb[j / 4], j % 4);
              acc[i][j] = fmaf(diff, diff, acc[i][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) tot[i][j] += acc[i][j];
  };

  issue(0);
  if (n_stages > 1) {
    issue(1);
    copy_wait<1>();  // stage 0 landed (this thread's copies)
  } else {
    copy_wait<0>();
  }
  __syncthreads();
  convert(0);
  for (int s = 0; s < n_stages; ++s) {
    // An opaque copy of the thread index each stage: the copies' addresses
    // are recomputed, not held in registers across the loop.
    asm volatile("" : "+r"(tid));
    copy_wait<0>();   // this thread's copies of stage s + 1 landed
    __syncthreads();  // all of them; tile s written; slots of s - 1 free
    if (s + 2 < n_stages) issue(s + 2);
    if (s + 1 < n_stages) convert(s + 1);
    compute(s);
  }

  const bool out_vec = vec & kVecOut;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty + kThreadsQ * i;
    if (row >= n_q) continue;
#pragma unroll
    for (int h = 0; h < kTN / 4; ++h) {
      const int col = c0 + 4 * kThreadsC * h + 4 * tx;
      float* dst = out + static_cast<long long>(row) * n_c + col;
      if (out_vec && col + 3 < n_c) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            tot[i][4 * h], tot[i][4 * h + 1], tot[i][4 * h + 2], tot[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n_c) dst[j] = tot[i][4 * h + j];
      }
    }
  }
}

// Shared by both launchers: the levels a code can reach are staged (16
// for a nibble, 256 for a byte), in a power-of-two row; an operand takes
// 16-byte copies only if its base pointer and its row length allow them;
// the shared memory above the default 48 KB is asked for once per kernel
// and device.
template <bool kPacked>
int launch(const void* q, const void* codes, const void* cent, void* out,
           int n_q, int n_c, int d, int levels, void* stream) {
  if (n_q <= 0 || n_c <= 0 || d <= 0 || levels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = kPacked ? 16 : 256;
  const int staged = levels < cap ? levels : cap;
  int tab_shift = 0;
  while ((1 << tab_shift) < staged) ++tab_shift;
  const size_t smem = smem_bytes<kPacked>(1 << tab_shift);
  auto on16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const unsigned vec =
      (on16(q) && d % 4 == 0 ? kVecQueries : 0u) |
      (on16(codes) && (kPacked ? (d + 7) / 8 % 4 == 0 : d % 16 == 0) ? kVecCodes : 0u) |
      (on16(cent) && levels % 4 == 0 && (1 << tab_shift) == staged ? kVecCentroids : 0u) |
      (on16(out) && n_c % 4 == 0 ? kVecOut : 0u);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static size_t smem_allowed[64] = {};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > smem_allowed[dev]) {
    e = cudaFuncSetAttribute(qdist_dense_kernel<kPacked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed[dev] = smem;
  }
  const dim3 grid(static_cast<unsigned>((n_c + kTileC - 1) / kTileC),
                  static_cast<unsigned>((n_q + kTileQ - 1) / kTileQ));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  qdist_dense_kernel<kPacked><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), codes, static_cast<const float*>(cent),
      static_cast<float*>(out), n_q, n_c, d, levels, staged, tab_shift, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return the cudaError_t of the launch (0 = success).
extern "C" int qdist_u8_launch(const void* q, const void* codes, const void* cent,
                               void* out, int n_q, int n_c, int d, int levels,
                               void* stream) {
  return launch<false>(q, codes, cent, out, n_q, n_c, d, levels, stream);
}

extern "C" int qdist_packed_launch(const void* q, const void* packed,
                                   const void* cent, void* out, int n_q, int n_c,
                                   int d, int levels, void* stream) {
  return launch<true>(q, packed, cent, out, n_q, n_c, d, levels, stream);
}
