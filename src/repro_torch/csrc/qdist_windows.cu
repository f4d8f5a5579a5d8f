// Stage-2 distance of Algorithm 1: fp32 queries against the nibble-packed
// 4-bit codes of each query's OWN candidate rows, read by window straight
// from the resident codes.
//
// Replaces the Pallas TPU kernel qdist_packed_windows_kernel /
// _qdist_packed_windows_kernel in src/repro/kernels/qdist/kernel.py (:179,
// pallas_call :197; wrapper qdist_windows_from_packed in
// src/repro/kernels/qdist/ops.py).  Contract: rows (n, W = ceil(D/8))
// 32-bit words with dim 8w+s in nibble s of word w, starts (Q, S) int32, a
// window length L >= 1, queries (Q, D) f32, centroids (D, 16) f32 ->
// out (Q, S*L) f32, where out[q, c] is the sum over d of
// (q_d - centroids[d, code_d])^2 for the codes of row starts[q, c / L] +
// c % L.  With no starts (a null pointer) the row of candidate c of query
// q is q*S*L + c: a pre-gathered (Q, C, W) block viewed as (Q*C, W).  A row
// outside [0, n) reads NaN.  Row offsets are 64-bit (n*W reaches 144 M
// words at 3,000,000 rows).  The launch goes on the given stream,
// allocates nothing and returns its cudaError_t.
//
// Bound on the H100: bytes.  At the engine's shape (Q = 2048, S = 384,
// L = 5, W = 48, D = 384) the 1,920 candidate rows of a query are 369 KB
// of codes if each is read once, 755 MB a launch, about 0.23 ms at 3.35
// TB/s; the windows of neighbouring candidates overlap, so the rows a
// launch must read are fewer.  The 4.5 GFLOP of sub/mul/add would take
// 0.07 ms at the 67 TFLOP/s of non-tensor fp32.  Past the bytes, the floor
// is the shared-memory lookups: D a candidate, one wavefront a clock an
// SM, about 0.18 ms at that shape.
//
// Design: no tensor cores and no TF32.
// - One block a query, 256 threads.  The block turns the query row and
//   the (D, 16) centroid table into the 16*D terms (q_d - c[d, l])^2 once,
//   dim-major in shared memory (24.6 KB at D = 384), each rounded as the
//   plain version rounds it; dims past D read 0.  A warp's 32 lookups of
//   one dim touch 16 consecutive words, so they never conflict.
// - Candidate c of the query belongs to thread c % 256; a warp owns 32
//   consecutive candidates at a time and walks their codes kWords words a
//   stage.  Each warp keeps its own cp.async ring of kStages stages in
//   shared memory and waits on it with cp.async.wait_group and __syncwarp
//   only: no block barrier after the table.  The copies of the next
//   kStages - 1 stages are in flight while a stage's lookups run.
// - 16-byte copies where the launcher finds rows' base on 16 bytes and
//   W*4 % 16 == 0: lane l copies chunk l % (kWords/4) of a candidate, so a
//   warp's copy instruction reads whole 32-byte sectors of neighbouring
//   rows.  Otherwise each lane copies its own candidate's words 4 bytes at
//   a time.  The stage tile is chunk-major with an XOR swizzle, so the
//   16-byte reads of a quarter warp and the copies land in distinct banks.
// - A lookup is three instructions besides its add: two shifts and masks
//   a word leave 4 x nibble in each byte of two registers, one byte
//   permute puts a nibble's byte under the table's shared address (whose
//   low byte is 0), and the load adds the dim's row as an immediate.
// - Four interleaved accumulators a candidate (nibble s of every word adds
//   to accumulator s % 4), as the plain version's tolerance needs (rtol
//   1e-5, atol 1e-6); zeros the padding adds do not change a sum.
// - Shared memory a block: the table plus 256 x kStages x kWords words
//   (49.4 KB at D = 384), four blocks (32 warps) an SM.
// What holds it (PERF.md section 6): the copies.  Without the lookups the
// kernel takes as long; without the copies, 0.6 of the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLevels = 16;  // 4-bit codes
constexpr int kWords = 8;             // words of a candidate a stage
constexpr int kStages = 3;            // ring depth
constexpr int kAcc = 4;               // accumulators a candidate
constexpr int kChunks = kWords / 4;   // 16-byte chunks a candidate a stage
constexpr int kSwizzle = 8 / kChunks;  // chunk p's tile column is lane ^ (p * kSwizzle)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kLutAlign = 256;  // the table's shared address has a zero low byte

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Global -> shared without registers; zero-fill (the source is not read)
// when !ok.  The 16-byte copy asks L2 to fetch the whole 128-byte line: a
// candidate row's later stages then find their sectors in L2.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::
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

// A float of shared memory at shared address `a`.
__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t lane_word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Stages of a candidate row, table floats and bytes a block.
inline int slabs_of(int w) { return (w + kWords - 1) / kWords; }
inline size_t smem_bytes(int w) {
  return kLutAlign + sizeof(float) * static_cast<size_t>(slabs_of(w)) * kWords * 8 * kLevels +
         sizeof(uint4) * static_cast<size_t>(kStages) * kChunks * kThreads;
}

// kVec: 16-byte copies.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
qdist_windows_kernel(const float* __restrict__ q,         // (Q, D)
                     const uint32_t* __restrict__ rows,   // (n, W)
                     const int* __restrict__ starts,      // (Q, S) or null
                     const float* __restrict__ cent,      // (D, 16)
                     float* __restrict__ out,             // (Q, S*L)
                     long long n_rows, int n_s, int len, int d, int w) {
  const int slabs = (w + kWords - 1) / kWords;
  extern __shared__ __align__(16) float smem[];
  // (slabs * kWords * 8) dims x 16 levels, dim-major, from a shared
  // address whose low byte is 0 (the launcher adds kLutAlign bytes).
  float* lut = smem + ((kLutAlign - (smem_addr(smem) & (kLutAlign - 1))) & (kLutAlign - 1)) / 4;
  const unsigned lut_s = smem_addr(lut);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // This warp's part of the ring: kStages x kChunks x 32 chunks.
  uint4* ring = reinterpret_cast<uint4*>(lut + slabs * kWords * 8 * kLevels) +
                warp * kStages * kChunks * 32;
  const long long qi = blockIdx.x;
  const int n_c = n_s * len;
  const int w0 = warp * 32;  // the warp's first candidate; then + kThreads a group
  const int groups = w0 < n_c ? (n_c - w0 - 1) / kThreads + 1 : 0;  // warp-uniform

  // Row of candidate c (< n_c), or -1 outside [0, n_rows).
  auto row_of = [&](int c) -> long long {
    long long r;
    if (starts == nullptr) {
      r = qi * n_c + c;
    } else {
      const int s = c / len;
      r = static_cast<long long>(__ldg(starts + qi * n_s + s)) + (c - s * len);
    }
    return r >= 0 && r < n_rows ? r : -1;
  };

  // The issue cursor: group g, stage (slab) of it, ring slot.  In the
  // 16-byte path lane l copies chunk l % kChunks of candidates
  // j * (32 / kChunks) + l / kChunks (j < kChunks) of the group; in the
  // 4-byte path all kWords words of its own candidate.
  constexpr int kSrc = kVec ? kChunks : 1;
  const uint32_t* src[kSrc];
  bool src_ok[kSrc];
  int is_g = 0, is_slab = 0, is_slot = 0;
  const int my_chunk = kVec ? lane % kChunks : 0;
  auto issue = [&]() {
    if (is_g < groups) {
      if (is_slab == 0) {
#pragma unroll
        for (int j = 0; j < kSrc; ++j) {
          const int cw = kVec ? j * (32 / kChunks) + lane / kChunks : lane;
          const int c = w0 + is_g * kThreads + cw;
          const long long r = c < n_c ? row_of(c) : -1;
          src_ok[j] = r >= 0;
          src[j] = rows + (r >= 0 ? r : 0) * w;
        }
      }
      const int word0 = is_slab * kWords;
      uint4* slot = ring + is_slot * kChunks * 32;
      if (kVec) {
#pragma unroll
        for (int j = 0; j < kSrc; ++j) {
          const int cw = j * (32 / kChunks) + lane / kChunks;
          const int wd = word0 + 4 * my_chunk;
          const bool ok = src_ok[j] && wd < w;
          copy16(slot + my_chunk * 32 + (cw ^ (my_chunk * kSwizzle)),
                 ok ? src[j] + wd : rows, ok);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const int p = k / 4;
          const bool ok = src_ok[0] && word0 + k < w;
          uint32_t* dst = reinterpret_cast<uint32_t*>(slot + p * 32 + (lane ^ (p * kSwizzle)));
          copy4(dst + k % 4, ok ? src[0] + word0 + k : rows, ok);
        }
      }
      if (++is_slab == slabs) {
        is_slab = 0;
        ++is_g;
      }
    }
    if (++is_slot == kStages) is_slot = 0;
    copy_commit();  // one group a stage, empty past the end
  };

  // The first copies fly while the block builds the table.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue();
  const float* qrow = q + qi * d;
  for (int i = t; i < slabs * kWords * 8 * kLevels; i += kThreads) {
    const int j = i >> 4;  // dim; cent is (D, 16), so its index is i
    float v = 0.f;
    if (j < d) {
      const float diff = qrow[j] - cent[i];
      v = __fmul_rn(diff, diff);
    }
    lut[i] = v;
  }
  __syncthreads();

  int cs_slot = 0;
  for (int g = 0; g < groups; ++g) {
    const int c = w0 + g * kThreads + lane;
    const long long r = c < n_c ? row_of(c) : -1;  // read at the end
    float acc[kAcc];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
    // One stage: wait for its copies, read its codes, start the copies
    // kStages - 1 stages ahead, then the lookups of kWords * 8 dims; `tab`
    // is the shared address of the stage's first dim, its low byte 0.
    auto stage = [&](unsigned tab) {
      copy_wait<kStages - 2>();
      // The warp's copies of this stage have landed, not only this lane's;
      // and every lane has read the previous stage's slot, which the
      // copies issued below refill.
      __syncwarp();
      const uint4* slot = ring + cs_slot * kChunks * 32;
      uint4 code[kChunks];
#pragma unroll
      for (int p = 0; p < kChunks; ++p) code[p] = slot[p * 32 + (lane ^ (p * kSwizzle))];
      if (++cs_slot == kStages) cs_slot = 0;
      issue();
#pragma unroll
      for (int p = 0; p < kChunks; ++p) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t word = lane_word(code[p], e);
          const uint32_t even = (word << 2) & 0x3C3C3C3Cu;  // byte i: 4 x nibble 2i
          const uint32_t odd = (word >> 2) & 0x3C3C3C3Cu;   // byte i: 4 x nibble 2i + 1
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            // tab | (4 x nibble s) in one byte permute, + the dim's row.
            const unsigned a = __byte_perm(s & 1 ? odd : even, tab, 0x7650 | (s >> 1));
            acc[s % kAcc] += lds(a + ((4 * p + e) * 8 + s) * kLevels * 4);
          }
        }
      }
    };
    constexpr unsigned kSlabBytes = kWords * 8 * kLevels * 4;
#pragma unroll 1
    for (int slab = 0; slab < slabs; ++slab) stage(lut_s + slab * kSlabBytes);
    const float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    if (c < n_c) out[qi * n_c + c] = r >= 0 ? sum : __int_as_float(0x7fc00000);
  }
  copy_wait<0>();  // no copy outlives the block
}

// Ask once per instantiation and device for the shared memory above the
// default 48 KB and for the carveout that fits the most blocks; launch.
template <bool kVec>
int run(const float* q, const uint32_t* rows, const int* starts, const float* cent,
        float* out, int n_q, long long n_rows, int n_s, int len, int d, int w,
        size_t smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static size_t smem_allowed[64] = {};
  static bool carveout_set[64] = {};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!carveout_set[dev]) {
    e = cudaFuncSetAttribute(qdist_windows_kernel<kVec>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    carveout_set[dev] = true;
  }
  if (smem > 48 * 1024 && smem > smem_allowed[dev]) {
    e = cudaFuncSetAttribute(qdist_windows_kernel<kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed[dev] = smem;
  }
  qdist_windows_kernel<kVec><<<static_cast<unsigned>(n_q), kThreads, smem, stream>>>(
      q, rows, starts, cent, out, n_rows, n_s, len, d, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `starts` may be null (the pre-gathered layout, n_rows = n_q * n_s * len).
// The 16-byte copies are taken where `rows` lies on 16 bytes and W*4 % 16
// == 0; D is at most what the table and the ring leave of 227 KB (~3,000).
extern "C" int qdist_windows_launch(const void* q, const void* rows, const void* starts,
                                    const void* cent, void* out, int n_q, int n_s,
                                    int len, int d, long long n_rows, void* stream) {
  if (n_q <= 0 || n_s <= 0 || len <= 0 || d <= 0 || n_rows <= 0 ||
      static_cast<long long>(n_s) * len > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = (d + 7) / 8;
  const size_t smem = smem_bytes(w);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(rows) % 16 == 0 && w % 4 == 0;
  const auto* qf = static_cast<const float*>(q);
  const auto* r = static_cast<const uint32_t*>(rows);
  const auto* st = static_cast<const int*>(starts);
  const auto* c = static_cast<const float*>(cent);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? run<true>(qf, r, st, c, o, n_q, n_rows, n_s, len, d, w, smem, s)
             : run<false>(qf, r, st, c, o, n_q, n_rows, n_s, len, d, w, smem, s);
}
