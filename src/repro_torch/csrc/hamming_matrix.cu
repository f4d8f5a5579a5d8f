// Dense sketch Hamming matrix: every query against every candidate, with
// the inner product on the tensor cores.
//
// Replaces the Pallas TPU kernel hamming_matrix_kernel / _hamming_kernel
// in src/repro/kernels/hamming/kernel.py (:47, pallas_call :62; wrapper
// hamming_matrix in src/repro/kernels/hamming/ops.py).  Contract: (Q, W)
// and (C, W) 32-bit words -> (Q, C) int32 popcount(q ^ c) summed over W,
// for any Q, C, W >= 1.  The launch goes on the given stream, allocates
// nothing and returns its cudaError_t.
//
// Bound on the H100: bytes.  At the kernel bench's shape (Q = 512, C =
// 65536, W = 12) the inputs are 3.2 MB and the int32 output 134 MB: 137.4
// MB at 3.35 TB/s = 0.041 ms.  What held the CUDA-core design before
// this one: one __popc(a ^ b) a word a pair, 0.40 G popcounts at 16 a
// clock an SM (132 SMs, 1,980 MHz) = 0.096 ms, whatever the bytes.
//
// Design: popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b), and popc(a &
// b) summed over the words is the integer dot product of the two rows'
// bits, taken exactly on the tensor cores in int32.
// - 128 x 128 output tiles, 256 threads: 8 warps of 64 x 32 outputs (4 x 4
//   tiles of m16n8), 64 int32 accumulators a thread.
// - The words of a row come kWords (8) a stage: thread t copies 16 bytes
//   (4 words) of row t / 2 of each side with cp.async into a two-stage
//   ring (4-byte copies where a base is off 16 bytes or W % 4 != 0);
//   words past W and rows past Q or C land as zeros and add nothing.
// - mma.sync m16n8k128 b1 x b1 -> s32 with .and.popc on the packed words
//   straight from the ring, four words a k step; ldmatrix reads the
//   fragments (48-byte rows: 8 rows, 8 distinct bank groups).  Unpacking
//   the bits to bytes for mma.sync m16n8k32 u8 measured 1.4x slower on
//   the H100 (PERF.md section 6).
// - Each thread sums the popcounts of the words it copied; the pairs that
//   share a row add theirs at the end: popc(a) and popc(b) once a tile.
// - Epilogue: popc(a) + popc(b) - 2 dot, staged through shared memory
//   (rows padded by 8 words against bank conflicts), then each warp writes
//   whole output rows, 16 bytes a lane, 512 contiguous bytes a store, with
//   the evict-first hint.  Storing the fragments straight from registers
//   (8 bytes a lane) measured 1.5x slower; without the hint, 1.1x.
// - 95,232 bytes of shared memory and at most 128 registers a thread: two
//   blocks an SM, so one block's stores overlap the other's products.
// What holds it (PERF.md section 6): the output write; a plain fill of
// the same 134 MB takes 0.046 ms on the H100.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;            // queries and candidates per block
constexpr int kThreads = 256;         // 8 warps: 2 (queries) x 4 (candidates)
constexpr int kWords = 8;             // words of a row a stage
constexpr int kPackStride = 12;       // words a row in the ring (48 B rows)
constexpr int kOutStride = kTile + 8;  // int32 a row of the staged output tile
constexpr int kRingWords = 2 * 2 * kTile * kPackStride;  // stages x sides x rows
constexpr int kTileBytes = kTile * kOutStride * 4;       // the staged output tile
constexpr int kSmemBytes = kRingWords * 4 + kTileBytes + 2 * kTile * 4;

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

__device__ __forceinline__ void copy_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
hamming_matrix_kernel(const uint32_t* __restrict__ q,  // (Q, W)
                      const uint32_t* __restrict__ c,  // (C, W)
                      int32_t* __restrict__ out,       // (Q, C)
                      int n_q, int n_c, int w, bool vec_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;  // [stage][side][row][kPackStride]
  int32_t* tile = reinterpret_cast<int32_t*>(smem + kRingWords);  // [row][kOutStride]
  int32_t* pop = tile + kTile * kOutStride;                          // [side][row]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row group, thread in group
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 64 x 32 outputs
  const int q0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int my_row = t >> 1, my_chunk = t & 1;  // the 4 words this thread copies
  const int stages = (w + kWords - 1) / kWords;

  // Copy stage s (if any) into ring slot s & 1; one commit group a call.
  auto issue = [&](int s) {
    if (s < stages) {
      const int w0 = s * kWords + 4 * my_chunk;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int row = (side ? c0 : q0) + my_row;
        const bool row_ok = row < (side ? n_c : n_q);
        const uint32_t* src = (side ? c : q) + static_cast<long long>(row_ok ? row : 0) * w;
        uint32_t* dst = ring + (((s & 1) * 2 + side) * kTile + my_row) * kPackStride +
                        4 * my_chunk;
        if (kVec) {
          const bool ok = row_ok && w0 < w;
          copy16(dst, ok ? src + w0 : src, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = row_ok && w0 + e < w;
            copy4(dst + e, ok ? src + w0 + e : src, ok);
          }
        }
      }
    }
    copy_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int pop_part[2] = {0, 0};

  issue(0);
  for (int s = 0; s < stages; ++s) {
    issue(s + 1);  // its slot was last read before the barrier closing stage s - 1
    copy_wait_one();
    __syncthreads();  // every thread's copies of stage s have landed
    const uint32_t* slot = ring + (s & 1) * 2 * kTile * kPackStride;
    const int nw = min(kWords, w - s * kWords);  // words of this stage
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          slot + (side * kTile + my_row) * kPackStride + 4 * my_chunk);
      pop_part[side] += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    const unsigned ring_s = smem_addr(slot);
    const int mat = lane >> 3, r8 = lane & 7;
    for (int ks = 0; 4 * ks < nw; ++ks) {  // four words = one k128 step
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        // Matrices: m tile 2ii rows 0-7, 8-15, m tile 2ii + 1 rows 0-7, 8-15.
        const int row = wm * 64 + 32 * ii + 8 * mat + r8;
        ldmatrix_x4(a[ii], ring_s + (row * kPackStride + 4 * ks) * 4);
      }
      {
        const int row = wn * 32 + 8 * mat + r8;  // matrix j: n tile j
        ldmatrix_x4(b, ring_s + ((kTile + row) * kPackStride + 4 * ks) * 4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_b1(acc[i][j], a[i >> 1][2 * (i & 1)], a[i >> 1][2 * (i & 1) + 1], b[j]);
    }
    __syncthreads();  // the stage's slot is free
  }

  // Row popcounts: the two threads of a row add their halves.
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int p = pop_part[side] + __shfl_xor_sync(0xffffffffu, pop_part[side], 1);
    if (my_chunk == 0) pop[side * kTile + my_row] = p;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn * 32 + 8 * j + 2 * tq;
      const int pb0 = pop[kTile + col], pb1 = pop[kTile + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 64 + 16 * i + g + 8 * h;
        const int pa = pop[row];
        *reinterpret_cast<int2*>(tile + row * kOutStride + col) =
            make_int2(pa + pb0 - 2 * acc[i][j][2 * h], pa + pb1 - 2 * acc[i][j][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  const int col = c0 + 4 * lane;
  for (int rr = 0; rr < kTile / 8; ++rr) {
    const int r = warp * (kTile / 8) + rr;
    if (q0 + r >= n_q) break;
    const int4 v = *reinterpret_cast<const int4*>(tile + r * kOutStride + 4 * lane);
    int32_t* dst = out + static_cast<long long>(q0 + r) * n_c + col;
    if (vec_out && col + 3 < n_c) {
      __stcs(reinterpret_cast<int4*>(dst), v);  // evict-first: 134 MB passes through L2
    } else {
      const int vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < n_c) dst[e] = vals[e];
    }
  }
}

// Ask once per instantiation and device for the shared memory above the
// default 48 KB; launch.
template <bool kVec>
int run(const uint32_t* q, const uint32_t* c, int32_t* out, int n_q, int n_c, int w,
        bool vec_out, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool smem_set[64] = {};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(hamming_matrix_kernel<kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>((n_c + kTile - 1) / kTile),
                  static_cast<unsigned>((n_q + kTile - 1) / kTile));
  hamming_matrix_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(q, c, out, n_q, n_c,
                                                                      w, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// 16-byte copies are taken where both inputs lie on 16 bytes and W % 4 ==
// 0; 16-byte stores where the output does and C % 4 == 0.
extern "C" int hamming_matrix_launch(const void* q, const void* c, void* out,
                                     int n_q, int n_c, int w, void* stream) {
  if (n_q <= 0 || n_c <= 0 || w <= 0 || (n_q + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const bool vec_out = n_c % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* qw = static_cast<const uint32_t*>(q);
  const auto* cw = static_cast<const uint32_t*>(c);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? run<true>(qw, cw, o, n_q, n_c, w, vec_out, s)
             : run<false>(qw, cw, o, n_q, n_c, w, vec_out, s);
}
