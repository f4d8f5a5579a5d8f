// Dense sketch Hamming matrix: every query against every candidate.
//
// Replaces the Pallas TPU kernel hamming_matrix_kernel / _hamming_kernel
// in src/repro/kernels/hamming/kernel.py (wrapper hamming_matrix in
// src/repro/kernels/hamming/ops.py).  Contract: (Q, W) and (C, W) 32-bit
// words -> (Q, C) int32 popcount(q ^ c) summed over W, for any W >= 1.
//
// Bound on the H100: bytes.  At the kernel bench's shape (Q=512,
// C=65536, W=12) the inputs are 3.2 MB and the int32 output 134 MB, so
// the bound is 137.4 MB at 3.35 TB/s = 0.041 ms; the 0.4 G popcounts run
// on the SM's integer pipe and may well take longer.  Design: no padding
// of Q or C (the TPU kernel needed 128-multiples).  A 2-D grid of
// 64-query x 64-candidate tiles, 256 threads each owning a 4 x 4 block of
// outputs in registers.  Both sides' words are staged through shared
// memory 16 words at a time, word-major, so a thread reads its 4 query
// words and its 4 candidate words of one word index as one 16-byte load
// each (the 32 lanes of a warp share two query rows: a broadcast).  Each
// output row is written as 16-byte stores, neighbouring threads on
// neighbouring candidates.  Tiles past Q or C read zero words and are not
// written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;           // queries and candidates per block
constexpr int kThreads = 256;       // 16 x 16 threads, each 4 x 4 outputs
constexpr int kWords = 16;          // words staged per pass
constexpr int kStride = kTile + 4;  // row stride: 16-byte aligned rows

__global__ void __launch_bounds__(kThreads)
hamming_matrix_kernel(const uint32_t* __restrict__ q,  // (Q, W)
                      const uint32_t* __restrict__ c,  // (C, W)
                      int32_t* __restrict__ out,       // (Q, C)
                      int n_q, int n_c, int w) {
  __shared__ __align__(16) uint32_t qs[kWords][kStride];
  __shared__ __align__(16) uint32_t cs[kWords][kStride];
  const int tx = threadIdx.x & 15;   // candidates c0 + 4 tx .. + 3
  const int ty = threadIdx.x >> 4;   // queries q0 + 4 ty .. + 3
  const int q0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  int acc[4][4] = {};
  for (int w0 = 0; w0 < w; w0 += kWords) {
    const int wn = min(kWords, w - w0);
    for (int i = threadIdx.x; i < kTile * kWords; i += kThreads) {
      const int r = i / kWords;
      const int k = i - r * kWords;
      uint32_t a = 0, b = 0;
      if (k < wn) {
        if (q0 + r < n_q) a = q[static_cast<long long>(q0 + r) * w + w0 + k];
        if (c0 + r < n_c) b = c[static_cast<long long>(c0 + r) * w + w0 + k];
      }
      qs[k][r] = a;
      cs[k][r] = b;
    }
    __syncthreads();
    for (int k = 0; k < wn; ++k) {
      const uint4 a = *reinterpret_cast<const uint4*>(&qs[k][4 * ty]);
      const uint4 b = *reinterpret_cast<const uint4*>(&cs[k][4 * tx]);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(av[i] ^ bv[j]);
    }
    __syncthreads();  // tiles free for the next pass
  }
  const int col = c0 + 4 * tx;
  const bool vec = (n_c & 3) == 0 && col + 3 < n_c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= n_q) break;
    int32_t* dst = out + static_cast<long long>(row) * n_c + col;
    if (vec) {
      *reinterpret_cast<int4*>(dst) =
          make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n_c) dst[j] = acc[i][j];
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int hamming_matrix_launch(const void* q, const void* c, void* out,
                                     int n_q, int n_c, int w, void* stream) {
  if (n_q <= 0 || n_c <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_c + kTile - 1) / kTile),
                  static_cast<unsigned>((n_q + kTile - 1) / kTile));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  hamming_matrix_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(c),
      static_cast<int32_t*>(out), n_q, n_c, w);
  return static_cast<int>(cudaGetLastError());
}
