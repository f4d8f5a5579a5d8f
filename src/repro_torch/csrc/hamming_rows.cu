// Stage-1 sketch filter of Algorithm 1: each query's Hamming distance to
// its OWN K candidate sketches.
//
// Replaces the Pallas TPU kernel hamming_rows_kernel / _hamming_rows_kernel
// in src/repro/kernels/hamming/kernel.py (wrapper hamming_rows in
// src/repro/kernels/hamming/ops.py).  Contract: (Q, W) and (Q, K, W)
// 32-bit words -> (Q, K) int32 popcount(q ^ c) summed over W.
//
// Bound on the H100: bytes.  At the search path's shapes (Q=2048, K=48,
// W=12) one launch reads 4.7 MB and writes 0.4 MB, about 1.5 us at
// 3.35 TB/s, so the launch itself (a few us) is the real cost; the
// arithmetic (XOR + __popc + add per word) is negligible.  Design: one
// thread per (query, candidate) row, 128 rows per block.  The block first
// copies its rows' words into shared memory with neighbouring threads on
// neighbouring words (coalesced), then each thread sums its row from
// shared memory; the row stride is made odd so the 32 rows a warp reads
// fall into 32 distinct banks.  The query row is read through the
// read-only cache: the K rows of one query share it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // (query, candidate) rows per block, one per thread

__global__ void __launch_bounds__(kRows)
hamming_rows_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ c,
                    int32_t* __restrict__ out,
                    long long n_rows, int k, int w, int stride) {
  extern __shared__ uint32_t tile[];  // kRows x stride words
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long left = n_rows - row0;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;
  const uint32_t* src = c + row0 * w;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int r = i / w;
    tile[r * stride + (i - r * w)] = src[i];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) {
    const long long row = row0 + r;
    const uint32_t* qr = q + (row / k) * w;
    const uint32_t* cr = tile + r * stride;
    int acc = 0;
    for (int j = 0; j < w; ++j) acc += __popc(__ldg(qr + j) ^ cr[j]);
    out[row] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int hamming_rows_launch(const void* q, const void* c, void* out,
                                   int n_q, int k, int w, void* stream) {
  const long long n_rows = static_cast<long long>(n_q) * k;
  if (n_rows == 0 || w == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int stride = w | 1;
  const size_t smem = static_cast<size_t>(kRows) * stride * sizeof(uint32_t);
  static size_t smem_allowed = 48 * 1024;  // the default opt-in limit
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        hamming_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const unsigned blocks = static_cast<unsigned>((n_rows + kRows - 1) / kRows);
  hamming_rows_kernel<<<blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(c),
      static_cast<int32_t*>(out), n_rows, k, w, stride);
  return static_cast<int>(cudaGetLastError());
}
