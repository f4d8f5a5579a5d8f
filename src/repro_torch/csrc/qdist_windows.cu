// Stage-2 distance of Algorithm 1: fp32 queries against the nibble-packed
// 4-bit codes of each query's OWN candidate windows.
//
// Replaces the Pallas TPU kernel qdist_packed_windows_kernel /
// _qdist_packed_windows_kernel in src/repro/kernels/qdist/kernel.py
// (wrapper qdist_windows_from_packed in src/repro/kernels/qdist/ops.py).
// Contract: queries (Q, D) f32, windows (Q, C, W=ceil(D/8)) 32-bit words
// with dim 8w+s in nibble s of word w, centroids (D, 16) f32 ->
// (Q, C) f32 sum over d of (q_d - centroids[d, code_d])^2.
//
// Bound on the H100: bytes.  At the search path's shapes (Q=2048,
// C=k2*(2h+1)=1920, W=48, D=384) one launch reads 755 MB of windows,
// about 0.23 ms at 3.35 TB/s; the 4.5 GFLOP of sub/mul/add would take
// 0.07 ms at the 67 TFLOP/s of non-tensor fp32.  Design: no tensor cores
// and no TF32.  One block per (query, tile of 1024 candidates), 256
// threads, one candidate per thread per pass.  The block first turns the
// query row and the (D, 16) centroid table into a table of the 16*D terms
// (q_d - c[d, l])^2 in shared memory (24.6 KB at D=384; each term rounded
// exactly as the plain version rounds it), so the inner loop is one
// shared-memory lookup and one add per dim.  The table is stored
// level-major with an odd row stride: the 32 threads of a warp read the
// same dim and at most 16 distinct levels, which land in distinct banks.
// Candidate rows are staged through shared memory with neighbouring
// threads on neighbouring words (coalesced), again with an odd row stride
// so each thread's reads of its own row are conflict-free.  Four
// interleaved accumulators keep the fp32 sum close to the plain version's
// (rtol 1e-5, atol 1e-6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // one candidate per thread per pass
constexpr int kCandPerBlock = 1024;   // candidates per block (4 passes)
constexpr int kLevels = 16;           // 4-bit codes

__global__ void __launch_bounds__(kThreads)
qdist_windows_kernel(const float* __restrict__ q,       // (Q, D)
                     const uint32_t* __restrict__ win,  // (Q, C, W)
                     const float* __restrict__ cent,    // (D, 16)
                     float* __restrict__ out,           // (Q, C)
                     int c, int w, int d, int lut_stride, int row_stride) {
  extern __shared__ float smem[];
  float* lut = smem;  // kLevels x lut_stride: lut[l * lut_stride + j]
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem + kLevels * lut_stride);
  const long long qi = blockIdx.x;
  const float* qrow = q + qi * d;
  for (int i = threadIdx.x; i < d * kLevels; i += kThreads) {
    const int j = i / kLevels;
    const float diff = qrow[j] - cent[i];
    lut[(i - j * kLevels) * lut_stride + j] = __fmul_rn(diff, diff);
  }
  const int c0 = blockIdx.y * kCandPerBlock;
  const int c_end = min(c, c0 + kCandPerBlock);
  const int full = d >> 3;  // words whose 8 nibbles are all real dims
  const uint32_t* base = win + qi * c * w;
  for (int t0 = c0; t0 < c_end; t0 += kThreads) {
    const int rows = min(kThreads, c_end - t0);
    __syncthreads();  // table written (first pass) / tile free (later passes)
    const uint32_t* src = base + static_cast<long long>(t0) * w;
    for (int i = threadIdx.x; i < rows * w; i += kThreads) {
      const int r = i / w;
      tile[r * row_stride + (i - r * w)] = src[i];
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      const uint32_t* row = tile + threadIdx.x * row_stride;
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
      for (int k = 0; k < full; ++k) {
        const uint32_t word = row[k];
        const float* col = lut + 8 * k;
        acc0 += col[((word >> 0) & 0xF) * lut_stride + 0];
        acc1 += col[((word >> 4) & 0xF) * lut_stride + 1];
        acc2 += col[((word >> 8) & 0xF) * lut_stride + 2];
        acc3 += col[((word >> 12) & 0xF) * lut_stride + 3];
        acc0 += col[((word >> 16) & 0xF) * lut_stride + 4];
        acc1 += col[((word >> 20) & 0xF) * lut_stride + 5];
        acc2 += col[((word >> 24) & 0xF) * lut_stride + 6];
        acc3 += col[((word >> 28) & 0xF) * lut_stride + 7];
      }
      if (full < w) {  // ragged last word: only its first d - 8*full nibbles
        const uint32_t word = row[full];
        for (int s = 0; s < d - 8 * full; ++s)
          acc0 += lut[((word >> (4 * s)) & 0xF) * lut_stride + 8 * full + s];
      }
      out[qi * c + t0 + threadIdx.x] = (acc0 + acc1) + (acc2 + acc3);
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int qdist_windows_launch(const void* q, const void* win,
                                    const void* cent, void* out, int n_q,
                                    int c, int w, int d, void* stream) {
  if (n_q == 0 || c == 0 || d == 0 || w != (d + 7) / 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lut_stride = d | 1;
  const int row_stride = w | 1;
  const size_t smem = (static_cast<size_t>(kLevels) * lut_stride +
                       static_cast<size_t>(kThreads) * row_stride) * 4;
  static size_t smem_allowed = 48 * 1024;  // the default opt-in limit
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        qdist_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const dim3 grid(static_cast<unsigned>(n_q),
                  static_cast<unsigned>((c + kCandPerBlock - 1) / kCandPerBlock));
  qdist_windows_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint32_t*>(win),
      static_cast<const float*>(cent), static_cast<float*>(out), c, w, d,
      lut_stride, row_stride);
  return static_cast<int>(cudaGetLastError());
}
