// Dense asymmetric distance: fp32 queries against every candidate's 4-bit
// codes, unpacked (one uint8 per dim) or nibble-packed (eight per word).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/qdist/kernel.py:
//   qdist_u8_kernel / _qdist_u8_kernel (wrapper qdist in
//     src/repro/kernels/qdist/ops.py), launcher qdist_u8_launch;
//   qdist_packed_kernel / _qdist_packed_kernel (wrapper qdist_from_packed),
//     launcher qdist_packed_launch.
// Contract: queries (Q, D) f32, codes (C, D) uint8 or (C, W=ceil(D/8))
// 32-bit words with dim 8w+s in nibble s of word w, centroids (D, L) f32
// -> (Q, C) f32 sum over d of (q_d - centroids[d, code_d])^2.  A code
// >= L reconstructs to 0, as the TPU kernel's select chain gives.
//
// Bound on the H100: operations.  At the kernel bench's shape (Q=512,
// C=16384, D=384) the sub/mul/add take 3*Q*C*D = 9.66 G operations,
// 0.144 ms at the 67 TFLOP/s of non-tensor fp32; the bytes (34 MB of
// output, 6.3 MB of u8 or 3.1 MB of packed codes) take ~0.012 ms.  Design:
// no tensor cores and no TF32 (the distance contract is rtol 1e-5), and
// the distance is summed directly as (q - r)^2 rather than in the TPU's
// expanded |q|^2 - 2 q.r + |r|^2 form, whose cancellation costs digits.
// A 2-D grid of 64-query x 64-candidate tiles, 256 threads each owning a
// 4 x 4 block of outputs in registers, like a register-tiled GEMM whose
// inner product is a squared difference.  Per pass of 32 dims the block
// stages the queries' values, its centroid rows (32 x L, in shared
// memory) and the candidates' reconstructed values, dim-major, so the
// inner loop reads 4 query and 4 candidate values as two 16-byte loads
// and does 16 sub + fma.  Dequantization (a shared-memory lookup per
// candidate dim) is done once per block and pass, 1/16 of the arithmetic.
// Each pass sums into fresh registers that are then added to the total,
// which keeps the fp32 sum within the contract of the plain version's
// reduction.  Dims past D (a ragged last word, a ragged pass) stage zero
// on both sides and add nothing; tiles past Q or C are not written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;           // queries and candidates per block
constexpr int kThreads = 256;       // 16 x 16 threads, each 4 x 4 outputs
constexpr int kDims = 32;           // dims per pass (4 packed words)
constexpr int kStride = kTile + 4;  // row stride: 16-byte aligned rows

// Shared memory of one block: query and candidate tiles, then the pass's
// centroid rows (only the levels a code can reach are staged).
inline size_t smem_bytes(int staged_levels) {
  return (2 * static_cast<size_t>(kDims) * kStride +
          static_cast<size_t>(kDims) * staged_levels) * sizeof(float);
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
qdist_dense_kernel(const float* __restrict__ q,      // (Q, D)
                   const void* __restrict__ codes,   // (C, D) u8 | (C, W) u32
                   const float* __restrict__ cent,   // (D, L)
                   float* __restrict__ out,          // (Q, C)
                   int n_q, int n_c, int d, int levels, int staged) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // kDims x kStride, dim-major
  float* rs = qs + kDims * kStride;  // kDims x kStride, dim-major
  float* ct = rs + kDims * kStride;  // kDims x staged: this pass's centroids
  const int tx = threadIdx.x & 15;   // candidates c0 + 4 tx .. + 3
  const int ty = threadIdx.x >> 4;   // queries q0 + 4 ty .. + 3
  const int q0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  float tot[4][4] = {};
  for (int d0 = 0; d0 < d; d0 += kDims) {
    for (int i = threadIdx.x; i < kDims * staged; i += kThreads) {
      const int k = i / staged;
      const int l = i - k * staged;
      ct[i] = d0 + k < d ? cent[static_cast<long long>(d0 + k) * levels + l] : 0.f;
    }
    for (int i = threadIdx.x; i < kTile * kDims; i += kThreads) {
      const int r = i / kDims;
      const int k = i - r * kDims;
      float v = 0.f;
      if (q0 + r < n_q && d0 + k < d) v = q[static_cast<long long>(q0 + r) * d + d0 + k];
      qs[k * kStride + r] = v;
    }
    __syncthreads();  // centroid rows staged
    if (kPacked) {
      const int w = (d + 7) / 8;
      const uint32_t* p = static_cast<const uint32_t*>(codes);
      for (int i = threadIdx.x; i < kTile * (kDims / 8); i += kThreads) {
        const int r = i / (kDims / 8);
        const int k = i - r * (kDims / 8);  // word k of this pass
        const int word_i = d0 / 8 + k;
        const uint32_t word = (c0 + r < n_c && word_i < w)
            ? p[static_cast<long long>(c0 + r) * w + word_i] : 0u;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int kk = 8 * k + s;
          const int code = (word >> (4 * s)) & 0xF;
          rs[kk * kStride + r] =
              (d0 + kk < d && code < staged) ? ct[kk * staged + code] : 0.f;
        }
      }
    } else {
      const uint8_t* u = static_cast<const uint8_t*>(codes);
      for (int i = threadIdx.x; i < kTile * kDims; i += kThreads) {
        const int r = i / kDims;
        const int k = i - r * kDims;
        float v = 0.f;
        if (c0 + r < n_c && d0 + k < d) {
          const int code = u[static_cast<long long>(c0 + r) * d + d0 + k];
          v = code < staged ? ct[k * staged + code] : 0.f;
        }
        rs[k * kStride + r] = v;
      }
    }
    __syncthreads();  // both tiles staged
    float acc[4][4] = {};
#pragma unroll 8
    for (int k = 0; k < kDims; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(qs + k * kStride + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(rs + k * kStride + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float diff = av[i] - bv[j];
          acc[i][j] = fmaf(diff, diff, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[i][j] += acc[i][j];
    __syncthreads();  // tiles free for the next pass
  }
  const int col = c0 + 4 * tx;
  const bool vec = (n_c & 3) == 0 && col + 3 < n_c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= n_q) break;
    float* dst = out + static_cast<long long>(row) * n_c + col;
    if (vec) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(tot[i][0], tot[i][1], tot[i][2], tot[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n_c) dst[j] = tot[i][j];
    }
  }
}

// Shared by both launchers: levels a code can reach are staged (16 for a
// nibble, 256 for a byte); more shared memory than the default 48 KB is
// asked for once per kernel.
template <bool kPacked>
int launch(const void* q, const void* codes, const void* cent, void* out,
           int n_q, int n_c, int d, int levels, void* stream) {
  if (n_q <= 0 || n_c <= 0 || d <= 0 || levels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int staged = levels < (kPacked ? 16 : 256) ? levels : (kPacked ? 16 : 256);
  const size_t smem = smem_bytes(staged);
  static size_t smem_allowed = 48 * 1024;  // the default opt-in limit
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        qdist_dense_kernel<kPacked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const dim3 grid(static_cast<unsigned>((n_c + kTile - 1) / kTile),
                  static_cast<unsigned>((n_q + kTile - 1) / kTile));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  qdist_dense_kernel<kPacked><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), codes, static_cast<const float*>(cent),
      static_cast<float*>(out), n_q, n_c, d, levels, staged);
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
