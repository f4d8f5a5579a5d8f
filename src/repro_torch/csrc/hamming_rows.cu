// Stage-1 sketch filter of Algorithm 1: each query's Hamming distance to
// its OWN K candidate sketches, pre-gathered or read by index straight
// from the resident sketch table.
//
// Replaces the Pallas TPU kernel hamming_rows_kernel / _hamming_rows_kernel
// in src/repro/kernels/hamming/kernel.py (:83, pallas_call :96; wrapper
// hamming_rows in src/repro/kernels/hamming/ops.py).  Contract: queries
// (Q, W) 32-bit words; the candidate of (q, k) is row q*K + k of a
// pre-gathered (Q*K, W) block, or row idx[q, k] (int32 or int64) of an
// (n, W) table, an index outside [0, n) clamped to [0, n - 1] as the JAX
// gather clamps it -> (Q, K) int32 popcount(query ^ candidate) summed over
// W.  The launch goes on the given stream, allocates nothing and returns
// its cudaError_t.
//
// Bound on the H100: bytes.  Pre-gathered, the (Q, K, W) block is read
// once: 4.7 MB at the search's (2048, 48, 12), 1.5 us at 3.35 TB/s, so
// there the launch and one DRAM round trip are the cost.  Read by index,
// what must move is the distinct rows the indices name (two 32-byte
// sectors for a 48-byte row), the indices and the output: at Table 1's
// 120-tree pool (2048, 2425) at most 0.33 GB, against the ~0.8 GB of
// gathering the block (read 64 B a row, write 48 B) and reading it back.
//
// Design: one thread per (query, candidate) row, 128 rows a block; no
// shared memory and no barrier.  The thread reads its index (coalesced),
// then the candidate row and its query row a slab of 16 words at a time,
// every load of the slab issued before the first XOR, so a row costs one
// dependent DRAM round trip after its index.  Where the launcher finds
// both bases on 16 bytes and W*4 % 16 == 0 the loads are 16-byte
// read-only loads (3 a row at W = 12), else 4-byte ones.  The query rows
// (Q*W words, 98 KB at the search's shape) stay in L1/L2 and are held in
// registers for the slab.  One 32-bit division a row (its query), none a
// word; the int32 stores of a warp are contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // (query, candidate) rows per block, one per thread
constexpr int kSlab = 16;      // words of a row loaded before they are used

// Where the candidate row of output i comes from: kIdxBytes 0 is the
// pre-gathered block (row i), 4 and 8 an int32 or int64 index table.
template <int kIdxBytes>
__device__ __forceinline__ long long row_of(const void* idx, long long i, long long n_rows) {
  if constexpr (kIdxBytes == 0) {
    return i;
  } else {
    long long r;
    if constexpr (kIdxBytes == 4) {
      r = __ldg(static_cast<const int*>(idx) + i);
    } else {
      r = __ldg(static_cast<const long long*>(idx) + i);
    }
    return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  }
}

// kVec: 16-byte loads (both bases on 16 bytes, W % 4 == 0).
template <int kIdxBytes, bool kVec>
__global__ void __launch_bounds__(kThreads)
hamming_rows_kernel(const uint32_t* __restrict__ q,     // (Q, W)
                    const uint32_t* __restrict__ rows,  // (n, W) or (Q*K, W)
                    const void* __restrict__ idx,       // (Q, K) or null
                    int32_t* __restrict__ out,          // (Q, K)
                    long long n_out, long long n_rows, int k, int w) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const long long r = row_of<kIdxBytes>(idx, i, n_rows);
  const long long qi = n_out <= 0xffffffffLL
                           ? static_cast<long long>(static_cast<unsigned>(i) /
                                                    static_cast<unsigned>(k))
                           : i / k;
  const uint32_t* qr = q + qi * w;
  const uint32_t* cr = rows + r * w;
  int acc = 0;
  for (int w0 = 0; w0 < w; w0 += kSlab) {
    if constexpr (kVec) {
      uint4 a[kSlab / 4], b[kSlab / 4];
#pragma unroll
      for (int j = 0; j < kSlab / 4; ++j) {
        const bool ok = w0 + 4 * j < w;
        a[j] = ok ? __ldg(reinterpret_cast<const uint4*>(qr + w0) + j) : make_uint4(0, 0, 0, 0);
        b[j] = ok ? __ldg(reinterpret_cast<const uint4*>(cr + w0) + j) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < kSlab / 4; ++j)
        acc += __popc(a[j].x ^ b[j].x) + __popc(a[j].y ^ b[j].y) +
               __popc(a[j].z ^ b[j].z) + __popc(a[j].w ^ b[j].w);
    } else {
      uint32_t a[kSlab], b[kSlab];
#pragma unroll
      for (int j = 0; j < kSlab; ++j) {
        const bool ok = w0 + j < w;
        a[j] = ok ? __ldg(qr + w0 + j) : 0u;
        b[j] = ok ? __ldg(cr + w0 + j) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kSlab; ++j) acc += __popc(a[j] ^ b[j]);
    }
  }
  out[i] = acc;
}

template <int kIdxBytes, bool kVec>
int run(const uint32_t* q, const uint32_t* rows, const void* idx, int32_t* out,
        long long n_out, long long n_rows, int k, int w, cudaStream_t stream) {
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  hamming_rows_kernel<kIdxBytes, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      q, rows, idx, out, n_out, n_rows, k, w);
  return static_cast<int>(cudaGetLastError());
}

template <int kIdxBytes>
int run_aligned(bool vec, const uint32_t* q, const uint32_t* rows, const void* idx,
                int32_t* out, long long n_out, long long n_rows, int k, int w,
                cudaStream_t stream) {
  return vec ? run<kIdxBytes, true>(q, rows, idx, out, n_out, n_rows, k, w, stream)
             : run<kIdxBytes, false>(q, rows, idx, out, n_out, n_rows, k, w, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `idx` null: `rows` is the pre-gathered (Q*K, W) block and n_rows is
// ignored; otherwise `idx` is (Q, K) of `idx_bytes` 4 or 8 into the
// (n_rows, W) table `rows`.  16-byte loads are taken where `q` and `rows`
// lie on 16 bytes and W*4 % 16 == 0.
extern "C" int hamming_rows_launch(const void* q, const void* rows, const void* idx,
                                   int idx_bytes, void* out, int n_q, int k, int w,
                                   long long n_rows, void* stream) {
  const long long n_out = static_cast<long long>(n_q) * k;
  if (n_q <= 0 || k <= 0 || w <= 0 || (idx != nullptr && n_rows <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const auto* qw = static_cast<const uint32_t*>(q);
  const auto* rw = static_cast<const uint32_t*>(rows);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (idx == nullptr) return run_aligned<0>(vec, qw, rw, idx, o, n_out, n_out, k, w, s);
  if (idx_bytes == 4) return run_aligned<4>(vec, qw, rw, idx, o, n_out, n_rows, k, w, s);
  if (idx_bytes == 8) return run_aligned<8>(vec, qw, rw, idx, o, n_out, n_rows, k, w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
