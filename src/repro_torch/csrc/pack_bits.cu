// MSB-first bit packing of a {0,1} byte matrix into 32-bit words.
//
// Replaces the Pallas TPU kernel pack_bits_kernel / _pack_kernel in
// src/repro/kernels/bitpack/kernel.py (wrapper pack_bits in
// src/repro/kernels/bitpack/ops.py).  Contract: (N, K) uint8 (or bool)
// in {0,1} -> (N, ceil(K/32)) 32-bit words; bit 31 of word 0 is column 0,
// and the padding bits past column K-1 are zero.  Any N and K: the kernel
// masks the ragged last word itself, so nothing is padded in memory.
//
// Bound on the H100: bytes.  The work is one compare per input byte; the
// input (1 B per bit) is 32x the output.  At the key path's shape
// (262144, 448) one launch reads 117 MB and writes 14.7 MB, about 39 us
// at 3.35 TB/s; the sketches of 3,000,000 x 384 points are 1.15 GB in,
// 0.14 GB out, about 0.39 ms.  Design: one warp per output word.  Lane j
// reads byte j of the word's 32 columns (one 32-byte sector per warp,
// neighbouring lanes on neighbouring bytes), __ballot_sync gathers the 32
// predicates into one register with lane j at bit j, and __brev puts
// lane 0 at bit 31.  The TPU kernel's shift-and-sum over a (BN, 32*BW)
// VMEM tile has no counterpart here: the ballot is the warp-wide OR.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 output words per block

__global__ void __launch_bounds__(kThreads)
pack_bits_kernel(const uint8_t* __restrict__ bits, uint32_t* __restrict__ out,
                 long long n_words, int k, int w) {
  // The word index is uniform across a warp, so whole warps exit together
  // and the full-mask ballot below always sees 32 live lanes.
  const long long word =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (word >= n_words) return;
  const int lane = threadIdx.x & 31;
  const long long row = word / w;
  const int col = static_cast<int>(word - row * w) * 32 + lane;
  const bool set = col < k && bits[row * k + col] != 0;
  const unsigned mask = __ballot_sync(0xffffffffu, set);
  if (lane == 0) out[word] = __brev(mask);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int pack_bits_launch(const void* bits, void* out, long long n, int k,
                                void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int w = (k + 31) / 32;
  const long long n_words = n * w;
  const long long words_per_block = kThreads / 32;
  const unsigned blocks =
      static_cast<unsigned>((n_words + words_per_block - 1) / words_per_block);
  pack_bits_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<uint32_t*>(out), n_words,
      k, w);
  return static_cast<int>(cudaGetLastError());
}
