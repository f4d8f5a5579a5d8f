// MSB-first bit packing of a {0,1} byte matrix into 32-bit words.
//
// Replaces the Pallas TPU kernel pack_bits_kernel / _pack_kernel in
// src/repro/kernels/bitpack/kernel.py (wrapper pack_bits in
// src/repro/kernels/bitpack/ops.py).  Contract: (N, K) uint8 whose every
// byte is 0 or 1 (a bool tensor's bytes are) -> (N, ceil(K/32)) 32-bit
// words; bit 31 of word 0 is column 0, and the padding bits past column
// K-1 are zero.  Any N and K: the kernel masks the ragged last word itself,
// so nothing is padded in memory.  Bytes other than 0 and 1 are outside
// the contract: the 16-byte path below would carry them into the
// neighbouring bits.  Both callers give 0 and 1 only (core/hilbert.py
// masks each key bit with & 1; core/sketch.py packs a bool comparison).
//
// Bound on the H100: bytes.  The input (1 B per bit) is 32x the output.
// At the key path's shape (262144, 448) one launch reads 117 MB and writes
// 14.7 MB, about 39 us at 3.35 TB/s; the sketches of 3,000,000 x 384
// points are 1.15 GB in, 0.14 GB out, about 0.39 ms.
//
// Design: one thread makes one output word, in a grid-stride loop whose
// (row, word) cursor advances by the stride's quotient and remainder (the
// launcher computes them), so the loop divides nothing.
// - 16-byte path (the launcher's `vec`: base pointer on 16 bytes and
//   K % 16 == 0, so every word's 32 columns start on 16 bytes).  The
//   thread reads its 32 bytes as two 16-byte loads; neighbouring threads
//   make neighbouring words, so a warp's two loads cover 1,024 contiguous
//   bytes of a row.  Four bytes b0..b3 (b0 at the lowest address) become
//   four bits by one multiply: ((x * 0x08040201) >> 24) & 0xF is
//   b0<<3 | b1<<2 | b2<<1 | b3, each byte's bit landing on its own bit of
//   the product, so nothing carries.  A row whose K % 32 == 16 has a
//   last word of 16 bytes: its second load is skipped.
// - Byte path (any other base or K): the same loop reads its word's
//   columns one byte at a time and masks the ragged last word.
// One store per word; a warp's stores are 128 contiguous bytes.  The TPU
// kernel's shift-and-sum over a (BN, 32*BW) VMEM tile has no counterpart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads an SM

// Four bytes of {0,1}, lowest address first, to four bits, first byte high.
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  return ((x * 0x08040201u) >> 24) & 0xFu;
}

__device__ __forceinline__ uint32_t pack16(const uint4& v) {
  return nibble(v.x) << 12 | nibble(v.y) << 8 | nibble(v.z) << 4 | nibble(v.w);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_bits_kernel(const uint8_t* __restrict__ bits, uint32_t* __restrict__ out,
                 long long n_words, int k, int w, long long step_rows, int step_cols) {
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  long long row = first / static_cast<unsigned>(w);  // once, 32-bit
  int col = static_cast<int>(first - row * w);
  for (long long word = first; word < n_words; word += step) {
    const uint8_t* src = bits + row * k + col * 32;
    const int left = k - col * 32;  // columns of this word: min(32, left)
    uint32_t v;
    if (kVec) {
      const uint4 lo = __ldg(reinterpret_cast<const uint4*>(src));
      const uint4 hi = left > 16 ? __ldg(reinterpret_cast<const uint4*>(src + 16))
                                 : make_uint4(0, 0, 0, 0);
      v = pack16(lo) << 16 | pack16(hi);
    } else {
      v = 0;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c < left) v |= static_cast<uint32_t>(src[c] != 0) << (31 - c);
    }
    out[word] = v;
    row += step_rows;
    col += step_cols;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `vec` asks for the 16-byte path; it is refused (cudaErrorInvalidValue)
// unless `bits` lies on 16 bytes and k % 16 == 0.  vec = 0 takes the byte
// path on any input.
extern "C" int pack_bits_launch(const void* bits, void* out, long long n, int k,
                                int vec, void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (reinterpret_cast<uintptr_t>(bits) % 16 != 0 || k % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = (k + 31) / 32;
  const long long n_words = n * w;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long needed = (n_words + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(needed < cap ? needed : cap);
  const long long step = static_cast<long long>(blocks) * kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(bits);
  auto* o = static_cast<uint32_t*>(out);
  if (vec)
    pack_bits_kernel<true><<<blocks, kThreads, 0, s>>>(in, o, n_words, k, w, step / w,
                                                       static_cast<int>(step % w));
  else
    pack_bits_kernel<false><<<blocks, kThreads, 0, s>>>(in, o, n_words, k, w, step / w,
                                                        static_cast<int>(step % w));
  return static_cast<int>(cudaGetLastError());
}
