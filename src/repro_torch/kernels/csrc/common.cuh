// Shared helpers for the wire kernels (sm_90a, plain C entry points).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// Largest code length any book may hold (MAX_CODE_LEN): the canonical
// tables have kMaxLen + 1 entries.
constexpr int kMaxLen = 16;

// The 32 stream bits starting at bit ``bit_pos`` of an MSB-first,
// big-endian word stream.  The two-word fetch clamps to words
// cap - 2, cap - 1 (the chunk's pad word), as every reference decoder does.
__device__ __forceinline__ uint32_t window32(const uint32_t* __restrict__ w,
                                             uint32_t bit_pos, int cap) {
  uint32_t widx = min(bit_pos >> 5, static_cast<uint32_t>(cap - 2));
  uint32_t pin = bit_pos & 31u;
  uint32_t w0 = __ldg(w + widx);
  uint32_t w1 = __ldg(w + widx + 1);
  return (w0 << pin) | (pin ? (w1 >> (32u - pin)) : 0u);
}

// Canonical-prefix search over code lengths lo..max_len of a max_len-bit
// window: the smallest valid length and its symbol.  With no valid
// length it falls back to length lo, as the reference's argmax over an
// all-false vector does (never reached inside a valid stream's count).
__device__ __forceinline__ void canonical_first(
    int window, int lo, int max_len, const int32_t* fc, const int32_t* bi,
    const int32_t* nc, const int32_t* ss, int n_ss, int* len, int* sym) {
  int l = lo;
  int off = (window >> (max_len - lo)) - fc[lo];
  for (int ll = lo; ll <= max_len; ++ll) {
    int o = (window >> (max_len - ll)) - fc[ll];
    if (o >= 0 && o < nc[ll]) {
      l = ll;
      off = o;
      break;
    }
  }
  int idx = min(max(bi[l] + off, 0), n_ss - 1);
  *len = l;
  *sym = ss[idx];
}

// Canonical walk of one chunk: ``count`` symbols from the chunk's words
// into ``dst`` (any integer type), zeros after them up to ``chunk``.
template <typename T>
__device__ __forceinline__ void walk_canonical(
    const uint32_t* __restrict__ w, int count, int chunk, int cap,
    int max_len, const int32_t* fc, const int32_t* bi, const int32_t* nc,
    const int32_t* ss, int n_ss, T* dst) {
  uint32_t bit_pos = 0;
  for (int k = 0; k < count; ++k) {
    const int window =
        static_cast<int>(window32(w, bit_pos, cap) >> (32 - max_len));
    int l, sym;
    canonical_first(window, 1, max_len, fc, bi, nc, ss, n_ss, &l, &sym);
    dst[k] = static_cast<T>(sym);
    bit_pos += static_cast<uint32_t>(l);
  }
  for (int k = max(count, 0); k < chunk; ++k) dst[k] = static_cast<T>(0);
}

// Table-free QLC walk of one chunk (kernels B6 and B8): the top 2 bits
// of the 16-bit window name the class, ``len_pack`` (8 bits a class)
// its length l, the next l - 2 bits the index past the class base
// (``base_pack``, 10 bits for classes 1..3).  ``st`` holds 256 entries;
// a pointer clamps to entry 255, as the reference's does.  Every class
// length lies in [2, 16] (the wrapper checks ``len_pack``).
template <typename T>
__device__ __forceinline__ void walk_qlc(
    const uint32_t* __restrict__ w, int count, int chunk, int cap,
    uint32_t len_pack, uint32_t base_pack, const int32_t* st, T* dst) {
  uint32_t bit_pos = 0;
  for (int k = 0; k < count; ++k) {
    const uint32_t win = window32(w, bit_pos, cap) >> 16;
    const uint32_t cls = win >> 14;
    const uint32_t l = (len_pack >> (cls << 3)) & 0xFFu;
    const uint32_t idx = (win >> (16u - l)) & ((1u << (l - 2u)) - 1u);
    const uint32_t base =
        cls == 0u ? 0u : (base_pack >> ((cls - 1u) * 10u)) & 0x3FFu;
    dst[k] = static_cast<T>(st[min(base + idx, 255u)]);
    bit_pos += l;
  }
  for (int k = max(count, 0); k < chunk; ++k) dst[k] = static_cast<T>(0);
}

// Raise a kernel's dynamic shared-memory limit to ``bytes`` on the
// current device, calling cudaFuncSetAttribute only when the limit set
// there so far (``allowed``, one slot per device) is smaller: a launch
// after the first pays no attribute call.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 132;
  return sms;
}

}  // namespace repro
