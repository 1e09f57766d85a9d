// Shared helpers for the wire kernels (sm_90a, plain C entry points).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// Largest code length any book may hold (MAX_CODE_LEN): the canonical
// tables have kMaxLen + 1 entries.
constexpr int kMaxLen = 16;

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

// The current device's SM count, queried once a device (a launch asks
// for it every call).
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 132;
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 132;
    sms[dev] = n;
  }
  return sms[dev];
}

}  // namespace repro
