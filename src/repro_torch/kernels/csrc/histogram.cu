// Kernel B5: exact 256-bin histogram of a uint8 symbol plane.
//
// Replaces the TPU kernel repro/kernels/histogram.py::histogram256_pallas
// (_histogram_kernel), which has no atomics: it compares each (32, 128)
// block against a broadcast iota of the 256 bins, reduces, pads the
// input to whole blocks and subtracts the padding from bin 0.
//
// Bound on Hopper: bytes (1 byte in per symbol, 256 counts out) as long
// as the atomics keep up.  Design: privatised bins in shared memory, one
// 256-bin copy per warp, so that a plane that packs its mass into a few
// bins (the hi byte of bf16 weights or logits) contends only inside a
// warp; a grid-stride loop reads 16 symbols per load where the plane is
// 16-byte aligned and masks the ragged edge (no padding, so no padding
// correction); at the end each block sums its warps' copies and adds one
// 64-bit atomic per non-empty bin into the output, which the entry point
// zeroes on the same stream.  The grid is at most 4 blocks per SM, so a
// warp's uint32 bin sees at most n / (grid * 8) symbols: exact up to
// 2^32 symbols per warp, far beyond a plane.  Nothing here waits for
// the device (no read-back of the input's maximum, as torch.bincount
// does on CUDA).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;

__device__ __forceinline__ void count4(uint32_t v, uint32_t* bins) {
  atomicAdd(&bins[v & 0xFFu], 1u);
  atomicAdd(&bins[(v >> 8) & 0xFFu], 1u);
  atomicAdd(&bins[(v >> 16) & 0xFFu], 1u);
  atomicAdd(&bins[v >> 24], 1u);
}

__global__ void __launch_bounds__(kThreads)
histogram256_kernel(const uint8_t* __restrict__ sym, long long n,
                    long long n_vec, unsigned long long* __restrict__ out) {
  __shared__ uint32_t s_bins[kWarps * kBins];
  for (int i = threadIdx.x; i < kWarps * kBins; i += blockDim.x)
    s_bins[i] = 0u;
  __syncthreads();
  uint32_t* bins = s_bins + (threadIdx.x >> 5) * kBins;

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* vec = reinterpret_cast<const uint4*>(sym);
  for (long long i = first; i < n_vec; i += stride) {
    const uint4 v = __ldg(vec + i);
    count4(v.x, bins);
    count4(v.y, bins);
    count4(v.z, bins);
    count4(v.w, bins);
  }
  for (long long i = n_vec * 16 + first; i < n; i += stride)
    atomicAdd(&bins[sym[i]], 1u);
  __syncthreads();

  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    uint32_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_bins[w * kBins + b];
    if (total) atomicAdd(&out[b], static_cast<unsigned long long>(total));
  }
}

}  // namespace

extern "C" int histogram256_launch(const void* sym, long long n, void* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, kBins * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const bool aligned = (reinterpret_cast<uintptr_t>(sym) & 15u) == 0;
    const long long n_vec = aligned ? n / 16 : 0;
    long long blocks = (n / 16 + kThreads) / kThreads;
    long long most = 4ll * repro::sm_count();
    int grid = static_cast<int>(blocks < most ? blocks : most);
    histogram256_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(sym), n, n_vec,
        static_cast<unsigned long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
