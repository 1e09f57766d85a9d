// Kernel B1: single-stage codebook lookup, symbol -> (codeword, length),
// plus the total bit count.
//
// Replaces the TPU kernel repro/kernels/encode.py::encode_lookup_pallas
// (_encode_kernel), which maps symbols through the LUT as a one-hot
// matmul on the MXU because the TPU gathers poorly.
//
// Bound on Hopper: bytes.  Per symbol it reads 1 byte and writes 8
// (codeword and length, int32 each), ~9 MB per 1 024 000-symbol plane;
// the arithmetic is one shared-memory gather and an add.  Design: the
// 256-entry LUT sits in shared memory as int32 codes and lengths, a
// grid-stride loop of coalesced byte loads / word stores covers the
// plane, the ragged edge is masked (no padding, so no padding
// correction), and the bit total is a warp-shuffle reduction per block
// followed by one 64-bit atomicAdd per block into a counter the entry
// point zeroes on the same stream.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
encode_lookup_kernel(const uint8_t* __restrict__ sym,
                     const int32_t* __restrict__ lut,   // (256, 2)
                     int32_t* __restrict__ codes,
                     int32_t* __restrict__ lens,
                     unsigned long long* __restrict__ bits, long long n) {
  __shared__ int32_t s_code[256];
  __shared__ int32_t s_len[256];
  __shared__ unsigned long long s_warp[kThreads / 32];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_code[i] = lut[2 * i];
    s_len[i] = lut[2 * i + 1];
  }
  __syncthreads();

  unsigned long long local = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int s = sym[i];
    const int l = s_len[s];
    codes[i] = s_code[s];
    lens[i] = l;
    local += static_cast<unsigned long long>(l);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0) s_warp[warp] = local;
  __syncthreads();
  if (warp == 0) {
    local = lane < (kThreads / 32) ? s_warp[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, off);
    if (lane == 0 && local) atomicAdd(bits, local);
  }
}

}  // namespace

extern "C" int encode_lookup_launch(const void* sym, const void* lut,
                                    void* codes, void* lens, void* bits,
                                    long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bits, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    long long most = 8ll * repro::sm_count();
    int grid = static_cast<int>(blocks < most ? blocks : most);
    encode_lookup_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(sym), static_cast<const int32_t*>(lut),
        static_cast<int32_t*>(codes), static_cast<int32_t*>(lens),
        static_cast<unsigned long long*>(bits), n);
  }
  return static_cast<int>(cudaGetLastError());
}
