// Kernel B1: single-stage codebook lookup, symbol -> (codeword, length),
// plus the total bit count.
//
// Replaces the TPU kernel repro/kernels/encode.py::encode_lookup_pallas
// (_encode_kernel), which maps symbols through the LUT as a one-hot
// matmul on the MXU because the TPU gathers poorly.
//
// What bounds it on Hopper: bytes.  Per symbol it reads 1 byte and writes
// 8 (codeword and length, int32 each), ~9 MB per 1 024 000-symbol plane,
// 2.75 us at 3.35 TB/s; the arithmetic is one shared-memory lookup and an
// add.  At that size a call's host path (the wrapper, the launch) costs
// more than its device time, so the design keeps both short:
//   * one launch a call, nothing else on the stream: the bit total needs
//     no zeroed counter.  Each block adds its partial into a per-stream
//     accumulator and takes a ticket; the block that takes the last ticket
//     moves the sum into the output and leaves accumulator and ticket 0
//     for the next call (the wrapper zeroes them once, when it first meets
//     the stream).  The sum stays exact in 64 bits;
//   * 16 symbols a thread through one 16-byte load, one shared-memory
//     lookup a symbol in a 256-entry table of `code | length << 16` (codes
//     are < 2^16 and lengths <= 16), and 16-byte stores of four codes and
//     four lengths.  A warp stages its 512 loaded symbols in shared memory
//     and reads them back four to a lane, so that every store instruction
//     writes 512 contiguous bytes (storing each lane's own 16 codes put
//     its stores 64 bytes apart and doubled the kernel's time);
//   * a grid of at most one wave (8 blocks of 256 threads an SM) that
//     covers a logits plane in one pass, a grid-stride loop beyond;
//   * the ragged tail (N mod 16 symbols) read one byte at a time, never
//     past N; where the symbols are not 16-byte aligned the whole call
//     takes that path.  Codes, lengths and total share one allocation
//     (the wrapper's one torch call for its outputs).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;      // symbols a thread a step: one uint4
constexpr int kTile = 32 * kPerThread;   // symbols a warp a step

__device__ __forceinline__ int4 codes_of(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  return make_int4(a & 0xFFFF, b & 0xFFFF, c & 0xFFFF, d & 0xFFFF);
}

__device__ __forceinline__ int4 lengths_of(uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d) {
  return make_int4(a >> 16, b >> 16, c >> 16, d >> 16);
}

__global__ void __launch_bounds__(kThreads)
encode_lookup_kernel(const uint8_t* __restrict__ sym,
                     const int32_t* __restrict__ lut,   // (256, 2)
                     int32_t* __restrict__ codes,
                     int32_t* __restrict__ lens,
                     unsigned long long* __restrict__ bits,
                     unsigned long long* __restrict__ acc,  // sum, ticket
                     long long n, int vec) {
  __shared__ uint32_t s_lut[256];
  __shared__ __align__(16) uint32_t s_tile[kWarps][kTile / 4];
  __shared__ unsigned long long s_warp[kWarps];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_lut[i] = (static_cast<uint32_t>(lut[2 * i]) & 0xFFFFu) |
               (static_cast<uint32_t>(lut[2 * i + 1]) << 16);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long local = 0;
  // A warp takes a tile of kTile symbols a step: one 16-byte load a lane,
  // staged in shared memory, then read back four symbols a lane at a
  // time, so that each 16-byte store of codes (and of lengths) by the
  // warp writes 512 contiguous bytes.
  const long long tiles = vec ? n / kTile : 0;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  uint32_t* tile = s_tile[warp];
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps + warp;
       t < tiles; t += warps) {
    reinterpret_cast<uint4*>(tile)[lane] =
        reinterpret_cast<const uint4*>(sym + t * kTile)[lane];
    __syncwarp();
    int4* co = reinterpret_cast<int4*>(codes) + t * (kTile / 4) + lane;
    int4* le = reinterpret_cast<int4*>(lens) + t * (kTile / 4) + lane;
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t w = tile[32 * k + lane];
      const uint32_t e0 = s_lut[w & 0xFF];
      const uint32_t e1 = s_lut[(w >> 8) & 0xFF];
      const uint32_t e2 = s_lut[(w >> 16) & 0xFF];
      const uint32_t e3 = s_lut[w >> 24];
      sum += (e0 >> 16) + (e1 >> 16) + (e2 >> 16) + (e3 >> 16);
      co[32 * k] = codes_of(e0, e1, e2, e3);
      le[32 * k] = lengths_of(e0, e1, e2, e3);
    }
    local += sum;
    __syncwarp();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tiles * kTile +
                     static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t e = s_lut[sym[i]];
    codes[i] = static_cast<int32_t>(e & 0xFFFF);
    lens[i] = static_cast<int32_t>(e >> 16);
    local += e >> 16;
  }

  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0) s_warp[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block = 0;
    for (int i = 0; i < kWarps; ++i) block += s_warp[i];
    if (block) atomicAdd(acc, block);
    __threadfence();                  // the add lands before the ticket
    if (atomicAdd(acc + 1, 1ull) == gridDim.x - 1) {
      // Every other block's add came before its ticket: the sum is whole.
      __threadfence();
      *bits = atomicExch(acc, 0ull);
      atomicExch(acc + 1, 0ull);
    }
  }
}

}  // namespace

// out: one allocation holding the codes (n4 int32), then the lengths (n4
// int32), then the total (int64), where n4 is n rounded up to 4, so that
// both rows start on 16 bytes.
extern "C" int encode_lookup_launch(const void* sym, const void* lut,
                                    void* out, void* acc, long long n,
                                    void* stream) {
  const long long n4 = (n + 3) & ~3ll;
  int32_t* codes = static_cast<int32_t*>(out);
  const int vec = (reinterpret_cast<uintptr_t>(sym) & 15u) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  const long long blocks =
      vec ? (n / kTile + kWarps - 1) / kWarps           // a tile a warp
          : (n + kThreads - 1) / kThreads;              // a symbol a thread
  const long long wave = 8ll * repro::sm_count();
  // At least one block, so that an empty call still writes its total 0.
  const int grid =
      static_cast<int>(blocks < 1 ? 1 : blocks < wave ? blocks : wave);
  encode_lookup_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), static_cast<const int32_t*>(lut),
      codes, codes + n4,
      reinterpret_cast<unsigned long long*>(codes + 2 * n4),
      static_cast<unsigned long long*>(acc), n, vec);
  return static_cast<int>(cudaGetLastError());
}
