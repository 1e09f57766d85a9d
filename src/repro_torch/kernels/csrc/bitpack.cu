// Kernel B2: per-chunk bit packing of variable-length codes into the
// chunked wire format (MSB-first big-endian words, chunk bit counts).
//
// Replaces the TPU kernel repro/kernels/bitpack.py::pack_blocks_pallas
// (_pack_kernel): per 2048-symbol block, an exclusive prefix sum of the
// lengths, then the hi/lo two-word placement into CAP_WORDS = 1025 words.
//
// Bound on Hopper: bytes.  It reads 8 bytes per symbol (codeword and
// length) and writes cap words plus one count per chunk, ~8 MB in and
// ~2.05 MB out per 1 024 000-symbol plane; per symbol it does a handful
// of integer operations.  Design: one CTA per chunk (chunk is a runtime
// argument; the capacity is chunk_capacity_words(chunk, 16), 1025 at
// 2048, so odd chunks such as 1001 work too).  Each thread owns a
// contiguous run of the chunk's symbols: it sums its lengths, a
// block-wide exclusive scan (warp shuffles, then one warp over the warp
// totals) gives its starting bit, and it atomicOr's every codeword's
// hi and lo parts into the chunk's words held in shared memory
// (cap x 4 B, 4100 B at chunk 2048).  Positions past the plane's end
// have length 0.  The words then go out with coalesced stores, and the
// chunk's bit count beside them.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
pack_blocks_kernel(const int32_t* __restrict__ codes,
                   const int32_t* __restrict__ lens,
                   uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                   long long n, int chunk, int cap) {
  extern __shared__ uint32_t s_words[];
  __shared__ uint32_t s_scan[kWarps];

  const long long base = static_cast<long long>(blockIdx.x) * chunk;
  const long long left = n - base;
  const int count = left <= 0 ? 0 : (left < chunk ? static_cast<int>(left)
                                                  : chunk);
  for (int i = threadIdx.x; i < cap; i += blockDim.x) s_words[i] = 0u;

  const int per = (chunk + kThreads - 1) / kThreads;
  const int first = threadIdx.x * per;
  const int last = min(first + per, count);

  uint32_t local = 0;
  for (int i = first; i < last; ++i)
    local += static_cast<uint32_t>(lens[base + i]);

  // Block-wide exclusive scan of the per-thread bit totals.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t incl = local;
  for (int off = 1; off < 32; off <<= 1) {
    uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();                       // also orders the s_words zeroing
  if (warp == 0) {
    uint32_t v = lane < kWarps ? s_scan[lane] : 0u;
    for (int off = 1; off < 32; off <<= 1) {
      uint32_t u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane < kWarps) s_scan[lane] = v;
  }
  __syncthreads();
  uint32_t offset = incl - local + (warp > 0 ? s_scan[warp - 1] : 0u);

  for (int i = first; i < last; ++i) {
    const uint32_t l = static_cast<uint32_t>(lens[base + i]);
    if (l) {
      const uint32_t v = static_cast<uint32_t>(codes[base + i]);
      const uint32_t idx = offset >> 5;
      const int sh = 32 - static_cast<int>(offset & 31u) -
                     static_cast<int>(l);
      if (sh >= 0) {
        atomicOr(&s_words[idx], v << sh);
      } else {
        atomicOr(&s_words[idx], v >> (-sh));
        atomicOr(&s_words[idx + 1], v << (32 + sh));
      }
    }
    offset += l;
  }
  __syncthreads();

  uint32_t* out = words + static_cast<long long>(blockIdx.x) * cap;
  for (int i = threadIdx.x; i < cap; i += blockDim.x) out[i] = s_words[i];
  if (threadIdx.x == 0) bits[blockIdx.x] = static_cast<int32_t>(s_scan[kWarps - 1]);
}

}  // namespace

extern "C" int pack_blocks_launch(const void* codes, const void* lens,
                                  void* words, void* bits, long long n,
                                  int nb, int chunk, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int allowed[repro::kMaxDevices] = {};
  size_t smem = static_cast<size_t>(cap) * sizeof(uint32_t);
  cudaError_t err = repro::allow_smem(pack_blocks_kernel,
                                      static_cast<int>(smem), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_blocks_kernel<<<nb, kThreads, smem, s>>>(
      static_cast<const int32_t*>(codes), static_cast<const int32_t*>(lens),
      static_cast<uint32_t*>(words), static_cast<int32_t*>(bits), n, chunk,
      cap);
  return static_cast<int>(cudaGetLastError());
}
