// Kernel B5: exact 256-bin histogram of a uint8 symbol plane.
//
// Replaces the TPU kernel repro/kernels/histogram.py::histogram256_pallas
// (_histogram_kernel), which has no atomics: it compares each (32, 128)
// block against a broadcast iota of the 256 bins, reduces, pads the
// input to whole blocks and subtracts the padding from bin 0.
//
// What bounds it on Hopper: bytes, one read a symbol (10 us for the 33.5 M
// symbols of a gemma2-2b FFN weight plane at 3.35 TB/s); on a 1 MB logits
// plane, the fixed cost of a call.  The design:
//   * Each warp counts into its own 256 32-bit bins in shared memory with
//     one shared atomic add a symbol.  Skew costs nothing here: Hopper's
//     shared atomics merge the lanes of a warp that add to one address,
//     so a plane of one symbol value is the fastest case, not the
//     slowest.  (Two designs that avoid shared contention were slower on
//     the card: per-thread 8-bit counters, flushed before they overflow,
//     and warp-aggregated atomics through __match_any_sync;
//     chip_smoke.py times both as probes beside this kernel.)
//   * One wave sized to the plane: a grid-stride loop of 16-byte loads,
//     every warp load reading 512 contiguous bytes.  The wrapper picks
//     the grid (kernels/histogram.py, launch_grid): at least MIN_LOADS
//     loads a thread (a 1 MB logits plane: 63 CTAs, as each CTA's zeroing,
//     summing and adding out of its bins costs more than a few more
//     loads), at most the CTAs of one wave.  The plane may start at any
//     byte: its head up to the first 16-byte boundary and its ragged tail
//     (< 16 bytes each) are counted byte by byte by the first CTA, never
//     read past the end.
//   * One device operation a call: no memset and no atomics into the
//     output.  Each CTA adds its 256 bins into a per-(device, stream)
//     accumulator of 64-bit sums, which the wrapper zeroes once; a ticket
//     picks the last CTA to finish, which moves the sums into the output
//     and leaves sums and ticket 0 for the stream's next call.
//
// Exactness: a warp's and a CTA's bins are 32-bit, so a CTA may count at
// most 2^32 - 1 symbols, and the launch refuses a plane for which one
// could count more: one larger than about (2^32 - 1) x the grid's CTAs
// (over 10^12 symbols with the wave of an H100; the store's largest
// plane, a stacked gemma2-2b FFN weight, has 6 x 10^8).  The sums are
// 64-bit.  Nothing here waits for the device (torch.bincount on CUDA
// reads the input's maximum back to the host).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;

__device__ __forceinline__ void count4(uint32_t* bins, uint32_t v) {
  atomicAdd(bins + (v & 0xFFu), 1u);
  atomicAdd(bins + ((v >> 8) & 0xFFu), 1u);
  atomicAdd(bins + ((v >> 16) & 0xFFu), 1u);
  atomicAdd(bins + (v >> 24), 1u);
}

__device__ __forceinline__ void count16(uint32_t* bins, uint4 v) {
  count4(bins, v.x);
  count4(bins, v.y);
  count4(bins, v.z);
  count4(bins, v.w);
}

// sym: the plane (any byte alignment); head: its bytes before the first
// 16-byte boundary; n_vec: its whole 16-byte loads from there.  acc: the
// stream's 256 running sums, then the ticket.
__global__ void __launch_bounds__(kThreads)
histogram256_kernel(const uint8_t* __restrict__ sym, long long n,
                    long long head, long long n_vec,
                    unsigned long long* __restrict__ acc,
                    unsigned long long* __restrict__ out) {
  __shared__ uint32_t s_bins[kWarps * kBins];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const uint4* vec = reinterpret_cast<const uint4*>(sym + head);
  for (int i = t; i < kWarps * kBins; i += kThreads) s_bins[i] = 0u;
  __syncthreads();
  uint32_t* bins = s_bins + (t >> 5) * kBins;
  if (blockIdx.x == 0) {          // head and tail, one byte a thread
    const long long tail = n - head - 16 * n_vec;
    if (t < head)
      atomicAdd(bins + sym[t], 1u);
    else if (t >= 16 && t < 16 + tail)
      atomicAdd(bins + sym[head + 16 * n_vec + (t - 16)], 1u);
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + t;
       i < n_vec; i += stride)
    count16(bins, __ldg(vec + i));
  __syncthreads();
  uint32_t total = 0;             // this CTA's count of bin t
  for (int w = 0; w < kWarps; ++w) total += s_bins[w * kBins + t];

  // Thread i adds bin i into the stream's sums (a reduction without a
  // return value: nothing waits for it).  After the CTA barrier one
  // thread takes a ticket with an acquire-release atomic: its release
  // orders every thread's add before the ticket (PTX releases are
  // cumulative), its acquire every later read of the last CTA after
  // every other CTA's adds.
  if (total) atomicAdd(acc + t, static_cast<unsigned long long>(total));
  __syncthreads();
  if (t == 0) {
    unsigned long long ticket;
    asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
                 : "=l"(ticket) : "l"(acc + kBins) : "memory");
    s_last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // The last CTA moves the sums out, leaving them and the ticket 0 for
  // the stream's next call.
  out[t] = atomicExch(acc + t, 0ull);
  if (t == 0) atomicExch(acc + kBins, 0ull);
}

}  // namespace

// The CTAs of one wave on the current device: the CTAs an SM that its
// threads, registers and shared memory allow, times its SMs.
extern "C" int histogram256_wave(int* ctas) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, histogram256_kernel, kThreads, 0);
  *ctas = per_sm * repro::sm_count();
  return static_cast<int>(err);
}

// out: 256 int64 counts; acc: the stream's 257 int64 (256 sums and the
// ticket, 0 on entry and left 0).  threads is the wrapper's constant,
// checked against this file's.
extern "C" int histogram256_launch(const void* sym, long long n, void* out,
                                   void* acc, int threads, int grid,
                                   void* stream) {
  if (threads != kThreads || n < 0 || grid < 1) return cudaErrorInvalidValue;
  const long long to_edge = static_cast<long long>(
      (16u - (reinterpret_cast<uintptr_t>(sym) & 15u)) & 15u);
  const long long head = to_edge < n ? to_edge : n;
  const long long n_vec = (n - head) / 16;
  // A CTA's loads: at most kThreads more than an even share.
  const long long per = (n_vec + grid - 1) / grid + kThreads;
  if (16 * per + 31 > 0xFFFFFFFFll) return cudaErrorInvalidValue;
  histogram256_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), n, head, n_vec,
      static_cast<unsigned long long*>(acc),
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
