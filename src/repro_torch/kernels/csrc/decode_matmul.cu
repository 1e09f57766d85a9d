// Kernels B7 and B8: fused coded-weight decode + matmul, out = x @ W
// straight from W's two coded byte planes (lo, hi), never writing the
// raw weight to device memory.
//
// B7 replaces repro/kernels/decode_matmul.py::decode_matmul_pallas
// (_decode_matmul_kernel: a canonical walk per plane, each with its own
// book); B8 replaces decode_matmul_qlc_pallas (_decode_matmul_qlc_kernel:
// a QLC walk per plane).  Layout contract, as the reference's: W (K, N)
// is flattened row-major before the plane split and the chunked encode,
// chunk % N == 0, so chunk i decodes to the bf16 rows
// [i * rows, (i + 1) * rows) with rows = chunk / N; x arrives as float32
// (the bf16 activations widened) zero-padded to NB * rows columns, and a
// tail chunk's slack decodes to symbol 0 = bf16 0.0.
//
// What bounds it on Hopper.  Inside a chunk every decode step needs the
// bit position the step before it left, so a chunk is a chain of
// `chunk` dependent steps; the store puts chunk >= N, so the chain of
// the longest chunk (16 384 steps for an FFN matrix of gemma2-2b) bounds
// the call from below, at a few tens of ns a step.  Next come bytes (the
// coded words, a few MB: microseconds); the products are M * K * N
// multiply-adds of a decode batch, tens of microseconds of CUDA cores at
// M = 4, so no tensor cores are used.  So the design shortens the step
// and walks every chain at once:
//   * One CTA per group of kGroup = 32 consecutive chunks: two walker
//     warps (lane = chunk; one walks the lo plane, one the hi plane,
//     each its own chain on its own scheduler) and two consumer warps.
//     A CTA holds no whole tile (below), so three or four CTAs fit an SM
//     and the layer-0 matrices of gemma2-2b (1024 to 8192 chunks) are
//     walked in one wave.  The group stays 32 chunks (it fixes the sum
//     order) even where that leaves SMs idle (2048 chunks: 64 CTAs): a
//     step is one warp's latency, and is shortest with one CTA an SM.
//   * The bit reader lives in registers (walk.cuh, shared with B3): the
//     current word, the next and the one after (`BitReader`); a window is
//     one funnel shift, and a word boundary moves the three along with
//     selects, not a branch (a warp issues in order, so a branch or a
//     load on the chain stalls every lane).  Each lane copies its plane's
//     words into its own ring in shared memory with cp.async, a slice
//     ahead of its reader, so no load address depends on the code just
//     decoded and the walker never waits for device memory.  The reader
//     clamps its word index to cap - 2 as window32 does (the chunk's pad
//     word).
//   * B7 decodes a step with one lookup: a 2^kPrefixBits-entry table of
//     `symbol | length << 8` per plane (uint16, 8 KB each, in shared
//     memory) resolves every code of at most kPrefixBits bits; an entry
//     0 sends the longer codes to canonical_first, unchanged.  B8's step
//     stays the table-free QLC step: shifts and one byte permute for the
//     length; its one load, the symbol, is taken a step later, off the
//     chain, as each step stores the symbol of the step before.
//   * The product streams through a ring of two slots of kSlice decoded
//     bf16 values per chunk (each walker writes its byte of them): the
//     walkers fill one slot while the consumers multiply the other into
//     the group's partial (M, N), a producer/consumer pair on named
//     barriers (FULL: a slot is written, EMPTY: a slot is read).
//
// Sum order (fixed; the plain version in kernels/decode_matmul.py,
// `grouped_product`, adds in exactly this order):
//   pass 1: per group g of kGroup consecutive chunks c0 .. c0 + here - 1,
//     for each output (m, n), owned by one consumer thread:
//       acc = 0; for j in 0 .. rows - 1: for c in c0 .. c0 + here - 1:
//         acc = acc + x[m, c * rows + j] * W[c * rows + j, n]
//     with __fmul_rn / __fadd_rn (never contracted to an FMA); the
//     running acc lives in the group partial (device memory, written only
//     by this CTA, read back by the same thread on the next row);
//   pass 2: one thread per output sums the group partials in group order
//     (__fadd_rn again).
// So kernel and plain version agree bit for bit for any float32 x; against
// the reference's chunk-major sum the product agrees to float32 rounding.
// An optional tile output (the decoded bf16 weight as uint16) lets a
// check hold the decoded tiles to a plain decode.
#include "walk.cuh"

namespace {

// The walker's parts (walk.cuh): the word ring, the bit reader and the
// prefix table's lookup.
using repro::BitReader;
using repro::copies_done;
using repro::kAhead;
using repro::kPrefix;
using repro::kPrefixBits;
using repro::kRingStride;
using repro::kSlice;
using repro::stage_words;

constexpr int kGroup = 32;          // chunks per CTA = walker lanes
constexpr int kWalkers = 2;         // walker warps: lo plane, hi plane
constexpr int kConsumers = 2;       // consumer warps
constexpr int kConsumerThreads = 32 * kConsumers;
constexpr int kThreads = 32 * (kWalkers + kConsumers);
// A chunk's row of a slot: a spare element in front (where a walker's
// pipelined store lands before its first step) and one behind, so that
// rows start on other banks.
constexpr int kSliceRow = kSlice + 2;
static_assert(kWalkers == 2 && kConsumers == 2, "warp roles assume 2 + 2");
constexpr int kReduceThreads = 256;
// Named barriers (0 is __syncthreads): FULL per slot, EMPTY per slot.
constexpr int kFull = 1;
constexpr int kEmpty = 3;

constexpr int kSymRingBytes = 2 * kGroup * kSliceRow * 2;
constexpr int kWordRingBytes = 2 * kGroup * kRingStride * 4;
constexpr int kSmemBytes = kSymRingBytes + kWordRingBytes;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// A step decoder: lookup(win) gives the entry of the code at the window,
// length(e) its bits, symbol(e) its symbol; slow(e) marks an entry whose
// length is 0 and that resolve(win) must redo.
//
// B7: the entry is the prefix table's `symbol | length << 8`; 0 (a code
// longer than kPrefixBits) goes to canonical_first, unchanged.
struct CanonicalStep {
  const uint16_t* prefix;     // shared, both planes' tables
  uint32_t table;             // this plane's table: byte offset in prefix
  const int32_t* fc;
  const int32_t* bi;
  const int32_t* nc;
  const int32_t* ss;          // shared, 256 entries
  int max_len;

  __device__ __forceinline__ uint32_t lookup(uint32_t win) const {
    return repro::prefix_entry(prefix, table, win);
  }
  __device__ __forceinline__ int length(uint32_t e) const {
    return static_cast<int>(e >> 8);
  }
  __device__ __forceinline__ bool slow(uint32_t e) const {
    return (e >> 8) == 0u;
  }
  __device__ __forceinline__ uint32_t resolve(uint32_t win) const {
    int l, sym;
    repro::canonical_first(static_cast<int>(win >> (32 - max_len)), 1,
                           max_len, fc, bi, nc, ss, 256, &l, &sym);
    return (static_cast<uint32_t>(sym) & 0xFFu) |
           (static_cast<uint32_t>(l) << 8);
  }
  __device__ __forceinline__ uint32_t symbol(uint32_t e) const {
    return e & 0xFFu;
  }
};

// B8: the table-free QLC step of walk_qlc.  The class is the window's
// top 2 bits, its length a byte of len_pack (one byte permute), the
// index the next l - 2 bits; the entry is the symbol table's pointer and
// the length, and symbol() the one load, which the walker takes a step
// later, off the chain.
struct QlcStep {
  uint32_t len_pack, base_pack;
  const int32_t* st;          // shared, 256 entries

  __device__ __forceinline__ uint32_t lookup(uint32_t win) const {
    const uint32_t cls = win >> 30;
    const uint32_t l = __byte_perm(len_pack, 0u, cls | 0x4440u);
    const uint32_t idx = __funnelshift_rc(win << 2, 0u, 34u - l);
    const uint32_t base =
        cls == 0u ? 0u : (base_pack >> ((cls - 1u) * 10u)) & 0x3FFu;
    return l | (min(base + idx, 255u) << 8);
  }
  __device__ __forceinline__ int length(uint32_t e) const {
    return static_cast<int>(e & 0xFFu);
  }
  __device__ __forceinline__ bool slow(uint32_t) const { return false; }
  __device__ __forceinline__ uint32_t resolve(uint32_t) const { return 0u; }
  __device__ __forceinline__ uint32_t symbol(uint32_t e) const {
    return static_cast<uint32_t>(st[e >> 8]) & 0xFFu;
  }
};

struct Geometry {
  int nb, chunk, cap, rows, n_cols, m;
};

// acc + x[g * rows] * w[g] for g = 0 .. kGroup - 1 in order, every x
// load issued before the first add.
__device__ __forceinline__ float group_sum(float acc, const float* xr,
                                           int rows, const float* w) {
  float xv[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) xv[g] = __ldg(xr + g * rows);
#pragma unroll
  for (int g = 0; g < kGroup; ++g) acc = __fadd_rn(acc, __fmul_rn(xv[g], w[g]));
  return acc;
}

// The same over the first `here` chunks of the tail group.
__device__ __forceinline__ float tail_group_sum(float acc, const float* xr,
                                                int rows, const float* w,
                                                int here) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
    if (g < here) acc = __fadd_rn(acc, __fmul_rn(__ldg(xr + g * rows), w[g]));
  return acc;
}

template <typename Step>
__device__ __forceinline__ void fused_body(
    const Step& lo_step, const Step& hi_step, const float* __restrict__ x,
    const uint32_t* __restrict__ lo_words,
    const uint32_t* __restrict__ hi_words,
    const int32_t* __restrict__ counts, float* __restrict__ partial,
    uint16_t* __restrict__ tiles, const Geometry& gm, uint8_t* smem) {
  uint16_t* s_sym = reinterpret_cast<uint16_t*>(smem);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem + kSymRingBytes);

  const int c0 = blockIdx.x * kGroup;
  const int here = min(kGroup, gm.nb - c0);
  const int lane = threadIdx.x & 31;
  // Warp roles: 0 and 1 walk (lo, hi), 2 and 3 multiply.  Odd CTAs
  // rotate them by two warps, so that two CTAs on one SM put their
  // walkers on different schedulers.
  const int warp = ((threadIdx.x >> 5) + 2 * (blockIdx.x & 1)) &
                   (kWalkers + kConsumers - 1);
  const int n_slices = (gm.chunk + kSlice - 1) / kSlice;
  __syncthreads();            // the caller's tables are in shared memory

  if (warp < kWalkers) {
    // ----------------------------------------------------------- walkers
    // Warp p walks plane p (0 lo, 1 hi) of chunk c0 + lane and writes its
    // byte of each decoded bf16 value into the slot.  Each lane keeps its
    // own word ring kAhead words ahead of its reader: at the start of a
    // slice it copies the words up to widx + kAhead (one cp.async group)
    // and waits for the group before it (a slice old), which holds every
    // word the slice can reach.
    const int p = warp;
    const Step step = p ? hi_step : lo_step;
    const int count =
        lane < here ? min(max(counts[c0 + lane], 0), gm.chunk) : 0;
    const uint32_t* src = (p ? hi_words : lo_words) +
                          static_cast<long long>(c0 + min(lane, here - 1)) *
                              gm.cap;
    uint32_t* ring = s_words + (p * kGroup + lane) * kRingStride;
    int staged = count > 0 ? min(kAhead, gm.cap) : 0;
    stage_words(src, ring, 0, staged);
    copies_done();
    uint8_t* sym_bytes = reinterpret_cast<uint8_t*>(s_sym);
    BitReader rd;
    rd.start(ring, gm.cap);
    for (int s = 0; s < n_slices; ++s) {
      const int b = s & 1;
      if (s >= 2) bar_sync(kEmpty + b);
      if (s > 0) {
        const int to = count > 0 ? min(rd.widx() + kAhead, gm.cap) : 0;
        stage_words(src, ring, staged, to);
        staged = max(staged, to);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      }
      // out[2 * i]: byte p of the slot's value i (element i + 1 of the row)
      uint8_t* out =
          sym_bytes + 2 * ((b * kGroup + lane) * kSliceRow + 1) + p;
      const int k0 = s * kSlice;
      const int k1 = min(k0 + kSlice, gm.chunk);
      const int kd = min(max(count, k0), k1);
      // Step k stores step k - 1's symbol (the first into the spare
      // element in front), so no symbol load holds up the chain.
      uint32_t pend = 0;
#pragma unroll 4
      for (int k = k0; k < kd; ++k) {
        const uint32_t prev = step.symbol(pend);
        const uint32_t up = rd.upcoming(ring);
        const uint32_t win = rd.window();
        pend = step.lookup(win);
        rd.advance(step.length(pend), up);
        // A slow entry has length 0, so the advance above moved nothing;
        // its branch comes after the advance, so that the common step
        // need not wait for it.
        if (step.slow(pend)) {
          pend = step.resolve(win);
          rd.advance(step.length(pend), up);
        }
        out[2 * (k - 1 - k0)] = static_cast<uint8_t>(prev);
      }
      out[2 * (kd - 1 - k0)] = static_cast<uint8_t>(step.symbol(pend));
      for (int k = kd; k < k1; ++k) out[2 * (k - k0)] = 0;
      __syncwarp();
      bar_arrive(kFull + b);
    }
    copies_done();
    return;
  }

  // -------------------------------------------------------------- consumers
  const int t = (warp - kWalkers) * 32 + lane;
  const long long k_pad = static_cast<long long>(gm.nb) * gm.rows;
  float* part = partial + static_cast<long long>(blockIdx.x) * gm.m *
                              gm.n_cols;
  for (int s = 0; s < n_slices; ++s) {
    const int b = s & 1;
    bar_sync(kFull + b);
    const uint16_t* slot = s_sym + b * kGroup * kSliceRow + 1;
    const int k0 = s * kSlice;
    const int k1 = min(k0 + kSlice, gm.chunk);
    // The slice as row segments; this thread takes the columns
    // n = t (mod kConsumerThreads), so each output has one owner and
    // meets its rows in order.
    for (int k = k0; k < k1;) {
      const int j = k / gm.n_cols;
      const int n0 = k - j * gm.n_cols;
      const int len = min(k1 - k, gm.n_cols - n0);
      int n = n0 + ((t - n0) % kConsumerThreads + kConsumerThreads) %
                       kConsumerThreads;
      for (; n < n0 + len; n += kConsumerThreads) {
        const int i = k + (n - n0) - k0;
        float w[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const uint32_t u = g < here ? slot[g * kSliceRow + i] : 0u;
          w[g] = __uint_as_float(u << 16);
          if (tiles && g < here)
            tiles[static_cast<long long>(c0 + g) * gm.chunk + k0 + i] =
                static_cast<uint16_t>(u);
        }
        for (int mi = 0; mi < gm.m; ++mi) {
          float* acc_at = part + static_cast<long long>(mi) * gm.n_cols + n;
          const float* xr = x + mi * k_pad +
                            static_cast<long long>(c0) * gm.rows + j;
          const float acc0 = j == 0 ? 0.0f : *acc_at;
          *acc_at = here == kGroup
                        ? group_sum(acc0, xr, gm.rows, w)
                        : tail_group_sum(acc0, xr, gm.rows, w, here);
        }
      }
      k += len;
    }
    if (s + 2 < n_slices) bar_arrive(kEmpty + b);
  }
}

__global__ void __launch_bounds__(kThreads)
decode_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ lo_words,
                     const uint32_t* __restrict__ hi_words,
                     const int32_t* __restrict__ counts,
                     const int32_t* __restrict__ fc,   // (2, max_len + 1)
                     const int32_t* __restrict__ bi,
                     const int32_t* __restrict__ nc,
                     const int32_t* __restrict__ ss,   // (2, 256)
                     const uint16_t* __restrict__ lo_prefix,
                     const uint16_t* __restrict__ hi_prefix,
                     float* __restrict__ partial, uint16_t* __restrict__ tiles,
                     Geometry gm, int max_len) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_fc[2][repro::kMaxLen + 1];
  __shared__ int32_t s_bi[2][repro::kMaxLen + 1];
  __shared__ int32_t s_nc[2][repro::kMaxLen + 1];
  __shared__ int32_t s_ss[2][256];
  __shared__ __align__(16) uint16_t s_prefix[2][kPrefix];
  constexpr int tl = repro::kMaxLen + 1;
  for (int i = threadIdx.x; i < 2 * tl; i += blockDim.x) {
    const int p = i / tl, j = i - p * tl;
    if (j <= max_len) {
      s_fc[p][j] = fc[p * (max_len + 1) + j];
      s_bi[p][j] = bi[p * (max_len + 1) + j];
      s_nc[p][j] = nc[p * (max_len + 1) + j];
    }
  }
  for (int i = threadIdx.x; i < 512; i += blockDim.x)
    s_ss[i >> 8][i & 255] = ss[i];
  for (int i = threadIdx.x; i < kPrefix; i += blockDim.x) {
    s_prefix[0][i] = lo_prefix[i];
    s_prefix[1][i] = hi_prefix[i];
  }
  // (fused_body synchronises before any table is read)
  const CanonicalStep lo{s_prefix[0], 0u, s_fc[0], s_bi[0], s_nc[0],
                         s_ss[0], max_len};
  const CanonicalStep hi{s_prefix[0], 2u * kPrefix, s_fc[1], s_bi[1],
                         s_nc[1], s_ss[1], max_len};
  fused_body(lo, hi, x, lo_words, hi_words, counts, partial, tiles, gm,
             smem);
}

__global__ void __launch_bounds__(kThreads)
decode_matmul_qlc_kernel(const float* __restrict__ x,
                         const uint32_t* __restrict__ lo_words,
                         const uint32_t* __restrict__ hi_words,
                         const int32_t* __restrict__ counts,
                         uint32_t lo_len_pack, uint32_t lo_base_pack,
                         uint32_t hi_len_pack, uint32_t hi_base_pack,
                         const int32_t* __restrict__ st,   // (2, 256)
                         float* __restrict__ partial,
                         uint16_t* __restrict__ tiles, Geometry gm) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_st[2][256];
  for (int i = threadIdx.x; i < 512; i += blockDim.x)
    s_st[i >> 8][i & 255] = st[i];
  const QlcStep lo{lo_len_pack, lo_base_pack, s_st[0]};
  const QlcStep hi{hi_len_pack, hi_base_pack, s_st[1]};
  fused_body(lo, hi, x, lo_words, hi_words, counts, partial, tiles, gm,
             smem);
}

// Pass 2: out[i] = sum over groups g = 0, 1, ... of partial[g, i].
__global__ void __launch_bounds__(kReduceThreads)
sum_groups_kernel(const float* __restrict__ partial, int groups,
                  long long outs, float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= outs) return;
  float acc = 0.0f;
  for (int g = 0; g < groups; ++g)
    acc = __fadd_rn(acc, __ldg(partial + g * outs + i));
  out[i] = acc;
}

int groups_of(int nb) { return (nb + kGroup - 1) / kGroup; }

cudaError_t sum_groups(const float* partial, int groups, int m, int n_cols,
                       float* out, cudaStream_t s) {
  const long long outs = static_cast<long long>(m) * n_cols;
  if (outs > 0) {
    const long long grid = (outs + kReduceThreads - 1) / kReduceThreads;
    sum_groups_kernel<<<static_cast<unsigned int>(grid), kReduceThreads, 0,
                        s>>>(partial, groups, outs, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_matmul_group() { return kGroup; }

extern "C" int decode_matmul_prefix_bits() { return kPrefixBits; }

// CTAs of B7 (qlc = 0) or B8 (qlc = 1) one SM holds at once, into *ctas.
extern "C" int decode_matmul_occupancy(int qlc, int* ctas) {
  static int allowed[2][repro::kMaxDevices] = {};
  cudaError_t err =
      qlc ? repro::allow_smem(decode_matmul_qlc_kernel, kSmemBytes,
                              allowed[1])
          : repro::allow_smem(decode_matmul_kernel, kSmemBytes, allowed[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = qlc ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  ctas, decode_matmul_qlc_kernel, kThreads, kSmemBytes)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  ctas, decode_matmul_kernel, kThreads, kSmemBytes);
  return static_cast<int>(err);
}

extern "C" int decode_matmul_launch(
    const void* x, const void* lo_words, const void* hi_words,
    const void* counts, const void* fc, const void* bi, const void* nc,
    const void* ss, const void* lo_prefix, const void* hi_prefix,
    void* partial, void* tiles, void* out, int nb, int chunk, int cap,
    int rows, int n_cols, int m, int max_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int allowed[repro::kMaxDevices] = {};
  cudaError_t err =
      repro::allow_smem(decode_matmul_kernel, kSmemBytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = groups_of(nb);
  if (groups > 0) {
    decode_matmul_kernel<<<groups, kThreads, kSmemBytes, s>>>(
        static_cast<const float*>(x), static_cast<const uint32_t*>(lo_words),
        static_cast<const uint32_t*>(hi_words),
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(fc),
        static_cast<const int32_t*>(bi), static_cast<const int32_t*>(nc),
        static_cast<const int32_t*>(ss),
        static_cast<const uint16_t*>(lo_prefix),
        static_cast<const uint16_t*>(hi_prefix), static_cast<float*>(partial),
        static_cast<uint16_t*>(tiles),
        Geometry{nb, chunk, cap, rows, n_cols, m}, max_len);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(sum_groups(static_cast<const float*>(partial),
                                     groups, m, n_cols,
                                     static_cast<float*>(out), s));
}

extern "C" int decode_matmul_qlc_launch(
    const void* x, const void* lo_words, const void* hi_words,
    const void* counts, unsigned int lo_len_pack, unsigned int lo_base_pack,
    unsigned int hi_len_pack, unsigned int hi_base_pack, const void* st,
    void* partial, void* tiles, void* out, int nb, int chunk, int cap,
    int rows, int n_cols, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int allowed[repro::kMaxDevices] = {};
  cudaError_t err =
      repro::allow_smem(decode_matmul_qlc_kernel, kSmemBytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = groups_of(nb);
  if (groups > 0) {
    decode_matmul_qlc_kernel<<<groups, kThreads, kSmemBytes, s>>>(
        static_cast<const float*>(x), static_cast<const uint32_t*>(lo_words),
        static_cast<const uint32_t*>(hi_words),
        static_cast<const int32_t*>(counts), lo_len_pack, lo_base_pack,
        hi_len_pack, hi_base_pack, static_cast<const int32_t*>(st),
        static_cast<float*>(partial), static_cast<uint16_t*>(tiles),
        Geometry{nb, chunk, cap, rows, n_cols, m});
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(sum_groups(static_cast<const float*>(partial),
                                     groups, m, n_cols,
                                     static_cast<float*>(out), s));
}
