// Kernel B3: chunked canonical Huffman decode; kernel B4: chunked
// multi-symbol decode; kernel B6: chunked QLC decode.
//
// B3 replaces repro/kernels/decode.py::decode_chunks_pallas
// (_decode_kernel): per chunk, a canonical-prefix walk of one symbol a
// step (16-bit window, first_code subtraction for every length,
// sorted_symbols[base_index[l] + off]).
//
// What bounds B3 on Hopper: neither bytes nor operations but the chain of
// dependent steps inside a chunk.  Each step needs the bit position the
// step before it left, so a chunk of 2048 symbols is 2048 dependent steps;
// the words read and the symbols written are a few MB per plane,
// microseconds at 3.35 TB/s.  A call takes at least one chunk's chain
// times the time of one step, so the design makes the step short and
// walks every chunk at once:
//   * Every SM walks.  One lane walks one chunk, and the chunks a CTA
//     takes are chosen at launch from the chunk count and the SM count:
//     ceil(nb / SMs) lanes, in up to kMaxWalkWarps walker warps (one a
//     scheduler).  A logits plane's 500 chunks go 4 a CTA to 125 SMs, a
//     store plane's 16 384 chunks 125 a CTA (4 warps) to 132 SMs, each in
//     one wave; more chunks than 128 a SM take more CTAs.
//   * The reader is B7's (walk.cuh): each lane copies its chunk's words
//     into its own ring in shared memory with cp.async, a slice ahead of
//     its reader, so no load address depends on the code just decoded;
//     the reader keeps three words in registers and moves them with
//     selects.  A step is one lookup in the book's 2^12-entry prefix
//     table (8 KB of shared memory); beside it, the canonical search over
//     the lengths past 12 bits runs from registers, and a select takes its
//     length where the table's entry is 0 (a longer code).  So nothing on
//     the chain branches: a branch, even one no lane takes, cost every
//     step a jump and a reconvergence, and a lane taking it stalled its
//     whole warp, which with 32 lanes a warp and a book with long codes
//     happened every few dozen steps.
//     The search's symbol, one load, is taken a step later, off the chain.
//   * The output leaves in coalesced 16-byte stores: each lane stages a
//     slice of its symbols as bytes in shared memory, shifted by its row's
//     misalignment (chunk 1001 rows start anywhere), and after the slice
//     the warp writes every lane's int32 row segment out, four symbols a
//     store, zeros past the count included.
// The canonical search pads sorted_symbols to 256 with its last entry, so
// it clamps exactly as the reference's search does.
//
// B4 replaces repro/kernels/decode.py::decode_chunks_multisym_pallas
// (_decode_multisym_kernel): a K = 13 bit window LUT that emits up to
// s_max = 8 symbols a step, with an inline canonical slow path for the
// windows whose first code is 14..16 bits long.  Bound as B3: the chain,
// about 2048 / s_bar windows a chunk (s_bar symbols per window).  Design:
// one thread walks one chunk, CTAs are one warp (32 chunks), the
// canonical tables (3 x 17 + 256 int32) sit in shared memory.  B4's LUT
// does not fit Hopper's 227 KB as the reference's int32 (288 KB), so the
// wrapper converts it once per book to syms uint8 (64 KB) and meta uint16
// (16 KB): 80 KB of dynamic shared memory.  Output slots past each
// chunk's count are written 0.  It is simple and right first; its time is
// far above the bound (a plane fills a fraction of the card), which is
// later work.
//
// B6 replaces repro/kernels/decode.py::decode_chunks_qlc_pallas
// (_decode_qlc_kernel): the table-free QLC walk, one symbol a step, the
// class from the window's top 2 bits, its length and base from two
// packed scalars (kernel arguments, so registers), the symbol from a
// 256-entry table in shared memory (1 KB).  Bound as B3: the chain of
// dependent steps inside a chunk.  Same scaffolding as B4 (one thread a
// chunk, one warp a CTA); with 1 KB of shared memory a CTA, an SM holds
// up to 32 of them, so a store leaf's many chunks fill the card.
#include "walk.cuh"

namespace {

constexpr int kThreads = 32;   // one warp: 32 chunks per CTA

__device__ __forceinline__ void load_canonical(
    const int32_t* fc, const int32_t* bi, const int32_t* nc,
    const int32_t* ss, int n_ss, int max_len, int32_t* s_fc, int32_t* s_bi,
    int32_t* s_nc, int32_t* s_ss) {
  for (int i = threadIdx.x; i <= max_len; i += blockDim.x) {
    s_fc[i] = fc[i];
    s_bi[i] = bi[i];
    s_nc[i] = nc[i];
  }
  for (int i = threadIdx.x; i < n_ss; i += blockDim.x) s_ss[i] = ss[i];
}

// ----------------------------------------------------------------- B3
constexpr int kMaxWalkWarps = 4;    // walker warps a CTA: one a scheduler
constexpr int kMaxLanes = 32 * kMaxWalkWarps;
// A lane's staged slice: 4 spare bytes (where the pipelined store of the
// step before the first lands), up to 3 bytes of row misalignment, then
// kSlice symbols; 76 bytes = 19 words, an odd count, so the lanes of a
// warp staging the same step write 32 different banks.
constexpr int kRowBytes = 76;
static_assert(4 + 3 + repro::kSlice <= kRowBytes && kRowBytes % 4 == 0 &&
                  (kRowBytes / 4) % 2 == 1,
              "staging row too short, unaligned or on an even stride");
// A slice segment of a lane's output row spans at most this many
// 16-byte quads (kSlice symbols starting up to 3 past a quad's start).
constexpr int kQuads = (3 + repro::kSlice + 3) / 4;
constexpr int kLaneBytes = repro::kRingStride * 4 + kRowBytes;

// After a slice: the warp writes its `lanes` lanes' staged symbols to
// their output rows, elements [k0, k0 + len) of chunks c .. c + lanes - 1.
// Row l's segment starts at element a = (c + l) * chunk + k0 and is
// staged from byte 4 + (a & 3) of its row, so quad q of the row (bytes
// 4 + 4q .. 4q + 7) holds the int32 elements a - (a & 3) + 4q .. + 3: a
// 16-byte aligned store where all four lie in the segment, single stores
// at its two ends.
__device__ __forceinline__ void write_slice(const uint8_t* rows, int lanes,
                                            long long c, int chunk, int k0,
                                            int len, int32_t* __restrict__ out,
                                            int lane) {
  const int items = lanes * kQuads;
  uint32_t v[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {        // every load before a store
    const int it = lane + 32 * j;
    const int l = it / kQuads, q = it - l * kQuads;
    v[j] = it < items ? *reinterpret_cast<const uint32_t*>(
                            rows + l * kRowBytes + 4 + 4 * q)
                      : 0u;
  }
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int it = lane + 32 * j;
    if (it >= items) break;
    const int l = it / kQuads, q = it - l * kQuads;
    const long long a = (c + l) * chunk + k0;
    const int r = static_cast<int>(a & 3);
    const int lo = max(r - 4 * q, 0), hi = min(r + len - 4 * q, 4);
    int32_t* dst = out + (a - r) + 4 * q;
    const uint32_t w = v[j];
    if (lo == 0 && hi == 4) {
      *reinterpret_cast<int4*>(dst) =
          make_int4(w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, w >> 24);
    } else {
      for (int i = lo; i < hi; ++i) dst[i] = (w >> (8 * i)) & 0xFF;
    }
  }
}

// B3's step: one lookup in the prefix table and, beside it, the canonical
// search over the lengths past kPrefixBits, from registers (first code,
// code count and base index of lengths 13..16, and those of length 1 for
// the no-valid-length fallback, as canonical_first falls back).  Where the
// table's entry is not 0 it decides the step; where it is 0 (no code of at
// most kPrefixBits bits starts the window) the search does.  The length
// is picked with a select, not a branch, and the search's symbol, one
// load, is taken a step later, off the chain.
struct PrefixSearchStep {
  const uint16_t* prefix;   // shared, 2^kPrefixBits entries
  const int32_t* ss;        // shared, 256 entries
  int top_shift;            // 32 - max_len
  int shift[4], fc[4], nc[4], bi[4];   // lengths 13..16
  int shift1, fc1, bi1;                 // length 1

  __device__ __forceinline__ void init(const uint16_t* p, const int32_t* s_fc,
                                       const int32_t* s_bi,
                                       const int32_t* s_nc,
                                       const int32_t* s_ss, int max_len) {
    prefix = p;
    ss = s_ss;
    top_shift = 32 - max_len;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ll = repro::kPrefixBits + 1 + i;
      const bool here = ll <= max_len;
      shift[i] = here ? max_len - ll : 0;
      fc[i] = here ? s_fc[ll] : 0;
      nc[i] = here ? s_nc[ll] : 0;      // a length past max_len: no code
      bi[i] = here ? s_bi[ll] : 0;
    }
    shift1 = max_len - 1;
    fc1 = s_fc[1];
    bi1 = s_bi[1];
  }

  // The table's entry `symbol | length << 8` for the window (0 where it
  // has none), and the search's length and sorted_symbols index.
  __device__ __forceinline__ uint32_t lookup(uint32_t win, int* len,
                                             int* idx) const {
    const uint32_t e = repro::prefix_entry(prefix, 0u, win);
    const int top = static_cast<int>(win >> top_shift);
    int l = 1, b = bi1, off = (top >> shift1) - fc1;
#pragma unroll
    for (int i = 3; i >= 0; --i) {      // the shortest valid length wins
      const int o = (top >> shift[i]) - fc[i];
      const bool valid =
          static_cast<unsigned>(o) < static_cast<unsigned>(nc[i]);
      l = valid ? repro::kPrefixBits + 1 + i : l;
      b = valid ? bi[i] : b;
      off = valid ? o : off;
    }
    *len = e != 0u ? static_cast<int>(e >> 8) : l;
    *idx = min(max(b + off, 0), 255);
    return e;
  }

  // The symbol of a step whose lookup gave entry e and search index idx.
  __device__ __forceinline__ uint32_t symbol(uint32_t e, int idx) const {
    return e != 0u ? e & 0xFFu : static_cast<uint32_t>(ss[idx]) & 0xFFu;
  }
};

__global__ void __launch_bounds__(kMaxLanes)
decode_canonical_kernel(const uint32_t* __restrict__ words,
                        const int32_t* __restrict__ counts,
                        const uint16_t* __restrict__ prefix,
                        const int32_t* __restrict__ fc,
                        const int32_t* __restrict__ bi,
                        const int32_t* __restrict__ nc,
                        const int32_t* __restrict__ ss, int n_ss,
                        int32_t* __restrict__ out, int nb, int chunk,
                        int cap, int max_len, int per_cta) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_fc[repro::kMaxLen + 1];
  __shared__ int32_t s_bi[repro::kMaxLen + 1];
  __shared__ int32_t s_nc[repro::kMaxLen + 1];
  __shared__ int32_t s_ss[256];
  __shared__ __align__(16) uint16_t s_prefix[repro::kPrefix];
  for (int i = threadIdx.x; i <= max_len; i += blockDim.x) {
    s_fc[i] = fc[i];
    s_bi[i] = bi[i];
    s_nc[i] = nc[i];
  }
  // Padded with the last entry: the search's clamp to 255 then gives what
  // the reference's clamp to n_ss - 1 gives.
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_ss[i] = ss[min(i, n_ss - 1)];
  for (int i = threadIdx.x; i < repro::kPrefix / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(s_prefix)[i] =
        reinterpret_cast<const uint4*>(prefix)[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * per_cta + warp * 32;   // the warp's chunks
  const int lanes = min(32, min(per_cta - warp * 32, nb - c0));
  if (lanes <= 0) return;                            // the whole warp
  // Lanes past `lanes` walk nothing but take part in the warp's writes.
  const int c = c0 + min(lane, lanes - 1);
  const int count = lane < lanes ? min(max(counts[c], 0), chunk) : 0;
  const uint32_t* src = words + static_cast<long long>(c) * cap;
  // Shared memory: every lane's word ring, then every lane's staging row.
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem) +
                   (warp * 32 + lane) * repro::kRingStride;
  uint8_t* rows = smem + blockDim.x * repro::kRingStride * 4 +
                  warp * 32 * kRowBytes;
  // This lane's staged symbol k of a slice at byte 4 + r + (k - k0).
  uint8_t* staged_at =
      rows + lane * kRowBytes + 4 +
      static_cast<int>((static_cast<long long>(c) * chunk) & 3);
  PrefixSearchStep step;
  step.init(s_prefix, s_fc, s_bi, s_nc, s_ss, max_len);

  int staged = count > 0 ? min(repro::kAhead, cap) : 0;
  repro::stage_words(src, ring, 0, staged);
  repro::copies_done();
  repro::BitReader rd;
  rd.start(ring, cap);
  const int n_slices = (chunk + repro::kSlice - 1) / repro::kSlice;
  for (int s = 0; s < n_slices; ++s) {
    if (s > 0) {
      // The words this slice can reach were staged a slice ago: stage the
      // next slice's and wait for the group before them.
      const int to = count > 0 ? min(rd.widx() + repro::kAhead, cap) : 0;
      repro::stage_words(src, ring, staged, to);
      staged = max(staged, to);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    }
    const int k0 = s * repro::kSlice;
    const int k1 = min(k0 + repro::kSlice, chunk);
    const int kd = min(max(count, k0), k1);
    uint8_t* o = staged_at - k0;
    // Step k stores step k - 1's symbol (the first into a spare byte), so
    // neither the store nor the search's symbol load waits on the chain.
    uint32_t pend = 1u;
    int pend_idx = 0;
#pragma unroll 4
    for (int k = k0; k < kd; ++k) {
      const uint32_t prev = step.symbol(pend, pend_idx);
      const uint32_t up = rd.upcoming(ring);
      int len;
      pend = step.lookup(rd.window(), &len, &pend_idx);
      rd.advance(len, up);
      o[k - 1] = static_cast<uint8_t>(prev);
    }
    o[kd - 1] = static_cast<uint8_t>(step.symbol(pend, pend_idx));
    for (int k = kd; k < k1; ++k) o[k] = 0;
    __syncwarp();
    write_slice(rows, lanes, c0, chunk, k0, k1 - k0, out, lane);
    __syncwarp();
  }
  repro::copies_done();
}

// B3's launch shape for nb chunks on this device: lanes (chunks) a CTA,
// walker warps a CTA, CTAs, and the dynamic shared memory of a CTA.
struct CanonicalShape {
  int per_cta, warps, grid, smem;
};

CanonicalShape canonical_shape(int nb) {
  const int sms = repro::sm_count();
  const int spread = (nb + sms - 1) / sms;
  const int per_cta = spread < 1 ? 1 : spread > kMaxLanes ? kMaxLanes : spread;
  const int warps = (per_cta + 31) / 32;
  return {per_cta, warps, (nb + per_cta - 1) / per_cta,
          warps * 32 * kLaneBytes};
}

// ----------------------------------------------------------- B4 and B6
__global__ void __launch_bounds__(kThreads)
decode_qlc_kernel(const uint32_t* __restrict__ words,
                  const int32_t* __restrict__ counts, uint32_t len_pack,
                  uint32_t base_pack, const int32_t* __restrict__ sym_tab,
                  int32_t* __restrict__ out, int nb, int chunk, int cap) {
  __shared__ int32_t s_st[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_st[i] = sym_tab[i];
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nb) return;
  repro::walk_qlc(words + static_cast<long long>(c) * cap,
                  min(counts[c], chunk), chunk, cap, len_pack, base_pack,
                  s_st, out + static_cast<long long>(c) * chunk);
}

__global__ void __launch_bounds__(kThreads)
decode_multisym_kernel(const uint32_t* __restrict__ words,
                       const int32_t* __restrict__ counts,
                       const uint8_t* __restrict__ syms,    // (2^k, s_max)
                       const uint16_t* __restrict__ meta,   // (2^k,)
                       const int32_t* __restrict__ fc,
                       const int32_t* __restrict__ bi,
                       const int32_t* __restrict__ nc,
                       const int32_t* __restrict__ ss, int n_ss,
                       int32_t* __restrict__ out, int nb, int chunk, int cap,
                       int k, int s_max, int max_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t s_fc[repro::kMaxLen + 1];
  __shared__ int32_t s_bi[repro::kMaxLen + 1];
  __shared__ int32_t s_nc[repro::kMaxLen + 1];
  __shared__ int32_t s_ss[256];
  const int size = 1 << k;
  uint16_t* s_meta = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s_syms = smem + 2 * size;

  // Both tables are multiples of 16 bytes: copy them as uint4.
  const int meta_vec = (2 * size) / 16;
  const int syms_vec = (size * s_max) / 16;
  const uint4* gm = reinterpret_cast<const uint4*>(meta);
  const uint4* gs = reinterpret_cast<const uint4*>(syms);
  uint4* sm = reinterpret_cast<uint4*>(s_meta);
  uint4* sy = reinterpret_cast<uint4*>(s_syms);
  for (int i = threadIdx.x; i < meta_vec; i += blockDim.x) sm[i] = gm[i];
  for (int i = threadIdx.x; i < syms_vec; i += blockDim.x) sy[i] = gs[i];
  load_canonical(fc, bi, nc, ss, n_ss, max_len, s_fc, s_bi, s_nc, s_ss);
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nb) return;
  const uint32_t* w = words + static_cast<long long>(c) * cap;
  int32_t* o = out + static_cast<long long>(c) * chunk;
  const int count = min(counts[c], chunk);
  uint32_t bit_pos = 0;
  int out_pos = 0;
  while (out_pos < count) {
    const uint32_t win = repro::window32(w, bit_pos, cap);
    const int idx = static_cast<int>(win >> (32 - k));
    const int m = s_meta[idx];
    int cnt = m & 0xFF;
    int adv = (m >> 8) & 0xFF;
    if (cnt == 0) {                      // first code longer than k bits
      int l, sym;
      repro::canonical_first(static_cast<int>(win >> (32 - max_len)), k + 1,
                             max_len, s_fc, s_bi, s_nc, s_ss, n_ss, &l, &sym);
      o[out_pos] = sym;
      cnt = 1;
      adv = l;
    } else {
      const uint8_t* row = s_syms + idx * s_max;
      const int emit = min(cnt, count - out_pos);
      for (int j = 0; j < emit; ++j) o[out_pos + j] = row[j];
    }
    out_pos += cnt;
    bit_pos += static_cast<uint32_t>(adv);
  }
  for (int j = max(count, 0); j < chunk; ++j) o[j] = 0;
}

}  // namespace

extern "C" int decode_canonical_launch(const void* words, const void* counts,
                                       const void* prefix, const void* fc,
                                       const void* bi, const void* nc,
                                       const void* ss, int n_ss, void* out,
                                       int nb, int chunk, int cap,
                                       int max_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int allowed[repro::kMaxDevices] = {};
  cudaError_t err = repro::allow_smem(decode_canonical_kernel,
                                      kMaxLanes * kLaneBytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    const CanonicalShape sh = canonical_shape(nb);
    decode_canonical_kernel<<<sh.grid, 32 * sh.warps, sh.smem, s>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(counts),
        static_cast<const uint16_t*>(prefix),
        static_cast<const int32_t*>(fc), static_cast<const int32_t*>(bi),
        static_cast<const int32_t*>(nc), static_cast<const int32_t*>(ss),
        n_ss, static_cast<int32_t*>(out), nb, chunk, cap, max_len,
        sh.per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_canonical_prefix_bits() { return repro::kPrefixBits; }

// B3's launch shape for nb chunks, into shape[0..4]: chunks a CTA, walker
// warps a CTA, CTAs, dynamic shared memory a CTA (bytes), and CTAs one SM
// holds at once.
extern "C" int decode_canonical_shape(int nb, int* shape) {
  static int allowed[repro::kMaxDevices] = {};
  cudaError_t err = repro::allow_smem(decode_canonical_kernel,
                                      kMaxLanes * kLaneBytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CanonicalShape sh = canonical_shape(nb > 1 ? nb : 1);
  shape[0] = sh.per_cta;
  shape[1] = sh.warps;
  shape[2] = sh.grid;
  shape[3] = sh.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      shape + 4, decode_canonical_kernel, 32 * sh.warps, sh.smem));
}

extern "C" int decode_multisym_launch(const void* words, const void* counts,
                                      const void* syms, const void* meta,
                                      const void* fc, const void* bi,
                                      const void* nc, const void* ss,
                                      int n_ss, void* out, int nb, int chunk,
                                      int cap, int k, int s_max, int max_len,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int allowed[repro::kMaxDevices] = {};
  size_t smem = static_cast<size_t>(1 << k) * (2 + s_max);
  cudaError_t err = repro::allow_smem(decode_multisym_kernel,
                                      static_cast<int>(smem), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    int grid = (nb + kThreads - 1) / kThreads;
    decode_multisym_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(counts),
        static_cast<const uint8_t*>(syms),
        static_cast<const uint16_t*>(meta), static_cast<const int32_t*>(fc),
        static_cast<const int32_t*>(bi), static_cast<const int32_t*>(nc),
        static_cast<const int32_t*>(ss), n_ss, static_cast<int32_t*>(out),
        nb, chunk, cap, k, s_max, max_len);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_qlc_launch(const void* words, const void* counts,
                                 unsigned int len_pack, unsigned int base_pack,
                                 const void* sym_tab, void* out, int nb,
                                 int chunk, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb > 0) {
    int grid = (nb + kThreads - 1) / kThreads;
    decode_qlc_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(counts), len_pack, base_pack,
        static_cast<const int32_t*>(sym_tab), static_cast<int32_t*>(out), nb,
        chunk, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
