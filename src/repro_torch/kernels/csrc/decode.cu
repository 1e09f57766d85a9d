// Kernel B3: chunked canonical Huffman decode; kernel B4: chunked
// multi-symbol decode; kernel B6: chunked QLC decode.
//
// B3 replaces repro/kernels/decode.py::decode_chunks_pallas
// (_decode_kernel): per chunk, a canonical-prefix walk of one symbol a
// step (16-bit window, first_code subtraction for every length,
// sorted_symbols[base_index[l] + off]).  B4 replaces
// decode_chunks_multisym_pallas (_decode_multisym_kernel): a K-bit
// window LUT (any 1 <= K <= max_len) that emits up to s_max symbols a
// step, with an inline canonical search for the windows whose first code
// is longer than K bits.  B6 replaces decode_chunks_qlc_pallas
// (_decode_qlc_kernel): the table-free QLC walk, one symbol a step.
//
// What bounds them on Hopper: neither bytes nor operations but the chain
// of dependent steps inside a chunk.  Each step needs the bit position
// the step before it left, so a chunk of 2048 symbols is 2048 dependent
// steps (B3, B6) or about 2048 / s_bar windows (B4, s_bar symbols a
// window); the words read and the symbols written are a few MB per
// plane, microseconds at 3.35 TB/s.  A call takes at least one chunk's
// chain times the time of one step, so the three share one design
// (walk_chunks) that makes the step short and walks every chunk at once:
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
//     selects.
//   * Nothing on the chain branches or loads from device memory: a
//     branch, even one no lane takes, cost every step a jump and a
//     reconvergence, and a lane taking it stalled its whole warp.
//     B3's step is one lookup in the book's 2^12-entry prefix table (8 KB
//     of shared memory); beside it, the canonical search over the lengths
//     past 12 bits runs from registers, and a select takes its length
//     where the table's entry is 0 (a longer code).  B6's step is B8's
//     QlcStep: the length from the window's top two bits by one byte
//     permute of a register, no load at all.  B4's step is one uint16
//     lookup of the window's top K bits in the LUT's meta (count | bits
//     << 8, always in shared memory); beside it, the canonical search over
//     lengths K+1..16 from registers, which a select takes where the count
//     is 0 (one symbol; with no valid length, length K + 1, as the
//     reference's argmax over an all-false vector).  Each step's symbols
//     (the search's, the QLC table's, or B4's LUT row) are loaded a step
//     later, off the chain.
//   * The output leaves in coalesced 16-byte stores: each lane stages a
//     slice of its symbols as bytes in shared memory, shifted by its row's
//     misalignment (chunk 1001 rows start anywhere), and after the slice
//     the warp writes every lane's int32 row segment out, four symbols a
//     store, zeros past the count included (write_slice).  B4's slices
//     are cut by symbols, not steps: a lane walks until it has decoded the
//     slice's symbols, the few past its end staying in the row for the
//     next slice; a window's row of R bytes is staged by R / 4 + 1 word
//     stores, the word that holds earlier bytes kept in a register.
// B4's LUT does not fit Hopper's 227 KB as the reference's int32 (288
// KB at K = 13, s_max = 8), so the wrapper converts it once per book to
// syms uint8 and meta uint16.  A window holds at most W = min(s_max, K)
// codes (each is at least one bit), so a row is staged as R = 8 bytes
// (W <= 8) or 16 (9 <= W <= 16); the wrapper re-strides a LUT whose
// s_max is not R.  Each CTA copies meta (2^K x 2 bytes, at most 128 KB)
// into shared memory with cp.async, and the rows (2^K x R bytes, 16 KB to
// 1 MB) too where they fit beside the lanes the launch needs; otherwise a
// step reads its row from device memory (through L1 and the 50 MB L2),
// which is off the chain.  The default LUT (K = 13, R = 8: 80 KB, with
// the lanes' rings and rows about 158 KB, one CTA an SM) has a kernel of
// its own with K and the search's lengths compiled in; every other LUT
// runs one kernel a row class, K read at run time and the search over
// lengths 2..16 with those up to K masked off (at K = 13, R = 8 that
// general kernel took 1.48-1.79x the compiled-in one's time on an H100,
// chip_compare.py).
// The canonical searches pad sorted_symbols to 256 with its last entry,
// so they clamp exactly as the plain versions clamp.
#include <type_traits>

#include "walk.cuh"

namespace {

using repro::BitReader;
using repro::kAhead;
using repro::kMaxLen;
using repro::kPrefixBits;
using repro::kRingStride;
using repro::kSlice;

constexpr int kMaxWalkWarps = 4;    // walker warps a CTA: one a scheduler
constexpr int kMaxLanes = 32 * kMaxWalkWarps;
// A lane's staging row: up to 3 bytes of row misalignment, then the
// slice's kSlice symbols.  B3/B6 keep 4 spare bytes in front (where the
// pipelined store of the step before the first lands); B4 starts at byte
// 0, and its last window of a slice (from byte 3 + kSlice - 1 at most)
// stores R / 4 + 1 words (B4's rows: MultisymWalk).  76 bytes = 19 words,
// an odd count, so the lanes of a warp staging the same byte write 32
// different banks.
constexpr int kRowBytes = 76;
static_assert(4 + 3 + kSlice <= kRowBytes && kRowBytes % 4 == 0 &&
                  (kRowBytes / 4) % 2 == 1,
              "staging row too short, unaligned or on an even stride");
// A slice segment of a lane's output row spans at most this many
// 16-byte quads (kSlice symbols starting up to 3 past a quad's start).
constexpr int kQuads = (3 + kSlice + 3) / 4;
static_assert(4 + 4 * kQuads <= kRowBytes, "quads past the row");

// After a slice: the warp writes its `lanes` lanes' staged symbols to
// their output rows, elements [k0, k0 + len) of chunks c .. c + lanes - 1.
// Row l's segment starts at element a = (c + l) * chunk + k0 and is
// staged from byte Base + (a & 3) of its row, so quad q of the row (bytes
// Base + 4q .. Base + 4q + 3) holds the int32 elements a - (a & 3) + 4q
// .. + 3: a 16-byte aligned store where all four lie in the segment,
// single stores at its two ends.
template <int Base, int RowBytes>
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
                            rows + l * RowBytes + Base + 4 * q)
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

// One CTA's walk (B3, B4, B6): lane l of warp w walks chunk
// blockIdx.x * per_cta + 32 w + l, slice by slice, with `walk`'s steps;
// after each slice the warp writes its lanes' staged rows out.  `lanes_smem`
// holds every lane's word ring, then every lane's staging row
// (Walk::kRowBytes bytes).
template <class Walk>
__device__ __forceinline__ void walk_chunks(
    Walk& walk, const uint32_t* __restrict__ words,
    const int32_t* __restrict__ counts, int32_t* __restrict__ out, int nb,
    int chunk, int cap, int per_cta, uint8_t* lanes_smem) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * per_cta + warp * 32;   // the warp's chunks
  const int lanes = min(32, min(per_cta - warp * 32, nb - c0));
  if (lanes <= 0) return;                            // the whole warp
  // Lanes past `lanes` walk nothing but take part in the warp's writes.
  const int c = c0 + min(lane, lanes - 1);
  const int count = lane < lanes ? min(max(counts[c], 0), chunk) : 0;
  const uint32_t* src = words + static_cast<long long>(c) * cap;
  uint32_t* ring = reinterpret_cast<uint32_t*>(lanes_smem) +
                   (warp * 32 + lane) * kRingStride;
  uint8_t* rows = lanes_smem + blockDim.x * kRingStride * 4 +
                  warp * 32 * Walk::kRowBytes;
  uint8_t* row = rows + lane * Walk::kRowBytes;
  // The row's first element lies r elements past a 16-byte boundary.
  const int r = static_cast<int>((static_cast<long long>(c) * chunk) & 3);

  int staged = count > 0 ? min(kAhead, cap) : 0;
  repro::stage_words(src, ring, 0, staged);
  repro::copies_done();
  BitReader rd;
  rd.start(ring, cap);
  const int n_slices = (chunk + kSlice - 1) / kSlice;
  for (int s = 0; s < n_slices; ++s) {
    if (s > 0) {
      // The words this slice can reach were staged a slice ago: stage the
      // next slice's and wait for the group before them.  (A slice is at
      // most kSlice steps of at most kMaxLen bits: B4's too, as each of
      // its windows decodes at least one symbol.)
      const int to = count > 0 ? min(rd.widx() + kAhead, cap) : 0;
      repro::stage_words(src, ring, staged, to);
      staged = max(staged, to);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    }
    const int k0 = s * kSlice;
    const int k1 = min(k0 + kSlice, chunk);
    walk.slice(rd, ring, row, r, k0, k1, count);
    __syncwarp();
    write_slice<Walk::kBase, Walk::kRowBytes>(rows, lanes, c0, chunk, k0,
                                              k1 - k0, out, lane);
    __syncwarp();
    walk.carry(row);
  }
  repro::copies_done();
}

// The canonical search over the N code lengths Lo .. Lo + N - 1 of a
// window, from registers (shift, first code, code count and base index of
// each; a length below `first` or past max_len holds no code): the
// shortest valid length and the sorted_symbols index of its symbol
// (clamped to the 256 entries of the padded table).  With no valid length
// it takes length `fallback` and its offset, as the reference's argmax
// over an all-false vector takes its first candidate.  kWinShift takes
// the code of length l as the window's top l bits, a shift by a constant
// (B4: no shift registers, which its 15-length search needs); otherwise
// as the max_len-bit window shifted by max_len - l (B3: ptxas keeps that
// search in registers, where the constant shifts spill).
template <int Lo, int N, bool kWinShift = false>
struct CanonicalSearch {
  int top_shift;                        // 32 - max_len
  int shift[N], fc[N], nc[N], bi[N];
  int len_f, shift_f, fc_f, bi_f;       // the fallback length's

  __device__ __forceinline__ void init(const int32_t* s_fc,
                                       const int32_t* s_bi,
                                       const int32_t* s_nc, int max_len,
                                       int first, int fallback) {
    top_shift = 32 - max_len;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int ll = Lo + i;
      const bool here = ll >= first && ll <= max_len;
      shift[i] = here ? max_len - ll : 0;
      fc[i] = here ? s_fc[ll] : 0;
      nc[i] = here ? s_nc[ll] : 0;      // no code of this length
      bi[i] = here ? s_bi[ll] : 0;
    }
    const bool here = fallback <= max_len;
    len_f = fallback;
    shift_f = here ? max_len - fallback : 0;
    fc_f = here ? s_fc[fallback] : 0;
    bi_f = here ? s_bi[fallback] : 0;
  }

  __device__ __forceinline__ int find(uint32_t win, int* idx) const {
    const int top = static_cast<int>(win >> top_shift);
    int l = len_f, b = bi_f, off = (top >> shift_f) - fc_f;
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {  // the shortest valid length wins
      const int code = kWinShift ? static_cast<int>(win >> (32 - (Lo + i)))
                                 : top >> shift[i];
      const int o = code - fc[i];
      const bool valid =
          static_cast<unsigned>(o) < static_cast<unsigned>(nc[i]);
      l = valid ? Lo + i : l;
      b = valid ? bi[i] : b;
      off = valid ? o : off;
    }
    *idx = min(max(b + off, 0), 255);
    return l;
  }
};

// ------------------------------------------------------------- B3 and B6
// A step of one symbol: lookup(win, &len, &aux) gives the step's entry
// and length (aux: what symbol() needs besides the entry), symbol(e, aux)
// its symbol.
//
// B3: one lookup in the prefix table and, beside it, the canonical search
// over the lengths past kPrefixBits (falling back to length 1, as
// canonical_first from length 1 does).  Where the table's entry is not 0
// it decides the step; where it is 0 (no code of at most kPrefixBits bits
// starts the window) the search does.
struct PrefixSearchStep {
  const uint16_t* prefix;   // shared, 2^kPrefixBits entries
  const int32_t* ss;        // shared, 256 entries
  CanonicalSearch<kPrefixBits + 1, kMaxLen - kPrefixBits> search;

  __device__ __forceinline__ uint32_t lookup(uint32_t win, int* len,
                                             int* idx) const {
    const uint32_t e = repro::prefix_entry(prefix, 0u, win);
    const int l = search.find(win, idx);
    *len = e != 0u ? static_cast<int>(e >> 8) : l;
    return e;
  }
  __device__ __forceinline__ uint32_t symbol(uint32_t e, int idx) const {
    return e != 0u ? e & 0xFFu : static_cast<uint32_t>(ss[idx]) & 0xFFu;
  }
};

// B6: walk.cuh's QlcStep (B8's) behind that interface.
struct QlcWalkStep {
  repro::QlcStep qlc;

  __device__ __forceinline__ uint32_t lookup(uint32_t win, int* len,
                                             int*) const {
    const uint32_t e = qlc.lookup(win);
    *len = qlc.length(e);
    return e;
  }
  __device__ __forceinline__ uint32_t symbol(uint32_t e, int) const {
    return qlc.symbol(e);
  }
};

// A slice of one symbol a step: step k stores step k - 1's symbol (the
// first, of a harmless entry, into the spare byte in front), so neither
// the store nor the symbol's load waits on the chain.
template <class Step>
struct OneSymbolWalk {
  static constexpr int kBase = 4;       // the spare bytes
  static constexpr int kRowBytes = ::kRowBytes;
  Step step;

  __device__ __forceinline__ void slice(BitReader& rd, const uint32_t* ring,
                                        uint8_t* row, int r, int k0, int k1,
                                        int count) {
    const int kd = min(max(count, k0), k1);
    uint8_t* o = row + kBase + r - k0;  // o[k]: symbol k's byte
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
  }
  __device__ __forceinline__ void carry(uint8_t*) const {}
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
  __shared__ int32_t s_fc[kMaxLen + 1];
  __shared__ int32_t s_bi[kMaxLen + 1];
  __shared__ int32_t s_nc[kMaxLen + 1];
  __shared__ int32_t s_ss[256];
  __shared__ __align__(16) uint16_t s_prefix[repro::kPrefix];
  for (int i = threadIdx.x; i <= max_len; i += blockDim.x) {
    s_fc[i] = fc[i];
    s_bi[i] = bi[i];
    s_nc[i] = nc[i];
  }
  // Padded with the last entry: the search's clamp to 255 then gives what
  // the plain version's clamp to n_ss - 1 gives.
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_ss[i] = ss[min(i, n_ss - 1)];
  for (int i = threadIdx.x; i < repro::kPrefix / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(s_prefix)[i] =
        reinterpret_cast<const uint4*>(prefix)[i];
  __syncthreads();

  OneSymbolWalk<PrefixSearchStep> walk;
  walk.step.prefix = s_prefix;
  walk.step.ss = s_ss;
  walk.step.search.init(s_fc, s_bi, s_nc, max_len, kPrefixBits + 1, 1);
  walk_chunks(walk, words, counts, out, nb, chunk, cap, per_cta, smem);
}

__global__ void __launch_bounds__(kMaxLanes)
decode_qlc_kernel(const uint32_t* __restrict__ words,
                  const int32_t* __restrict__ counts, uint32_t len_pack,
                  uint32_t base_pack, const int32_t* __restrict__ sym_tab,
                  int32_t* __restrict__ out, int nb, int chunk, int cap,
                  int per_cta) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_st[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_st[i] = sym_tab[i];
  __syncthreads();

  OneSymbolWalk<QlcWalkStep> walk;
  walk.step.qlc = repro::QlcStep{len_pack, base_pack, s_st};
  walk_chunks(walk, words, counts, out, nb, chunk, cap, per_cta, smem);
}

// ------------------------------------------------------------------- B4
// A CTA's copy of B4's LUT in shared memory, at 16-byte aligned offsets:
// meta (2^K uint16) from byte 0, then the search's symbols as R-byte rows
// {symbol, 0, ...} (row 256: all 0), so that every window's symbols are
// one R-byte load; then, where they live in shared memory, the 2^K rows
// of R bytes.
struct MsLayout {
  int ss, rows, bytes;                  // byte offsets, and the total
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline MsLayout ms_layout(int k, int row,
                                              bool rows_shared) {
  const int ss = align16(2 << k);
  const int rows = ss + align16(257 * row);
  return {ss, rows, rows + (rows_shared ? row << k : 0)};
}

// B4's slice: windows of K bits, each emitting its LUT row's symbols (or
// the canonical search's one), until the lane has decoded the slice's
// symbols [k0, min(k0 + kSlice, count)).  A window's R bytes are loaded a
// step later, off the chain, and staged at the lane's running row byte q
// by R / 4 + 1 word stores: the word that holds q keeps its earlier
// bytes, which the lane holds in a register (acc); the bytes past the
// window's count are overwritten by the next window.  The last window of
// a slice may decode up to W - 1 <= R - 1 symbols past it; they move to
// the row's front for the next slice (carry).  Positions past the chunk's
// count are staged as 0, as the reference truncates at its count.
//
// KT is the window's bits where they are compiled in (the default LUT:
// the search covers lengths KT+1..16 alone), or 0 where K is the
// kernel's argument (the search covers lengths 2..16, those up to K
// holding no code).  Meta and the search's rows are in shared memory;
// `rows` in shared memory or in device memory.
template <int KT, int R>
struct MultisymWalk {
  static_assert(R == 8 || R == 16, "a window's symbols are one 8- or "
                "16-byte load");
  static_assert(KT == 0 || (KT >= 1 && KT < kMaxLen),
                "a compiled-in window leaves lengths to search");
  static constexpr int kBase = 0;
  static constexpr int kWords = R / 4;
  // The last window of a slice starts at most at row byte 3 + kSlice - 1
  // and stores kWords + 1 words; the row has an odd count of words.
  static constexpr int kRowBytes = 4 * ((3 + kSlice - 1) / 4 + kWords + 1);
  static_assert((kRowBytes / 4) % 2 == 1 && 4 + 4 * kQuads <= kRowBytes,
                "staging row on an even stride or too short");
  static constexpr int kLaneBytes = kRingStride * 4 + kRowBytes;
  // Row words past the slice that may hold symbols of the next (and the
  // word of byte q): bytes kSlice .. 3 + kSlice + R - 2.
  static constexpr int kCarryWords = (3 + R - 1) / 4 + 1;
  using Row = typename std::conditional<R == 8, uint2, uint4>::type;

  const uint16_t* meta;                 // shared, 2^K entries
  const uint8_t* ss;                    // shared, 257 rows of R bytes
  const uint8_t* rows;                  // 2^K rows of R bytes
  CanonicalSearch<KT ? KT + 1 : 2, KT ? kMaxLen - KT : kMaxLen - 1, true>
      search;
  int shift;                            // 32 - K
  bool searched;                        // K < max_len: lengths to search
  int pos = 0;                          // symbols decoded and staged
  uint32_t acc = 0u;                    // the staged word holding byte q

  __device__ __forceinline__ void init(const uint8_t* s_lut,
                                       const MsLayout& lay,
                                       const uint8_t* lut_rows, int k,
                                       const int32_t* s_fc,
                                       const int32_t* s_bi,
                                       const int32_t* s_nc, int max_len) {
    meta = reinterpret_cast<const uint16_t*>(s_lut);
    ss = s_lut + lay.ss;
    rows = lut_rows;
    search.init(s_fc, s_bi, s_nc, max_len, k + 1, k + 1);
    shift = 32 - k;
    searched = k < max_len;
  }

  __device__ __forceinline__ uint32_t index(uint32_t win) const {
    if constexpr (KT != 0) return win >> (32 - KT);
    return win >> shift;
  }

  __device__ __forceinline__ Row load(const uint8_t* p) const {
    return *reinterpret_cast<const Row*>(p);
  }

  static __device__ __forceinline__ void words(const uint2& v,
                                               uint32_t (&w)[2]) {
    w[0] = v.x;
    w[1] = v.y;
  }
  static __device__ __forceinline__ void words(const uint4& v,
                                               uint32_t (&w)[4]) {
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }

  // Stage the R bytes v at row byte q, of which the first n count; q
  // moves on by n.
  __device__ __forceinline__ void stage(uint32_t* rw, int& q, Row v,
                                        int n) {
    uint32_t vw[kWords];
    words(v, vw);
    const int wq = q >> 2;
    const uint32_t sh = static_cast<uint32_t>(q & 3) * 8u;
    uint32_t w[kWords + 1];
    w[0] = (acc & ((1u << sh) - 1u)) | (vw[0] << sh);
#pragma unroll
    for (int i = 1; i < kWords; ++i)
      w[i] = __funnelshift_l(vw[i - 1], vw[i], sh);
    w[kWords] = __funnelshift_l(vw[kWords - 1], 0u, sh);
#pragma unroll
    for (int i = 0; i <= kWords; ++i) rw[wq + i] = w[i];
    q += n;
    const int j = (q >> 2) - wq;
    acc = w[0];
#pragma unroll
    for (int i = 1; i <= kWords; ++i) acc = j == i ? w[i] : acc;
  }

  __device__ __forceinline__ void slice(BitReader& rd, const uint32_t* ring,
                                        uint8_t* row, int r, int k0, int k1,
                                        int count) {
    uint32_t* rw = reinterpret_cast<uint32_t*>(row);
    const int end = min(k0 + kSlice, count);
    int done = pos;                     // symbols decoded
    int q = r + (pos - k0);             // the row byte of symbol pos
    const uint8_t* pend = ss + R * 256;   // nothing decoded yet
    int pend_n = 0;
    while (done < end) {
      const Row v = load(pend);
      const uint32_t up = rd.upcoming(ring);
      const uint32_t win = rd.window();
      const uint32_t idx = index(win);
      const uint32_t m = meta[idx];
      int sidx;
      const int sl = search.find(win, &sidx);
      const bool slow = (m & 0xFFu) == 0u;    // first code over K bits
      rd.advance(slow ? (searched ? sl : 0) : static_cast<int>(m >> 8), up);
      stage(rw, q, v, pend_n);
      pend = slow ? ss + R * (searched ? sidx : 256) : rows + idx * R;
      pend_n = slow ? 1 : static_cast<int>(m & 0xFFu);
      done += pend_n;
    }
    if (pend_n > 0) stage(rw, q, load(pend), pend_n);
    pos = done;
    for (int k = max(count, k0); k < k1; ++k) row[r + k - k0] = 0;
  }

  // After the slice's write-out: the bytes past the slice move to the
  // row's front, where the next slice's symbols start; acc's word moves
  // with them.
  __device__ __forceinline__ void carry(uint8_t* row) const {
    uint32_t* rw = reinterpret_cast<uint32_t*>(row);
#pragma unroll
    for (int i = 0; i < kCarryWords; ++i) rw[i] = rw[kSlice / 4 + i];
  }
};

// The default LUT (Codebook.device_tables("multisym"): K = MULTISYM_K,
// s_max = MULTISYM_SMAX) runs with K compiled in.
constexpr int kMsK = 13;

template <int KT, int R>
__global__ void __launch_bounds__(kMaxLanes)
decode_multisym_kernel(const uint32_t* __restrict__ words,
                       const int32_t* __restrict__ counts,
                       const uint8_t* __restrict__ syms,    // (2^K, R)
                       const uint16_t* __restrict__ meta,   // (2^K,)
                       const int32_t* __restrict__ fc,
                       const int32_t* __restrict__ bi,
                       const int32_t* __restrict__ nc,
                       const int32_t* __restrict__ ss, int n_ss,
                       int32_t* __restrict__ out, int nb, int chunk, int cap,
                       int k, int max_len, int per_cta, int rows_shared) {
  using Walk = MultisymWalk<KT, R>;
  if constexpr (KT != 0) k = KT;
  // The default LUT's rows always fit (ms_launch_shape).
  const bool in_smem = KT != 0 || rows_shared != 0;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_fc[kMaxLen + 1];
  __shared__ int32_t s_bi[kMaxLen + 1];
  __shared__ int32_t s_nc[kMaxLen + 1];
  const MsLayout lay = ms_layout(k, R, in_smem);
  // The LUT: 16-byte copies, all in flight at once (meta of K < 3 is
  // under 16 bytes: plain copies).
  if (k >= 3) {
    for (int i = threadIdx.x; i < (2 << k) / 16; i += blockDim.x)
      repro::copy16_async(smem + 16 * i,
                          reinterpret_cast<const uint8_t*>(meta) + 16 * i);
  } else {
    for (int i = threadIdx.x; i < (1 << k); i += blockDim.x)
      reinterpret_cast<uint16_t*>(smem)[i] = meta[i];
  }
  if (in_smem) {
    for (int i = threadIdx.x; i < (R << k) / 16; i += blockDim.x)
      repro::copy16_async(smem + lay.rows + 16 * i, syms + 16 * i);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = threadIdx.x; i <= max_len; i += blockDim.x) {
    s_fc[i] = fc[i];
    s_bi[i] = bi[i];
    s_nc[i] = nc[i];
  }
  // The search's symbols, padded with the last entry (as B3's).
  for (int i = threadIdx.x; i <= 256; i += blockDim.x) {
    typename Walk::Row v{};
    v.x = i < 256 ? static_cast<uint32_t>(ss[min(i, n_ss - 1)]) & 0xFFu : 0u;
    *reinterpret_cast<typename Walk::Row*>(smem + lay.ss + R * i) = v;
  }
  repro::copies_done();
  __syncthreads();

  Walk walk;
  walk.init(smem, lay, in_smem ? smem + lay.rows : syms, k, s_fc, s_bi,
            s_nc, max_len);
  walk_chunks(walk, words, counts, out, nb, chunk, cap, per_cta,
              smem + lay.bytes);
}

// A walk kernel's launch shape for nb chunks on this device: lanes
// (chunks) a CTA, walker warps a CTA, CTAs, and the dynamic shared memory
// of a CTA (`tables` bytes, then each lane's ring and row, a whole warp's
// at a time).
struct WalkShape {
  int per_cta, warps, grid, smem;
};

WalkShape walk_shape(int nb, int tables, int lane_bytes) {
  const int sms = repro::sm_count();
  const int spread = (nb + sms - 1) / sms;
  const int per_cta = spread < 1 ? 1 : spread > kMaxLanes ? kMaxLanes : spread;
  const int warps = (per_cta + 31) / 32;
  return {per_cta, warps, (nb + per_cta - 1) / per_cta,
          tables + warps * 32 * lane_bytes};
}

// B3's and B6's lanes: OneSymbolWalk's rows.
constexpr int kLaneBytes = kRingStride * 4 + kRowBytes;

// The dynamic shared memory each of B3 and B6 may take (its largest
// launch), raised once a device.
int allowed_b3[repro::kMaxDevices] = {};
int allowed_b6[repro::kMaxDevices] = {};

template <typename Kernel>
cudaError_t allow_walk(Kernel kernel, int* allowed) {
  return repro::allow_smem(kernel, kMaxLanes * kLaneBytes, allowed);
}

// A B3 or B6 launch shape for nb chunks, into shape[0..4]: chunks a CTA,
// walker warps a CTA, CTAs, dynamic shared memory a CTA (bytes), and
// CTAs one SM holds at once.
template <typename Kernel>
int walk_shape_query(Kernel kernel, int* allowed, int nb, int* shape) {
  cudaError_t err = allow_walk(kernel, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WalkShape sh = walk_shape(nb > 1 ? nb : 1, 0, kLaneBytes);
  shape[0] = sh.per_cta;
  shape[1] = sh.warps;
  shape[2] = sh.grid;
  shape[3] = sh.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      shape + 4, kernel, 32 * sh.warps, sh.smem));
}

// A B4 launch: its walk's shape and where the LUT's rows live.  The rows
// go to shared memory where they fit beside the lanes the launch needs,
// else a step reads its row from device memory, a step behind the chain:
// capping the lanes to keep the rows in shared memory would add CTAs and
// a wave (K = 14, R = 8 at 16 384 chunks: 96 lanes a CTA, 171 CTAs on
// 132 SMs), which measured slower than one wave reading device memory.
// The limit is the block's opt-in shared memory less the kernel's static
// tables, read once a device; meta, the search's rows and 128 lanes
// always fit it.
struct MsShape {
  WalkShape sh;
  bool rows_shared;
};

template <int KT, int R>
cudaError_t ms_launch_shape(int nb, int k, MsShape* out) {
  using Walk = MultisymWalk<KT, R>;
  auto kernel = decode_multisym_kernel<KT, R>;
  static int limits[repro::kMaxDevices] = {};
  static int allowed[repro::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= repro::kMaxDevices) return cudaErrorInvalidDevice;
  if (limits[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    limits[dev] = optin - static_cast<int>(attr.sharedSizeBytes);
  }
  const int lanes = walk_shape(nb, 0, Walk::kLaneBytes).smem;
  out->rows_shared = ms_layout(k, R, true).bytes + lanes <= limits[dev];
  if (KT != 0 && !out->rows_shared) return cudaErrorInvalidValue;
  out->sh = walk_shape(nb, ms_layout(k, R, out->rows_shared).bytes,
                       Walk::kLaneBytes);
  if (out->sh.smem > limits[dev]) return cudaErrorInvalidValue;
  return repro::allow_smem(kernel, out->sh.smem, allowed);
}

template <int KT, int R>
int ms_launch(const void* words, const void* counts, const void* syms,
              const void* meta, const void* fc, const void* bi,
              const void* nc, const void* ss, int n_ss, void* out, int nb,
              int chunk, int cap, int k, int max_len, cudaStream_t s) {
  MsShape plan;
  cudaError_t err = ms_launch_shape<KT, R>(nb, k, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    const WalkShape& sh = plan.sh;
    decode_multisym_kernel<KT, R><<<sh.grid, 32 * sh.warps, sh.smem, s>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(counts),
        static_cast<const uint8_t*>(syms),
        static_cast<const uint16_t*>(meta), static_cast<const int32_t*>(fc),
        static_cast<const int32_t*>(bi), static_cast<const int32_t*>(nc),
        static_cast<const int32_t*>(ss), n_ss, static_cast<int32_t*>(out),
        nb, chunk, cap, k, max_len, sh.per_cta, plan.rows_shared ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KT, int R>
int ms_shape_query(int nb, int k, int* shape) {
  MsShape plan;
  cudaError_t err = ms_launch_shape<KT, R>(nb > 1 ? nb : 1, k, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  shape[0] = plan.sh.per_cta;
  shape[1] = plan.sh.warps;
  shape[2] = plan.sh.grid;
  shape[3] = plan.sh.smem;
  shape[5] = plan.rows_shared ? 1 : 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      shape + 4, decode_multisym_kernel<KT, R>, 32 * plan.sh.warps,
      plan.sh.smem));
}

// The LUT of 2^k rows of `row` bytes (8 or 16) that B4 takes: every
// 1 <= k <= max_len <= kMaxLen, as the reference's build_multisym_tables.
bool ms_valid(int k, int row, int max_len) {
  return max_len >= 1 && max_len <= kMaxLen && k >= 1 && k <= max_len &&
         (row == 8 || row == 16);
}

}  // namespace

extern "C" int decode_canonical_launch(const void* words, const void* counts,
                                       const void* prefix, const void* fc,
                                       const void* bi, const void* nc,
                                       const void* ss, int n_ss, void* out,
                                       int nb, int chunk, int cap,
                                       int max_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_walk(decode_canonical_kernel, allowed_b3);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    const WalkShape sh = walk_shape(nb, 0, kLaneBytes);
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

extern "C" int decode_canonical_prefix_bits() { return kPrefixBits; }

extern "C" int decode_canonical_shape(int nb, int* shape) {
  return walk_shape_query(decode_canonical_kernel, allowed_b3, nb, shape);
}

// A LUT of 2^k rows of `row` bytes (the wrapper's re-strided syms, 8 or
// 16) for a stream of codes of at most max_len bits: the default LUT
// (k = 13, row 8) runs its own kernel, every other one its row class's.
extern "C" int decode_multisym_launch(const void* words, const void* counts,
                                      const void* syms, const void* meta,
                                      const void* fc, const void* bi,
                                      const void* nc, const void* ss,
                                      int n_ss, void* out, int nb, int chunk,
                                      int cap, int k, int row, int max_len,
                                      void* stream) {
  if (!ms_valid(k, row, max_len))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == kMsK && row == 8)
    return ms_launch<kMsK, 8>(words, counts, syms, meta, fc, bi, nc, ss,
                              n_ss, out, nb, chunk, cap, k, max_len, s);
  if (row == 8)
    return ms_launch<0, 8>(words, counts, syms, meta, fc, bi, nc, ss, n_ss,
                           out, nb, chunk, cap, k, max_len, s);
  return ms_launch<0, 16>(words, counts, syms, meta, fc, bi, nc, ss, n_ss,
                          out, nb, chunk, cap, k, max_len, s);
}

// B4's launch shape for nb chunks and a LUT of 2^k rows of `row` bytes,
// into shape[0..5]: chunks a CTA, walker warps a CTA, CTAs, dynamic
// shared memory a CTA (bytes), CTAs one SM holds at once, and 1 where the
// rows live in shared memory (0: device memory).
extern "C" int decode_multisym_shape(int nb, int k, int row, int* shape) {
  if (!ms_valid(k, row, kMaxLen))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == kMsK && row == 8) return ms_shape_query<kMsK, 8>(nb, k, shape);
  if (row == 8) return ms_shape_query<0, 8>(nb, k, shape);
  return ms_shape_query<0, 16>(nb, k, shape);
}

extern "C" int decode_qlc_launch(const void* words, const void* counts,
                                 unsigned int len_pack, unsigned int base_pack,
                                 const void* sym_tab, void* out, int nb,
                                 int chunk, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_walk(decode_qlc_kernel, allowed_b6);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    const WalkShape sh = walk_shape(nb, 0, kLaneBytes);
    decode_qlc_kernel<<<sh.grid, 32 * sh.warps, sh.smem, s>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(counts), len_pack, base_pack,
        static_cast<const int32_t*>(sym_tab), static_cast<int32_t*>(out), nb,
        chunk, cap, sh.per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_qlc_shape(int nb, int* shape) {
  return walk_shape_query(decode_qlc_kernel, allowed_b6, nb, shape);
}
