// Kernel B3: chunked canonical Huffman decode; kernel B4: chunked
// multi-symbol decode; kernel B6: chunked QLC decode.
//
// B3 replaces repro/kernels/decode.py::decode_chunks_pallas
// (_decode_kernel): per chunk, a canonical-prefix walk of one symbol a
// step (16-bit window, first_code subtraction for every length,
// sorted_symbols[base_index[l] + off]).  B4 replaces
// decode_chunks_multisym_pallas (_decode_multisym_kernel): a K = 13 bit
// window LUT that emits up to s_max = 8 symbols a step, with an inline
// canonical search for the windows whose first code is longer than K
// bits.  B6 replaces decode_chunks_qlc_pallas (_decode_qlc_kernel): the
// table-free QLC walk, one symbol a step.
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
//     << 8); beside it, the canonical search over lengths K+1..16 from
//     registers, which a select takes where the count is 0 (one symbol;
//     with no valid length, length K + 1, as the reference's argmax over
//     an all-false vector).  Each step's symbols (the search's, the QLC
//     table's, or B4's 8-byte LUT row) are loaded a step later, off the
//     chain.
//   * The output leaves in coalesced 16-byte stores: each lane stages a
//     slice of its symbols as bytes in shared memory, shifted by its row's
//     misalignment (chunk 1001 rows start anywhere), and after the slice
//     the warp writes every lane's int32 row segment out, four symbols a
//     store, zeros past the count included (write_slice).  B4's slices
//     are cut by symbols, not steps: a lane walks until it has decoded the
//     slice's symbols, the few past its end staying in the row for the
//     next slice; a window's 8 bytes are staged by three word stores, the
//     word that holds earlier bytes kept in a register.
// B4's LUT does not fit Hopper's 227 KB as the reference's int32 (288
// KB), so the wrapper converts it once per book to syms uint8 (64 KB) and
// meta uint16 (16 KB), which each CTA copies into shared memory with
// cp.async: with the lanes' rings and rows about 158 KB, one CTA an SM.
// The canonical searches pad sorted_symbols to 256 with its last entry,
// so they clamp exactly as the plain versions clamp.
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
// stores three words.  76 bytes = 19 words, an odd count, so the lanes of
// a warp staging the same byte write 32 different banks.
constexpr int kRowBytes = 76;
static_assert(4 + 3 + kSlice <= kRowBytes &&
                  4 * ((3 + kSlice - 1) / 4 + 3) <= kRowBytes &&
                  kRowBytes % 4 == 0 && (kRowBytes / 4) % 2 == 1,
              "staging row too short, unaligned or on an even stride");
// A slice segment of a lane's output row spans at most this many
// 16-byte quads (kSlice symbols starting up to 3 past a quad's start).
constexpr int kQuads = (3 + kSlice + 3) / 4;
static_assert(4 + 4 * kQuads <= kRowBytes, "quads past the row");
constexpr int kLaneBytes = kRingStride * 4 + kRowBytes;

// After a slice: the warp writes its `lanes` lanes' staged symbols to
// their output rows, elements [k0, k0 + len) of chunks c .. c + lanes - 1.
// Row l's segment starts at element a = (c + l) * chunk + k0 and is
// staged from byte Base + (a & 3) of its row, so quad q of the row (bytes
// Base + 4q .. Base + 4q + 3) holds the int32 elements a - (a & 3) + 4q
// .. + 3: a 16-byte aligned store where all four lie in the segment,
// single stores at its two ends.
template <int Base>
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
                            rows + l * kRowBytes + Base + 4 * q)
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
// holds every lane's word ring, then every lane's staging row.
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
                  warp * 32 * kRowBytes;
  uint8_t* row = rows + lane * kRowBytes;
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
    write_slice<Walk::kBase>(rows, lanes, c0, chunk, k0, k1 - k0, out, lane);
    __syncwarp();
    walk.carry(row);
  }
  repro::copies_done();
}

// The canonical search over the N code lengths Lo .. Lo + N - 1 of a
// window, from registers (shift, first code, code count and base index of
// each; a length past max_len holds no code): the shortest valid length
// and the sorted_symbols index of its symbol (clamped to the 256 entries
// of the padded table).  With no valid length it takes length `fallback`
// and its offset, as the reference's argmax over an all-false vector
// takes its first candidate.
template <int Lo, int N>
struct CanonicalSearch {
  int top_shift;                        // 32 - max_len
  int shift[N], fc[N], nc[N], bi[N];
  int len_f, shift_f, fc_f, bi_f;       // the fallback length's

  __device__ __forceinline__ void init(const int32_t* s_fc,
                                       const int32_t* s_bi,
                                       const int32_t* s_nc, int max_len,
                                       int fallback) {
    top_shift = 32 - max_len;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int ll = Lo + i;
      const bool here = ll <= max_len;
      shift[i] = here ? max_len - ll : 0;
      fc[i] = here ? s_fc[ll] : 0;
      nc[i] = here ? s_nc[ll] : 0;      // a length past max_len: no code
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
      const int o = (top >> shift[i]) - fc[i];
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
  walk.step.search.init(s_fc, s_bi, s_nc, max_len, 1);
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
// The LUT's shape: Codebook.device_tables("multisym") always builds
// K = MULTISYM_K and s_max = MULTISYM_SMAX (core/huffman.py).
constexpr int kMsK = 13;
constexpr int kMsSmax = 8;

// A CTA's copy of the LUT in shared memory: meta (2^K uint16), syms (2^K
// rows of s_max bytes), then the search's symbols as 8-byte rows {symbol,
// 0} (row 256: all 0), so that every window's symbols are one 8-byte
// load at a byte offset into it.
template <int K, int S>
struct MultisymLut {
  static constexpr int kSyms = (1 << K) * 2;
  static constexpr int kSs8 = kSyms + (1 << K) * S;
  static constexpr int kBytes = kSs8 + 16 * ((257 * 8 + 15) / 16);
};

// B4's slice: windows of K bits, each emitting its LUT row's symbols (or
// the canonical search's one), until the lane has decoded the slice's
// symbols [k0, min(k0 + kSlice, count)).  A window's S = 8 bytes are
// loaded a step later, off the chain, and staged at the lane's running
// row byte q by three word stores: the word that holds q keeps its
// earlier bytes, which the lane holds in a register (acc); the bytes past
// the window's count are overwritten by the next window.  The last window
// of a slice may decode up to S - 1 symbols past it; they move to the
// row's front for the next slice (carry).  Positions past the chunk's
// count are staged as 0, as the reference truncates at its count.
template <int K, int S>
struct MultisymWalk {
  static_assert(S == 8, "a window's symbols are one 8-byte load");
  static constexpr int kBase = 0;
  using Lut = MultisymLut<K, S>;
  const uint8_t* lut;                   // shared, MultisymLut's layout
  CanonicalSearch<K + 1, kMaxLen - K> search;
  bool searched;                        // K < max_len: lengths to search
  int pos = 0;                          // symbols decoded and staged
  uint32_t acc = 0u;                    // the staged word holding byte q

  __device__ __forceinline__ void init(const uint8_t* s_lut,
                                       const int32_t* s_fc,
                                       const int32_t* s_bi,
                                       const int32_t* s_nc, int max_len) {
    lut = s_lut;
    search.init(s_fc, s_bi, s_nc, max_len, K + 1);
    searched = K < max_len;
  }

  // Stage the 8 bytes v at row byte q, of which the first n count; q
  // moves on by n.
  __device__ __forceinline__ void stage(uint32_t* rw, int& q, uint2 v,
                                        int n) {
    const int wq = q >> 2;
    const uint32_t sh = static_cast<uint32_t>(q & 3) * 8u;
    const uint32_t w0 = (acc & ((1u << sh) - 1u)) | (v.x << sh);
    const uint32_t w1 = __funnelshift_l(v.x, v.y, sh);
    const uint32_t w2 = __funnelshift_l(v.y, 0u, sh);
    rw[wq] = w0;
    rw[wq + 1] = w1;
    rw[wq + 2] = w2;
    q += n;
    const int j = (q >> 2) - wq;
    acc = j == 0 ? w0 : j == 1 ? w1 : w2;
  }

  __device__ __forceinline__ void slice(BitReader& rd, const uint32_t* ring,
                                        uint8_t* row, int r, int k0, int k1,
                                        int count) {
    uint32_t* rw = reinterpret_cast<uint32_t*>(row);
    const uint16_t* meta = reinterpret_cast<const uint16_t*>(lut);
    const int end = min(k0 + kSlice, count);
    int done = pos;                     // symbols decoded
    int q = r + (pos - k0);             // the row byte of symbol pos
    uint32_t pend = Lut::kSs8 + 8 * 256;   // nothing decoded yet
    int pend_n = 0;
    while (done < end) {
      const uint2 v = *reinterpret_cast<const uint2*>(lut + pend);
      const uint32_t up = rd.upcoming(ring);
      const uint32_t win = rd.window();
      const uint32_t idx = win >> (32 - K);
      const uint32_t m = meta[idx];
      int sidx;
      const int sl = search.find(win, &sidx);
      const bool slow = (m & 0xFFu) == 0u;    // first code over K bits
      rd.advance(slow ? (searched ? sl : 0) : static_cast<int>(m >> 8), up);
      stage(rw, q, v, pend_n);
      pend = slow ? Lut::kSs8 + 8u * (searched ? sidx : 256)
                  : Lut::kSyms + idx * S;
      pend_n = slow ? 1 : static_cast<int>(m & 0xFFu);
      done += pend_n;
    }
    if (pend_n > 0)
      stage(rw, q, *reinterpret_cast<const uint2*>(lut + pend), pend_n);
    pos = done;
    for (int k = max(count, k0); k < k1; ++k) row[r + k - k0] = 0;
  }

  // After the slice's write-out: the bytes past the slice (row bytes
  // kSlice .. kSlice + 11) move to the row's front, where the next
  // slice's symbols start; acc's word moves with them.
  __device__ __forceinline__ void carry(uint8_t* row) const {
    uint32_t* rw = reinterpret_cast<uint32_t*>(row);
#pragma unroll
    for (int i = 0; i < 3; ++i) rw[i] = rw[kSlice / 4 + i];
  }
};

using MsLut = MultisymLut<kMsK, kMsSmax>;

__global__ void __launch_bounds__(kMaxLanes)
decode_multisym_kernel(const uint32_t* __restrict__ words,
                       const int32_t* __restrict__ counts,
                       const uint8_t* __restrict__ syms,    // (2^K, s_max)
                       const uint16_t* __restrict__ meta,   // (2^K,)
                       const int32_t* __restrict__ fc,
                       const int32_t* __restrict__ bi,
                       const int32_t* __restrict__ nc,
                       const int32_t* __restrict__ ss, int n_ss,
                       int32_t* __restrict__ out, int nb, int chunk, int cap,
                       int max_len, int per_cta) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_fc[kMaxLen + 1];
  __shared__ int32_t s_bi[kMaxLen + 1];
  __shared__ int32_t s_nc[kMaxLen + 1];
  // The LUT: 16-byte copies, all in flight at once.
  for (int i = threadIdx.x; i < MsLut::kSyms / 16; i += blockDim.x)
    repro::copy16_async(smem + 16 * i,
                        reinterpret_cast<const uint8_t*>(meta) + 16 * i);
  for (int i = threadIdx.x; i < (MsLut::kSs8 - MsLut::kSyms) / 16;
       i += blockDim.x)
    repro::copy16_async(smem + MsLut::kSyms + 16 * i, syms + 16 * i);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = threadIdx.x; i <= max_len; i += blockDim.x) {
    s_fc[i] = fc[i];
    s_bi[i] = bi[i];
    s_nc[i] = nc[i];
  }
  // The search's symbols, padded with the last entry (as B3's).
  uint2* ss8 = reinterpret_cast<uint2*>(smem + MsLut::kSs8);
  for (int i = threadIdx.x; i <= 256; i += blockDim.x)
    ss8[i] = make_uint2(
        i < 256 ? static_cast<uint32_t>(ss[min(i, n_ss - 1)]) & 0xFFu : 0u,
        0u);
  repro::copies_done();
  __syncthreads();

  MultisymWalk<kMsK, kMsSmax> walk;
  walk.init(smem, s_fc, s_bi, s_nc, max_len);
  walk_chunks(walk, words, counts, out, nb, chunk, cap, per_cta,
              smem + MsLut::kBytes);
}

// A walk kernel's launch shape for nb chunks on this device: lanes
// (chunks) a CTA, walker warps a CTA, CTAs, and the dynamic shared memory
// of a CTA (`tables` bytes, then each lane's ring and row).
struct WalkShape {
  int per_cta, warps, grid, smem;
};

WalkShape walk_shape(int nb, int tables) {
  const int sms = repro::sm_count();
  const int spread = (nb + sms - 1) / sms;
  const int per_cta = spread < 1 ? 1 : spread > kMaxLanes ? kMaxLanes : spread;
  const int warps = (per_cta + 31) / 32;
  return {per_cta, warps, (nb + per_cta - 1) / per_cta,
          tables + warps * 32 * kLaneBytes};
}

// The dynamic shared memory each walk kernel may take (its largest
// launch), raised once a device.
int allowed_b3[repro::kMaxDevices] = {};
int allowed_b4[repro::kMaxDevices] = {};
int allowed_b6[repro::kMaxDevices] = {};

template <typename Kernel>
cudaError_t allow_walk(Kernel kernel, int tables, int* allowed) {
  return repro::allow_smem(kernel, tables + kMaxLanes * kLaneBytes, allowed);
}

// A walk kernel's launch shape for nb chunks, into shape[0..4]: chunks a
// CTA, walker warps a CTA, CTAs, dynamic shared memory a CTA (bytes), and
// CTAs one SM holds at once.
template <typename Kernel>
int walk_shape_query(Kernel kernel, int tables, int* allowed, int nb,
                     int* shape) {
  cudaError_t err = allow_walk(kernel, tables, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WalkShape sh = walk_shape(nb > 1 ? nb : 1, tables);
  shape[0] = sh.per_cta;
  shape[1] = sh.warps;
  shape[2] = sh.grid;
  shape[3] = sh.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      shape + 4, kernel, 32 * sh.warps, sh.smem));
}

}  // namespace

extern "C" int decode_canonical_launch(const void* words, const void* counts,
                                       const void* prefix, const void* fc,
                                       const void* bi, const void* nc,
                                       const void* ss, int n_ss, void* out,
                                       int nb, int chunk, int cap,
                                       int max_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_walk(decode_canonical_kernel, 0, allowed_b3);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    const WalkShape sh = walk_shape(nb, 0);
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
  return walk_shape_query(decode_canonical_kernel, 0, allowed_b3, nb, shape);
}

// k and s_max must be the kernel's (kMsK, kMsSmax): the wrapper checks
// them, and any other LUT is refused here too.
extern "C" int decode_multisym_launch(const void* words, const void* counts,
                                      const void* syms, const void* meta,
                                      const void* fc, const void* bi,
                                      const void* nc, const void* ss,
                                      int n_ss, void* out, int nb, int chunk,
                                      int cap, int k, int s_max, int max_len,
                                      void* stream) {
  if (k != kMsK || s_max != kMsSmax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      allow_walk(decode_multisym_kernel, MsLut::kBytes, allowed_b4);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    const WalkShape sh = walk_shape(nb, MsLut::kBytes);
    decode_multisym_kernel<<<sh.grid, 32 * sh.warps, sh.smem, s>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(counts),
        static_cast<const uint8_t*>(syms),
        static_cast<const uint16_t*>(meta), static_cast<const int32_t*>(fc),
        static_cast<const int32_t*>(bi), static_cast<const int32_t*>(nc),
        static_cast<const int32_t*>(ss), n_ss, static_cast<int32_t*>(out),
        nb, chunk, cap, max_len, sh.per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_multisym_shape(int nb, int* shape) {
  return walk_shape_query(decode_multisym_kernel, MsLut::kBytes, allowed_b4,
                          nb, shape);
}

extern "C" int decode_qlc_launch(const void* words, const void* counts,
                                 unsigned int len_pack, unsigned int base_pack,
                                 const void* sym_tab, void* out, int nb,
                                 int chunk, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_walk(decode_qlc_kernel, 0, allowed_b6);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    const WalkShape sh = walk_shape(nb, 0);
    decode_qlc_kernel<<<sh.grid, 32 * sh.warps, sh.smem, s>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(counts), len_pack, base_pack,
        static_cast<const int32_t*>(sym_tab), static_cast<int32_t*>(out), nb,
        chunk, cap, sh.per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_qlc_shape(int nb, int* shape) {
  return walk_shape_query(decode_qlc_kernel, 0, allowed_b6, nb, shape);
}
