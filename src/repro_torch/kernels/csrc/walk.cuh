// The chunk walker's parts, shared by kernel B3 (decode.cu) and kernels
// B7/B8 (decode_matmul.cu).
//
// A walker lane decodes one chunk, one code a step, and every step needs
// the bit position the step before it left.  So the parts below keep the
// step short and keep loads off its chain: the lane's words sit in its
// own ring in shared memory, which it fills a slice ahead of its reader
// with cp.async (`stage_words`); the reader holds three words in
// registers and moves them with selects, not a branch (`BitReader`); and
// a canonical step starts with one lookup in a 2^kPrefixBits-entry table
// (`prefix_entry`), only longer codes needing the canonical search.
#pragma once

#include "common.cuh"

namespace repro {

// Codes a walker decodes between two refills of its ring.
constexpr int kSlice = 64;
// Words a reader can move through in one slice (kSlice codes of at most
// kMaxLen bits), and how far ahead of its reader a lane keeps its ring
// filled: two slices of them plus the reader's three registers' words.
constexpr int kSliceWords = (kSlice * kMaxLen + 31) / 32 + 1;
constexpr int kAhead = 2 * kSliceWords + 3;
// A lane's word ring: a power of two, so a word's slot is its index
// masked; a lane's ring takes kRing + 1 words of shared memory, so that
// lanes at the same slot read other banks.
constexpr int kRing = 128;
constexpr int kRingStride = kRing + 1;
static_assert(kRing >= kAhead && (kRing & (kRing - 1)) == 0,
              "word ring too small or not a power of two");

// The one-lookup canonical table: 2^12 entries of `symbol | length << 8`
// (core.encoder.canonical_prefix_table), 8 KB a book as uint16; an entry
// is 0 where no code of at most kPrefixBits bits starts the window.
constexpr int kPrefixBits = 12;
constexpr int kPrefix = 1 << kPrefixBits;

// The entry for the 32-bit window `win` in the table at byte offset
// `table` of `prefix` (shared memory): one shift and one three-input
// logic op for the entry's byte offset, then the load.
__device__ __forceinline__ uint32_t prefix_entry(const uint16_t* prefix,
                                                 uint32_t table,
                                                 uint32_t win) {
  const uint32_t off =
      ((win >> (31 - kPrefixBits)) & ((kPrefix - 1) << 1)) | table;
  return *reinterpret_cast<const uint16_t*>(
      reinterpret_cast<const uint8_t*>(prefix) + off);
}

__device__ __forceinline__ void copy_word_async(uint32_t* dst,
                                                const uint32_t* src) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A lane copies the words [from, to) of its chunk into its ring with
// cp.async, and commits them as one group.
__device__ __forceinline__ void stage_words(const uint32_t* __restrict__ src,
                                            uint32_t* ring, int from,
                                            int to) {
  for (int w = from; w < to; ++w)
    copy_word_async(ring + (w & (kRing - 1)), src + w);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A chunk's bit reader: words cur (index widx), nxt and after (index
// wnext = widx + 2), and the bit offset pos into cur.  window() is the
// 32 stream bits at the cursor, as window32 gives them (the funnel shift
// takes pos mod 32).  advance() has no branch, so a step's chain is
// shift, decode, add, compare, select.
struct BitReader {
  uint32_t cur, nxt, after;
  int pos, wnext, lim, last;

  __device__ __forceinline__ void start(const uint32_t* ring, int cap) {
    cur = ring[0];
    nxt = ring[1];
    after = ring[min(2, cap - 1)];
    pos = 0;
    wnext = 2;
    last = cap - 2;
    lim = 0 < last ? 32 : 1 << 30;
  }

  // The index of the word in cur.
  __device__ __forceinline__ int widx() const { return wnext - 2; }

  __device__ __forceinline__ uint32_t window() const {
    return __funnelshift_l(nxt, cur, static_cast<unsigned int>(pos));
  }

  // The word after `after` (from the ring), which a step loads at its
  // start, so that the load is done by the time advance() may need it.
  __device__ __forceinline__ uint32_t upcoming(const uint32_t* ring) const {
    return ring[(wnext + 1) & (kRing - 1)];
  }

  // Move on by `len` bits; past a word boundary the three words move
  // along and `up` (this step's upcoming()) becomes `after`.  The word
  // index stops at last = cap - 2, where window32 clamps its two-word
  // fetch (lim, the bit count that moves the words, is then out of
  // reach); pos keeps counting bits mod 32, as window32's does.
  __device__ __forceinline__ void advance(int len, uint32_t up) {
    pos += len;
    const bool move = pos >= lim;
    pos &= 31;
    cur = move ? nxt : cur;
    nxt = move ? after : nxt;
    after = move ? up : after;
    wnext += move ? 1 : 0;
    lim = wnext - 2 < last ? 32 : 1 << 30;
  }
};

}  // namespace repro
