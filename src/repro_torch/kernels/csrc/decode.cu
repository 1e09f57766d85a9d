// Kernels B3 and B4: chunked canonical Huffman decode; kernel B6:
// chunked QLC decode.
//
// B3 replaces repro/kernels/decode.py::decode_chunks_pallas
// (_decode_kernel): per chunk, a canonical-prefix walk of one symbol a
// step (16-bit window, first_code subtraction for every length,
// sorted_symbols[base_index[l] + off]).
//
// B4 replaces repro/kernels/decode.py::decode_chunks_multisym_pallas
// (_decode_multisym_kernel): a K = 13 bit window LUT that emits up to
// s_max = 8 symbols a step, with an inline canonical slow path for the
// windows whose first code is 14..16 bits long.
//
// Bound on Hopper: neither bytes nor operations but the dependent chain
// inside a chunk.  Each step needs the previous step's bit position, so
// a chunk of 2048 symbols is 2048 dependent steps for B3 and about
// 2048 / s_bar for B4 (s_bar symbols per window); the words read and the
// symbols written are a few MB per plane, microseconds at 3.35 TB/s.
// Design: chunks are independent, so one thread walks one chunk, and
// CTAs are one warp (32 chunks) so that a plane's 500 chunks spread over
// 16 SMs instead of 4.  The canonical tables (3 x 17 + 256 int32) sit
// in shared memory.  B4's LUT does not fit Hopper's 227 KB as the
// reference's int32 (288 KB), so the wrapper converts it once per book
// to syms uint8 (64 KB) and meta uint16 (16 KB): 80 KB of dynamic
// shared memory.  Output slots past each chunk's count are written 0.
// Both are simple and right first; their time is far above the bound
// (a plane fills a fraction of the card), which is later work.
//
// B6 replaces repro/kernels/decode.py::decode_chunks_qlc_pallas
// (_decode_qlc_kernel): the table-free QLC walk, one symbol a step, the
// class from the window's top 2 bits, its length and base from two
// packed scalars (kernel arguments, so registers), the symbol from a
// 256-entry table in shared memory (1 KB).  Bound as B3: the chain of
// dependent steps inside a chunk.  Same scaffolding as B3 (one thread a
// chunk, one warp a CTA); with 1 KB of shared memory a CTA, an SM holds
// up to 32 of them, so a store leaf's many chunks fill the card.
#include "common.cuh"

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

__global__ void __launch_bounds__(kThreads)
decode_canonical_kernel(const uint32_t* __restrict__ words,
                        const int32_t* __restrict__ counts,
                        const int32_t* __restrict__ fc,
                        const int32_t* __restrict__ bi,
                        const int32_t* __restrict__ nc,
                        const int32_t* __restrict__ ss, int n_ss,
                        int32_t* __restrict__ out, int nb, int chunk,
                        int cap, int max_len) {
  __shared__ int32_t s_fc[repro::kMaxLen + 1];
  __shared__ int32_t s_bi[repro::kMaxLen + 1];
  __shared__ int32_t s_nc[repro::kMaxLen + 1];
  __shared__ int32_t s_ss[256];
  load_canonical(fc, bi, nc, ss, n_ss, max_len, s_fc, s_bi, s_nc, s_ss);
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nb) return;
  const uint32_t* w = words + static_cast<long long>(c) * cap;
  int32_t* o = out + static_cast<long long>(c) * chunk;
  repro::walk_canonical(w, min(counts[c], chunk), chunk, cap, max_len, s_fc,
                        s_bi, s_nc, s_ss, n_ss, o);
}

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
                                       const void* fc, const void* bi,
                                       const void* nc, const void* ss,
                                       int n_ss, void* out, int nb, int chunk,
                                       int cap, int max_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb > 0) {
    int grid = (nb + kThreads - 1) / kThreads;
    decode_canonical_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(fc),
        static_cast<const int32_t*>(bi), static_cast<const int32_t*>(nc),
        static_cast<const int32_t*>(ss), n_ss, static_cast<int32_t*>(out),
        nb, chunk, cap, max_len);
  }
  return static_cast<int>(cudaGetLastError());
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
