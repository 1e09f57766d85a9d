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
// The TPU kernel runs its grid in order and sums x_blk @ tile into one
// resident (M, N) block, chunk by chunk.  Hopper runs blocks in no
// order, and atomics on the output would make the sum order change from
// run to run.  So the sum order here is fixed and two-level:
//   pass 1: one CTA per group of kGroup consecutive chunks.  Threads
//     0 .. 2 * chunks - 1 each walk one plane of one chunk into shared
//     memory (lo and hi bytes, 2 * kGroup * chunk bytes), then every
//     thread owns outputs (m, n) and sums, in the group's row order,
//     acc = acc + x[m, r] * W[r, n] with __fmul_rn / __fadd_rn (never
//     contracted to an FMA), and writes its group partial;
//   pass 2: one thread per output sums the group partials in group order
//     (__fadd_rn again).
// The plain version (kernels/decode_matmul.py) adds in exactly this
// order with separate float32 multiplies and adds, so the two agree bit
// for bit for any float32 x; against the reference's chunk-major sum the
// product agrees to float32 rounding.
//
// Bound on Hopper: the chain of dependent decode steps inside a chunk
// (chunk steps per plane; both planes walk in parallel), then bytes (the
// coded words) — the products are M * K * N multiply-adds of a decode
// batch, a few microseconds of the card.  The product is plain float32
// arithmetic here (no wgmma): a right kernel first.  An optional tile
// output (the decoded bf16 weight as uint16) lets a check hold the
// decoded tiles to a plain decode.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 4;       // chunks per CTA (B7/B8 pass 1)
constexpr int kReduceThreads = 256;

// x (m, k_pad) float32 times the group's decoded tile (s_lo/s_hi bytes,
// n_rows x n_cols, row-major) into partial (m, n_cols) float32.
__device__ __forceinline__ void group_product(
    const float* __restrict__ x, long long k_pad, long long k0, int n_rows,
    int n_cols, int m, const uint8_t* s_lo, const uint8_t* s_hi,
    float* __restrict__ partial) {
  const int outs = m * n_cols;
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    const int mi = o / n_cols;
    const int n = o - mi * n_cols;
    const float* xr = x + mi * k_pad + k0;
    float acc = 0.0f;
    for (int r = 0; r < n_rows; ++r) {
      const int e = r * n_cols + n;
      const uint32_t u = static_cast<uint32_t>(s_lo[e]) |
                         (static_cast<uint32_t>(s_hi[e]) << 8);
      const float w = __uint_as_float(u << 16);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(xr + r), w));
    }
    partial[o] = acc;
  }
}

__device__ __forceinline__ void write_tiles(const uint8_t* s_lo,
                                            const uint8_t* s_hi, int n,
                                            uint16_t* __restrict__ tiles) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    tiles[i] = static_cast<uint16_t>(s_lo[i] | (s_hi[i] << 8));
}

__global__ void __launch_bounds__(kThreads)
decode_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ lo_words,
                     const uint32_t* __restrict__ hi_words,
                     const int32_t* __restrict__ counts,
                     const int32_t* __restrict__ fc,   // (2, kMaxLen + 1)
                     const int32_t* __restrict__ bi,
                     const int32_t* __restrict__ nc,
                     const int32_t* __restrict__ ss,   // (2, 256)
                     float* __restrict__ partial, uint16_t* __restrict__ tiles,
                     int nb, int chunk, int cap, int rows, int n_cols, int m,
                     int max_len) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_fc[2][repro::kMaxLen + 1];
  __shared__ int32_t s_bi[2][repro::kMaxLen + 1];
  __shared__ int32_t s_nc[2][repro::kMaxLen + 1];
  __shared__ int32_t s_ss[2][256];
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
  uint8_t* s_lo = smem;
  uint8_t* s_hi = smem + kGroup * chunk;
  __syncthreads();

  const int c0 = blockIdx.x * kGroup;
  const int here = min(kGroup, nb - c0);
  if (static_cast<int>(threadIdx.x) < 2 * here) {
    const int j = threadIdx.x >> 1;
    const int p = threadIdx.x & 1;
    const long long c = c0 + j;
    repro::walk_canonical((p ? hi_words : lo_words) + c * cap,
                          min(counts[c], chunk), chunk, cap, max_len,
                          s_fc[p], s_bi[p], s_nc[p], s_ss[p], 256,
                          (p ? s_hi : s_lo) + j * chunk);
  }
  __syncthreads();
  if (tiles)
    write_tiles(s_lo, s_hi, here * chunk,
                tiles + static_cast<long long>(c0) * chunk);
  group_product(x, static_cast<long long>(nb) * rows,
                static_cast<long long>(c0) * rows, here * rows, n_cols, m,
                s_lo, s_hi,
                partial + static_cast<long long>(blockIdx.x) * m * n_cols);
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
                         uint16_t* __restrict__ tiles, int nb, int chunk,
                         int cap, int rows, int n_cols, int m) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_st[2][256];
  for (int i = threadIdx.x; i < 512; i += blockDim.x)
    s_st[i >> 8][i & 255] = st[i];
  uint8_t* s_lo = smem;
  uint8_t* s_hi = smem + kGroup * chunk;
  __syncthreads();

  const int c0 = blockIdx.x * kGroup;
  const int here = min(kGroup, nb - c0);
  if (static_cast<int>(threadIdx.x) < 2 * here) {
    const int j = threadIdx.x >> 1;
    const int p = threadIdx.x & 1;
    const long long c = c0 + j;
    repro::walk_qlc((p ? hi_words : lo_words) + c * cap,
                    min(counts[c], chunk), chunk, cap,
                    p ? hi_len_pack : lo_len_pack,
                    p ? hi_base_pack : lo_base_pack, s_st[p],
                    (p ? s_hi : s_lo) + j * chunk);
  }
  __syncthreads();
  if (tiles)
    write_tiles(s_lo, s_hi, here * chunk,
                tiles + static_cast<long long>(c0) * chunk);
  group_product(x, static_cast<long long>(nb) * rows,
                static_cast<long long>(c0) * rows, here * rows, n_cols, m,
                s_lo, s_hi,
                partial + static_cast<long long>(blockIdx.x) * m * n_cols);
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

extern "C" int decode_matmul_launch(
    const void* x, const void* lo_words, const void* hi_words,
    const void* counts, const void* fc, const void* bi, const void* nc,
    const void* ss, void* partial, void* tiles, void* out, int nb, int chunk,
    int cap, int rows, int n_cols, int m, int max_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int allowed[repro::kMaxDevices] = {};
  const int smem = 2 * kGroup * chunk;
  cudaError_t err = repro::allow_smem(decode_matmul_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = groups_of(nb);
  if (groups > 0) {
    decode_matmul_kernel<<<groups, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const uint32_t*>(lo_words),
        static_cast<const uint32_t*>(hi_words),
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(fc),
        static_cast<const int32_t*>(bi), static_cast<const int32_t*>(nc),
        static_cast<const int32_t*>(ss), static_cast<float*>(partial),
        static_cast<uint16_t*>(tiles), nb, chunk, cap, rows, n_cols, m,
        max_len);
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
  const int smem = 2 * kGroup * chunk;
  cudaError_t err =
      repro::allow_smem(decode_matmul_qlc_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = groups_of(nb);
  if (groups > 0) {
    decode_matmul_qlc_kernel<<<groups, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const uint32_t*>(lo_words),
        static_cast<const uint32_t*>(hi_words),
        static_cast<const int32_t*>(counts), lo_len_pack, lo_base_pack,
        hi_len_pack, hi_base_pack, static_cast<const int32_t*>(st),
        static_cast<float*>(partial), static_cast<uint16_t*>(tiles), nb,
        chunk, cap, rows, n_cols, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(sum_groups(static_cast<const float*>(partial),
                                     groups, m, n_cols,
                                     static_cast<float*>(out), s));
}
