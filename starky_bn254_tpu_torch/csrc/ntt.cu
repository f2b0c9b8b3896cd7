// K1: NTT along axis 0 of a row-major [n, c] Goldilocks matrix, natural
// order in and out; the inverse includes the 1/n scale.
//
// Replaces starky_bn254_tpu/pallas/ntt_kernel.py::ntt2d (_dif_kernel,
// _dit_kernel and the host tables _stage_table / _outer_table /
// _gather_perm). That kernel is a four-step transform shaped by the TPU's
// VMEM blocks and (8, 128) tiling; none of its shape gates (c % 128 == 0,
// n >= 2^6) apply here: any power-of-two n and any c, including 1-D input.
//
// Design: the radix-2 Cooley-Tukey DIT ladder of the JAX package's
// ntt._ntt_xla (bit-reversal gather, then log2(n) stages; stage s pairs rows
// i and i + 2^s with twiddle w_{2^(s+1)}^(i mod 2^s)), run in a few
// shared-memory passes instead of one HBM pass per stage. A pass runs stages
// [s_lo, s_hi); those stages only pair rows that agree in their low s_lo
// bits and their bits from s_hi up, so each block loads one tile of
// G = 2^(s_hi - s_lo) such rows x R consecutive residues x W consecutive
// columns, runs the stages with __syncthreads() between them, and writes
// the tile back. The first pass gathers its rows straight from the
// bit-reversed source rows (any row stride, so a column slice needs no
// copy) and applies the inverse's 1/n scale as it loads (the transform is
// linear and exact mod p, so scaling first gives the same residues). The
// pass plan and the per-pass twiddle tables are built in ntt.py
// (_pass_plan, _pass_twiddles) and passed in. The kernel's tile-row and
// twiddle-index formulas mirror NttPass.tile_rows and
// NttPass.twiddle_index, which the CPU tests replay with torch ops; each
// formula below names its twin, and a change to one is a change to both.
// With 64 KB tiles two passes cover n <= 2^18 at 16 columns a slab, and
// n <= 2^26 at one column.
//
// Bound: integer throughput. A [131072, 888] forward transform is
// 65536 * 17 * 888 butterflies (an add and a subtract, and a multiply
// where the twiddle is not 1; chip_smoke.py's Bounds.ntt counts them in
// the instructions of csrc/sass_probes.cu) against 2 * 0.93 GB of
// compulsory HBM traffic; the two passes move 3.7 GB. Threads run along
// the column slab (16 words: 128-byte row segments, coalesced; a half-warp
// covers one 128-byte shared-memory row, so 8-byte words meet no bank
// conflicts when W >= 16). Tiles are at most 64 KB, so three blocks share
// an SM and one block's loads overlap another's butterflies.

#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define NTT_THREADS 256

// u + v*w, u - v*w
__device__ __forceinline__ void ntt_butterfly(uint64_t& u, uint64_t& v, uint64_t w) {
  uint64_t vw = gl_mul(v, w);
  v = gl_sub(u, vw);
  u = gl_add(u, vw);
}

// One pass: stages [s_lo, s_hi) over tiles of G = 2^(s_hi - s_lo) rows x
// R = 2^log_r residues x W = 2^log_w columns; tile t of the grid is column
// slab t % n_slabs of row group t / n_slabs (NttPass.tile_rows). `tw` is
// the pass's table (_pass_twiddles). `gather`: read row bitrev(i) of `in`
// (row stride in_stride), times `scale` when do_scale; else read `out`.
__global__ void __launch_bounds__(NTT_THREADS)
ntt_pass_kernel(const uint64_t* __restrict__ in, int64_t in_stride, uint64_t* out, int64_t c,
                int log_n, int s_lo, int s_hi, int log_r, int log_w, int64_t n_slabs,
                const uint64_t* __restrict__ tw, uint64_t scale, int gather, int do_scale) {
  extern __shared__ uint64_t tile[];
  const int stages = s_hi - s_lo;
  const int log_q = log_r + log_w;  // a tile row: R residues x W columns
  const int words = 1 << (stages + log_q);
  const int q_mask = (1 << log_q) - 1;
  const int w_mask = (1 << log_w) - 1;
  const int64_t slab = blockIdx.x % n_slabs;
  const int64_t g = blockIdx.x / n_slabs;
  // NttPass.tile_rows: hi = g >> lo_bits, lo_base = (g mod 2^lo_bits) * R
  const int lo_bits = s_lo - log_r;
  const int64_t lo_base = (g & (((int64_t)1 << lo_bits) - 1)) << log_r;
  const int64_t row_base = ((g >> lo_bits) << s_hi) + lo_base;
  const int64_t col0 = slab << log_w;

  for (int e = threadIdx.x; e < words; e += NTT_THREADS) {
    const int q = e & q_mask;
    // NttPass.tile_rows: row = hi * 2^s_hi + mid * 2^s_lo + lo_base + r
    const int64_t row = row_base + ((int64_t)(e >> log_q) << s_lo) + (q >> log_w);
    const int64_t col = col0 + (q & w_mask);
    uint64_t v = 0;
    if (col < c) {
      if (gather) {
        const int64_t src = log_n ? (int64_t)(__brevll((unsigned long long)row) >> (64 - log_n)) : 0;
        v = in[src * in_stride + col];
        if (do_scale) v = gl_mul(v, scale);
      } else {
        v = out[row * c + col];
      }
    }
    tile[e] = v;
  }
  __syncthreads();

  for (int sp = 0; sp < stages; sp++) {
    const int m = 1 << sp;  // half-block, in tile rows
    // NttPass.twiddle_index: ((m - 1 + jm) << s_lo) + lo, lo = lo_base + r
    const uint64_t* tws = tw + ((int64_t)(m - 1) << s_lo) + lo_base;
#pragma unroll 4
    for (int e = threadIdx.x; e < (words >> 1); e += NTT_THREADS) {
      const int q = e & q_mask;
      const int bi = e >> log_q;
      const int jm = bi & (m - 1);
      const int i0 = ((((bi >> sp) << (sp + 1)) + jm) << log_q) + q;
      const int i1 = i0 + (m << log_q);
      uint64_t u = tile[i0], v = tile[i1];
      ntt_butterfly(u, v, gl_ldg(tws + ((int64_t)jm << s_lo) + (q >> log_w)));
      tile[i0] = u;
      tile[i1] = v;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < words; e += NTT_THREADS) {
    const int q = e & q_mask;
    const int64_t row = row_base + ((int64_t)(e >> log_q) << s_lo) + (q >> log_w);
    const int64_t col = col0 + (q & w_mask);
    if (col < c) out[row * c + col] = tile[e];
  }
}

// One pass of ntt.py::_pass_plan. in: [n, c] with row stride in_stride
// (words), read only when `gather`; out: contiguous [n, c], distinct from
// in. Returns the launch's CUDA error, 0 on success. Allocates nothing, no
// sync.
extern "C" int starky_ntt_pass(const uint64_t* in, int64_t in_stride, uint64_t* out, int64_t n,
                               int64_t c, int log_n, int s_lo, int s_hi, int log_r, int log_w,
                               const uint64_t* tw, uint64_t scale, int gather, int do_scale,
                               cudaStream_t stream) {
  const int log_tile = s_hi - s_lo + log_r + log_w;
  const size_t smem = (size_t)8 << log_tile;
  const int64_t n_slabs = (c + ((int64_t)1 << log_w) - 1) >> log_w;
  const int64_t blocks = (n >> (s_hi - s_lo + log_r)) * n_slabs;
  if (blocks < 1 || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {  // the attribute is per device: set it on the current one every time
    cudaError_t err = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ntt_pass_kernel<<<(unsigned)blocks, NTT_THREADS, smem, stream>>>(
      in, in_stride, out, c, log_n, s_lo, s_hi, log_r, log_w, n_slabs, tw, scale, gather,
      do_scale);
  return (int)cudaGetLastError();
}
