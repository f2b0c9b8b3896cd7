// K3: Poseidon (width 12, rate 8, x^7 S-box, 4 full + 22 partial + 4 full
// rounds) overwrite-mode sponge absorb, plus the fused proof-of-work grind.
//
// Replaces starky_bn254_tpu/pallas/poseidon_kernel.py::sponge_absorb
// (_sponge_kernel, _permute, _mds, _mds_consts, _rc_u32) and the grind
// batch of starky_bn254_tpu/stark/fri.py::_grind_scan that calls it as a
// raw batched permutation.
//
// The MDS matrix is circ(row) + diag(diag) (poseidon.py). When every entry
// is <= 2^16 (poseidon._small_mds, the default parameters) it runs in the
// small-constant form of the TPU kernel's 'shift'/'mul16' paths and of
// poseidon._mds_layer: each output sums row[d] times the 32-bit halves of
// its 12 inputs, plus the diagonal term, in two 64-bit accumulators (13
// terms < 2^48 each, so the sums stay < 2^53 and exact), then one
// gl_reduce128: 24 IMAD.WIDE.U32 and one reduction per output instead of
// 12 modular products. Larger entries take the dense form: 13 gl_mul and
// 12 gl_add per output. `row` and `diag` come in as device tables, with the
// round constants, at every launch, so set_params takes effect without a
// rebuild. The S-box x^7 is x^3 * x^4 (three multiplies deep).
//
// Two layouts of the state, chosen by poseidon._sponge_form from the row
// count:
// - poseidon_sponge_kernel: one thread per row, the state in 12 registers.
//   For batches that fill the card (Merkle leaves, the grind).
// - poseidon_coop_kernel: one state per 16 lanes, lane i holding word i
//   (lanes 12..15 shadow lanes 0..3 so every shuffle has a full warp); each
//   lane does its own S-box and gathers its MDS inputs with __shfl_sync.
//   For the challenger's vector digests and the tree levels near the cap:
//   1 to 27 rows of 16 chained permutations, where the time is the latency
//   of one serial chain, which this cuts by spreading a round over 12 lanes.
//
// starky_poseidon_sponge: ceil(width / 8) chunks overwrite lanes 0..7 (the
// words past `width` in the last chunk are zero, which is poseidon.py's
// zero-padded tail), each followed by a permutation. A raw permutation is
// the absorb of a state's own first 8 lanes.
//
// starky_poseidon_grind: thread i builds [seed, start + i, 0, ...],
// permutes, and if lane 0 < threshold lowers *result to i with atomicMin, so
// *result ends as the LOWEST hit index in the batch, which is the index
// jnp.argmax picks in the JAX grind: the nonce is the same.
//
// Bound: integer throughput (a permutation reads and writes at most 96
// bytes a row, the grind none). A permutation's work is 360 round-constant
// adds, 472 multiplies (118 S-boxes) and 30 MDS layers; chip_smoke.py's
// Bounds counts their instructions in csrc/sass_probes.cu. As this kernel
// runs them in the small-constant form, a full round is 2496 SASS integer
// instructions and a partial round 1223, ~47k a permutation; a dense
// matvec's 144 products alone are 144 * 32 = 4608 a round.

#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define PSN_WIDTH 12
#define PSN_RATE 8
#define PSN_HALF 4
#define PSN_PARTIAL 22
#define PSN_ROUNDS 30
#define PSN_RC_WORDS (PSN_ROUNDS * PSN_WIDTH)
#define PSN_THREADS 128
#define PSN_GROUP 16  // lanes per state in the cooperative form

// x^7 = x^3 * x^4: gl_mul returns the canonical residue, so the grouping
// changes no bit of the result
__device__ __forceinline__ uint64_t psn_sbox(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x3 = gl_mul(x2, x);
  uint64_t x4 = gl_mul(x2, x2);
  return gl_mul(x3, x4);
}

// a * 2^32 + b (mod p), for the small-constant MDS half-sums a, b < 2^53
__device__ __forceinline__ uint64_t psn_mds_finish(uint64_t a, uint64_t b) {
  uint64_t lo_part = a << 32;
  uint64_t v_lo = lo_part + b;
  return gl_reduce128((a >> 32) + (v_lo < lo_part ? 1 : 0), v_lo);
}

__device__ __forceinline__ int psn_wrap(int k) { return k < PSN_WIDTH ? k : k - PSN_WIDTH; }

// ---- one thread per state -------------------------------------------------

// small-constant form: row, diag entries <= 2^16
__device__ __forceinline__ void psn_mds(uint64_t s[PSN_WIDTH], const uint32_t row[PSN_WIDTH],
                                        const uint32_t diag[PSN_WIDTH]) {
  uint64_t t[PSN_WIDTH];
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) {
    uint64_t lo = (uint64_t)diag[i] * (uint32_t)s[i];
    uint64_t hi = (uint64_t)diag[i] * (uint32_t)(s[i] >> 32);
#pragma unroll
    for (int d = 0; d < PSN_WIDTH; d++) {
      const uint64_t v = s[(i + d) % PSN_WIDTH];
      lo += (uint64_t)row[d] * (uint32_t)v;
      hi += (uint64_t)row[d] * (uint32_t)(v >> 32);
    }
    t[i] = psn_mds_finish(hi, lo);
  }
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) s[i] = t[i];
}

// dense form: any canonical entries
__device__ __forceinline__ void psn_mds(uint64_t s[PSN_WIDTH], const uint64_t row[PSN_WIDTH],
                                        const uint64_t diag[PSN_WIDTH]) {
  uint64_t t[PSN_WIDTH];
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) {
    uint64_t acc = gl_mul(diag[i], s[i]);
#pragma unroll
    for (int d = 0; d < PSN_WIDTH; d++) acc = gl_add(acc, gl_mul(row[d], s[(i + d) % PSN_WIDTH]));
    t[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) s[i] = t[i];
}

template <typename Row>
__device__ __forceinline__ void psn_full_round(uint64_t s[PSN_WIDTH], const uint64_t* rc,
                                               const Row row[PSN_WIDTH],
                                               const Row diag[PSN_WIDTH]) {
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) s[i] = psn_sbox(gl_add(s[i], rc[i]));
  psn_mds(s, row, diag);
}

template <typename Row>
__device__ __forceinline__ void psn_partial_round(uint64_t s[PSN_WIDTH], const uint64_t* rc,
                                                  const Row row[PSN_WIDTH],
                                                  const Row diag[PSN_WIDTH]) {
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) s[i] = gl_add(s[i], rc[i]);
  s[0] = psn_sbox(s[0]);
  psn_mds(s, row, diag);
}

template <typename Row>
__device__ __forceinline__ void psn_permute(uint64_t s[PSN_WIDTH], const uint64_t* rc,
                                            const Row row[PSN_WIDTH], const Row diag[PSN_WIDTH]) {
  int r = 0;
#pragma unroll 1
  for (; r < PSN_HALF; r++) psn_full_round(s, rc + r * PSN_WIDTH, row, diag);
#pragma unroll 1
  for (; r < PSN_HALF + PSN_PARTIAL; r++) psn_partial_round(s, rc + r * PSN_WIDTH, row, diag);
#pragma unroll 1
  for (; r < PSN_ROUNDS; r++) psn_full_round(s, rc + r * PSN_WIDTH, row, diag);
}

// round constants into shared memory (block-wide), row and diag into
// registers (Row = uint32_t: small-constant form; uint64_t: dense)
template <typename Row>
__device__ __forceinline__ void psn_load_tables(uint64_t* s_rc, const uint64_t* rc,
                                                const uint64_t* row_tab, const uint64_t* diag_tab,
                                                Row row[PSN_WIDTH], Row diag[PSN_WIDTH]) {
  for (int i = threadIdx.x; i < PSN_RC_WORDS; i += blockDim.x) s_rc[i] = rc[i];
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) {
    row[i] = (Row)gl_ldg(row_tab + i);
    diag[i] = (Row)gl_ldg(diag_tab + i);
  }
  __syncthreads();
}

template <typename Row>
__global__ void __launch_bounds__(PSN_THREADS)
poseidon_sponge_kernel(const uint64_t* __restrict__ state_in, const uint64_t* __restrict__ block,
                       int64_t n, int64_t width, int64_t row_stride,
                       const uint64_t* __restrict__ rc, const uint64_t* __restrict__ row_tab,
                       const uint64_t* __restrict__ diag_tab, uint64_t* __restrict__ out,
                       int out_words) {
  __shared__ uint64_t s_rc[PSN_RC_WORDS];
  Row row[PSN_WIDTH], diag[PSN_WIDTH];
  psn_load_tables(s_rc, rc, row_tab, diag_tab, row, diag);
  for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < n;
       r += (int64_t)gridDim.x * blockDim.x) {
    uint64_t s[PSN_WIDTH];
#pragma unroll
    for (int i = 0; i < PSN_WIDTH; i++) s[i] = state_in ? state_in[r * PSN_WIDTH + i] : 0;
    const uint64_t* src = block + r * row_stride;
    for (int64_t off = 0; off < width; off += PSN_RATE) {
#pragma unroll
      for (int i = 0; i < PSN_RATE; i++) s[i] = off + i < width ? src[off + i] : 0;
      psn_permute(s, s_rc, row, diag);
    }
#pragma unroll
    for (int i = 0; i < PSN_WIDTH; i++)
      if (i < out_words) out[r * out_words + i] = s[i];
  }
}

template <typename Row>
__global__ void __launch_bounds__(PSN_THREADS)
poseidon_grind_kernel(uint64_t seed, uint64_t start, int64_t batch, uint64_t threshold,
                      const uint64_t* __restrict__ rc, const uint64_t* __restrict__ row_tab,
                      const uint64_t* __restrict__ diag_tab, unsigned long long* result) {
  __shared__ uint64_t s_rc[PSN_RC_WORDS];
  Row row[PSN_WIDTH], diag[PSN_WIDTH];
  psn_load_tables(s_rc, rc, row_tab, diag_tab, row, diag);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < batch;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint64_t s[PSN_WIDTH];
#pragma unroll
    for (int k = 0; k < PSN_WIDTH; k++) s[k] = 0;
    s[0] = seed;
    s[1] = start + (uint64_t)i;
    psn_permute(s, s_rc, row, diag);
    if (s[0] < threshold) atomicMin(result, (unsigned long long)i);
  }
}

// ---- one state per 16 lanes ----------------------------------------------

__device__ __forceinline__ uint64_t psn_shfl(uint64_t v, int lane) {
  return (uint64_t)__shfl_sync(0xffffffffu, (unsigned long long)v, lane, PSN_GROUP);
}

// output word i of the MDS, small-constant form
__device__ __forceinline__ uint64_t psn_mds_lane(uint64_t x, int i, const uint32_t row[PSN_WIDTH],
                                                 uint32_t my_diag) {
  uint64_t lo = (uint64_t)my_diag * (uint32_t)x;
  uint64_t hi = (uint64_t)my_diag * (uint32_t)(x >> 32);
#pragma unroll
  for (int d = 0; d < PSN_WIDTH; d++) {
    const uint64_t v = psn_shfl(x, psn_wrap(i + d));
    lo += (uint64_t)row[d] * (uint32_t)v;
    hi += (uint64_t)row[d] * (uint32_t)(v >> 32);
  }
  return psn_mds_finish(hi, lo);
}

// output word i of the MDS, dense form
__device__ __forceinline__ uint64_t psn_mds_lane(uint64_t x, int i, const uint64_t row[PSN_WIDTH],
                                                 uint64_t my_diag) {
  uint64_t acc = gl_mul(my_diag, x);
#pragma unroll
  for (int d = 0; d < PSN_WIDTH; d++) acc = gl_add(acc, gl_mul(row[d], psn_shfl(x, psn_wrap(i + d))));
  return acc;
}

template <typename Row>
__global__ void __launch_bounds__(PSN_THREADS)
poseidon_coop_kernel(const uint64_t* __restrict__ state_in, const uint64_t* __restrict__ block,
                     int64_t n, int64_t width, int64_t row_stride,
                     const uint64_t* __restrict__ rc, const uint64_t* __restrict__ row_tab,
                     const uint64_t* __restrict__ diag_tab, uint64_t* __restrict__ out,
                     int out_words) {
  __shared__ uint64_t s_rc[PSN_RC_WORDS];
  Row row[PSN_WIDTH], diag[PSN_WIDTH];
  psn_load_tables(s_rc, rc, row_tab, diag_tab, row, diag);
  const int lane = threadIdx.x & (PSN_GROUP - 1);
  const int i = psn_wrap(lane);  // the state word this lane holds
  const Row my_diag = (Row)gl_ldg(diag_tab + i);
  const int per_warp = 32 / PSN_GROUP;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  // every lane of a warp runs every iteration (the shuffles name the whole
  // warp); a group past the last row computes on zeros and stores nothing
  for (int64_t base = warp * per_warp; base < n; base += n_warps * per_warp) {
    const int64_t r = base + ((threadIdx.x >> 4) & (per_warp - 1));
    const bool valid = r < n;
    uint64_t x = valid && state_in ? state_in[r * PSN_WIDTH + i] : 0;
    const uint64_t* src = block + (valid ? r : 0) * row_stride;
    for (int64_t off = 0; off < width; off += PSN_RATE) {
      if (i < PSN_RATE) x = valid && off + i < width ? src[off + i] : 0;
#pragma unroll 1
      for (int k = 0; k < PSN_ROUNDS; k++) {
        x = gl_add(x, s_rc[k * PSN_WIDTH + i]);
        if (i == 0 || k < PSN_HALF || k >= PSN_HALF + PSN_PARTIAL) x = psn_sbox(x);
        x = psn_mds_lane(x, i, row, my_diag);
      }
    }
    if (valid && lane < out_words) out[r * out_words + lane] = x;
  }
}

// ---- entry points -----------------------------------------------------------

static inline unsigned psn_blocks(int64_t threads_needed) {
  int64_t blocks = (threads_needed + PSN_THREADS - 1) / PSN_THREADS;
  if (blocks > (1 << 30)) blocks = 1 << 30;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// state_in: [n, 12] or NULL (zero state); block: [n, width], row stride
// row_stride words; rc: [30 * 12]; row, diag: [12] (the MDS is
// circ(row) + diag(diag)); out: [n, out_words], out_words 12 or 4.
// small: every row and diag entry <= 2^16; coop: one state per 16 lanes.
// Allocates nothing, no sync.
extern "C" int starky_poseidon_sponge(const uint64_t* state_in, const uint64_t* block, int64_t n,
                                      int64_t width, int64_t row_stride, const uint64_t* rc,
                                      const uint64_t* row, const uint64_t* diag, uint64_t* out,
                                      int out_words, int small, int coop, cudaStream_t stream) {
  if (coop) {
    const unsigned blocks = psn_blocks(n * PSN_GROUP);
    if (small)
      poseidon_coop_kernel<uint32_t><<<blocks, PSN_THREADS, 0, stream>>>(
          state_in, block, n, width, row_stride, rc, row, diag, out, out_words);
    else
      poseidon_coop_kernel<uint64_t><<<blocks, PSN_THREADS, 0, stream>>>(
          state_in, block, n, width, row_stride, rc, row, diag, out, out_words);
  } else {
    const unsigned blocks = psn_blocks(n);
    if (small)
      poseidon_sponge_kernel<uint32_t><<<blocks, PSN_THREADS, 0, stream>>>(
          state_in, block, n, width, row_stride, rc, row, diag, out, out_words);
    else
      poseidon_sponge_kernel<uint64_t><<<blocks, PSN_THREADS, 0, stream>>>(
          state_in, block, n, width, row_stride, rc, row, diag, out, out_words);
  }
  return (int)cudaGetLastError();
}

// result: one word, preset by the caller to `batch` (no hit).
extern "C" int starky_poseidon_grind(uint64_t seed, uint64_t start, int64_t batch,
                                     uint64_t threshold, const uint64_t* rc, const uint64_t* row,
                                     const uint64_t* diag, int small, uint64_t* result,
                                     cudaStream_t stream) {
  if (small)
    poseidon_grind_kernel<uint32_t><<<psn_blocks(batch), PSN_THREADS, 0, stream>>>(
        seed, start, batch, threshold, rc, row, diag, (unsigned long long*)result);
  else
    poseidon_grind_kernel<uint64_t><<<psn_blocks(batch), PSN_THREADS, 0, stream>>>(
        seed, start, batch, threshold, rc, row, diag, (unsigned long long*)result);
  return (int)cudaGetLastError();
}
