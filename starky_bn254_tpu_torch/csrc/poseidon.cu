// K3: Poseidon (width 12, rate 8, x^7 S-box, 4 full + 22 partial + 4 full
// rounds) overwrite-mode sponge absorb, one thread per row, plus the fused
// proof-of-work grind.
//
// Replaces starky_bn254_tpu/pallas/poseidon_kernel.py::sponge_absorb
// (_sponge_kernel, _permute, _mds, _mds_consts, _rc_u32) and the grind
// batch of starky_bn254_tpu/stark/fri.py::_grind_scan that calls it as a
// raw batched permutation. The Pallas kernel evaluates the MDS in 'shift'
// or 'mul16' form on u32 pairs (a TPU VPU trick); here the state is 12
// uint64_t registers and the MDS is a plain dense mulmod matvec. Round
// constants [30, 12] and the dense MDS [12, 12] come from the port's
// poseidon._constants() as device tables at every launch, so set_params
// takes effect without a rebuild; each block copies them to shared memory.
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
// Bound: integer multiply throughput. One permutation is 30 * 144 dense
// mulmods for the MDS plus the S-boxes (~4.5k 64x64->128 products), against
// 96 bytes read and written per row; the grind reads nothing. A sparse
// partial-round MDS or the small-constant circulant would cut the
// multiplies; that is later work.

#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define PSN_WIDTH 12
#define PSN_RATE 8
#define PSN_HALF 4
#define PSN_PARTIAL 22
#define PSN_ROUNDS 30

__device__ __forceinline__ uint64_t psn_sbox(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x4 = gl_mul(x2, x2);
  uint64_t x6 = gl_mul(x4, x2);
  return gl_mul(x6, x);
}

__device__ __forceinline__ void psn_mds(uint64_t s[PSN_WIDTH], const uint64_t* mds) {
  uint64_t t[PSN_WIDTH];
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < PSN_WIDTH; j++) acc = gl_add(acc, gl_mul(mds[i * PSN_WIDTH + j], s[j]));
    t[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) s[i] = t[i];
}

__device__ __forceinline__ void psn_permute(uint64_t s[PSN_WIDTH], const uint64_t* rc,
                                            const uint64_t* mds) {
#pragma unroll 1
  for (int r = 0; r < PSN_ROUNDS; r++) {
#pragma unroll
    for (int i = 0; i < PSN_WIDTH; i++) s[i] = gl_add(s[i], rc[r * PSN_WIDTH + i]);
    if (r < PSN_HALF || r >= PSN_HALF + PSN_PARTIAL) {
#pragma unroll
      for (int i = 0; i < PSN_WIDTH; i++) s[i] = psn_sbox(s[i]);
    } else {
      s[0] = psn_sbox(s[0]);
    }
    psn_mds(s, mds);
  }
}

// copy the round constants and the MDS into shared memory (block-wide)
__device__ __forceinline__ void psn_load_tables(uint64_t* sh, const uint64_t* rc,
                                                const uint64_t* mds) {
  for (int i = threadIdx.x; i < PSN_ROUNDS * PSN_WIDTH; i += blockDim.x) sh[i] = rc[i];
  for (int i = threadIdx.x; i < PSN_WIDTH * PSN_WIDTH; i += blockDim.x)
    sh[PSN_ROUNDS * PSN_WIDTH + i] = mds[i];
  __syncthreads();
}

__global__ void poseidon_sponge_kernel(const uint64_t* __restrict__ state_in,
                                       const uint64_t* __restrict__ block, int64_t n,
                                       int64_t width, int64_t row_stride,
                                       const uint64_t* __restrict__ rc,
                                       const uint64_t* __restrict__ mds,
                                       uint64_t* __restrict__ out, int out_words) {
  __shared__ uint64_t tables[PSN_ROUNDS * PSN_WIDTH + PSN_WIDTH * PSN_WIDTH];
  psn_load_tables(tables, rc, mds);
  const uint64_t* s_rc = tables;
  const uint64_t* s_mds = tables + PSN_ROUNDS * PSN_WIDTH;
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; row < n;
       row += (int64_t)gridDim.x * blockDim.x) {
    uint64_t s[PSN_WIDTH];
#pragma unroll
    for (int i = 0; i < PSN_WIDTH; i++) s[i] = state_in ? state_in[row * PSN_WIDTH + i] : 0;
    const uint64_t* src = block + row * row_stride;
    for (int64_t off = 0; off < width; off += PSN_RATE) {
#pragma unroll
      for (int i = 0; i < PSN_RATE; i++) s[i] = off + i < width ? src[off + i] : 0;
      psn_permute(s, s_rc, s_mds);
    }
#pragma unroll
    for (int i = 0; i < PSN_WIDTH; i++)
      if (i < out_words) out[row * out_words + i] = s[i];
  }
}

__global__ void poseidon_grind_kernel(uint64_t seed, uint64_t start, int64_t batch,
                                      uint64_t threshold, const uint64_t* __restrict__ rc,
                                      const uint64_t* __restrict__ mds,
                                      unsigned long long* result) {
  __shared__ uint64_t tables[PSN_ROUNDS * PSN_WIDTH + PSN_WIDTH * PSN_WIDTH];
  psn_load_tables(tables, rc, mds);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < batch;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint64_t s[PSN_WIDTH];
#pragma unroll
    for (int k = 0; k < PSN_WIDTH; k++) s[k] = 0;
    s[0] = seed;
    s[1] = start + (uint64_t)i;
    psn_permute(s, tables, tables + PSN_ROUNDS * PSN_WIDTH);
    if (s[0] < threshold) atomicMin(result, (unsigned long long)i);
  }
}

static inline unsigned psn_blocks(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 30)) blocks = 1 << 30;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// state_in: [n, 12] or NULL (zero state); block: [n, width], row stride
// row_stride words; rc: [30 * 12]; mds: [12 * 12]; out: [n, out_words]
// with out_words 12 or 4. Allocates nothing, no sync.
extern "C" int starky_poseidon_sponge(const uint64_t* state_in, const uint64_t* block,
                                      int64_t n, int64_t width, int64_t row_stride,
                                      const uint64_t* rc, const uint64_t* mds,
                                      uint64_t* out, int out_words, cudaStream_t stream) {
  const int threads = 128;
  poseidon_sponge_kernel<<<psn_blocks(n, threads), threads, 0, stream>>>(
      state_in, block, n, width, row_stride, rc, mds, out, out_words);
  return (int)cudaGetLastError();
}

// result: one word, preset by the caller to `batch` (no hit).
extern "C" int starky_poseidon_grind(uint64_t seed, uint64_t start, int64_t batch,
                                     uint64_t threshold, const uint64_t* rc,
                                     const uint64_t* mds, uint64_t* result,
                                     cudaStream_t stream) {
  const int threads = 128;
  poseidon_grind_kernel<<<psn_blocks(batch, threads), threads, 0, stream>>>(
      seed, start, batch, threshold, rc, mds, (unsigned long long*)result);
  return (int)cudaGetLastError();
}
