// Goldilocks field operations over strided, broadcast operands: one launch
// for each add, sub, mul, neg, mul_const and sum_mod that goldilocks.py runs
// on a CUDA tensor.
//
// Replaces no Pallas kernel. The JAX package left these ops to XLA, which
// fuses them inside its jitted segments (starky_bn254_tpu/stark/
// composition.py:1-30). The port runs the constraint eval eagerly, and each
// op of goldilocks.py's torch engine is a chain of 10-46 int64 torch
// kernels, each a launch and a full pass over the block. Here each op is one
// launch that reads its operands once and writes one word an element.
//
// Bound: memory. An elementwise op moves 8 bytes an operand read (a
// broadcast operand once, a host scalar not at all) and 8 bytes an output
// word; sum_mod reads its input once and writes its outputs. At the
// composition's shapes ([B, k] lanes, B = 131072 rows at g1, 16384 at Fq12)
// an op is 1-50 MB, 0.3-15 us at 3.35 TB/s: shorter than the launch, so the
// design keeps the host's side short (one ctypes call, the layout in one
// struct) and the device's simple (a grid-stride loop, one thread a word).
//
// Layout: the wrapper (goldilocks._layout) broadcasts the operands to the
// output's shape, drops its size-1 dims and merges neighbours every operand
// steps through as one, leaving at most 4 dims. Each operand has its own
// strides in words (0 along a broadcast dim), so a column slice of a row
// block is read in place; a null pointer stands for a host scalar, passed by
// value. The output is contiguous. Index arithmetic is 32-bit (the wrapper
// takes fewer than 2^31 words); offsets are 64-bit.
//
// Arithmetic: the torch engine's formulas step by step on uint64_t, so every
// 64-bit input word, canonical or not, gives the plain version's word:
// add/sub/reduce are goldilocks.cuh's (the same branchless steps), mul is
// the exact 128-bit product (what _mul128 assembles from 32-bit halves) then
// the same reduction, mul_const(c) with c < 2^32 the same as mul by c, neg
// maps 0 to 0 and any other word to p - a mod 2^64 (not sub(0, a), which
// differs on words above p). sum_mod accumulates an exact 128-bit sum an
// output word, the value the plain version's two 32-bit half-sums
// recombine, then reduces it once.
//
// sum_mod: one thread an output word walks the reduced axis when the outputs
// fill the card or the axis is short (the composition's lane sums, [B, k]
// over k). Few outputs over a long axis (the openings' [rows, 32] over rows)
// split it: 32 x 8 threads a block, blockIdx.y one of `splits` slices of
// the axis; a block writes its 128-bit partials to scratch, and the last
// block of an output tile to arrive (an atomic counter, zeroed before the
// launch) adds them, its 8 lanes a word, and writes the words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

#define FIELD_MAX_DIMS 4

enum { FIELD_ADD = 0, FIELD_SUB = 1, FIELD_MUL = 2, FIELD_NEG = 3 };
enum { UNARY_NEG = 0, UNARY_MUL_CONST = 1 };

// the wrapper's layout, 14 int64 words: dims, output words, then per dim
// (outermost first) the size and each operand's stride
struct FieldLayout {
  int64_t ndim, numel;
  int64_t size[FIELD_MAX_DIMS];
  int64_t sa[FIELD_MAX_DIMS];
  int64_t sb[FIELD_MAX_DIMS];
};

template <int OP>
__device__ __forceinline__ uint64_t field_apply(uint64_t a, uint64_t b) {
  if (OP == FIELD_ADD) return gl_add(a, b);
  if (OP == FIELD_SUB) return gl_sub(a, b);
  if (OP == FIELD_MUL) return gl_mul(a, b);
  return a == 0 ? 0 : GL_P - a;  // FIELD_NEG
}

// offsets of output word i in two operands
template <int NDIM>
__device__ __forceinline__ void field_offsets(uint32_t i, const FieldLayout& L, int64_t& oa,
                                              int64_t& ob) {
  oa = 0;
  ob = 0;
#pragma unroll
  for (int d = NDIM - 1; d >= 0; d--) {
    uint32_t c = i;
    if (d > 0) {
      uint32_t s = (uint32_t)L.size[d];
      c = i % s;
      i /= s;
    }
    oa += (int64_t)c * L.sa[d];
    ob += (int64_t)c * L.sb[d];
  }
}

template <int OP, int NDIM>
__global__ void field_elementwise_kernel(const uint64_t* __restrict__ a, uint64_t a_word,
                                         const uint64_t* __restrict__ b, uint64_t b_word,
                                         uint64_t* __restrict__ out, FieldLayout L) {
  const uint32_t n = (uint32_t)L.numel;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    int64_t oa, ob;
    field_offsets<NDIM>(i, L, oa, ob);
    uint64_t x = a ? gl_ldg(a + oa) : a_word;
    uint64_t y = b ? gl_ldg(b + ob) : b_word;
    out[i] = field_apply<OP>(x, y);
  }
}

// hi:lo += h:l, exact mod 2^128
__device__ __forceinline__ void add128(uint64_t& hi, uint64_t& lo, uint64_t h, uint64_t l) {
  lo += l;
  hi += h + (lo < l);
}

// blockDim (tx, ty): tx output words, ty lanes along the reduced axis;
// gridDim (tiles of tx outputs, splits)
template <int NDIM>
__global__ void field_sum_kernel(const uint64_t* __restrict__ x, FieldLayout L, int64_t n,
                                 int64_t red_stride, uint64_t* __restrict__ out,
                                 uint64_t* partial, unsigned int* counters) {
  __shared__ uint64_t s_lo[256], s_hi[256];
  __shared__ bool last;
  const uint32_t m = (uint32_t)L.numel;
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const uint32_t splits = gridDim.y;
  const uint32_t o = blockIdx.x * TX + tx;
  uint64_t lo = 0, hi = 0;
  if (o < m) {
    int64_t base, unused;
    field_offsets<NDIM>(o, L, base, unused);
    for (int64_t j = (int64_t)blockIdx.y * TY + ty; j < n; j += (int64_t)splits * TY) {
      uint64_t v = gl_ldg(x + base + j * red_stride);
      lo += v;
      hi += (lo < v);
    }
  }
  if (TY > 1) {
    s_lo[ty * TX + tx] = lo;
    s_hi[ty * TX + tx] = hi;
    __syncthreads();
    if (ty == 0)
      for (int k = 1; k < TY; k++) add128(hi, lo, s_hi[k * TX + tx], s_lo[k * TX + tx]);
  }
  if (splits == 1) {
    if (ty == 0 && o < m) out[o] = gl_reduce128(hi, lo);
    return;
  }
  if (ty == 0 && o < m) {
    partial[2 * ((uint64_t)blockIdx.y * m + o)] = lo;
    partial[2 * ((uint64_t)blockIdx.y * m + o) + 1] = hi;
  }
  __threadfence();
  __syncthreads();
  if (tx == 0 && ty == 0) last = atomicAdd(&counters[blockIdx.x], 1u) == splits - 1;
  __syncthreads();
  if (!last) return;
  // the last block of the tile: its ty lanes add the tile's partials
  lo = hi = 0;
  if (o < m) {
    for (uint32_t g = ty; g < splits; g += TY) {
      const unsigned long long* p = (const unsigned long long*)partial + 2 * ((uint64_t)g * m + o);
      add128(hi, lo, __ldcg(p + 1), __ldcg(p));
    }
  }
  s_lo[ty * TX + tx] = lo;
  s_hi[ty * TX + tx] = hi;
  __syncthreads();
  if (ty != 0 || o >= m) return;
  for (int k = 1; k < TY; k++) add128(hi, lo, s_hi[k * TX + tx], s_lo[k * TX + tx]);
  out[o] = gl_reduce128(hi, lo);
}

template <int OP>
static void field_launch(const uint64_t* a, uint64_t a_word, const uint64_t* b, uint64_t b_word,
                         uint64_t* out, const FieldLayout& L, int sms, cudaStream_t stream) {
  const int threads = 256;
  int64_t want = (L.numel + threads - 1) / threads;
  if (want > (int64_t)sms * 32) want = (int64_t)sms * 32;  // grid-stride beyond 32 blocks an SM
  const int blocks = want < 1 ? 1 : (int)want;
  switch (L.ndim) {
    case 4: field_elementwise_kernel<OP, 4><<<blocks, threads, 0, stream>>>(a, a_word, b, b_word, out, L); break;
    case 3: field_elementwise_kernel<OP, 3><<<blocks, threads, 0, stream>>>(a, a_word, b, b_word, out, L); break;
    case 2: field_elementwise_kernel<OP, 2><<<blocks, threads, 0, stream>>>(a, a_word, b, b_word, out, L); break;
    default: field_elementwise_kernel<OP, 1><<<blocks, threads, 0, stream>>>(a, a_word, b, b_word, out, L);
  }
}

// out = a (op) b over the layout; a null a or b is the host word a_word or
// b_word. op: FIELD_ADD, FIELD_SUB, FIELD_MUL. sms: the card's SM count (the
// grid's cap). Allocates nothing, no sync.
extern "C" int starky_field_binary(int op, const uint64_t* a, uint64_t a_word, const uint64_t* b,
                                   uint64_t b_word, uint64_t* out, const int64_t* layout, int sms,
                                   cudaStream_t stream) {
  FieldLayout L = *(const FieldLayout*)layout;
  if (L.ndim < 0 || L.ndim > FIELD_MAX_DIMS || op < FIELD_ADD || op > FIELD_MUL || sms < 1)
    return (int)cudaErrorInvalidValue;
  if (op == FIELD_ADD) field_launch<FIELD_ADD>(a, a_word, b, b_word, out, L, sms, stream);
  if (op == FIELD_SUB) field_launch<FIELD_SUB>(a, a_word, b, b_word, out, L, sms, stream);
  if (op == FIELD_MUL) field_launch<FIELD_MUL>(a, a_word, b, b_word, out, L, sms, stream);
  return (int)cudaGetLastError();
}

// out = -a (UNARY_NEG) or a * c (UNARY_MUL_CONST, c < 2^32) over the layout
// (its sb unused), sms as above. Allocates nothing, no sync.
extern "C" int starky_field_unary(int op, const uint64_t* a, uint64_t c, uint64_t* out,
                                  const int64_t* layout, int sms, cudaStream_t stream) {
  FieldLayout L = *(const FieldLayout*)layout;
  if (L.ndim < 0 || L.ndim > FIELD_MAX_DIMS || sms < 1) return (int)cudaErrorInvalidValue;
  if (op == UNARY_NEG) field_launch<FIELD_NEG>(a, 0, nullptr, 0, out, L, sms, stream);
  else if (op == UNARY_MUL_CONST) field_launch<FIELD_MUL>(a, 0, nullptr, c, out, L, sms, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out[o] = sum_j x[offset(o) + j * red_stride] mod p, j < n, over the
// layout's output dims (x's strides in sa). splits 0: one thread an output;
// splits >= 1: 32 x 8 threads a block, the axis cut in `splits` slices, with
// scratch holding 2 * splits * numel partial words and then one 32-bit
// counter a tile of 32 outputs (zeroed here). Allocates nothing, no sync.
extern "C" int starky_field_sum(const uint64_t* x, uint64_t* out, const int64_t* layout, int64_t n,
                                int64_t red_stride, int splits, uint64_t* scratch,
                                cudaStream_t stream) {
  FieldLayout L = *(const FieldLayout*)layout;
  if (L.ndim < 0 || L.ndim > FIELD_MAX_DIMS || splits < 0) return (int)cudaErrorInvalidValue;
  dim3 threads = splits ? dim3(32, 8) : dim3(256, 1);
  int64_t tiles = (L.numel + threads.x - 1) / threads.x;
  dim3 grid((unsigned)(tiles < 1 ? 1 : tiles), splits > 1 ? splits : 1);
  unsigned int* counters = nullptr;
  if (splits > 1) {
    counters = (unsigned int*)(scratch + 2 * (int64_t)splits * L.numel);
    cudaError_t err = cudaMemsetAsync(counters, 0, tiles * sizeof(unsigned int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  switch (L.ndim) {
    case 4: field_sum_kernel<4><<<grid, threads, 0, stream>>>(x, L, n, red_stride, out, scratch, counters); break;
    case 3: field_sum_kernel<3><<<grid, threads, 0, stream>>>(x, L, n, red_stride, out, scratch, counters); break;
    case 2: field_sum_kernel<2><<<grid, threads, 0, stream>>>(x, L, n, red_stride, out, scratch, counters); break;
    default: field_sum_kernel<1><<<grid, threads, 0, stream>>>(x, L, n, red_stride, out, scratch, counters);
  }
  return (int)cudaGetLastError();
}
