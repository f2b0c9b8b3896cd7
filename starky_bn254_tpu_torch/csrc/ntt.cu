// K1: NTT along axis 0 of a row-major [n, c] Goldilocks matrix, natural
// order in and out; the inverse includes the 1/n scale.
//
// Replaces starky_bn254_tpu/pallas/ntt_kernel.py::ntt2d (_dif_kernel,
// _dit_kernel and the host tables _stage_table / _outer_table /
// _gather_perm). That kernel is a four-step transform shaped by the TPU's
// VMEM blocks and (8, 128) tiling; none of its shape gates (c % 128 == 0,
// n >= 2^6) apply here: any power-of-two n and any c, including 1-D input.
//
// Design: one bit-reversal gather (which also applies the inverse's 1/n
// scale: the transform is linear and exact mod p, so scaling first gives
// the same residues), then log2(n) radix-2 Cooley-Tukey DIT stages, one
// launch each, one thread per butterfly per column. Stage s (half-size
// m = 2^s) reads its twiddles w_{2m}^j from a device table packed as
// tw[m + j] (built by ntt.py::_twiddle_table from _stage_twiddles). This is
// exactly the butterfly ladder of the JAX package's ntt._ntt_xla, so every
// output word is the same.
//
// Bound: memory. Each stage reads and writes the whole matrix once
// (2 * n * c * 8 bytes), so a [131072, 888] transform moves ~17 * 1.9 GB
// through HBM; the 64-bit multiply per butterfly is cheap beside that.
// Threads run along the contiguous column axis, so a warp's loads and
// stores are coalesced. Fusing several stages in shared memory (or a
// four-step layout) would cut the passes; that is later work.

#include <cuda_runtime.h>

#include "goldilocks.cuh"

__global__ void ntt_bitrev_kernel(const uint64_t* __restrict__ in, int64_t in_stride,
                                  uint64_t* __restrict__ out, int64_t n, int64_t c,
                                  int log_n, uint64_t scale, int do_scale) {
  for (int64_t row = blockIdx.y * (int64_t)blockDim.y + threadIdx.y; row < n;
       row += (int64_t)gridDim.y * blockDim.y) {
    int64_t src = log_n ? (int64_t)(__brevll((unsigned long long)row) >> (64 - log_n)) : 0;
    for (int64_t col = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; col < c;
         col += (int64_t)gridDim.x * blockDim.x) {
      uint64_t v = in[src * in_stride + col];
      out[row * c + col] = do_scale ? gl_mul(v, scale) : v;
    }
  }
}

__global__ void ntt_stage_kernel(uint64_t* __restrict__ x, int64_t half_n, int64_t c,
                                 int s, const uint64_t* __restrict__ tw) {
  const int64_t m = (int64_t)1 << s;
  for (int64_t b = blockIdx.y * (int64_t)blockDim.y + threadIdx.y; b < half_n;
       b += (int64_t)gridDim.y * blockDim.y) {
    int64_t j = b & (m - 1);
    int64_t i0 = ((b >> s) << (s + 1)) + j;
    int64_t i1 = i0 + m;
    uint64_t w = tw[m + j];
    for (int64_t col = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; col < c;
         col += (int64_t)gridDim.x * blockDim.x) {
      uint64_t u = x[i0 * c + col];
      uint64_t v = gl_mul(x[i1 * c + col], w);
      x[i0 * c + col] = gl_add(u, v);
      x[i1 * c + col] = gl_sub(u, v);
    }
  }
}

// in: [n, c] with row stride in_stride (words); out: contiguous [n, c],
// distinct from in; tw: [n] packed stage twiddles. Returns the CUDA error of
// the first failed launch, 0 on success. Allocates nothing, no sync.
extern "C" int starky_ntt(const uint64_t* in, int64_t in_stride, uint64_t* out,
                          int64_t n, int64_t c, const uint64_t* tw, uint64_t scale,
                          int do_scale, cudaStream_t stream) {
  int log_n = 0;
  while (((int64_t)1 << log_n) < n) log_n++;
  dim3 grid, block;
  gl_dims2(n, c, &grid, &block);
  ntt_bitrev_kernel<<<grid, block, 0, stream>>>(in, in_stride, out, n, c, log_n, scale,
                                                do_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gl_dims2(n / 2, c, &grid, &block);
  for (int s = 0; s < log_n; s++) {
    ntt_stage_kernel<<<grid, block, 0, stream>>>(out, n / 2, c, s, tw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
