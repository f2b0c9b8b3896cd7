// K2: Keccak-f[1600] sponge absorb, one thread per row.
//
// Replaces starky_bn254_tpu/pallas/keccak_kernel.py::sponge_absorb
// (_sponge_kernel, _permute, _round, _rol). The Pallas kernel splits each
// lane into a u32 pair and absorbs at most 15 chunks per call (a Mosaic
// unroll limit); here the 25 lanes are uint64_t registers with native
// 64-bit rotates, and one launch absorbs every chunk of the row.
//
// One entry point covers keccak.py's hash_no_pad, sponge_absorb, finalize
// and compress: absorb floor(width / 17) full rate chunks (XOR into lanes
// 0..16, then 24 rounds), then, when `pad` is set, one final block holding
// the width % 17 tail words with the word-granular 10*1 padding of
// keccak._pad_tail (0x01 in the word after the tail, the MSB of word 16).
// The output is the full 25-lane state or the first 4 lanes (the digest).
//
// Bound: for Merkle leaf hashing ([131072, 812] per commit) the permutation
// is ~24 * ~150 64-bit ops per 17 absorbed words, against 8 bytes read per
// word: compute-bound on integer throughput when the reads stay in L1/L2.
// Each thread reads its own row (rows are 812 words apart), so a warp's
// loads are strided; every 32-byte sector is still used in full over four
// consecutive words. Staging row tiles through shared memory to coalesce
// the reads is later work.
//
// Round constants and rotation offsets are the FIPS 202 values; keccak.py
// derives them from the reference definition and tests/test_torch_hashes.py
// checks that the tables below equal the derived ones.

#include <cuda_runtime.h>
#include <stdint.h>

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rotation offset of lane x + 5y
#define KECCAK_RHO {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14}

__device__ __forceinline__ uint64_t rol64(uint64_t v, int k) {
  return k == 0 ? v : ((v << k) | (v >> (64 - k)));
}

__device__ __forceinline__ void keccak_round(uint64_t a[25], uint64_t rc) {
  constexpr int rho[25] = KECCAK_RHO;
  uint64_t c[5], d[5], b[25];
#pragma unroll
  for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
  for (int x = 0; x < 5; x++) d[x] = c[(x + 4) % 5] ^ rol64(c[(x + 1) % 5], 1);
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
  // rho + pi: B[y, 2x + 3y] = rol(A[x, y])
#pragma unroll
  for (int x = 0; x < 5; x++) {
#pragma unroll
    for (int y = 0; y < 5; y++) b[y + 5 * ((2 * x + 3 * y) % 5)] = rol64(a[x + 5 * y], rho[x + 5 * y]);
  }
  // chi
#pragma unroll
  for (int y = 0; y < 5; y++) {
#pragma unroll
    for (int x = 0; x < 5; x++)
      a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
  }
  a[0] ^= rc;  // iota
}

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
#pragma unroll 1
  for (int r = 0; r < 24; r++) keccak_round(a, KECCAK_RC[r]);
}

__global__ void keccak_sponge_kernel(const uint64_t* __restrict__ state_in,
                                     const uint64_t* __restrict__ block, int64_t n,
                                     int64_t width, int64_t row_stride, int pad,
                                     uint64_t* __restrict__ out, int out_words) {
  const int RATE = 17;
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; row < n;
       row += (int64_t)gridDim.x * blockDim.x) {
    uint64_t a[25];
#pragma unroll
    for (int i = 0; i < 25; i++) a[i] = state_in ? state_in[row * 25 + i] : 0;
    const uint64_t* src = block + row * row_stride;
    int64_t full = width / RATE;
    for (int64_t ch = 0; ch < full; ch++) {
#pragma unroll
      for (int i = 0; i < RATE; i++) a[i] ^= src[ch * RATE + i];
      keccak_f(a);
    }
    if (pad) {
      int rem = (int)(width - full * RATE);
#pragma unroll
      for (int i = 0; i < RATE; i++) {
        uint64_t v = i < rem ? src[full * RATE + i] : 0;
        if (i == rem) v ^= 1ULL;
        if (i == RATE - 1) v ^= 1ULL << 63;
        a[i] ^= v;
      }
      keccak_f(a);
    }
    // constant lane indices keep a[] in registers
#pragma unroll
    for (int i = 0; i < 25; i++)
      if (i < out_words) out[row * out_words + i] = a[i];
  }
}

// state_in: [n, 25] or NULL (zero state); block: [n, width] with row stride
// row_stride (words); out: [n, out_words], out_words 25 or 4. Without pad,
// width must be a multiple of 17. Allocates nothing, no sync.
extern "C" int starky_keccak_sponge(const uint64_t* state_in, const uint64_t* block,
                                    int64_t n, int64_t width, int64_t row_stride, int pad,
                                    uint64_t* out, int out_words, cudaStream_t stream) {
  const int threads = 128;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 30)) blocks = 1 << 30;
  if (blocks < 1) blocks = 1;
  keccak_sponge_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      state_in, block, n, width, row_stride, pad, out, out_words);
  return (int)cudaGetLastError();
}
