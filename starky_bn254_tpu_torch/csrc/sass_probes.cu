// Probe kernels for the operation counts in the kernels' bounds. Never
// launched: cuda_lib.sass_op_counts compiles this file to a cubin with the
// library's flags and counts the integer instructions of each probe with
// cuobjdump -sass. Each probe runs one unit of arithmetic on values it
// loads. The bounds (chip_smoke.py Bounds) count the work each function
// needs, in these units:
//   probe_gl_mul               one Goldilocks multiply
//   probe_add_canonical        one Goldilocks add of canonical words
//   probe_sub_canonical        one Goldilocks subtract of canonical words
//   probe_poseidon_mds         one K3 MDS layer, small-constant form
//   probe_keccak_round         one K2 Keccak-f[1600] round
// The others count a whole unit of a kernel as the kernel runs it, for
// comparison with the bound's units (not used by the bounds):
//   probe_ntt_butterfly        one K1 butterfly (gl_mul, gl_add, gl_sub)
//   probe_poseidon_full_round  one K3 full round, small-constant MDS
//   probe_poseidon_partial_round  one K3 partial round, small-constant MDS

#include "keccak.cu"
#include "ntt.cu"
#include "poseidon.cu"

// The shortest add and subtract we know for canonical inputs (a, b < p).
// The kernels' gl_add and gl_sub keep the JAX package's branch sequence
// word for word; these exist only to be counted.
__device__ __forceinline__ uint64_t add_canonical(uint64_t a, uint64_t b) {
  const uint64_t s = a + b, t = s + GL_EPS;  // t = s - p (mod 2^64)
  return (s < a || t < s) ? t : s;           // a + b wrapped 2^64, or s >= p
}

__device__ __forceinline__ uint64_t sub_canonical(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - GL_EPS : d;  // borrowed: d - 2^64 + p
}

extern "C" __global__ void probe_add_canonical(uint64_t* x) { x[0] = add_canonical(x[0], x[1]); }

extern "C" __global__ void probe_sub_canonical(uint64_t* x) { x[0] = sub_canonical(x[0], x[1]); }

extern "C" __global__ void probe_ntt_butterfly(uint64_t* x) {
  uint64_t u = x[0], v = x[1];
  ntt_butterfly(u, v, x[2]);
  x[0] = u;
  x[1] = v;
}

extern "C" __global__ void probe_gl_mul(uint64_t* x) { x[0] = gl_mul(x[0], x[1]); }

extern "C" __global__ void probe_keccak_round(uint64_t* x) {
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = x[i];
  keccak_round(a, x[25]);
#pragma unroll
  for (int i = 0; i < 25; i++) x[i] = a[i];
}

// x: state [12], round constants [12], row [12], diag [12]
__device__ __forceinline__ void probe_load(const uint64_t* x, uint64_t s[PSN_WIDTH],
                                           uint32_t row[PSN_WIDTH], uint32_t diag[PSN_WIDTH]) {
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) {
    s[i] = x[i];
    row[i] = (uint32_t)x[2 * PSN_WIDTH + i];
    diag[i] = (uint32_t)x[3 * PSN_WIDTH + i];
  }
}

extern "C" __global__ void probe_poseidon_mds(uint64_t* x) {
  uint64_t s[PSN_WIDTH];
  uint32_t row[PSN_WIDTH], diag[PSN_WIDTH];
  probe_load(x, s, row, diag);
  psn_mds(s, row, diag);
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) x[i] = s[i];
}

extern "C" __global__ void probe_poseidon_full_round(uint64_t* x) {
  uint64_t s[PSN_WIDTH];
  uint32_t row[PSN_WIDTH], diag[PSN_WIDTH];
  probe_load(x, s, row, diag);
  psn_full_round(s, x + PSN_WIDTH, row, diag);
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) x[i] = s[i];
}

extern "C" __global__ void probe_poseidon_partial_round(uint64_t* x) {
  uint64_t s[PSN_WIDTH];
  uint32_t row[PSN_WIDTH], diag[PSN_WIDTH];
  probe_load(x, s, row, diag);
  psn_partial_round(s, x + PSN_WIDTH, row, diag);
#pragma unroll
  for (int i = 0; i < PSN_WIDTH; i++) x[i] = s[i];
}
