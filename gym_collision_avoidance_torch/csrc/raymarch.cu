// K2: full-range laserscan ray march for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gym_collision_avoidance_tpu/ops/raymarch.py
// (`_make_kernel`, launched by `laserscan_sparse_pallas`), whose XLA twin is
// the full pass of obs/sensors.py:laserscan_sparse.  One thread per (host,
// beam): it marches the R = 60 range samples p = pos + r * (cos, sin), maps
// each to its cell (i, j) = (floor(oi - y * inv_cell), floor(oj + x * inv_cell))
// and counts a hit when the sample is on the map, outside the host's own disc,
// and inside one of the env's agent discs (di^2 + dj^2 < r_cells^2) or on a
// static occupied cell.  With k1, k2 the first two hit indices the range is
// rsamples[k2 - 1], rsamples[R - 1] for a single hit, or 6 m for none: the
// reference's cumsum == 1 "last index" rule (LaserScanSensor.py:63-82), which
// the Pallas kernel carries as a (count, value) pair.  The thread stops at k2.
//
// What bounds it on this card: at full width (256 envs x 20 hosts x 512 beams,
// no static cells) one launch tests up to 2.6 M x 60 samples, each against 20
// discs: about 170 scalar operations a sample, some 2.7e10 in all, while it
// reads under 11 MB and writes 5 MB.  So it is bound by operations.  The design
// is the simplest one that keeps the inner loop on chip: the env's disc table
// (cell, squared radius), the static cell list and the range table sit in
// shared memory, loaded once by each block of 256 (host, beam) threads of one
// env; the beams' cosines and sines are inputs computed once by PyTorch, so
// kernel and plain version read the same bits.  No library call computes this
// function (library_ms is null).
//
// Exactness (kernel and plain PyTorch version are bitwise equal):
//  1. No FMA contraction: the arithmetic uses the _rn intrinsics and the build
//     passes --fmad=false, so p = pos + r * cos rounds twice, as in PyTorch.
//  2. The quotients by the cell size multiply by inv_cell, the reciprocal
//     rounded to the dtype, as the JAX package's compiled XLA does.
//  3. The integer square sum converts to the float type with round to
//     nearest before it is compared with the squared radius, as PyTorch's
//     promotion does.  The row sentinel 40000 of a disc that is invalid or
//     off the map keeps the sum below 2^31 and above any radius.
//  4. A hit inside the env's own disc of the host is erased by the host-disc
//     test, so the loop over discs need not skip the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kR = 60;            // range samples
constexpr int kThreads = 256;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float to_t(int v, float) { return __int2float_rn(v); }
__device__ __forceinline__ double to_t(int v, double) { return static_cast<double>(v); }

template <typename T>
__global__ void raymarch_kernel(const T* __restrict__ pos_e,      // [E, Ae, 2]
                                const T* __restrict__ cos_a,      // [E, Ae, L]
                                const T* __restrict__ sin_a,      // [E, Ae, L]
                                const int* __restrict__ gi_e,     // [E, Ae]
                                const int* __restrict__ gj_e,     // [E, Ae]
                                const T* __restrict__ rsq_e,      // [E, Ae]
                                const int* __restrict__ gi,       // [E, A]
                                const int* __restrict__ gj,       // [E, A]
                                const T* __restrict__ rsq,        // [E, A]
                                const int* __restrict__ cells,    // [S, 2]
                                const T* __restrict__ rsamples,   // [R]
                                T* __restrict__ out,              // [E, Ae, L]
                                int ae, int na, int L, int ns, int H, int W,
                                T oi, T oj, T inv_cell, int blocks_per_env) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rs_s = reinterpret_cast<T*>(smem);                 // [R]
  T* rsq_s = rs_s + kR;                                 // [A]
  int* gi_s = reinterpret_cast<int*>(rsq_s + na);       // [A]
  int* gj_s = gi_s + na;                                // [A]
  int* cells_s = gj_s + na;                             // [2 S]

  const int64_t env = blockIdx.x / blocks_per_env;
  const int64_t local =
      static_cast<int64_t>(blockIdx.x % blocks_per_env) * blockDim.x + threadIdx.x;
  for (int t = threadIdx.x; t < kR; t += blockDim.x) rs_s[t] = rsamples[t];
  for (int t = threadIdx.x; t < na; t += blockDim.x) {
    rsq_s[t] = rsq[env * na + t];
    gi_s[t] = gi[env * na + t];
    gj_s[t] = gj[env * na + t];
  }
  for (int t = threadIdx.x; t < 2 * ns; t += blockDim.x) cells_s[t] = cells[t];
  __syncthreads();
  if (local >= static_cast<int64_t>(ae) * L) return;

  const int64_t row = env * ae + local / L;             // host
  const int64_t beam = row * L + local % L;
  const T x0 = pos_e[2 * row], y0 = pos_e[2 * row + 1];
  const T c = cos_a[beam], s = sin_a[beam];
  const int egi = gi_e[row], egj = gj_e[row];
  const T ersq = rsq_e[row];

  int k1 = kR, k2 = kR;
  for (int k = 0; k < kR; ++k) {
    const T r = rs_s[k];
    const T px = add_rn(x0, mul_rn(r, c));
    const T py = add_rn(y0, mul_rn(r, s));
    const int ii = static_cast<int>(floor(sub_rn(oi, mul_rn(py, inv_cell))));
    const int jj = static_cast<int>(floor(add_rn(oj, mul_rn(px, inv_cell))));
    if (ii < 0 || jj < 0 || ii >= H || jj >= W) continue;
    const int dei = ii - egi, dej = jj - egj;
    if (to_t(dei * dei + dej * dej, T()) < ersq) continue;
    bool hit = false;
    for (int a = 0; a < na && !hit; ++a) {
      const int di = ii - gi_s[a], dj = jj - gj_s[a];
      hit = to_t(di * di + dj * dj, T()) < rsq_s[a];
    }
    for (int q = 0; q < ns && !hit; ++q) {
      hit = ii == cells_s[2 * q] && jj == cells_s[2 * q + 1];
    }
    if (!hit) continue;
    if (k1 == kR) {
      k1 = k;
    } else {
      k2 = k;
      break;
    }
  }
  const int ans = k1 == kR ? -1 : (k2 == kR ? kR - 1 : k2 - 1);
  out[beam] = ans >= 0 ? rs_s[ans] : static_cast<T>(6.0);
}

template <typename T>
int launch(const void* pos_e, const void* cos_a, const void* sin_a, const void* gi_e,
           const void* gj_e, const void* rsq_e, const void* gi, const void* gj,
           const void* rsq, const void* cells, const void* rsamples, void* out,
           int64_t num_envs, int ae, int na, int L, int ns, int H, int W, double oi,
           double oj, double inv_cell, void* stream) {
  const int64_t per_env = static_cast<int64_t>(ae) * L;
  if (num_envs == 0 || per_env == 0) return 0;
  const int blocks_per_env = static_cast<int>((per_env + kThreads - 1) / kThreads);
  const int64_t blocks = num_envs * blocks_per_env;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(T) * (kR + na) + sizeof(int) * (2 * na + 2 * ns);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raymarch_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  raymarch_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos_e), static_cast<const T*>(cos_a),
      static_cast<const T*>(sin_a), static_cast<const int*>(gi_e),
      static_cast<const int*>(gj_e), static_cast<const T*>(rsq_e),
      static_cast<const int*>(gi), static_cast<const int*>(gj), static_cast<const T*>(rsq),
      static_cast<const int*>(cells), static_cast<const T*>(rsamples), static_cast<T*>(out),
      ae, na, L, ns, H, W, static_cast<T>(oi), static_cast<T>(oj), static_cast<T>(inv_cell),
      blocks_per_env);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RAYMARCH_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* pos_e, const void* cos_a, const void* sin_a,           \
                      const void* gi_e, const void* gj_e, const void* rsq_e,             \
                      const void* gi, const void* gj, const void* rsq, const void* cells, \
                      const void* rsamples, void* out, int64_t num_envs, int ae, int na, \
                      int L, int ns, int H, int W, double oi, double oj, double inv_cell, \
                      void* stream) {                                                    \
    return launch<T>(pos_e, cos_a, sin_a, gi_e, gj_e, rsq_e, gi, gj, rsq, cells, rsamples, \
                     out, num_envs, ae, na, L, ns, H, W, oi, oj, inv_cell, stream);      \
  }

RAYMARCH_ENTRY(raymarch_f32, float)
RAYMARCH_ENTRY(raymarch_f64, double)
