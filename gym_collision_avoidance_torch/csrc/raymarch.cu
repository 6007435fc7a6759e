// K2: full-range laserscan ray march for Hopper (sm_90a), by per-beam source bands.
//
// Replaces the Pallas TPU kernel gym_collision_avoidance_tpu/ops/raymarch.py
// (`_make_kernel`, launched by `laserscan_sparse_pallas`), whose XLA twin is
// the full pass of obs/sensors.py:laserscan_sparse.  The function, defined by
// ops/raymarch.py:march_plain: for each (host, beam) the R = 60 range samples
// p = pos + r * (cos, sin) map to cells (i, j) = (floor(oi - y * inv_cell),
// floor(oj + x * inv_cell)); a sample hits when it is on the map, outside the
// host's own disc, and inside one of the env's agent discs (di^2 + dj^2 <
// r_cells^2) or on a static occupied cell.  With k1 < k2 the first two hit
// indices the range is rsamples[k2 - 1], rsamples[R - 1] for a single hit, or
// 6 m for none (the reference's cumsum == 1 "last index" rule,
// LaserScanSensor.py:63-82).
//
// What bounds it on this card.  Tested brute force (every sample against every
// disc and static cell), a beam costs up to 60 x (27 + 7 A + 2 S) operations:
// some 2.7e10 a launch at 256 envs x 20 hosts x 512 beams, while the launch
// moves only ~31 MB.  Yet a beam crosses one or two discs, and a disc covers
// only the few samples near where the beam enters it, so nearly all of that
// work cannot hit.  The design below does only the work the inputs need: at
// that shape a beam screens about 2 sources and tests about 3 band samples,
// some 130 operations, so the launch is bound by the bytes it moves
// (chip_smoke.py:k2_bound counts both from the run's data).
//
//  1. Every source (an agent disc, or a static cell) has a band of samples
//     outside which it cannot be hit.  In cell units, a sample's computed
//     coordinates (X, Y) = (oj + x * inv_cell, oi - y * inv_cell) lie in its
//     cell (jj, ii), within sqrt(2)/2 of the cell's centre.  A disc hit needs
//     |(ii - gi, jj - gj)| < sqrt(rsq), so the sample is closer than
//     sqrt(rsq) + sqrt(2)/2 to the source's cell centre (gj + 0.5, gi + 0.5);
//     a static-cell hit needs ii == ci and jj == cj, so closer than sqrt(2)/2.
//     The radius r_out adds 0.05 cells for float rounding (like the JAX
//     package's _WINDOW_CELL_SLACK, sensors.py:207-213): the rounding of the
//     sample and of the screen stays below 1e-3 cells for coordinates below
//     1e4 cells in float32.  With the beam origin (bj, bi) and direction
//     (cos, -sin) in cell units, t_c = relj cos - reli sin and disc = r_out^2
//     - (rel^2 - t_c^2); when disc > 0 the samples that can hit lie in
//     k in [floor((t_c - sqrt(disc)) kpc) - 1, floor((t_c + sqrt(disc)) kpc) + 1]
//     clipped to [0, R - 1], with kpc = cell / res samples per cell.
//  2. Inside each band the kernel runs the plain version's exact per-sample
//     test (the same rounded arithmetic, the on-map test, the test against
//     this source, the host-disc test) and merges the hits into the two
//     smallest distinct indices m1 < m2, which are k1, k2.  A source whose
//     band starts at or beyond m2 is skipped and a band stops at m2.  The
//     host's own disc (same cell and radius as the host disc) is skipped: the
//     host-disc test erases all its hits.  Static cells off the map, such as
//     the -1 padding rows, are never hit and get no band; the row sentinel
//     40000 of an invalid or off-map disc puts it 4000 m away, where its band
//     is empty.  No slot, window or guard: the result is exact.
//  3. Layout: one thread per (host, beam), a warp = 32 adjacent beams of one
//     host (when 32 divides L), so the loops over sources are warp-uniform.
//     Each block of 256 threads belongs to one env and keeps the source table
//     in shared memory: the discs' cell centres, r_out, cells and radii, and
//     the static cells' centres (float, NaN off the map: 8 bytes a cell),
//     built once per block.
//  4. Per-warp wedge pre-screen.  A warp's 32 beams span a wedge (11 degrees
//     at 512 beams), so most sources miss all of them.  Each lane screens one
//     source of a chunk of 32 against the wedge: the inflated disc wholly
//     clockwise of the first beam's line, wholly counter-clockwise of the
//     last's, or beyond the last sample cannot be crossed by any lane (the
//     margin r_out covers the rounding of the beams' directions).  A ballot
//     gives the chunk's survivors, and only those go to the lanes' own
//     screens; a source no lane crosses is then skipped after one __any_sync
//     vote, without divergence.  A warp whose lanes are not all live beams of
//     one host skips the pre-screen.
//
// No library call computes this function (library_ms is null).
//
// Exactness (kernel and plain PyTorch version are bitwise equal):
//  1. No FMA contraction: the sample arithmetic uses the _rn intrinsics and the
//     build passes --fmad=false, so p = pos + r * cos rounds twice, as in
//     PyTorch.
//  2. The quotients by the cell size multiply by inv_cell, the reciprocal
//     rounded to the dtype, as the JAX package's compiled XLA does.
//  3. The integer square sum converts to the float type with round to nearest
//     before it is compared with the squared radius, as PyTorch's promotion
//     does.
//  4. The bands and the wedge pre-screen are conservative (1. and 4. above),
//     so the hit set is the plain version's and so are (k1, k2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kR = 60;            // range samples
constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
// sqrt(2)/2, a sample's farthest reach from its cell's centre, plus 0.05
// cells for rounding
constexpr double kSlack = 0.70710678118654752 + 0.05;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float to_t(int v, float) { return __int2float_rn(v); }
__device__ __forceinline__ double to_t(int v, double) { return static_cast<double>(v); }

// The band [lo, hi] of samples a source of squared radius ro2 (cells) centred
// at (cj, ci) can be hit on, for the beam from (bj, bi) along (c, -s).
// False when the beam misses the inflated disc or the band is empty.
template <typename T>
__device__ __forceinline__ bool source_band(T bj, T bi, T c, T s, T cj, T ci, T ro2, T kpc,
                                            int& lo, int& hi) {
  const T relj = sub_rn(cj, bj), reli = sub_rn(ci, bi);
  const T tc = sub_rn(mul_rn(relj, c), mul_rn(reli, s));
  const T bb = sub_rn(add_rn(mul_rn(relj, relj), mul_rn(reli, reli)), mul_rn(tc, tc));
  const T disc = sub_rn(ro2, bb);
  if (!(disc > T(0))) return false;
  const T half = sqrt(disc);
  // fmax / fmin drop a NaN, so a non-finite band is the whole range
  const T flo = fmax(sub_rn(floor(mul_rn(sub_rn(tc, half), kpc)), T(1)), T(0));
  const T fhi = fmin(add_rn(floor(mul_rn(add_rn(tc, half), kpc)), T(1)), T(kR - 1));
  if (!(flo <= fhi)) return false;
  lo = static_cast<int>(flo);
  hi = static_cast<int>(fhi);
  return true;
}

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
                                T oi, T oj, T inv_cell, T kpc, int blocks_per_env) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rs_s = reinterpret_cast<T*>(smem);                 // [R]
  float2* cell_s = reinterpret_cast<float2*>(rs_s + kR);  // [S] (cj, ci) centres
  T* dcj_s = reinterpret_cast<T*>(cell_s + ns);         // [A] disc cell centres
  T* dci_s = dcj_s + na;
  T* dro_s = dci_s + na;                                // [A] r_out
  T* rsq_s = dro_s + na;                                // [A]
  int* gi_s = reinterpret_cast<int*>(rsq_s + na);       // [A]
  int* gj_s = gi_s + na;                                // [A]

  const int64_t env = blockIdx.x / blocks_per_env;
  const int64_t local =
      static_cast<int64_t>(blockIdx.x % blocks_per_env) * blockDim.x + threadIdx.x;
  for (int t = threadIdx.x; t < kR; t += blockDim.x) rs_s[t] = rsamples[t];
  for (int t = threadIdx.x; t < na; t += blockDim.x) {
    const int a_gi = gi[env * na + t], a_gj = gj[env * na + t];
    const T a_rsq = rsq[env * na + t];
    gi_s[t] = a_gi;
    gj_s[t] = a_gj;
    rsq_s[t] = a_rsq;
    dcj_s[t] = add_rn(to_t(a_gj, T()), T(0.5));
    dci_s[t] = add_rn(to_t(a_gi, T()), T(0.5));
    dro_s[t] = add_rn(sqrt(a_rsq), T(kSlack));
  }
  for (int t = threadIdx.x; t < ns; t += blockDim.x) {
    const int ci = cells[2 * t], cj = cells[2 * t + 1];
    const bool on_map = ci >= 0 && ci < H && cj >= 0 && cj < W;
    cell_s[t] = on_map ? make_float2(static_cast<float>(cj) + 0.5f, static_cast<float>(ci) + 0.5f)
                       : make_float2(nanf(""), nanf(""));
  }
  __syncthreads();

  // Lanes past the last beam stay in the loops (with nothing to do) so that
  // every lane of a warp takes part in its votes.
  const bool live = local < static_cast<int64_t>(ae) * L;
  const int64_t row = env * ae + (live ? local / L : 0);              // host
  const int64_t beam = row * L + (live ? local % L : 0);
  const T x0 = pos_e[2 * row], y0 = pos_e[2 * row + 1];
  const T c = cos_a[beam], s = sin_a[beam];
  const int egi = gi_e[row], egj = gj_e[row];
  const T ersq = rsq_e[row];
  const T bj = add_rn(oj, mul_rn(x0, inv_cell));
  const T bi = sub_rn(oi, mul_rn(y0, inv_cell));

  // The warp's wedge: when its 32 lanes are live adjacent beams of one host,
  // lane 0's direction is the most clockwise and lane 31's the most
  // counter-clockwise, less than pi apart.  A source whose inflated disc lies
  // wholly clockwise of lane 0's line, wholly counter-clockwise of lane 31's,
  // or beyond the last sample (one sample of slack) is crossed by no lane.
  const int lane = threadIdx.x & 31;
  const long long host = row;
  const bool wedge = __all_sync(kFullMask, live && host == __shfl_sync(kFullMask, host, 0));
  const T c_cw = __shfl_sync(kFullMask, c, 0), s_cw = __shfl_sync(kFullMask, s, 0);
  const T c_ccw = __shfl_sync(kFullMask, c, 31), s_ccw = __shfl_sync(kFullMask, s, 31);
  const T reach = T(kR) / kpc;                          // cells
  const int nsrc = na + ns;

  int m1 = kR, m2 = kR;
  // The exact test of sample k, as march_plain does it; a hit joins the two
  // smallest distinct indices.
  auto test_band = [&](int lo, int hi, auto in_source) {
    for (int k = lo; k <= hi && k < m2; ++k) {
      const T r = rs_s[k];
      const T px = add_rn(x0, mul_rn(r, c));
      const T py = add_rn(y0, mul_rn(r, s));
      const int ii = static_cast<int>(floor(sub_rn(oi, mul_rn(py, inv_cell))));
      const int jj = static_cast<int>(floor(add_rn(oj, mul_rn(px, inv_cell))));
      if (ii < 0 || jj < 0 || ii >= H || jj >= W) continue;
      if (!in_source(ii, jj)) continue;
      const int dei = ii - egi, dej = jj - egj;
      if (to_t(dei * dei + dej * dej, T()) < ersq) continue;
      if (k < m1) {
        m2 = m1;
        m1 = k;
      } else if (k > m1) {
        m2 = k;                                         // k < m2 by the loop bound
      }
    }
  };

  const T cell_ro2 = mul_rn(T(kSlack), T(kSlack));
  for (int base = 0; base < nsrc; base += 32) {
    // the chunk's sources that may cross the wedge, one lane screening each
    unsigned keep = nsrc - base >= 32 ? kFullMask : (1u << (nsrc - base)) - 1;
    if (wedge) {
      const int q = base + lane;
      bool near = false;
      if (q < nsrc) {
        T cj, ci, r_out;
        if (q < na) {
          cj = dcj_s[q], ci = dci_s[q], r_out = dro_s[q];
        } else {
          const float2 ctr = cell_s[q - na];
          cj = T(ctr.x), ci = T(ctr.y), r_out = T(kSlack);
        }
        const T relj = sub_rn(cj, bj), reli = sub_rn(ci, bi);
        // cross((c, s), (relj, -reli)), the signed distance from a beam's
        // line in world orientation
        const T side_cw = -add_rn(mul_rn(c_cw, reli), mul_rn(s_cw, relj));
        const T side_ccw = -add_rn(mul_rn(c_ccw, reli), mul_rn(s_ccw, relj));
        const T far = add_rn(reach, r_out);
        // false for a NaN centre (a static cell off the map)
        near = add_rn(mul_rn(relj, relj), mul_rn(reli, reli)) <= mul_rn(far, far) &&
               !(side_cw < -r_out) && !(side_ccw > r_out);
      }
      keep = __ballot_sync(kFullMask, near);
    }
    while (keep) {                                      // warp-uniform
      const int q = base + __ffs(keep) - 1;
      keep &= keep - 1;
      int lo = 0, hi = -1;
      if (q < na) {
        const int a_gi = gi_s[q], a_gj = gj_s[q];
        const T a_rsq = rsq_s[q];
        const T r_out = dro_s[q];
        const bool own = a_gi == egi && a_gj == egj && a_rsq == ersq;
        const bool cross = live && !own &&
                           source_band(bj, bi, c, s, dcj_s[q], dci_s[q], mul_rn(r_out, r_out),
                                       kpc, lo, hi) &&
                           lo < m2;
        if (!__any_sync(kFullMask, cross)) continue;
        if (cross) {
          test_band(lo, hi, [&](int ii, int jj) {
            const int di = ii - a_gi, dj = jj - a_gj;
            return to_t(di * di + dj * dj, T()) < a_rsq;
          });
        }
      } else {
        const float2 ctr = cell_s[q - na];
        const bool cross = live &&
                           source_band(bj, bi, c, s, T(ctr.x), T(ctr.y), cell_ro2, kpc, lo, hi) &&
                           lo < m2;
        if (!__any_sync(kFullMask, cross)) continue;
        if (cross) {
          const int ci = static_cast<int>(ctr.y), cj = static_cast<int>(ctr.x);
          test_band(lo, hi, [&](int ii, int jj) { return ii == ci && jj == cj; });
        }
      }
    }
  }
  if (!live) return;
  const int ans = m1 >= kR ? -1 : (m2 >= kR ? kR - 1 : m2 - 1);
  out[beam] = ans >= 0 ? rs_s[ans] : static_cast<T>(6.0);
}

template <typename T>
int launch(const void* pos_e, const void* cos_a, const void* sin_a, const void* gi_e,
           const void* gj_e, const void* rsq_e, const void* gi, const void* gj,
           const void* rsq, const void* cells, const void* rsamples, void* out,
           int64_t num_envs, int ae, int na, int L, int ns, int H, int W, double oi,
           double oj, double inv_cell, double kpc, void* stream) {
  const int64_t per_env = static_cast<int64_t>(ae) * L;
  if (num_envs == 0 || per_env == 0) return 0;
  const int blocks_per_env = static_cast<int>((per_env + kThreads - 1) / kThreads);
  const int64_t blocks = num_envs * blocks_per_env;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(T) * (kR + 4 * na) + sizeof(int) * 2 * na +
                      sizeof(float2) * ns;
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
      static_cast<T>(kpc), blocks_per_env);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RAYMARCH_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* pos_e, const void* cos_a, const void* sin_a,           \
                      const void* gi_e, const void* gj_e, const void* rsq_e,             \
                      const void* gi, const void* gj, const void* rsq, const void* cells, \
                      const void* rsamples, void* out, int64_t num_envs, int ae, int na, \
                      int L, int ns, int H, int W, double oi, double oj, double inv_cell, \
                      double kpc, void* stream) {                                        \
    return launch<T>(pos_e, cos_a, sin_a, gi_e, gj_e, rsq_e, gi, gj, rsq, cells, rsamples, \
                     out, num_envs, ae, na, L, ns, H, W, oi, oj, inv_cell, kpc, stream); \
  }

RAYMARCH_ENTRY(raymarch_f32, float)
RAYMARCH_ENTRY(raymarch_f64, double)
