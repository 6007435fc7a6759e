// K3: fused windowed, beam-compacted laserscan pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gym_collision_avoidance_tpu/ops/laser_pallas.py
// (`_make_kernel`, launched by `windowed_beam_compacted_pallas`), whose XLA twin
// is obs/sensors.py:_windowed_beam_compacted.  The function, defined by
// ops/laser_fused.py:beam_compacted_plain, for each (host, beam) of a beam
// block with S sources (agent discs, static cells):
//  1. screen: t_c = relx*cos + rely*sin, disc = ro2 - (rel2 - t_c^2); a source
//     crosses the beam when span_ok, disc > 0, t_hi = t_c + sqrt(disc) >= 0
//     and t_lo = t_c - sqrt(disc) <= t_max;
//  2. compaction: the first Cs crossing sources, in source order, are kept; a
//     further crossing source sets the slot-overflow flag;
//  3. window: samples k0 .. k0 + Wn - 1 of each kept source, with
//     k0 = clip(floor(t_lo * inv_res) - 1, 0, R), through the exact cell test
//     (on the map, inside the source, outside the host's own disc); the two
//     smallest distinct hit indices m1 < m2 give the range (m2 - 1) * res,
//     (R - 1) * res for a single hit, or 6 m for none.
// The window-span guard has no beam axis and stays in PyTorch in the wrapper.
// Two deliberate deviations from the XLA twin, kept from the Pallas kernel
// (laser_pallas.py:19-23): the overflow flag is the direct condition, and the
// integer radius is not clamped to 63.
//
// What bounds it on this card.  Done as defined, a beam screens all S sources
// of its block (about 15 operations each) and tests Wn samples of each kept
// one (about 25 each).  Yet a warp's 32 beams span an 11 degree wedge while a
// block's candidates span its 45 degrees, and a disc covers only a few of a
// window's samples.  The design below does the work the inputs need: at the
// fast route's full width (256 envs x 20 hosts x 512 beams, 9 candidates a
// block, Cs = 4, Wn = 12) a beam takes part in about 0.3 wedge screens, runs
// about 1 exact screen and tests about 3.4 band samples, some 110 operations,
// so the launch is bound by the ~40 MB it moves (chip_smoke.py:k3_bound counts
// both from the run's data, with tests/test_torch_laser_fused_band.py).
//
//  1. Layout: a CTA per (host, beam block, chunk of up to 128 beams) from
//     blockIdx (x host, y block, z chunk), one thread a beam, so a warp lies
//     within one host and one block and no thread divides.  The CTA stages its
//     block's S source records in shared memory with coalesced reads: relx,
//     rely, rel2, ro2, the cell and integer radius, and the pre-screen's radius
//     w (below; -1 where span_ok is false).  S is 9 on the empty map at the
//     fast route's width and 109 on map 002: a few KB.
//  2. Per-warp wedge pre-screen (when 32 divides the block's beams; else every
//     source with span_ok survives).  Lane q of the warp tests source
//     base + q of a chunk of 32 against the wedge between lane 0's beam line
//     and lane 31's, and against the reach t_max + w; __ballot_sync gives the
//     survivors.  The lanes then run the definition's exact screen on the
//     survivors in ascending source order, so the stable first-come slot order
//     and the count are the definition's.  A lane that has counted Cs + 1
//     crossings knows its flag and screens no more; the warp stops at the
//     first chunk where all its lanes have.
//  3. Band-cut windows with an m2 stop.  A kept source is windowed as soon as
//     it is kept: the two-smallest merge does not depend on order, so no slot
//     arrays.  Its window starts at the definition's k0 and ends at
//     min(k0 + Wn - 1, floor(t_hi * inv_res) + 1, R - 1), and sooner once
//     k >= m2, the beam's current second hit.
//
// No library call computes this function (library_ms is null).
//
// Exactness (kernel and plain PyTorch version are bitwise equal):
//  1. No FMA contraction: the _rn intrinsics and the build's --fmad=false;
//     quotients by the cell size and the range step are products with the
//     reciprocals rounded to the dtype; the integer square sum converts with
//     round to nearest before it is compared with the host's squared radius.
//  2. The band end.  A hit needs the sample's cell within sqrt(rsq) cells of
//     the source's cell, so the continuous sample lies within sqrt(rsq) +
//     sqrt(2) cells of the source's world centre (an agent's position lies in
//     its cell; a static cell's centre is its centre).  r_out adds
//     _WINDOW_CELL_SLACK = sqrt(2) + 0.05 cells (obs/sensors.py), the 0.05
//     for the rounding of the samples and the screen, so a hit sample lies in
//     [t_lo, t_hi] and no sample past floor(t_hi * inv_res) (+ 1 for the
//     product's rounding) can hit.  Samples at k >= m2 cannot change the two
//     smallest distinct indices.  A sample at k >= R does not exist.
//  3. The pre-screen is conservative against the rounded screen.  Exactly, a
//     disc of radius r_out that some beam ray between lane 0's and lane 31's
//     crosses within t_max has its centre P within t_max + r_out of the host
//     and no farther than r_out clockwise of lane 0's line or
//     counter-clockwise of lane 31's (the rays lie between the two lines,
//     which are less than pi apart: 32 beams of at least 32 over pi).  The
//     rounded screen lets a little more through; with u the unit roundoff and
//     far = t_max + r_out:
//     - rel2 - t_c^2 rounds by at most ~12 u |P|^2 (rel2, t_c and its square,
//       and |(cos, sin)|^2 = 1 +- 4 u), so disc > 0 lets the line pass up to
//       6 u far^2 / r_out farther than r_out;
//     - where disc is near 0, sqrt(disc) moves t_lo and t_hi by up to
//       sqrt(12 u) far, so the crossing may lie that far behind the host or
//       beyond t_max;
//     - the beam directions are rounded cos and sin of ordered angles whose
//       steps (pi / (L - 1)) are far above u, so every lane's direction stays
//       between lane 0's and lane 31's; |direction| <= 1 + 2 u, and the side
//       products round by 3 u |P|.
//     So w = r_out + 8 sqrt(u) far + 16 u far^2 / r_out (coefficients rounded
//     up to powers of two, each at least twice the sum it covers) bounds them
//     all; a radius that is not a number widens to infinity.  The 1e7 sentinel
//     of an empty candidate slot (rel2 ~ 1e14, finite in float32) fails the
//     reach test.  tests/test_torch_laser_fused_band.py models the design and
//     checks it against the definition on tangent beams, cell corners, map
//     edges, hosts inside discs and map 002, in both dtypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kR = 60;            // range samples
constexpr int kThreads = 128;     // beams a CTA at most
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float to_t(int v, float) { return __int2float_rn(v); }
__device__ __forceinline__ double to_t(int v, double) { return static_cast<double>(v); }

// The wedge margin's coefficients, 8 sqrt(u) and 16 u rounded up to powers of
// two (u = 2^-24 in float32, 2^-53 in float64).
template <typename T> struct Margin;
template <> struct Margin<float> {
  static constexpr float kSqrt = 0x1p-9f;
  static constexpr float kLin = 0x1p-20f;
};
template <> struct Margin<double> {
  static constexpr double kSqrt = 0x1p-23;
  static constexpr double kLin = 0x1p-49;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
laser_fused_kernel(const T* __restrict__ pos_e,     // [N, 2], N = E*Ae hosts
                   const int* __restrict__ gi_e,    // [N]
                   const int* __restrict__ gj_e,    // [N]
                   const T* __restrict__ rsq_e,     // [N]
                   const T* __restrict__ cos_a,     // [N, L]
                   const T* __restrict__ sin_a,     // [N, L]
                   const int* __restrict__ gi_d,    // [N, B, S]
                   const int* __restrict__ gj_d,    // [N, B, S]
                   const int* __restrict__ irsq_d,  // [N, B, S]
                   const T* __restrict__ relx,      // [N, B, S]
                   const T* __restrict__ rely,      // [N, B, S]
                   const T* __restrict__ rel2,      // [N, B, S]
                   const T* __restrict__ ro2,       // [N, B, S]
                   const uint8_t* __restrict__ span_ok,  // [N, B, S]
                   T* __restrict__ out,             // [N, L]
                   uint8_t* __restrict__ ovf,       // [N, L]
                   int L, int nb, int lb, int ns, int cs, int wn, int H, int W, T oi, T oj,
                   T inv_cell, T res, T inv_res, T t_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* px_s = reinterpret_cast<T*>(smem);         // [S] relx
  T* py_s = px_s + ns;                          // [S] rely
  T* p2_s = py_s + ns;                          // [S] rel2
  T* ro2_s = p2_s + ns;                         // [S] r_out^2
  T* w_s = ro2_s + ns;                          // [S] pre-screen radius, -1: never screened
  int* gi_s = reinterpret_cast<int*>(w_s + ns); // [S]
  int* gj_s = gi_s + ns;                        // [S]
  int* irsq_s = gj_s + ns;                      // [S]

  const int64_t row = blockIdx.x;               // host
  const int blk = blockIdx.y;                   // beam block
  // The beam's own inputs are loaded first, so that their latency overlaps
  // the staging.  Lanes past the block's last beam read beam 0 of the block.
  const int first = blockIdx.z * blockDim.x;
  const int l = first + threadIdx.x;
  const bool live = l < lb;
  const int64_t beam = row * L + static_cast<int64_t>(blk) * lb + (live ? l : 0);
  const T c = cos_a[beam], s = sin_a[beam];
  const T x0 = pos_e[2 * row], y0 = pos_e[2 * row + 1];
  const int egi = gi_e[row], egj = gj_e[row];
  const T ersq = rsq_e[row];

  const int64_t src = (row * nb + blk) * ns;
  for (int t = threadIdx.x; t < ns; t += blockDim.x) {
    const T r2 = ro2[src + t];
    px_s[t] = relx[src + t];
    py_s[t] = rely[src + t];
    p2_s[t] = rel2[src + t];
    ro2_s[t] = r2;
    gi_s[t] = gi_d[src + t];
    gj_s[t] = gj_d[src + t];
    irsq_s[t] = irsq_d[src + t];
    const T r_out = r2 > T(0) ? sqrt_rn(r2) : T(0);
    const T far = add_rn(t_max, r_out);
    T w = add_rn(r_out, add_rn(mul_rn(Margin<T>::kSqrt, far),
                               div_rn(mul_rn(Margin<T>::kLin, mul_rn(far, far)), r_out)));
    if (!(w >= T(0))) w = T(INFINITY);
    w_s[t] = span_ok[src + t] ? w : T(-1);
  }
  __syncthreads();

  // A warp with no live beam has nothing to do; in the others, lanes past the
  // block's last beam stay in the loops so that every lane takes part in the
  // votes.
  if (first + static_cast<int>(threadIdx.x & ~31u) >= lb) return;

  // The warp's wedge (when its 32 lanes are live adjacent beams): lane 0's
  // direction is the most clockwise, lane 31's the most counter-clockwise.
  const int lane = threadIdx.x & 31;
  const bool wedge = (lb & 31) == 0;
  const T c_cw = __shfl_sync(kFullMask, c, 0), s_cw = __shfl_sync(kFullMask, s, 0);
  const T c_ccw = __shfl_sync(kFullMask, c, 31), s_ccw = __shfl_sync(kFullMask, s, 31);

  int count = 0, m1 = kR, m2 = kR;
  for (int base = 0; base < ns; base += 32) {
    if (__all_sync(kFullMask, count > cs)) break;
    // the chunk's sources that may cross the wedge, one lane screening each
    const int q = base + lane;
    bool near = false;
    if (q < ns) {
      const T w = w_s[q];
      near = w >= T(0);
      if (near && wedge) {
        const T px = px_s[q], py = py_s[q];
        // cross((cos, sin), P): positive counter-clockwise of the beam line
        const T side_cw = sub_rn(mul_rn(c_cw, py), mul_rn(s_cw, px));
        const T side_ccw = sub_rn(mul_rn(c_ccw, py), mul_rn(s_ccw, px));
        const T far = add_rn(t_max, w);
        near = p2_s[q] <= mul_rn(far, far) && !(side_cw < -w) && !(side_ccw > w);
      }
    }
    unsigned keep = __ballot_sync(kFullMask, near);
    while (keep) {                                      // warp-uniform
      const int qq = base + __ffs(keep) - 1;
      keep &= keep - 1;
      // the definition's screen, in its rounded arithmetic
      T tlo = T(0), thi = T(0);
      bool cross = false;
      if (live && count <= cs) {
        const T tc = add_rn(mul_rn(px_s[qq], c), mul_rn(py_s[qq], s));
        const T disc = sub_rn(ro2_s[qq], sub_rn(p2_s[qq], mul_rn(tc, tc)));
        if (disc > T(0)) {
          const T half = sqrt_rn(disc);
          tlo = sub_rn(tc, half);
          thi = add_rn(tc, half);
          cross = thi >= T(0) && tlo <= t_max;
        }
      }
      if (!__any_sync(kFullMask, cross)) continue;
      if (!cross) continue;
      if (count++ >= cs) continue;                      // counted, not kept
      // the kept source's band, up to the current second hit
      int k0 = static_cast<int>(floor(mul_rn(tlo, inv_res))) - 1;
      k0 = k0 < 0 ? 0 : (k0 > kR ? kR : k0);
      const T fend = fmin(add_rn(floor(mul_rn(thi, inv_res)), T(1)), T(kR - 1));
      const int kend = min(k0 + wn - 1, static_cast<int>(fend));
      const int a_gi = gi_s[qq], a_gj = gj_s[qq], a_irsq = irsq_s[qq];
      for (int k = k0; k <= kend && k < m2; ++k) {
        const T rr = mul_rn(to_t(k, T()), res);
        const T px = add_rn(x0, mul_rn(rr, c));
        const T py = add_rn(y0, mul_rn(rr, s));
        const int ii = static_cast<int>(floor(sub_rn(oi, mul_rn(py, inv_cell))));
        const int jj = static_cast<int>(floor(add_rn(oj, mul_rn(px, inv_cell))));
        if (ii < 0 || ii >= H || jj < 0 || jj >= W) continue;
        const int di = ii - a_gi, dj = jj - a_gj;
        if (!(di * di + dj * dj < a_irsq)) continue;
        const int dei = ii - egi, dej = jj - egj;
        if (to_t(dei * dei + dej * dej, T()) < ersq) continue;
        if (k < m1) {
          m2 = m1;
          m1 = k;
        } else if (k > m1) {
          m2 = k;                                       // k < m2 by the loop bound
        }
      }
    }
  }
  if (!live) return;
  ovf[beam] = count > cs ? 1 : 0;
  const int ans = m1 >= kR ? -1 : (m2 >= kR ? kR - 1 : m2 - 1);
  out[beam] = ans >= 0 ? mul_rn(to_t(ans, T()), res) : static_cast<T>(6.0);
}

template <typename T>
int launch(void* const* ptr, int64_t hosts, int L, int nb, int ns, int cs, int wn, int H,
           int W, double oi, double oj, double inv_cell, double res, double inv_res,
           double t_max, void* stream) {
  if (cs < 1 || nb < 1 || L % nb != 0 || ns < 0 || wn < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hosts == 0 || L == 0) return 0;
  const int lb = L / nb;
  const int threads = lb >= kThreads ? kThreads : (lb + 31) / 32 * 32;
  const int chunks = (lb + threads - 1) / threads;
  if (hosts > 0x7fffffff || nb > 65535 || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = static_cast<size_t>(ns) * (5 * sizeof(T) + 3 * sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        laser_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(hosts), static_cast<unsigned int>(nb),
                  static_cast<unsigned int>(chunks));
  laser_fused_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ptr[0]), static_cast<const int*>(ptr[1]),
      static_cast<const int*>(ptr[2]), static_cast<const T*>(ptr[3]),
      static_cast<const T*>(ptr[4]), static_cast<const T*>(ptr[5]),
      static_cast<const int*>(ptr[6]), static_cast<const int*>(ptr[7]),
      static_cast<const int*>(ptr[8]), static_cast<const T*>(ptr[9]),
      static_cast<const T*>(ptr[10]), static_cast<const T*>(ptr[11]),
      static_cast<const T*>(ptr[12]), static_cast<const uint8_t*>(ptr[13]),
      static_cast<T*>(ptr[14]), static_cast<uint8_t*>(ptr[15]), L, nb, lb, ns, cs, wn, H, W,
      static_cast<T>(oi), static_cast<T>(oj), static_cast<T>(inv_cell), static_cast<T>(res),
      static_cast<T>(inv_res), static_cast<T>(t_max));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LASER_FUSED_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(void* pos_e, void* gi_e, void* gj_e, void* rsq_e, void* cos_a,        \
                      void* sin_a, void* gi_d, void* gj_d, void* irsq_d, void* relx,        \
                      void* rely, void* rel2, void* ro2, void* span_ok, void* out,          \
                      void* ovf, int64_t hosts, int L, int nb, int ns, int cs, int wn,      \
                      int H, int W, double oi, double oj, double inv_cell, double res,      \
                      double inv_res, double t_max, void* stream) {                        \
    void* const ptr[16] = {pos_e, gi_e, gj_e, rsq_e, cos_a, sin_a, gi_d, gj_d,              \
                           irsq_d, relx, rely, rel2, ro2, span_ok, out, ovf};               \
    return launch<T>(ptr, hosts, L, nb, ns, cs, wn, H, W, oi, oj, inv_cell, res, inv_res,   \
                     t_max, stream);                                                       \
  }

LASER_FUSED_ENTRY(laser_fused_f32, float)
LASER_FUSED_ENTRY(laser_fused_f64, double)
