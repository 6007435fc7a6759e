// K3: fused windowed, beam-compacted laserscan pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gym_collision_avoidance_tpu/ops/laser_pallas.py
// (`_make_kernel`, launched by `windowed_beam_compacted_pallas`), whose XLA twin
// is obs/sensors.py:_windowed_beam_compacted.  One thread per (host, beam),
// every env and every beam block in one launch (the Pallas kernel was vmapped
// over envs and scanned over 128-beam blocks):
//  1. screen: for each source s of the beam's block, t_c = relx*cos + rely*sin,
//     disc = ro2 - (rel2 - t_c^2); the source crosses the beam when disc > 0,
//     t_c + sqrt(disc) >= 0 and t_c - sqrt(disc) <= t_max (and span_ok);
//  2. compaction: the first Cs crossing sources, in source order, go to slots in
//     registers (window start k0 = clip(floor(t_lo * inv_res) - 1, 0, R), cell,
//     integer radius); a further crossing source sets the overflow flag;
//  3. window: Wn samples k0 .. k0 + Wn - 1 of each slot through the exact cell
//     test (on the map, inside the slot's source, outside the host's own disc),
//     and the two smallest distinct hit indices m1 < m2 give the range
//     (m2 - 1) * res, (R - 1) * res for a single hit, or 6 m for none.
// The window-span guard has no beam axis and stays in PyTorch in the wrapper.
// Two deliberate deviations from the XLA twin, kept from the Pallas kernel
// (laser_pallas.py:19-23): the overflow flag is the direct condition, and the
// integer radius is not clamped to 63.
//
// What bounds it on this card: at the fast-path config at full width (256 envs
// x 20 hosts x 512 beams, 9 candidates a block, Cs = 4, Wn = 12) a thread
// screens 9 sources (about 15 operations each) and tests at most 48 window
// samples (about 25 each); most beams cross no source and test none.  It reads
// the per-source scalars of its block (broadcast within a warp, which shares
// the host and block) and its cos/sin, and writes a range and a flag: some
// 16 MB at 2.6 M beams.  Bytes and operations are of the same order, so the
// bound is computed per run from the data (chip_smoke.py).  The design keeps
// every intermediate in registers; no shared memory.  No library call
// computes this function (library_ms is null).
//
// Exactness (kernel and plain PyTorch version are bitwise equal): the _rn
// intrinsics and --fmad=false (no FMA contraction), IEEE sqrt, quotients by
// the cell size and the range step as products with reciprocals rounded to
// the dtype, integer square sums converted with round to nearest before a
// float compare.  A window sample at k >= R does not exist: the XLA twin keeps
// it as an index >= R, which its first-hit rule reads as a miss, so stopping
// at R gives the same range.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kR = 60;            // range samples
constexpr int kMaxSlots = 8;      // laser_fused.MAX_SLOTS
constexpr int kThreads = 256;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float to_t(int v, float) { return __int2float_rn(v); }
__device__ __forceinline__ double to_t(int v, double) { return static_cast<double>(v); }

template <typename T>
__global__ void laser_fused_kernel(const T* __restrict__ pos_e,     // [N, 2], N = E*Ae hosts
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
                                   int64_t hosts, int L, int nb, int ns, int cs, int wn,
                                   int H, int W, T oi, T oj, T inv_cell, T res, T inv_res,
                                   T t_max) {
  const int64_t beam = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (beam >= hosts * L) return;
  const int64_t row = beam / L;
  const int l = static_cast<int>(beam - row * L);
  const int64_t base = (row * nb + l / (L / nb)) * ns;
  const T c = cos_a[beam], s = sin_a[beam];

  // ---- screen + stable first-come compaction ----
  int count = 0;
  int sk0[kMaxSlots], sgi[kMaxSlots], sgj[kMaxSlots], srs[kMaxSlots];
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) sk0[j] = sgi[j] = sgj[j] = srs[j] = 0;
  for (int q = 0; q < ns; ++q) {
    if (!span_ok[base + q]) continue;
    const T tc = add_rn(mul_rn(relx[base + q], c), mul_rn(rely[base + q], s));
    const T disc = sub_rn(ro2[base + q], sub_rn(rel2[base + q], mul_rn(tc, tc)));
    if (!(disc > T(0))) continue;
    const T half = sqrt_rn(disc);
    const T tlo = sub_rn(tc, half);
    if (!(add_rn(tc, half) >= T(0) && tlo <= t_max)) continue;
    if (count < cs) {
      int k0 = static_cast<int>(floor(mul_rn(tlo, inv_res))) - 1;
      k0 = k0 < 0 ? 0 : (k0 > kR ? kR : k0);
#pragma unroll
      for (int j = 0; j < kMaxSlots; ++j) {
        if (j == count) {
          sk0[j] = k0;
          sgi[j] = gi_d[base + q];
          sgj[j] = gj_d[base + q];
          srs[j] = irsq_d[base + q];
        }
      }
    }
    ++count;
  }
  ovf[beam] = count > cs ? 1 : 0;

  // ---- window pass: the two smallest distinct hit indices ----
  const T x0 = pos_e[2 * row], y0 = pos_e[2 * row + 1];
  const int egi = gi_e[row], egj = gj_e[row];
  const T ersq = rsq_e[row];
  const int filled = count < cs ? count : cs;
  int m1 = kR, m2 = kR;
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    if (j >= filled) break;
    for (int w = 0; w < wn; ++w) {
      const int k = sk0[j] + w;
      if (k >= kR) break;
      const T rr = mul_rn(to_t(k, T()), res);
      const T px = add_rn(x0, mul_rn(rr, c));
      const T py = add_rn(y0, mul_rn(rr, s));
      const int ii = static_cast<int>(floor(sub_rn(oi, mul_rn(py, inv_cell))));
      const int jj = static_cast<int>(floor(add_rn(oj, mul_rn(px, inv_cell))));
      if (ii < 0 || ii >= H || jj < 0 || jj >= W) continue;
      const int di = ii - sgi[j], dj = jj - sgj[j];
      if (!(di * di + dj * dj < srs[j])) continue;
      const int dei = ii - egi, dej = jj - egj;
      if (to_t(dei * dei + dej * dej, T()) < ersq) continue;
      if (k < m1) {
        m2 = m1;
        m1 = k;
      } else if (k > m1 && k < m2) {
        m2 = k;
      }
    }
  }
  const int ans = m1 >= kR ? -1 : (m2 >= kR ? kR - 1 : m2 - 1);
  out[beam] = ans >= 0 ? mul_rn(to_t(ans, T()), res) : static_cast<T>(6.0);
}

template <typename T>
int launch(void* const* ptr, int64_t hosts, int L, int nb, int ns, int cs, int wn, int H,
           int W, double oi, double oj, double inv_cell, double res, double inv_res,
           double t_max, void* stream) {
  if (cs < 1 || cs > kMaxSlots || nb < 1 || L % nb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t beams = hosts * L;
  if (beams == 0) return 0;
  const int64_t blocks = (beams + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  laser_fused_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ptr[0]), static_cast<const int*>(ptr[1]),
      static_cast<const int*>(ptr[2]), static_cast<const T*>(ptr[3]),
      static_cast<const T*>(ptr[4]), static_cast<const T*>(ptr[5]),
      static_cast<const int*>(ptr[6]), static_cast<const int*>(ptr[7]),
      static_cast<const int*>(ptr[8]), static_cast<const T*>(ptr[9]),
      static_cast<const T*>(ptr[10]), static_cast<const T*>(ptr[11]),
      static_cast<const T*>(ptr[12]), static_cast<const uint8_t*>(ptr[13]),
      static_cast<T*>(ptr[14]), static_cast<uint8_t*>(ptr[15]), hosts, L, nb, ns, cs, wn, H,
      W, static_cast<T>(oi), static_cast<T>(oj), static_cast<T>(inv_cell), static_cast<T>(res),
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
