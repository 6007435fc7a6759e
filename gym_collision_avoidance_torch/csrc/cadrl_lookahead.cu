// SA-CADRL's one-step lookahead in one launch, for Hopper (sm_90a):
//
//   s10 [n, 10], others_s10 [n, 3, 10], others_action [n, 3, 2], present [n, 3]
//     -> 47 candidate actions -> collision test against the 3 other slots
//        (front-agent projection, segment distances) -> shaped rewards
//     -> the ego and the others propagated one lookahead step
//     -> reached / needs-the-net flags -> the first row that asks the net
//     -> the closest other to slot 0 -> the agent-centric encoding
//     -> states_nn [n, 47, 31] and the aux fields the value stage reads
//
// where n = E * A ego agents.  It is policies/cadrl.py:_cadrl_prepare after
// _select_others in cadrl_mode "no_constr" with no passing side, and replaces
// no Pallas kernel: the JAX package leaves this stage to XLA, which fuses it
// (gym_collision_avoidance_tpu/policies/cadrl.py).  It was added because the
// plain PyTorch version makes about 400 launches a step, most of them over
// [E, A, 47, .] tensors, and ends in a stack of 31 columns into
// [E, A, 47, 31] with a stride of 31 elements: at cadrl4's E = 16384 that
// stack alone wrote 382 MB at about 70 GB/s, and the host spent about 21 us
// on each launch, as long as the card spent on the step.
//
// What bounds it on this card: bytes, 4 * (31 + 4) + 3 = 143 a candidate row
// in float32 (states_nn, speed, heading, reward, d_next and three flags),
// 0.13 ms a step at 3.35 TB/s for cadrl4's 3 080 192 rows; the arithmetic
// (two sincos, two atan2, eight remainders, a dozen roots and quotients a
// row) costs about as much.  The design:
//  * A block of G agents (4 in float32, 2 in float64), one thread a
//    candidate row: 188 of 192 threads busy.
//  * Phase 1 loads the block's inputs into shared memory; phase 2 gives one
//    thread to each other slot (its velocity, angles, collision cone,
//    propagated state) and one to each ego agent (the lookahead horizon, the
//    getting-close penalty, the candidate tables' inputs).
//  * Phase 3 runs one candidate in registers: collision against the 3
//    slots, rewards, propagation, flags, written straight out (consecutive
//    threads, consecutive addresses).  A warp ballot of needs-the-net gives
//    each agent its first such row.
//  * Phase 4 encodes each row against the reordered slots into a shared
//    staging buffer, stride 31 (coprime with the 32 banks); the block's
//    G * 47 * 31 elements are contiguous in states_nn and start on 16 bytes
//    (G * 47 * 31 * sizeof(T) is a multiple of 16), so they leave in 16-byte
//    stores.
//
// Exactness: the plain route's bits on the card in float32, op by op in
// PyTorch's order.  The same libdevice functions as PyTorch's CUDA kernels
// (sin, cos, atan2, asin, pow, fmod; bitwise equal to torch's under this
// build's flags, float32 and float64, except float64 pow, which may differ by
// an ulp); no FMA contraction (the _rn intrinsics and the build's
// --fmad=false); quotients IEEE-rounded, a quotient by a Python scalar a
// product with its reciprocal (PyTorch's CUDA division by a scalar; all such
// reciprocals here are powers of 2); every Python float rounded to T once, as
// PyTorch rounds a scalar for a tensor of T; torch.remainder as fmod then
// "+ b when the signs differ"; torch.clamp, minimum and amin keep or
// propagate NaN as torch does, and argmin takes the first NaN, else the first
// least value; a gathered row and _dot's partial sum get PyTorch's + 0.0
// (which turns -0.0 into +0.0).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 3;          // other agents the net sees
constexpr int kCand = 47;          // candidate actions in no_constr mode
constexpr int kWidth = 31;         // an encoded row

// np.linspace(-pi / 3, pi / 3, 10) (policies/cadrl.py:_TABLES), as doubles
__constant__ double kNearOffsets[10] = {
    -1.0471975511965976, -0.8144869842640203, -0.5817764173314431, -0.34906585039886595,
    -0.11635528346628865, 0.11635528346628865, 0.34906585039886573, 0.581776417331443,
    0.8144869842640203, 1.0471975511965976};
__constant__ double kNearScales[4] = {1.0, 0.75, 0.50, 0.25};
__constant__ double kDesiredScales[5] = {1.0, 0.80, 0.60, 0.40, 0.20};

constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kGamma = 0.97;
constexpr double kEps = 1e-5;
constexpr double kClose = 0.2;               // GETTING_CLOSE_RANGE
constexpr double kCollisionCost = -0.25;
constexpr double kGoalThres = 0.05;          // DIST_2_GOAL_THRES

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

template <typename T>
__device__ __forceinline__ T c(double v) { return static_cast<T>(v); }

template <typename T>
__device__ __forceinline__ bool isnan_t(T v) { return v != v; }

// torch.clamp(v, min=lo) / (max=hi) / (lo, hi): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) { return isnan_t(v) ? v : fmax(v, lo); }
template <typename T>
__device__ __forceinline__ T clamp_max(T v, T hi) { return isnan_t(v) ? v : fmin(v, hi); }
template <typename T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) {
  return isnan_t(v) ? v : fmin(fmax(v, lo), hi);
}

// torch.minimum, and one step of torch.amin: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return isnan_t(a) ? a : (isnan_t(b) ? b : fmin(a, b));
}

// maths.norm2 of (x, y): sqrt_rn(x * x + y * y)
template <typename T>
__device__ __forceinline__ T norm2(T x, T y) {
  return sqrt_rn(add_rn(mul_rn(x, x), mul_rn(y, y)));
}

// policies/cadrl.py:_dot: a0 * b0 + 0.0 + a1 * b1
template <typename T>
__device__ __forceinline__ T dot(T ax, T ay, T bx, T by) {
  return add_rn(add_rn(mul_rn(ax, bx), c<T>(0.0)), mul_rn(ay, by));
}

// policies/cadrl.py:_mod_wrap: torch.remainder(a + pi, 2 pi) - pi
template <typename T>
__device__ __forceinline__ T mod_wrap(T a) {
  const T b = c<T>(kTwoPi);
  T m = fmod(add_rn(a, c<T>(kPi)), b);
  if (m != c<T>(0.0) && ((b < c<T>(0.0)) != (m < c<T>(0.0)))) m = add_rn(m, b);
  return sub_rn(m, c<T>(kPi));
}

// the per-agent values that every candidate row of the agent reads
template <typename T>
struct Agent {
  T s10[10];
  T dt, horizon, gcp, cur_speed, desired, head0;
};

// the per-slot values
template <typename T>
struct Slot {
  T pos[2];       // others_s10[0:2]
  T ov[2];        // the filtered action as a velocity
  T osa, poa;     // its angle; the angle from the ego to the other
  T coll_angle, dist_eo, radius;
  T next[10];     // the other propagated one lookahead step
  bool present, too_far;
};

// policies/cadrl.py:_cadrl_prepare's lookahead horizon from an ego s10
template <typename T>
__device__ __forceinline__ T horizon_dt(const T* s) {
  const T pref = s[5];
  const T dist_to_goal = norm2(sub_rn(s[6], s[0]), sub_rn(s[7], s[1]));
  return min_nan(clamp_min(div_rn(c<T>(0.5), pref), c<T>(1.0)), div_rn(dist_to_goal, pref));
}

template <typename T, int G>
struct Shared {
  Agent<T> agent[G];
  Slot<T> slot[G][kSlots];
  T in_others[G * kSlots * 10];
  T in_action[G * kSlots * 2];
  bool in_present[G * kSlots];
  unsigned ballot[(G * kCand + 31) / 32];
  int first[G];
  // phase 3 keeps each row's next position here for the first-row lookup;
  // phase 4 reuses the buffer as the staging of the encoded rows
  alignas(16) T stage[G * kCand * kWidth];
};

template <typename T, int G>
__global__ void __launch_bounds__((G * kCand + 31) / 32 * 32)
cadrl_lookahead_kernel(const T* __restrict__ s10, const T* __restrict__ others_s10,
                       const T* __restrict__ others_action, const bool* __restrict__ present,
                       T* __restrict__ states_nn, T* __restrict__ rows, bool* __restrict__ flags,
                       T* __restrict__ dt_forward, int64_t n) {
  __shared__ Shared<T, G> sh;
  const int tid = threadIdx.x;
  const int64_t agent0 = static_cast<int64_t>(blockIdx.x) * G;
  const int live = static_cast<int>(n - agent0 < G ? n - agent0 : G);

  // ---- phase 1: the block's inputs
  for (int i = tid; i < live * 10; i += blockDim.x)
    sh.agent[i / 10].s10[i % 10] = s10[agent0 * 10 + i];
  for (int i = tid; i < live * kSlots * 10; i += blockDim.x)
    sh.in_others[i] = others_s10[agent0 * kSlots * 10 + i];
  for (int i = tid; i < live * kSlots * 2; i += blockDim.x)
    sh.in_action[i] = others_action[agent0 * kSlots * 2 + i];
  for (int i = tid; i < live * kSlots; i += blockDim.x)
    sh.in_present[i] = present[agent0 * kSlots + i];
  __syncthreads();

  // ---- phase 2: one thread a slot, one an ego agent
  if (tid < live * (kSlots + 1)) {
    const int g = tid / (kSlots + 1), j = tid % (kSlots + 1);
    const T* e = sh.agent[g].s10;
    const T dt = horizon_dt(e);
    if (j < kSlots) {
      const T* o = sh.in_others + (g * kSlots + j) * 10;
      const T speed = sh.in_action[(g * kSlots + j) * 2];
      const T angle = sh.in_action[(g * kSlots + j) * 2 + 1];
      Slot<T>& s = sh.slot[g][j];
      const T co = cos(angle), so = sin(angle);
      s.pos[0] = o[0];
      s.pos[1] = o[1];
      s.ov[0] = mul_rn(speed, co);
      s.ov[1] = mul_rn(speed, so);
      s.osa = atan2(s.ov[1], s.ov[0]);
      s.poa = atan2(sub_rn(o[1], e[1]), sub_rn(o[0], e[0]));
      s.dist_eo = norm2(sub_rn(e[0], o[0]), sub_rn(e[1], o[1]));
      s.radius = add_rn(add_rn(e[8], o[8]), c<T>(0.0));
      const T r_close = add_rn(add_rn(e[8], o[8]), c<T>(kClose));
      s.coll_angle = fabs(asin(clamp_max(div_rn(r_close, clamp_min(s.dist_eo, c<T>(1e-30))),
                                         c<T>(0.95))));
      s.too_far = s.dist_eo > add_rn(mul_rn(add_rn(e[5], speed), dt), s.radius);
      s.present = sh.in_present[g * kSlots + j];
      s.next[0] = add_rn(o[0], mul_rn(s.ov[0], dt));
      s.next[1] = add_rn(o[1], mul_rn(s.ov[1], dt));
      s.next[2] = s.ov[0];
      s.next[3] = s.ov[1];
      s.next[4] = angle;
      for (int f = 5; f < 10; ++f) s.next[f] = o[f];
    } else {
      Agent<T>& a = sh.agent[g];
      a.dt = dt;
      a.horizon = clamp_max(dt, c<T>(1.0));
      // _gcp: gamma ** (d / 0.5) * (1 - gamma ** (-v / 0.5))
      const T d = norm2(sub_rn(e[0], e[6]), sub_rn(e[1], e[7]));
      a.gcp = mul_rn(pow(c<T>(kGamma), mul_rn(d, c<T>(2.0))),
                     sub_rn(c<T>(1.0), pow(c<T>(kGamma), mul_rn(-e[5], c<T>(2.0)))));
      a.cur_speed = norm2(e[2], e[3]);
      a.desired = mod_wrap(atan2(sub_rn(e[7], e[1]), sub_rn(e[6], e[0])));
      a.head0 = mod_wrap(e[4]);
      dt_forward[agent0 + g] = dt;
    }
  }
  __syncthreads();

  // ---- phase 3: one thread a candidate row
  const int g = tid / kCand, k = tid % kCand;
  const bool active = g < live;
  const int64_t row = (agent0 + g) * kCand + k;
  const int64_t plane = n * kCand;
  T next[10];
  T av[2] = {c<T>(0.0), c<T>(0.0)}, vel_norm = c<T>(0.0);
  T ch = c<T>(0.0), sn = c<T>(0.0);   // cos and sin of the candidate's heading
  bool needs_nn = false;
  if (active) {
    const Agent<T>& a = sh.agent[g];
    const T* e = a.s10;
    const T pref = e[5];
    T speed, heading;
    if (k == 0) {
      speed = a.cur_speed;
      heading = a.head0;
    } else if (k <= 5) {
      speed = mul_rn(pref, c<T>(kDesiredScales[k - 1]));
      heading = a.desired;
    } else if (k == 6) {
      speed = c<T>(0.0);
      heading = c<T>(0.0);
    } else {
      speed = mul_rn(pref, c<T>(kNearScales[(k - 7) / 10]));
      heading = mod_wrap(add_rn(e[4], c<T>(kNearOffsets[(k - 7) % 10])));
    }
    ch = cos(heading);
    sn = sin(heading);
    av[0] = mul_rn(speed, ch);
    av[1] = mul_rn(speed, sn);
    const T asa = atan2(av[1], av[0]);
    vel_norm = norm2(av[0], av[1]);
    const T x2[2] = {add_rn(e[0], mul_rn(a.horizon, av[0])),
                     add_rn(e[1], mul_rn(a.horizon, av[1]))};

    // _if_actions_collide against each slot; min and any over present slots
    T min_dists = c<T>(INFINITY), cur_dist = c<T>(INFINITY);
    bool if_collide = false;
    for (int i = 0; i < kSlots; ++i) {
      const Slot<T>& s = sh.slot[g][i];
      const T heading_diff = mod_wrap(sub_rn(asa, s.osa));
      const T heading_2_other = mod_wrap(sub_rn(asa, s.poa));
      const bool front = (fabs(heading_2_other) < s.coll_angle)
                         && (fabs(heading_diff) < c<T>(kPi / 2.0));
      T d = dot(av[0], av[1], s.ov[0], s.ov[1]);
      if (av[0] > c<T>(kEps)) d = div_rn(d, clamp_min(vel_norm, c<T>(1e-30)));
      T ov[2] = {s.ov[0], s.ov[1]};
      if (front) {
        ov[0] = sub_rn(ov[0], mul_rn(mul_rn(d, av[0]), c<T>(0.5)));
        ov[1] = sub_rn(ov[1], mul_rn(mul_rn(d, av[1]), c<T>(0.5)));
      }
      const T y2[2] = {add_rn(s.pos[0], mul_rn(a.horizon, ov[0])),
                       add_rn(s.pos[1], mul_rn(a.horizon, ov[1]))};
      // _seg_min_dists(x1 = e, x2, y1 = s.pos, y2)
      const T end_dist = norm2(sub_rn(x2[0], y2[0]), sub_rn(x2[1], y2[1]));
      const T dx[2] = {sub_rn(x2[0], e[0]), sub_rn(x2[1], e[1])};
      const T dy[2] = {sub_rn(y2[0], s.pos[0]), sub_rn(y2[1], s.pos[1])};
      const T z[2] = {sub_rn(dx[0], dy[0]), sub_rn(dx[1], dy[1])};
      const T zz = dot(z[0], z[1], z[0], z[1]);
      const bool nonzero = sqrt_rn(zz) > c<T>(0.0);
      const T t_bar = div_rn(-dot(sub_rn(e[0], s.pos[0]), sub_rn(e[1], s.pos[1]), z[0], z[1]),
                             nonzero ? zz : c<T>(1.0));
      const T dist_bar = norm2(
          sub_rn(add_rn(e[0], mul_rn(dx[0], t_bar)), add_rn(s.pos[0], mul_rn(dy[0], t_bar))),
          sub_rn(add_rn(e[1], mul_rn(dx[1], t_bar)), add_rn(s.pos[1], mul_rn(dy[1], t_bar))));
      const bool use_crit = nonzero && (t_bar > c<T>(0.0)) && (t_bar < c<T>(1.0));
      T md = min_nan(end_dist, use_crit ? dist_bar : end_dist);
      const T r = s.radius;
      bool ifc = (s.dist_eo < r) || (md < r);
      md = sub_rn(md, r);
      if (s.too_far) md = add_rn(add_rn(r, c<T>(kClose)), c<T>(kEps));
      ifc = ifc && !s.too_far;
      if (s.present) {
        min_dists = min_nan(min_dists, md);
        if_collide = if_collide || ifc;
        cur_dist = min_nan(cur_dist, sub_rn(s.dist_eo, s.radius));
      }
    }

    // _action_rewards
    const T gcp = a.gcp;
    T rewards = cur_dist < c<T>(kClose) ? gcp : c<T>(0.0);
    const bool close = (min_dists > c<T>(0.0)) && (min_dists < c<T>(kClose));
    if (close) rewards = add_rn(rewards, gcp);
    if (min_dists < c<T>(0.0)) rewards = c<T>(kCollisionCost);
    const T shaped = add_rn(mul_rn(rewards, c<T>(2.0)),
                            mul_rn(mul_rn(gcp, c<T>(5.0)), sub_rn(c<T>(kClose), min_dists)));
    if (close) rewards = clamp(shaped, c<T>(kCollisionCost + 0.01), c<T>(0.0));
    if (cur_dist < c<T>(0.0)) rewards = c<T>(kCollisionCost);

    // _update_states (no_constr), d_next, reached
    next[0] = add_rn(e[0], mul_rn(av[0], a.dt));
    next[1] = add_rn(e[1], mul_rn(av[1], a.dt));
    next[2] = av[0];
    next[3] = av[1];
    next[4] = heading;
    for (int f = 5; f < 10; ++f) next[f] = e[f];
    const T d_next = norm2(sub_rn(next[0], next[6]), sub_rn(next[1], next[7]));
    const bool reached = (d_next < c<T>(kGoalThres)) && (min_dists > c<T>(kClose));
    needs_nn = !if_collide && !reached;

    rows[row] = speed;
    rows[plane + row] = heading;
    rows[2 * plane + row] = rewards;
    rows[3 * plane + row] = d_next;
    flags[row] = true;
    flags[plane + row] = if_collide;
    flags[2 * plane + row] = reached;
    sh.stage[2 * tid] = next[0];
    sh.stage[2 * tid + 1] = next[1];
  }
  const unsigned vote = __ballot_sync(0xffffffffu, needs_nn);
  if ((tid & 31) == 0) sh.ballot[tid >> 5] = vote;
  __syncthreads();

  // the first row of each agent that asks the net (argmax of needs_nn), 0 if none
  if (tid < live) {
    const int lo = tid * kCand, hi = lo + kCand;
    int first = -1;
    for (int w = lo / 32; w <= (hi - 1) / 32 && first < 0; ++w) {
      unsigned m = sh.ballot[w];
      const int base = 32 * w;
      if (lo > base) m &= ~0u << (lo - base);
      if (hi < base + 32) m &= (1u << (hi - base)) - 1u;
      if (m) first = base + __ffs(m) - 1 - lo;
    }
    sh.first[tid] = first < 0 ? 0 : first;
  }
  __syncthreads();
  T first_pos[2] = {c<T>(0.0), c<T>(0.0)};
  if (active) {
    const int f = g * kCand + sh.first[g];
    first_pos[0] = add_rn(sh.stage[2 * f], c<T>(0.0));
    first_pos[1] = add_rn(sh.stage[2 * f + 1], c<T>(0.0));
  }
  __syncthreads();   // the stage buffer is now the encoded rows'

  // ---- phase 4: the closest other to slot 0, and _encode
  if (active) {
    const Slot<T>* sl = sh.slot[g];
    int closest = 0;
    T best = c<T>(0.0);
    for (int i = 0; i < kSlots; ++i) {
      const T d = sl[i].present ? norm2(sub_rn(sl[i].next[0], first_pos[0]),
                                        sub_rn(sl[i].next[1], first_pos[1]))
                                : c<T>(INFINITY);
      // torch.argmin: the first NaN, else the first least value
      if (i == 0 || (isnan_t(d) && !isnan_t(best)) || (!isnan_t(best) && d < best)) {
        closest = i;
        best = d;
      }
    }
    const T gd[2] = {sub_rn(next[6], next[0]), sub_rn(next[7], next[1])};
    const T dist_to_goal = clamp(norm2(gd[0], gd[1]), c<T>(0.0), c<T>(30.0));
    T prll[2];
    if (dist_to_goal > c<T>(kEps)) {
      const T safe = clamp_min(dist_to_goal, c<T>(1e-30));
      prll[0] = div_rn(gd[0], safe);
      prll[1] = div_rn(gd[1], safe);
    } else {
      prll[0] = ch;                        // cos and sin of next[4], the heading
      prll[1] = sn;
    }
    const T orth[2] = {-prll[1], prll[0]};
    const T heading = mod_wrap(sub_rn(next[4], atan2(prll[1], prll[0])));
    const T cur_speed = vel_norm;          // norm2(next[2:4]) = norm2(av)
    const T radius = next[8];
    T* out = sh.stage + tid * kWidth;
    out[0] = dist_to_goal;
    out[1] = next[5];
    out[2] = cur_speed;
    out[3] = heading;
    out[4] = mul_rn(cur_speed, cos(heading));
    out[5] = mul_rn(cur_speed, sin(heading));
    out[6] = radius;
    T block0[7];
    for (int s = 0; s < kSlots; ++s) {
      // _swap_slot0's permutation, the gathered row + 0.0
      const int src = s == 0 ? closest : (s == closest ? 0 : s);
      const T* on = sl[src].next;
      const T o[2] = {add_rn(on[0], c<T>(0.0)), add_rn(on[1], c<T>(0.0))};
      const T ov[2] = {add_rn(on[2], c<T>(0.0)), add_rn(on[3], c<T>(0.0))};
      const T o_r = add_rn(on[8], c<T>(0.0));
      const T rel[2] = {sub_rn(o[0], next[0]), sub_rn(o[1], next[1])};
      const T ovx = dot(ov[0], ov[1], prll[0], prll[1]);
      const T ovy = dot(ov[0], ov[1], orth[0], orth[1]);
      const T d2o = sub_rn(sub_rn(norm2(sub_rn(next[0], o[0]), sub_rn(next[1], o[1])), radius), o_r);
      const T field[8] = {
          ovx, ovy,
          clamp(dot(rel[0], rel[1], prll[0], prll[1]), c<T>(-8.0), c<T>(8.0)),
          clamp(dot(rel[0], rel[1], orth[0], orth[1]), c<T>(-8.0), c<T>(8.0)),
          o_r, add_rn(radius, o_r), clamp(d2o, c<T>(-3.0), c<T>(10.0)),
          add_rn(mul_rn(ovx, ovx), mul_rn(ovy, ovy)) < c<T>(kEps) ? c<T>(2.0) : c<T>(1.0)};
      if (s == 0)
        for (int f = 0; f < 7; ++f) block0[f] = field[f];
      const bool on_slot = sl[src].present;
      for (int f = 0; f < 8; ++f)
        out[7 + 8 * s + f] = on_slot ? field[f] : (f < 7 ? block0[f] : c<T>(0.0));
    }
  }
  __syncthreads();

  // the block's rows are contiguous in states_nn and start on 16 bytes
  constexpr int kVec = 16 / sizeof(T);
  const int total = live * kCand * kWidth;
  T* dst = states_nn + agent0 * kCand * kWidth;
  const int vecs = total / kVec;
  if constexpr (sizeof(T) == 4) {
    const float4* src4 = reinterpret_cast<const float4*>(sh.stage);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = tid; i < vecs; i += blockDim.x) dst4[i] = src4[i];
  } else {
    const double2* src2 = reinterpret_cast<const double2*>(sh.stage);
    double2* dst2 = reinterpret_cast<double2*>(dst);
    for (int i = tid; i < vecs; i += blockDim.x) dst2[i] = src2[i];
  }
  for (int i = vecs * kVec + tid; i < total; i += blockDim.x) dst[i] = sh.stage[i];
}

template <typename T>
int launch(const void* s10, const void* others_s10, const void* others_action,
           const void* present, void* states_nn, void* rows, void* flags, void* dt_forward,
           int64_t n, void* stream) {
  if (n <= 0) return 0;
  constexpr int G = 16 / sizeof(T);   // agents a block: 4 in float32, 2 in float64
  static_assert(G * kCand * kWidth * sizeof(T) % 16 == 0, "a block's rows start on 16 bytes");
  constexpr int threads = (G * kCand + 31) / 32 * 32;
  const int64_t blocks = (n + G - 1) / G;
  cadrl_lookahead_kernel<T, G><<<static_cast<unsigned>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s10), static_cast<const T*>(others_s10),
      static_cast<const T*>(others_action), static_cast<const bool*>(present),
      static_cast<T*>(states_nn), static_cast<T*>(rows), static_cast<bool*>(flags),
      static_cast<T*>(dt_forward), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s10 [n, 10], others_s10 [n, 3, 10], others_action [n, 3, 2], present [n, 3]
// (bool); out: states_nn [n, 47, 31] (16-byte aligned), rows [4, n, 47]
// (speed, heading, reward, d_next), flags [3, n, 47] (bool: valid,
// if_collide, reached), dt_forward [n]; all contiguous on the current
// device.  Returns cudaGetLastError() after the launch.
extern "C" int cadrl_lookahead_f32(const void* s10, const void* others_s10,
                                   const void* others_action, const void* present,
                                   void* states_nn, void* rows, void* flags, void* dt_forward,
                                   int64_t n, void* stream) {
  return launch<float>(s10, others_s10, others_action, present, states_nn, rows, flags,
                       dt_forward, n, stream);
}

extern "C" int cadrl_lookahead_f64(const void* s10, const void* others_s10,
                                   const void* others_action, const void* present,
                                   void* states_nn, void* rows, void* flags, void* dt_forward,
                                   int64_t n, void* stream) {
  return launch<double>(s10, others_s10, others_action, present, states_nn, rows, flags,
                        dt_forward, n, stream);
}
