// K1: pairwise collision / nearest-gap kernel for Hopper (sm_90a), with the
// env step's whole reward stage as an optional epilogue.
//
// Replaces the Pallas TPU kernel gym_collision_avoidance_tpu/ops/pairwise.py
// (`_kernel`, launched by `pairwise_collisions(..., backend="pallas")`),
// whose XLA twin is env/step.py:_pairwise_collisions.  For each agent i of
// each env:
//   collision[i] = any_j valid_pair(i, j) && dist_ij <= r_i + r_j
//   nearest[i]   = min_j over valid pairs of (dist_ij - r_i - r_j), +inf if none
// where a valid pair has i != j and both agents valid.
//
// The reward epilogue (kRewards, entry pairwise_rewards_*) then computes, in
// the row's first lane and in the order of the plain chain
// (ops/pairwise.py:reward_chain_plain, the JAX package's
// env/step.py:_compute_rewards):
//   r = time_step; r = at_goal where is_at_goal & ~was_at_goal_already
//   eligible = ~is_at_goal & ~was_in_collision_already
//   hit_agent = eligible & collision               -> r = collision_with_agent
//   hit_wall  = eligible & ~collision & wall       -> r = collision_with_wall
//   no_hit    = eligible & ~collision & ~wall
//   no_hit & nearest <= close_range                -> r = getting_close - nearest / 2
//   no_hit & |past_actions[e, i, 0, 1]| > wiggly_threshold -> r = r + wiggly
//   r = clip(r, clip_lo, clip_hi) (NaN stays NaN); r = valid ? r : 0
//   in_collision_out = in_collision | hit_agent | hit_wall
// wall is an optional [E, A] bool mask (null: no static map).
//
// What bounds it on this card: at the main path's E = 16384, A = 4, f32, K1
// alone moves 1.18 MB (0.35 us at 3.35 TB/s) and the launch with the reward
// epilogue 2.03 MB (0.61 us), both below the 1.5 us a launch costs at the
// least.  So the design is for latency, not bytes:
//  * The reward stage was some 40 elementwise launches of PyTorch's a step;
//    as an epilogue it costs no launch of its own, and it reads and writes a
//    handful of bytes a row beside K1's.
//  * All the row's loads (its position, radius and flags, the epilogue's
//    inputs) are issued before the partner loop, so their DRAM latencies
//    overlap.  Written after K1's stores, the compiler could not hoist them
//    (the pointers may alias), and they cost one more round trip.
//  * `lanes` adjacent threads share a row and split its A partners, then
//    combine the partial minimum and hit flag with warp shuffles: one thread
//    a row leaves each thread a serial chain of A partners (L1 loads and
//    square roots) with only E * A threads on the card, which cost most at
//    A = 20 and 40.  Too many lanes cost more than they save, since every
//    thread has a fixed cost; the wrapper (ops/pairwise.py:lanes_for) gives
//    a row about A / 4 lanes, 1 on the main path.
// No shared memory and none of the TPU's 8-env VMEM blocks: an env's partner
// rows stay in L1.  No single PyTorch call computes this function, so the
// measurement has no library yardstick (library_ms is null).
//
// Exactness (kernel and plain PyTorch version are bitwise equal):
//  1. FMA contraction: nvcc would fuse dx*dx + dy*dy into an FMA, 1 ulp off
//     the plain version and maths.norm2.  The arithmetic uses the _rn
//     intrinsics, which are never contracted, and the build passes
//     --fmad=false as well.
//  2. No --use_fast_math: the square root is the IEEE round-to-nearest one
//     (__fsqrt_rn / __dsqrt_rn).
//  3. NaN propagation: fminf drops NaNs, but torch.amin and jnp.min
//     propagate them, so the running minimum takes g when g < best or g is
//     NaN; a NaN best then stays NaN.  The clip keeps a NaN reward as
//     torch.clamp does, so it compares instead of calling fminf / fmaxf.
//  4. A row with no valid partner (or an invalid agent) gives +INFINITY.
//  5. The constants arrive rounded to T, as PyTorch rounds a Python scalar
//     for a tensor of T, and every comparison runs in T.  nearest / 2 is
//     nearest * 0.5: the same correctly rounded value (PyTorch's CUDA
//     division by a scalar multiplies by its reciprocal, the CPU's divides).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// The reward constants, in the order ops/pairwise.py:reward_constants gives.
enum {
  kTimeStep, kAtGoal, kCollisionWithAgent, kCollisionWithWall, kGettingClose,
  kCloseRange, kWiggly, kWigglyThreshold, kClipLo, kClipHi, kNumConsts
};

// The reward epilogue's inputs and outputs (unused by K1 alone).
template <typename T>
struct RewardArgs {
  const uint8_t* is_at_goal;        // [E, A]
  const uint8_t* was_at_goal;       // [E, A]
  const uint8_t* was_in_collision;  // [E, A]
  const uint8_t* in_collision;      // [E, A]
  const T* past_actions;            // [E, A, P, 2]
  const uint8_t* wall;              // [E, A] or null
  uint8_t* in_collision_out;        // [E, A]
  T* reward;                        // [E, A]
  int num_past_actions;             // P
  T c[kNumConsts];
};

// NaN-propagating minimum, as torch.amin and jnp.min take it: b when b < a
// or b is NaN; a NaN a stays.  Exact and order-free (no gap is -0.0), so
// the lanes of a row may combine their partial minima in any order.
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (b < a || isnan(b)) ? b : a;
}

template <typename T, bool kRewards>
__global__ void pairwise_kernel(const T* __restrict__ pos,       // [E, A, 2]
                                const T* __restrict__ radius,    // [E, A]
                                const uint8_t* __restrict__ valid,  // [E, A]
                                uint8_t* __restrict__ collision,    // [E, A]
                                T* __restrict__ nearest,            // [E, A]
                                int64_t rows, int num_agents, int lanes,
                                RewardArgs<T> rw) {
  // `lanes` (a power of two <= 32) adjacent threads share one (env, i) row
  // and split its partners j = lane, lane + lanes, ...; every lane of a
  // warp reaches the shuffles below, the lanes past the last row too.
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = t / lanes;
  const int lane = static_cast<int>(t % lanes);
  const bool active = row < rows;
  const int64_t env = active ? row / num_agents : 0;
  const int i = active ? static_cast<int>(row - env * num_agents) : 0;
  const T* p = pos + env * num_agents * 2;
  const T* r = radius + env * num_agents;
  const uint8_t* v = valid + env * num_agents;

  // Every load of the row is issued before the loop, so their latencies
  // overlap instead of following each other.
  const bool vi = active && v[i] != 0;
  const T xi = p[2 * i];
  const T yi = p[2 * i + 1];
  const T ri = r[i];
  const bool leader = active && lane == 0;
  bool at_goal = false, was_goal = false, was_coll = false, in_coll = false, wall = false;
  T turn = static_cast<T>(0);
  if (kRewards && leader) {
    at_goal = rw.is_at_goal[row] != 0;
    was_goal = rw.was_at_goal[row] != 0;
    was_coll = rw.was_in_collision[row] != 0;
    in_coll = rw.in_collision[row] != 0;
    wall = rw.wall != nullptr && rw.wall[row] != 0;
    turn = rw.past_actions[row * rw.num_past_actions * 2 + 1];  // [e, i, 0, 1]
  }

  T best = static_cast<T>(INFINITY);
  bool hit = false;
  if (active) {
    for (int j = lane; j < num_agents; j += lanes) {
      const bool vj = v[j] != 0;
      const T xj = p[2 * j];
      const T yj = p[2 * j + 1];
      const T rj = r[j];
      if (!vi || j == i || !vj) continue;
      // Same operand order as the plain version: rel = pos_j - pos_i.
      const T dx = sub_rn(xj, xi);
      const T dy = sub_rn(yj, yi);
      const T dist = sqrt_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)));
      const T comb = add_rn(ri, rj);
      best = min_nan(best, sub_rn(dist, comb));
      hit = hit || (dist <= comb);
    }
  }
  for (int offset = lanes / 2; offset > 0; offset /= 2) {
    best = min_nan(best, __shfl_xor_sync(0xffffffffu, best, offset));
    hit = __shfl_xor_sync(0xffffffffu, static_cast<int>(hit), offset) != 0 || hit;
  }
  if (!leader) return;
  collision[row] = hit ? 1 : 0;
  nearest[row] = best;

  if constexpr (kRewards) {
    const T* c = rw.c;
    T rew = c[kTimeStep];
    if (at_goal && !was_goal) rew = c[kAtGoal];
    const bool eligible = !at_goal && !was_coll;
    const bool hit_agent = eligible && hit;
    const bool hit_wall = eligible && !hit && wall;
    if (hit_agent) rew = c[kCollisionWithAgent];
    if (hit_wall) rew = c[kCollisionWithWall];
    const bool no_hit = eligible && !hit && !wall;
    if (no_hit && best <= c[kCloseRange])
      rew = sub_rn(c[kGettingClose], mul_rn(best, static_cast<T>(0.5)));
    if (no_hit && fabs(turn) > c[kWigglyThreshold]) rew = add_rn(rew, c[kWiggly]);
    if (!isnan(rew)) {
      if (rew < c[kClipLo]) rew = c[kClipLo];
      if (rew > c[kClipHi]) rew = c[kClipHi];
    }
    rw.reward[row] = vi ? rew : static_cast<T>(0);
    rw.in_collision_out[row] = (in_coll || hit_agent || hit_wall) ? 1 : 0;
  }
}

template <typename T, bool kRewards>
int launch(const void* pos, const void* radius, const void* valid, void* collision,
           void* nearest, int64_t num_envs, int num_agents, int lanes,
           const RewardArgs<T>& rw, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = num_envs * num_agents;
  if (rows == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (rows * lanes + threads - 1) / threads;
  pairwise_kernel<T, kRewards><<<static_cast<unsigned int>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const T*>(radius),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(collision),
      static_cast<T*>(nearest), rows, num_agents, lanes, rw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rewards(const void* pos, const void* radius, const void* valid,
                   const void* is_at_goal, const void* was_at_goal,
                   const void* was_in_collision, const void* in_collision,
                   const void* past_actions, const void* wall, const void* consts,
                   void* collision, void* nearest, void* reward, void* in_collision_out,
                   int64_t num_envs, int num_agents, int num_past_actions, int lanes,
                   void* stream) {
  RewardArgs<T> rw;
  rw.is_at_goal = static_cast<const uint8_t*>(is_at_goal);
  rw.was_at_goal = static_cast<const uint8_t*>(was_at_goal);
  rw.was_in_collision = static_cast<const uint8_t*>(was_in_collision);
  rw.in_collision = static_cast<const uint8_t*>(in_collision);
  rw.past_actions = static_cast<const T*>(past_actions);
  rw.wall = static_cast<const uint8_t*>(wall);
  rw.in_collision_out = static_cast<uint8_t*>(in_collision_out);
  rw.reward = static_cast<T*>(reward);
  rw.num_past_actions = num_past_actions;
  for (int k = 0; k < kNumConsts; ++k) rw.c[k] = static_cast<const T*>(consts)[k];
  return launch<T, true>(pos, radius, valid, collision, nearest, num_envs, num_agents,
                         lanes, rw, stream);
}

}  // namespace

// lanes: threads a row, a power of two <= 32 (1: one thread a row); the
// wrapper's ops/pairwise.py:lanes_for chooses it.
extern "C" int pairwise_collisions_f32(const void* pos, const void* radius,
                                       const void* valid, void* collision,
                                       void* nearest, int64_t num_envs,
                                       int num_agents, int lanes, void* stream) {
  return launch<float, false>(pos, radius, valid, collision, nearest, num_envs,
                              num_agents, lanes, RewardArgs<float>{}, stream);
}

extern "C" int pairwise_collisions_f64(const void* pos, const void* radius,
                                       const void* valid, void* collision,
                                       void* nearest, int64_t num_envs,
                                       int num_agents, int lanes, void* stream) {
  return launch<double, false>(pos, radius, valid, collision, nearest, num_envs,
                               num_agents, lanes, RewardArgs<double>{}, stream);
}

// consts: kNumConsts values of the state's dtype, on the host.
#define PAIRWISE_REWARDS_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* pos, const void* radius, const void* valid,             \
                      const void* is_at_goal, const void* was_at_goal,                     \
                      const void* was_in_collision, const void* in_collision,              \
                      const void* past_actions, const void* wall, const void* consts,      \
                      void* collision, void* nearest, void* reward,                        \
                      void* in_collision_out, int64_t num_envs, int num_agents,            \
                      int num_past_actions, int lanes, void* stream) {                     \
    return launch_rewards<T>(pos, radius, valid, is_at_goal, was_at_goal,                  \
                             was_in_collision, in_collision, past_actions, wall, consts,   \
                             collision, nearest, reward, in_collision_out, num_envs,       \
                             num_agents, num_past_actions, lanes, stream);                 \
  }

PAIRWISE_REWARDS_ENTRY(pairwise_rewards_f32, float)
PAIRWISE_REWARDS_ENTRY(pairwise_rewards_f64, double)
