// K1: pairwise collision / nearest-gap kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gym_collision_avoidance_tpu/ops/pairwise.py
// (`_kernel`, launched by `pairwise_collisions(..., backend="pallas")`),
// whose XLA twin is env/step.py:_pairwise_collisions.  For each agent i of
// each env:
//   collision[i] = any_j valid_pair(i, j) && dist_ij <= r_i + r_j
//   nearest[i]   = min_j over valid pairs of (dist_ij - r_i - r_j), +inf if none
// where a valid pair has i != j and both agents valid.
//
// What bounds it on this card: at the main path's E = 16384, A = 4, f32 one
// launch reads 0.85 MB (pos, radius, valid) and writes 0.33 MB (collision,
// nearest): ~0.35 us at 3.35 TB/s, far below the few microseconds a launch
// costs, so the kernel is bound by launch latency, not by bytes or flops.
// The design is therefore the simplest correct one: one thread per (env, i)
// row, looping over j < A in registers, no shared memory and none of the
// TPU's 8-env VMEM blocks.  No single PyTorch call computes this function,
// so the measurement has no library yardstick (library_ms is null).
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
//     NaN; a NaN best then stays NaN.
//  4. A row with no valid partner (or an invalid agent) gives +INFINITY.

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

template <typename T>
__global__ void pairwise_kernel(const T* __restrict__ pos,       // [E, A, 2]
                                const T* __restrict__ radius,    // [E, A]
                                const uint8_t* __restrict__ valid,  // [E, A]
                                uint8_t* __restrict__ collision,    // [E, A]
                                T* __restrict__ nearest,            // [E, A]
                                int64_t rows, int num_agents) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int64_t env = row / num_agents;
  const int i = static_cast<int>(row - env * num_agents);
  const T* p = pos + env * num_agents * 2;
  const T* r = radius + env * num_agents;
  const uint8_t* v = valid + env * num_agents;

  T best = static_cast<T>(INFINITY);
  bool hit = false;
  if (v[i]) {
    const T xi = p[2 * i];
    const T yi = p[2 * i + 1];
    const T ri = r[i];
    for (int j = 0; j < num_agents; ++j) {
      if (j == i || !v[j]) continue;
      // Same operand order as the plain version: rel = pos_j - pos_i.
      const T dx = sub_rn(p[2 * j], xi);
      const T dy = sub_rn(p[2 * j + 1], yi);
      const T dist = sqrt_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)));
      const T comb = add_rn(ri, r[j]);
      const T gap = sub_rn(dist, comb);
      if (gap < best || isnan(gap)) best = gap;
      hit = hit || (dist <= comb);
    }
  }
  collision[row] = hit ? 1 : 0;
  nearest[row] = best;
}

template <typename T>
int launch(const void* pos, const void* radius, const void* valid, void* collision,
           void* nearest, int64_t num_envs, int num_agents, void* stream) {
  const int64_t rows = num_envs * num_agents;
  if (rows == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (rows + threads - 1) / threads;
  pairwise_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const T*>(radius),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(collision),
      static_cast<T*>(nearest), rows, num_agents);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pairwise_collisions_f32(const void* pos, const void* radius,
                                       const void* valid, void* collision,
                                       void* nearest, int64_t num_envs,
                                       int num_agents, void* stream) {
  return launch<float>(pos, radius, valid, collision, nearest, num_envs,
                       num_agents, stream);
}

extern "C" int pairwise_collisions_f64(const void* pos, const void* radius,
                                       const void* valid, void* collision,
                                       void* nearest, int64_t num_envs,
                                       int num_agents, void* stream) {
  return launch<double>(pos, radius, valid, collision, nearest, num_envs,
                        num_agents, stream);
}
