// DRL-Long's convolution stage in one launch, for Hopper (sm_90a):
//
//   x [B, 3, L] -> Conv1d(3 -> 32, k5, s2, p1) + b1, ReLU -> h1 [B, 32, L1]
//               -> Conv1d(32 -> 32, k3, s2, p1) + b2, ReLU -> y [B, 32, L2]
//   L1 = (L - 3) / 2 + 1,  L2 = (L1 - 1) / 2 + 1
//
// y is channel-major, as models/drl_long.py flattens it for fc1.
//
// It replaces no Pallas kernel: the JAX package leaves this net to XLA
// (gym_collision_avoidance_tpu/models/drl_long.py).  It was added because
// the plain PyTorch version (ops/drl_long_conv.py:drl_long_conv_plain) runs
// cuDNN's convolution, then a bias add and a ReLU over each output: at
// drl_long4's 65 536 rows a step, h1 is 2.14 GB and y 1.07 GB, each written
// by the convolution and read and written again twice.  Here h1 never leaves
// shared memory; the kernel reads x and writes y.
//
// What bounds it on this card: 1 031 232 operations a row (conv1 244 800,
// conv2 786 432; a multiply-add two) against 6 144 bytes in and 16 384 out
// (float32, L = 512), so float32 arithmetic on the CUDA cores (67 TFLOP/s,
// 1.009 ms at 65 536 rows) and not memory (0.44 ms).  The design:
//  * One block of 8 warps an SM; W1, W2 and the biases stay in shared memory
//    for the block's life, stored [in][tap][out] so that a thread's 8 output
//    channels are two 16-byte loads.  Each warp walks on its own over work
//    items, one row and P = 64 conv2 positions [j0, j0 + 64) each, with
//    nothing but __syncwarp between its phases.
//  * An item needs input samples 4 j0 - 3 .. 4 j0 + 257 of each frame, read
//    with 16-byte loads (one sample at a time where L is not a multiple of 4
//    or x not on 16 bytes) and zero outside [0, L), conv1's padding.  They
//    are staged by residue mod 4, A_r[m] = x[4 (j0 + m) + r - 3], so that
//    the stride-2 taps of 4 neighbouring conv1 outputs are 4 consecutive
//    elements.  The next item's loads are issued into registers before this
//    item's conv1 and stored to shared memory after it.
//  * conv1 computes the item's 129 h1 positions 2 j0 - 1 .. 2 j0 + 127 (one
//    position of halo past each end) split by parity, E[c][m] = h1[c][2 (j0 +
//    m)] and O[c][m] = h1[c][2 (j0 + m) - 1], adds b1 and applies the ReLU,
//    into shared memory only.  Positions outside [0, L1) are conv2's zero
//    padding of the post-ReLU map (at L = 512, O[64] of the last item, h1
//    index 255): they are set to 0 afterwards, never relu(b1).
//  * conv2 is a register-tiled product y[32, 64] = W2[32, 96] X[96, 64],
//    whose taps are O[m], E[m] and O[m + 1]: lane (cg, pg) holds output
//    channels 8 cg .. 8 cg + 7 at positions 4 pg + {0..3} and 32 + 4 pg +
//    {0..3}, 64 sums.  A k step is 5 loads of X (all four cg lanes of a pg
//    read the same 16 bytes) and 6 of W2 (one address a cg) for 192 FMAs.
//  * The ReLU is one max.NaN; y is stored with 16-byte stores (one element
//    at a time where L2 is not a multiple of 4), positions past L2 not
//    stored.
//
// Exactness.  All arithmetic is float32 (or float64) on the CUDA cores,
// written as __fmaf_rn and __fadd_rn (__fma_rn, __dadd_rn), since the build
// passes --fmad=false; no tensor-core, TF32 or lower-precision instruction.
// Each output sums its terms from 0 in (input channel, tap) order, channel
// by channel, one fused multiply-add a term (padding's zeros included), then
// adds the bias and applies the ReLU: the order of cuDNN's SIMT implicit GEMM
// that the plain version runs (sm80_xmma_fprop_implicit_gemm ..._ffma, then
// a separate bias add and clamp).  So the kernel gives the plain version's
// bits on the card in float32 at L = 512, at any B (a row's value depends on
// the row alone, in cuDNN's result as in this kernel's); the benchmark's
// judge of drl_long4.serve16k, whose reference runs cuDNN, needs that: summed
// from the bias instead, one seed of 14 read float_err 1.2e-3 over its 2e-4
// limit.  The order was found on an H100 with cuDNN 9.22 (version 92200)
// under torch 2.11.0+cu128; another cuDNN may choose another kernel, and then
// the plain version's bits, not this kernel's, change.  The ReLU keeps NaN, as
// torch.relu does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;            // channels of both convolutions
constexpr int kF = 3;             // input frames
constexpr int kK1 = 5;            // conv1's taps
constexpr int kK2 = 3;            // conv2's taps
constexpr int kP = 64;            // conv2 positions a work item
constexpr int kA = 68;            // a staged residue row: kP + 2 used
constexpr int kOdd = 68;          // a row of O: kP + 1 used
constexpr int kSamples = 4 * (kP + 2);   // input samples of a frame staged for an item

// shared memory, in elements: the resident weights, then each warp's piece
constexpr int kOffB1 = kF * kK1 * kC;          // W1 [frame][tap][out] first
constexpr int kOffW2 = kOffB1 + kC;
constexpr int kOffB2 = kOffW2 + kC * kK2 * kC;  // W2 [in][tap][out]
constexpr int kRes = kOffB2 + kC;
constexpr int kStage = kF * 4 * kA;            // A [frame][r][kA]
constexpr int kEven = kC * kP;                 // E [c][kP]
constexpr int kWarpElems = kStage + kEven + kC * kOdd;
static_assert(kRes % 4 == 0 && kStage % 4 == 0 && kEven % 4 == 0 && kWarpElems % 4 == 0,
              "16-byte pieces");

// the next item's input, held in registers: 16-byte loads or single samples
constexpr int kVecLoads = kF * (kP + 2);                  // 198 a warp
constexpr int kVecPer = (kVecLoads + 31) / 32;            // 7 a lane
constexpr int kScalarLoads = kF * kSamples;               // 792 a warp
constexpr int kScalarPer = (kScalarLoads + 31) / 32;      // 25 a lane
constexpr int kPre = 4 * kVecPer > kScalarPer ? 4 * kVecPer : kScalarPer;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// torch.relu: 0 for v <= 0, NaN stays NaN
__device__ __forceinline__ float relu(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ double relu(double v) { return (v > 0.0 || v != v) ? v : 0.0; }

// four consecutive elements: one 16-byte access (float) or two (double)
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void ldg4(const float* p, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ldg4(const double* p, double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p + 2));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// the input of the item at row b, conv2 positions from j0, into registers:
// with vec, 16-byte load n of the lane covers samples 4 (j0 + v - 1) + {0..3}
// of frame f (n = lane + 32 i, f = n / (kP + 2), v = n % (kP + 2)); without,
// sample s = n % kSamples of frame n / kSamples is 4 (j0 - 1) + s
template <typename T>
__device__ __forceinline__ void fetch(T (&pre)[kPre], const T* __restrict__ x, int64_t b,
                                      int j0, int L, bool vec, int lane) {
  const T* row = x + b * kF * static_cast<int64_t>(L);
  if (vec) {
#pragma unroll
    for (int i = 0; i < kVecPer; ++i) {
      const int n = lane + 32 * i;
      const int f = n / (kP + 2), v = n % (kP + 2);
      const int q = 4 * (j0 + v - 1);
      if (n < kVecLoads && q >= 0 && q < L) {
        ldg4(row + f * L + q, pre + 4 * i);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) pre[4 * i + u] = static_cast<T>(0);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScalarPer; ++i) {
      const int n = lane + 32 * i;
      const int f = n / kSamples;
      const int q = 4 * (j0 - 1) + n % kSamples;
      pre[i] = (n < kScalarLoads && q >= 0 && q < L) ? __ldg(row + f * L + q)
                                                      : static_cast<T>(0);
    }
  }
}

// sample 4 (j0 + v - 1) + u of frame f is A_r[m] with r = (u + 3) % 4 and
// m = v - (u == 0); the one with m = -1 is never read
template <typename T>
__device__ __forceinline__ void put(T* stage, int f, int v, int u, T val) {
  const int r = (u + 3) & 3;
  const int m = v - (u == 0);
  if (m >= 0) stage[(f * 4 + r) * kA + m] = val;
}

template <typename T>
__device__ __forceinline__ void stage_input(T* stage, const T (&pre)[kPre], bool vec, int lane) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kVecPer; ++i) {
      const int n = lane + 32 * i;
      if (n < kVecLoads) {
        const int f = n / (kP + 2), v = n % (kP + 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) put(stage, f, v, u, pre[4 * i + u]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScalarPer; ++i) {
      const int n = lane + 32 * i;
      if (n < kScalarLoads) {
        const int s = n % kSamples;
        put(stage, n / kSamples, s / 4, s % 4, pre[i]);
      }
    }
  }
}

// conv1 + b1 + ReLU for the warp's item: O[c][m] for m in [0, kP] and E[c][m]
// for m in [0, kP), from the staged input; lane (cg, pg) computes channels
// 8 cg .. 8 cg + 7 at m = 32 g + 4 pg + {0..3} for g = 0, 1, both parities
template <typename T>
__device__ __forceinline__ void conv1(const T* __restrict__ stage, T* even, T* odd,
                                      const T* __restrict__ res, int cg, int pg, int lane) {
#pragma unroll 1
  for (int g = 0; g < 2; ++g) {
    const int m = 32 * g + 4 * pg;
    T ao[8][4], ae[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) ao[i][k] = ae[i][k] = static_cast<T>(0);
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const T* a = stage + f * 4 * kA + m;
      T a0[5], a1[5], a2[5], a3[4];
      ld4(a, a0);
      a0[4] = a[4];
      ld4(a + kA, a1);
      a1[4] = a[kA + 4];
      ld4(a + 2 * kA, a2);
      a2[4] = a[2 * kA + 4];
      ld4(a + 3 * kA, a3);
      // O[m] = h1[2 (j0 + m) - 1] takes samples 4 (j0 + m) - 3 + t: A_0..A_3 at m, A_0 at m + 1;
      // E[m] = h1[2 (j0 + m)] takes 4 (j0 + m) - 1 + t: A_2, A_3 at m, A_0..A_2 at m + 1
      T to[kK1][4], te[kK1][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        to[0][k] = a0[k]; to[1][k] = a1[k]; to[2][k] = a2[k]; to[3][k] = a3[k];
        to[4][k] = a0[k + 1];
        te[0][k] = a2[k]; te[1][k] = a3[k]; te[2][k] = a0[k + 1]; te[3][k] = a1[k + 1];
        te[4][k] = a2[k + 1];
      }
#pragma unroll
      for (int t = 0; t < kK1; ++t) {
        T w[8];
        ld4(res + (f * kK1 + t) * kC + 8 * cg, w);
        ld4(res + (f * kK1 + t) * kC + 8 * cg + 4, w + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ao[i][k] = fma_rn(w[i], to[t][k], ao[i][k]);
            ae[i][k] = fma_rn(w[i], te[t][k], ae[i][k]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * cg + i;
      const T bias = res[kOffB1 + c];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ao[i][k] = relu(add_rn(ao[i][k], bias));
        ae[i][k] = relu(add_rn(ae[i][k], bias));
      }
      st4(odd + c * kOdd + m, ao[i]);
      st4(even + c * kP + m, ae[i]);
    }
  }
  // O[kP] = h1[2 (j0 + kP) - 1], the halo past the item's end: lane c
  {
    T s = static_cast<T>(0);
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const T* a = stage + f * 4 * kA + kP;
      const T taps[kK1] = {a[0], a[kA], a[2 * kA], a[3 * kA], a[1]};
#pragma unroll
      for (int t = 0; t < kK1; ++t) s = fma_rn(res[(f * kK1 + t) * kC + lane], taps[t], s);
    }
    odd[lane * kOdd + kP] = relu(add_rn(s, res[kOffB1 + lane]));
  }
}

// conv2 + b2 + ReLU for the warp's item, stored to y[b, :, j0 + m]
template <typename T>
__device__ __forceinline__ void conv2(const T* even, const T* odd, const T* __restrict__ res,
                                      T* __restrict__ y, int64_t b, int j0, int L2,
                                      bool vec_out, int cg, int pg) {
  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[i][p] = static_cast<T>(0);
#pragma unroll 2
  for (int ci = 0; ci < kC; ++ci) {
    const T* e = even + ci * kP + 4 * pg;
    const T* o = odd + ci * kOdd + 4 * pg;
    T ev[8], o0[5], o1[5];
    ld4(e, ev);
    ld4(e + 32, ev + 4);
    ld4(o, o0);
    o0[4] = o[4];
    ld4(o + 32, o1);
    o1[4] = o[36];
    // taps: O[m] (t = 0), E[m] (t = 1), O[m + 1] (t = 2)
    T taps[kK2][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      taps[0][k] = o0[k]; taps[0][4 + k] = o1[k];
      taps[1][k] = ev[k]; taps[1][4 + k] = ev[4 + k];
      taps[2][k] = o0[k + 1]; taps[2][4 + k] = o1[k + 1];
    }
#pragma unroll
    for (int t = 0; t < kK2; ++t) {
      T w[8];
      ld4(res + kOffW2 + (ci * kK2 + t) * kC + 8 * cg, w);
      ld4(res + kOffW2 + (ci * kK2 + t) * kC + 8 * cg + 4, w + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int p = 0; p < 8; ++p) acc[i][p] = fma_rn(w[i], taps[t][p], acc[i][p]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    T* out = y + (b * kC + 8 * cg + i) * static_cast<int64_t>(L2);
    const T bias = res[kOffB2 + 8 * cg + i];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      T v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = relu(add_rn(acc[i][4 * g + k], bias));
      const int j = j0 + 32 * g + 4 * pg;
      if (vec_out) {
        if (j < L2) st4(out + j, v);   // L2 % 4 == 0: the four are in or out together
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j + k < L2) out[j + k] = v[k];
      }
    }
  }
}

template <typename T, int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 1)
drl_long_conv_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                          const T* __restrict__ b1, const T* __restrict__ w2,
                          const T* __restrict__ b2, T* __restrict__ y, int64_t batch, int L,
                          int L1, int L2, int chunks, bool vec_in, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* res = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* stage = res + kRes + warp * kWarpElems;
  T* even = stage + kStage;
  T* odd = even + kEven;

  // the weights, transposed to [in][tap][out]
  for (int e = threadIdx.x; e < kF * kK1 * kC; e += 32 * kWarps) {
    const int c = e % kC, ft = e / kC;          // ft = frame * kK1 + tap
    res[e] = w1[c * kF * kK1 + ft];
  }
  for (int e = threadIdx.x; e < kC * kK2 * kC; e += 32 * kWarps) {
    const int co = e % kC, it = e / kC;         // it = in * kK2 + tap
    res[kOffW2 + e] = w2[co * kC * kK2 + it];
  }
  if (threadIdx.x < kC) {
    res[kOffB1 + threadIdx.x] = b1[threadIdx.x];
    res[kOffB2 + threadIdx.x] = b2[threadIdx.x];
  }
  __syncthreads();

  const int64_t items = batch * chunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (item >= items) return;
  const int cg = lane / 8, pg = lane % 8;
  // E[m] is h1 inside [0, L1) for j0 + m < e_end, O[m] for j0 + m < o_end
  const int e_end = (L1 + 1) / 2, o_end = L1 / 2 + 1;

  T pre[kPre];
  fetch(pre, x, item / chunks, static_cast<int>(item % chunks) * kP, L, vec_in, lane);
  stage_input(stage, pre, vec_in, lane);
  __syncwarp();
  for (;;) {
    const int64_t b = item / chunks;
    const int j0 = static_cast<int>(item % chunks) * kP;
    const int64_t next = item + stride;
    if (next < items)
      fetch(pre, x, next / chunks, static_cast<int>(next % chunks) * kP, L, vec_in, lane);
    conv1(stage, even, odd, res, cg, pg, lane);
    __syncwarp();
    // h1 positions outside [0, L1) are conv2's zero padding
    const int e_lo = e_end - j0 > 0 ? e_end - j0 : 0;
    const int o_lo = o_end - j0 > 0 ? o_end - j0 : 0;
    if (j0 == 0 || o_lo <= kP) {
      if (j0 == 0) odd[lane * kOdd] = static_cast<T>(0);
      for (int m = e_lo; m < kP; ++m) even[lane * kP + m] = static_cast<T>(0);
      for (int m = o_lo; m <= kP; ++m) odd[lane * kOdd + m] = static_cast<T>(0);
    }
    if (next < items) stage_input(stage, pre, vec_in, lane);   // conv1 is done with it
    __syncwarp();
    conv2(even, odd, res, y, b, j0, L2, vec_out, cg, pg);
    __syncwarp();                                                // before conv1 rewrites E, O
    if (next >= items) break;
    item = next;
  }
}

template <typename T, int kWarps>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* y, int64_t batch, int64_t length, void* stream) {
  if (batch <= 0) return 0;
  if (length < 3 || length > (1 << 28)) return static_cast<int>(cudaErrorInvalidValue);
  const int L = static_cast<int>(length);
  const int L1 = (L - 3) / 2 + 1;
  const int L2 = (L1 - 1) / 2 + 1;
  const int chunks = (L2 + kP - 1) / kP;
  constexpr size_t kSmem = sizeof(T) * (kRes + kWarps * kWarpElems);
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
  const auto kernel = drl_long_conv_gemm_kernel<T, kWarps>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = batch * chunks;
  const int64_t need = (items + kWarps - 1) / kWarps;
  const unsigned blocks = static_cast<unsigned>(need < sms ? need : sms);
  const bool vec_in = L % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = L2 % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  kernel<<<blocks, 32 * kWarps, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(y), batch, L, L1,
      L2, chunks, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [batch, 3, length]; w1: [32, 3, 5]; b1: [32]; w2: [32, 32, 3]; b2: [32]
// (Conv1d's own layouts); y: [batch, 32, L2]; all contiguous on the current
// device.  Returns cudaGetLastError() after the launch.
extern "C" int drl_long_conv_f32(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* y, int64_t batch, int64_t length,
                                 void* stream) {
  return launch<float, 8>(x, w1, b1, w2, b2, y, batch, length, stream);   // 176 KB
}

// float64: 4 warps a block, to fit shared memory (190 KB)
extern "C" int drl_long_conv_f64(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* y, int64_t batch, int64_t length,
                                 void* stream) {
  return launch<double, 4>(x, w1, b1, w2, b2, y, batch, length, stream);
}
