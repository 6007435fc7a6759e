// SA-CADRL's value net in one launch, for Hopper (sm_90a):
//
//   x [R, 31] -> (x - avg) * inv_std -> relu(. W0 + b0) [200] -> relu(. W1 + b1) [200]
//     -> host block [0, 50) and the elementwise max of the three other-agent
//        blocks [50, 100), [100, 150), [150, 200) -> [100]
//     -> relu(. W3 + b3) [50] -> . W4 + b4 -> * output_std + output_avg -> y [R]
//
// It replaces no Pallas kernel: the JAX package leaves this net to XLA
// (gym_collision_avoidance_tpu/models/cadrl.py:forward_raw).  It was added
// because the plain PyTorch version (models/cadrl.py:forward_raw_plain) makes
// about 18 launches that write and read [R, 200] tensors: at cadrl4's
// E = 16384 envs, R = 3 080 192 rows a step and each [R, 200] activation is
// 2.46 GB, so the bias adds, ReLUs, block max and cat cost as much device time
// as the products.  Here every intermediate stays in registers and shared
// memory; the kernel reads x and writes y.
//
// What bounds it on this card: 102 500 operations a row (a multiply-add two)
// against 128 bytes, so float32 arithmetic on the CUDA cores (67 TFLOP/s,
// 4.71 ms a step at R = 3 080 192) and not memory (0.12 ms).  The design:
//  * Persistent blocks of 256 threads, one an SM (203 KB of shared memory),
//    walk over tiles of BM = 128 rows; the ragged last tile is zero-filled
//    and not stored.
//  * The 200-wide products give each thread 4 rows x 25 columns (32 row
//    groups x 8 column groups): a k step is one 16-byte load of A (4 rows of
//    the transposed activations) and seven of B (25 columns of a group,
//    padded to start on 16 bytes, see the packed layout) for 100 FMAs.  A
//    warp shares one column group, so its B loads are broadcasts.  Eight
//    warps keep the four schedulers of an SM equally busy.  (5 rows a thread
//    on 160-row tiles, or 2 rows on 16 warps, measured slower.)
//  * The 50-wide product (layer 3) gives 160 threads 4 rows x 10 columns,
//    and the output layer one thread a row.
//  * W0, W3, W4, the biases and the norm vectors stay in shared memory for
//    the block's life.  W1 (179 KB padded) does not fit beside a tile's
//    activations, so it streams from L2 in slabs of KS rows, double-buffered
//    with cp.async; the next tile's x rows (into the buffer layer 1 has done
//    with) and W1's first slab load while this tile's slabs are multiplied.
//
// Exactness.  All arithmetic is float32 (or float64) on the CUDA cores: no
// tensor-core instruction, no atomics, no split of K across threads.  Each
// product of layers 1-3 sums k in order 0, 1, ..., K-1 from 0 with one
// explicit fused multiply-add a term (__fmaf_rn; the build passes
// --fmad=false, which would otherwise split every a * b + c), then adds the
// bias, as the plain version adds it after its product: the order of
// cuBLAS's SIMT kernels that the plain version runs on the card.  The output
// layer sums its 50 terms as two runs of 25 added at the end, the order of
// cuBLAS's gemv for this shape.  The standardisation is two rounded
// operations, (x - avg) * inv_std, and the output y * output_std +
// output_avg another two.  So at cadrl4's row counts the kernel gives the
// plain version's bits on the card (cuBLAS may order a small product
// otherwise); and a row's value depends on the row alone, not on its place in
// a tile nor on R: two equal rows give the same bits, and the policy's argmax
// still breaks exact ties by the first index.  ReLU and the block max
// propagate NaN as torch.relu and torch.maximum do.  The orders were read
// from cuBLAS's results on an H100 under torch 2.11.0+cu128 (CUDA 12.8) with
// cuBLAS 12.9.2; another cuBLAS may choose other kernels, and then the plain
// version's bits, not this kernel's, change.
//
// The packed weights (ops/cadrl_value.py:pack; ops/cadrl_value.py:packed
// keeps a net's copy and packs it again after a weight changes), in elements of T, each piece starting on a 16-byte boundary:
//   W1 [200][8][28] | W0 [31][8][28] | b0 [200] | b1 [200] | W3 [100][5][12]
//   | b3 [52] | W4 [52] | b4 [4] | avg [32] | inv_std [32] | out_std [4] | out_avg [4]
// where W1's and W0's [.][g][28] hold columns 25 g .. 25 g + 24 of a row
// then 3 zeros, and W3's [.][g][12] columns 10 g .. 10 g + 9 then 2 zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kIn = 31;           // input width
constexpr int kHidden = 200;      // layers 1 and 2
constexpr int kHost = 50;         // the host block; the three other-agent blocks follow
constexpr int kPooled = 100;      // host block and pooled block
constexpr int kZ = 50;            // layer 3
constexpr int kCols = 25;         // a thread's columns in layers 1-2
constexpr int kPad = 28;          // their group's padded width
constexpr int kRowPad = 8 * kPad;     // a padded row of W0 or W1
constexpr int kZCols = 10;        // a thread's columns in layer 3
constexpr int kZPad = 12;
constexpr int kZRowPad = 5 * kZPad;   // a padded row of W3

// offsets in the packed buffer; the resident part starts at kRes
constexpr int kRes = kHidden * kRowPad;
constexpr int kOffW0 = 0;
constexpr int kOffB0 = kOffW0 + kIn * kRowPad;
constexpr int kOffB1 = kOffB0 + kHidden;
constexpr int kOffW3 = kOffB1 + kHidden;
constexpr int kOffB3 = kOffW3 + kPooled * kZRowPad;
constexpr int kOffW4 = kOffB3 + 52;
constexpr int kOffB4 = kOffW4 + 52;
constexpr int kOffAvg = kOffB4 + 4;
constexpr int kOffInv = kOffAvg + 32;
constexpr int kOffOutStd = kOffInv + 32;
constexpr int kOffOutAvg = kOffOutStd + 4;
constexpr int kResSize = kOffOutAvg + 4;
static_assert(kResSize % 4 == 0 && kRes % 4 == 0 && kOffW3 % 4 == 0, "16-byte pieces");

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// torch.relu: 0 for v <= 0 (-0.0 included), NaN stays NaN
template <typename T>
__device__ __forceinline__ T relu(T v) {
  return (v > static_cast<T>(0) || v != v) ? v : static_cast<T>(0);
}

// torch.maximum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// four consecutive elements from 16 bytes (float) or two 16-byte loads (double)
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
// two consecutive elements from 8 (float) or 16 bytes (double)
__device__ __forceinline__ void ld2(const float* p, float* v) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void ld2(const double* p, double* v) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, the first src_bytes of them from global, the rest zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// one element (4 or 8 bytes), for an input that does not start on 16 bytes
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, int src_bytes) {
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n elements (n * sizeof(T) a multiple of 16, both ends on 16 bytes)
template <typename T, int kThreads>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n) {
  const int chunks = n * static_cast<int>(sizeof(T)) / 16;
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    cp_async16(reinterpret_cast<char*>(dst) + 16 * c,
               reinterpret_cast<const char*>(src) + 16 * c, 16);
}

// the rows of tile `tile` into xr [BM][31] as they are, rows past R as zeros
template <typename T, int BM, int kThreads>
__device__ __forceinline__ void load_rows(T* xr, const T* x, int64_t tile, int64_t rows,
                                          bool aligned) {
  const int64_t row0 = tile * BM;
  const int64_t valid = rows - row0 < BM ? rows - row0 : BM;
  const T* src = x + row0 * kIn;
  const int64_t elems = valid * kIn;
  if (aligned) {
    static_assert(BM * kIn * sizeof(T) % 16 == 0, "a tile of rows is whole chunks");
    constexpr int kChunks = BM * kIn * static_cast<int>(sizeof(T)) / 16;
    const int64_t bytes = elems * static_cast<int64_t>(sizeof(T));
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int64_t left = bytes - 16 * static_cast<int64_t>(c);
      const int n = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
      cp_async16(reinterpret_cast<char*>(xr) + 16 * c,
                 n > 0 ? reinterpret_cast<const char*>(src) + 16 * c
                       : reinterpret_cast<const char*>(x), n);
    }
  } else {
    for (int e = threadIdx.x; e < BM * kIn; e += kThreads)
      cp_async_elem(xr + e, e < elems ? src + e : x,
                    e < elems ? static_cast<int>(sizeof(T)) : 0);
  }
}

// acc[i][j] += sum over k < K of A[k][4 rg + i] * B[k][j], k in order, for
// A [K][BM] and b at the thread's column group of B [K][kRowPad]
template <typename T, int BM, int K>
__device__ __forceinline__ void products(T (&acc)[4][kCols], const T* a, const T* b, int rg) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T av[4];
    ld4(a + k * BM + 4 * rg, av);
    T bv[kCols];
#pragma unroll
    for (int v = 0; v < 6; ++v) ld4(b + k * kRowPad + 4 * v, bv + 4 * v);
    bv[24] = b[k * kRowPad + 24];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fma_rn(av[i], bv[j], acc[i][j]);
  }
}

// relu(acc + bias) into act [200][BM] (act[col * BM + row])
template <typename T, int BM>
__device__ __forceinline__ void store_hidden(T* act, const T (&acc)[4][kCols], const T* bias,
                                             int rg, int cg) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = cg * kCols + j;
    const T bj = bias[col];
    T v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = relu(add_rn(acc[i][j], bj));
    st4(act + col * BM + 4 * rg, v);
  }
}

template <typename T, int N>
__device__ __forceinline__ void zero(T (&acc)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = static_cast<T>(0);
}

template <typename T, int BM, int KS>
constexpr size_t smem_bytes() {
  return sizeof(T) * (kResSize + 2 * KS * kRowPad + BM * kIn + kHidden * BM);
}

// 8 RG threads, BM = 4 RG rows a tile: RG row groups x 8 column groups of 25
// in layers 1-2, RG row groups x 5 column groups of 10 in layer 3.
template <typename T, int RG, int KS>
__global__ void __launch_bounds__(8 * RG, 1)
cadrl_value_gemm_kernel(const T* __restrict__ packed, const T* __restrict__ x,
                        T* __restrict__ y, int64_t rows, bool aligned) {
  constexpr int kThreads = 8 * RG;
  constexpr int BM = 4 * RG;
  constexpr int kSlabs = kHidden / KS;
  constexpr int kPer = (BM * kIn + kThreads - 1) / kThreads;
  static_assert(kHidden % KS == 0 && kSlabs % 2 == 0, "slab 0 of every tile in buffer 0");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* res = reinterpret_cast<T*>(smem_raw);    // the resident weights
  T* w1s = res + kResSize;                     // [2][KS][kRowPad]: W1's slabs
  T* xs = w1s + 2 * KS * kRowPad;              // [BM][31] as read, then [31][BM] standardised
  T* act = xs + BM * kIn;                      // [200][BM]: h1, then h2, p and z

  const int tid = threadIdx.x;
  const int rg = tid % RG;
  const int cg = tid / RG;
  const int64_t num_tiles = (rows + BM - 1) / BM;
  int64_t tile = blockIdx.x;
  if (tile >= num_tiles) return;

  copy_async<T, kThreads>(res, packed + kRes, kResSize);
  load_rows<T, BM, kThreads>(xs, x, tile, rows, aligned);
  copy_async<T, kThreads>(w1s, packed, KS * kRowPad);
  cp_async_commit();

  for (; tile < num_tiles; tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    cp_async_wait_all();
    __syncthreads();

    // standardise and transpose in place: xs[k][m] = (x[m][k] - avg[k]) * inv_std[k]
    {
      T v[kPer];
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int e = tid + n * kThreads;
        if (e < BM * kIn) {
          const int m = e % BM, k = e / BM;
          v[n] = mul_rn(sub_rn(xs[m * kIn + k], res[kOffAvg + k]), res[kOffInv + k]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int e = tid + n * kThreads;
        if (e < BM * kIn) xs[e] = v[n];
      }
    }
    __syncthreads();

    T acc[4][kCols];
    zero(acc);
    products<T, BM, kIn>(acc, xs, res + kOffW0 + cg * kPad, rg);
    store_hidden<T, BM>(act, acc, res + kOffB0, rg, cg);  // published by the next barrier

    zero(acc);
    for (int s = 0; s < kSlabs; ++s) {
      cp_async_wait_all();
      __syncthreads();                // slab s has landed; slab s - 1's buffer is free
      if (s == 0 && next < num_tiles) load_rows<T, BM, kThreads>(xs, x, next, rows, aligned);
      if (s + 1 < kSlabs)
        copy_async<T, kThreads>(w1s + ((s + 1) & 1) * KS * kRowPad,
                                packed + (s + 1) * KS * kRowPad, KS * kRowPad);
      else if (next < num_tiles)
        copy_async<T, kThreads>(w1s, packed, KS * kRowPad);
      cp_async_commit();
      products<T, BM, KS>(acc, act + s * KS * BM, w1s + (s & 1) * KS * kRowPad + cg * kPad, rg);
    }
    __syncthreads();
    store_hidden<T, BM>(act, acc, res + kOffB1, rg, cg);
    __syncthreads();

    // block max, in place: act[50 + j] = max(act[50 + j], act[100 + j], act[150 + j])
    for (int e = tid; e < kHost * BM / 4; e += kThreads) {
      const int j = e / (BM / 4), m = (e % (BM / 4)) * 4;
      T a[4], b[4], c[4];
      ld4(act + (kHost + j) * BM + m, a);
      ld4(act + (2 * kHost + j) * BM + m, b);
      ld4(act + (3 * kHost + j) * BM + m, c);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = max_nan(max_nan(a[i], b[i]), c[i]);
      st4(act + (kHost + j) * BM + m, a);
    }
    __syncthreads();

    // layer 3: rows as in layers 1-2, columns 10 cg .. 10 cg + 9; z goes to act[100 .. 150)
    if (cg < kZ / kZCols) {
      T z[4][kZCols];
      zero(z);
      const T* w3 = res + kOffW3 + cg * kZPad;
#pragma unroll 4
      for (int k = 0; k < kPooled; ++k) {
        T av[4];
        ld4(act + k * BM + 4 * rg, av);
        T bv[kZCols];
        ld4(w3 + k * kZRowPad, bv);
        ld4(w3 + k * kZRowPad + 4, bv + 4);
        ld2(w3 + k * kZRowPad + 8, bv + 8);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kZCols; ++j) z[i][j] = fma_rn(av[i], bv[j], z[i][j]);
      }
#pragma unroll
      for (int j = 0; j < kZCols; ++j) {
        const int col = cg * kZCols + j;
        const T bj = res[kOffB3 + col];
        T v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = relu(add_rn(z[i][j], bj));
        st4(act + (kPooled + col) * BM + 4 * rg, v);
      }
    }
    __syncthreads();

    // output: one thread a row; the 50 terms as two runs of 25 (cuBLAS's gemv order)
    if (tid < BM) {
      T s0 = static_cast<T>(0), s1 = static_cast<T>(0);
#pragma unroll 5
      for (int k = 0; k < kZ / 2; ++k) {
        s0 = fma_rn(act[(kPooled + k) * BM + tid], res[kOffW4 + k], s0);
        s1 = fma_rn(act[(kPooled + kZ / 2 + k) * BM + tid], res[kOffW4 + kZ / 2 + k], s1);
      }
      const T v = add_rn(mul_rn(add_rn(add_rn(s0, s1), res[kOffB4]), res[kOffOutStd]),
                         res[kOffOutAvg]);
      const int64_t row = tile * BM + tid;
      if (row < rows) y[row] = v;
    }
  }
}

template <typename T, int RG, int KS>
int launch(const void* packed, const void* x, void* y, int64_t rows, void* stream) {
  if (rows <= 0) return 0;
  constexpr int BM = 4 * RG;
  constexpr size_t kSmem = smem_bytes<T, BM, KS>();
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
  const auto kernel = cadrl_value_gemm_kernel<T, RG, KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (rows + BM - 1) / BM;
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<blocks, 8 * RG, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(packed), static_cast<const T*>(x), static_cast<T*>(y), rows,
      aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: the layout above (16-byte aligned); x: [rows, 31]; y: [rows]; all
// contiguous on the current device.  Returns cudaGetLastError() after the launch.
extern "C" int cadrl_value_f32(const void* packed, const void* x, void* y, int64_t rows,
                               void* stream) {
  return launch<float, 32, 20>(packed, x, y, rows, stream);   // 128-row tiles
}

// float64: 32-row tiles of 64 threads and 10-row slabs, to fit shared memory
extern "C" int cadrl_value_f64(const void* packed, const void* x, void* y, int64_t rows,
                               void* stream) {
  return launch<double, 8, 10>(packed, x, y, rows, stream);
}
