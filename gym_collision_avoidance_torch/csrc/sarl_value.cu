// SARL's value net in one launch, for Hopper (sm_90a).  For a candidate row
// with P others (pairs x_j [P, 13], the present mask, its ego row [6]):
//
//   e_j = relu(relu(x_j W11 + b11) W12 + b12)             mlp1      13 -> 150 -> 100
//   h_j = relu(e_j W21 + b21) W22 + b22                   mlp2      100 -> 100 -> 50
//   m   = (sum of e_j over present j) / max(count, 1)     the global state
//   g   = m Wb + b_a1                                      attention.0, m's half
//   s_j = relu(relu(e_j Wa + g) W_a2 + b_a2) w_a3 + b_a3   attention 100 -> 100 -> 1
//   w_j = exp(s_j) over present j with s_j != 0, divided by their total (0 if it is 0)
//   V   = mlp3([self, sum_j w_j h_j])                      mlp3      56 -> 150 -> 100 -> 100 -> 1
//
// (models/sarl.py:forward_raw_plain, the plain version, with the attention's
// first layer split as there.)  It replaces no Pallas kernel: the JAX package
// has no SARL.  It was added because the plain version makes 64 launches that
// write and read [R P, 50-200] tensors: at sarl6.serve's 24 576 agents x 81
// candidates, R = 1 990 656 candidate rows and 9 953 280 pairs a step, each
// [9.95 M, 150] activation is 6 GB, and the ReLUs, the masked mean, the
// global-state add, the softmax and the pooling took 30 of its 84 ms.  Here
// every intermediate stays in registers and shared memory; the kernel reads
// the pairs, the mask and the ego rows and writes V.
//
// What bounds it on this card: P x 104 100 + 87 000 operations a candidate
// row (a multiply-add two; 607 500 at P = 5) against (13 P + 7) x 4 bytes, so
// float32 arithmetic on the CUDA cores (67 TFLOP/s, 18.05 ms a step at
// sarl6.serve's rows) and not memory (0.17 ms).  The design:
//  * Persistent blocks of 8 RG threads (256 in float32), one an SM, walk over
//    tiles of C = BM / P candidate rows, BM = 4 RG (128 in float32): the
//    tile's C P pair rows (125 at P = 5) all lie in the block, so the
//    per-candidate steps need no other block.  The ragged last tile is
//    zero-filled and not stored.  P is an argument (at most BM): C follows it.
//  * Pair products: each thread 4 rows x NC columns of 8 column groups (a
//    warp shares one group, so its weight loads are broadcasts), FMAs from
//    K-major activations in shared memory: mlp1.0 as 8 x 19 columns, W12 as
//    8 x 13, W21 and Wa (both read e) as one 100 -> 200 product of 8 x 25,
//    W22 and W_a2 (h21 and a1 in, the same k) as one pass of 8 x (7 + 13).
//    (Twelve groups on 384 threads, three warps a scheduler with at most 168
//    registers, measured 7% slower: smaller tiles load more a multiply-add.)
//  * The global state's product m Wb (C rows) rides in the W21|Wa pass over
//    k, as items of 4 rows x 4 columns dealt over the threads (up to 4 a
//    thread; at P = 5, 175 items, one a thread).
//  * mlp3 runs on batches of BM / C tiles' candidate rows (125 at P = 5), as
//    pair products of 8 x 19 and 8 x 13 columns, after the batch's last tile
//    and after the block's last tile: [self | pooled] waits in [56][BM].
//  * Weights: mlp1.0, the biases and the two 100 -> 1 rows stay in shared
//    memory for the block's life.  The other 108 560 (434 KB in float32) do
//    not fit beside a tile, so they stream from L2 as one sequence of slabs
//    (whole rows of one matrix, at most SLAB elements), double-buffered with
//    cp.async: each slab's barrier issues the next (after a tile's last, the
//    next tile's first); this tile's ego rows and the next tile's pairs load
//    while its mlp1.2 runs.  The k loops unroll by 2 only: a tile runs
//    through the whole kernel once, and larger loop bodies cost more in
//    instruction fetch than they save.
//  * Activations live in one [200][BM] buffer, each product's output stored
//    over its input after a barrier: h11 [0,150); e [0,100) with m, then g,
//    in [100,200) by candidate; [h21 | a1] [0,200); h [0,50) and a2
//    [100,200); mlp3's rows [0,150), then [0,100).
//
// Exactness.  All arithmetic is float32 (float64 in the _f64 entry) on the
// CUDA cores: no tensor-core instruction, no TF32, no atomics, no split of K
// across threads, no fast-math exp.  Every multiply-add is one explicit fused
// operation (__fmaf_rn; the build passes --fmad=false, which would otherwise
// split every a * b + c), every other operation an explicit _rn one.  The
// order, fixed: each product sums k = 0, 1, ..., K - 1 from 0, then adds its
// bias (a1: Wa's sum, then g, which is Wb's sum plus b_a1, as the plain
// version adds them); the two 100 -> 1 products sum four runs of 25 terms,
// then ((r0 + r1) + (r2 + r3)), then the bias; the mean, the softmax's total
// and the pooling sum over j = 0, ..., P - 1 from 0, an absent j adding 0 (as
// torch.where puts it), the pooling's terms the rounded products w_j h_j;
// m = sum x (1 / max(count, 1)) and w_j = exp(s_j) x (1 / total) (0 unless the
// total is above 0), each reciprocal an IEEE division taken once a row (a
// division an element took 2.5% of the launch), exp libdevice's.  So a candidate row's value depends on that row alone, not on
// its place in a tile or a batch nor on R: two equal rows give the same bits,
// and the policy's argmax still breaks exact ties by the first index.  cuBLAS
// sums the plain version's products in other orders, so float32 values
// differ from it by a few roundings.  ReLU propagates NaN as torch.relu does.
//
// The packed weights (ops/sarl_value.py:pack; ops/sarl_value.py:packed keeps
// a net's copy and packs it again after a weight changes), in elements of T,
// each piece a multiple of 4 elements, weights as [in][out]:
//   streamed, in the order a tile reads them:
//     W12 [150][8][16] | W21|Wa|Wb [100][8 x 28 + 100] | W22|W_a2 [100][8][20]
//     | W30 [56][8][20] | W31 [150][8][16] | W32 [100][8][16]
//   resident:
//     W11 [13][8][20] | b11 [152] | b12 [100] | b21 [100] | b22 [52] | b_a1 [100]
//     | b_a2 [100] | w_a3 [100] | b_a3 [4] | b30 [152] | b31 [100] | b32 [100]
//     | w33 [100] | b33 [4]
// where a [K][8][pad] piece holds in group g, for each matrix of it in turn,
// that matrix's columns NC g .. NC g + NC - 1 (zeros past its width), then
// zeros to pad: W11 and W30 NC = 19; W12, W31 and W32 13; W21|Wa 25 of the
// 200 columns W21's then Wa's, each row followed by Wb's row; W22|W_a2 7 of
// W22's then 13 of W_a2's.  Wb is attention.0's columns 100-199 (m's half),
// Wa its columns 0-99; W3x are mlp3.0, mlp3.2, mlp3.4 and w33 mlp3.6.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPairIn = 13;       // pair features
constexpr int kSelfIn = 6;        // ego features
constexpr int kH1 = 150;          // mlp1's hidden width
constexpr int kE = 100;           // e, the attention's hidden widths, mlp2's hidden width
constexpr int kH = 50;            // h
constexpr int kZ0 = kSelfIn + kH;     // mlp3's input
constexpr int kZ1 = 150;          // mlp3's first width
constexpr int kG = 8;             // column groups of a pair product
constexpr int kAct = 200;         // rows of the activation buffer

// a pair product's columns a thread, NC = ceil(N / kG), and their group's
// width in the packed weights, padded to 16 bytes
__host__ __device__ constexpr int cols(int n) { return (n + kG - 1) / kG; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
constexpr int kNC150 = cols(150), kPad150 = pad4(kNC150);      // mlp1.0, mlp3.0
constexpr int kNC100 = cols(100), kPad100 = pad4(kNC100);      // mlp1.2, mlp3.2, mlp3.4
constexpr int kNC200 = cols(200), kPad200 = pad4(kNC200);      // mlp2.0 | attention.0's e half
constexpr int kNC50 = cols(50), kPadDual = pad4(kNC50 + kNC100);   // mlp2.2 | attention.2

// the streamed matrices, in the order a tile reads them: rows and row width
__host__ __device__ constexpr int stream_k(int l) {
  return l == 0 ? 150 : l == 3 ? 56 : l == 4 ? 150 : 100;
}
__host__ __device__ constexpr int stream_w(int l) {
  return l == 1 ? kG * kPad200 + kE : l == 2 ? kG * kPadDual : l == 3 ? kG * kPad150
                                                                       : kG * kPad100;
}
constexpr int kLayers = 6;
enum { kW12 = 0, kW2a = 1, kDual = 2, kW30 = 3, kW31 = 4, kW32 = 5 };

__host__ __device__ constexpr int stream_off(int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += stream_k(i) * stream_w(i);
  return off;
}
constexpr int kStreamSize = stream_off(kLayers);
static_assert(kStreamSize == 108560 && stream_off(2) == 19200 + 32400, "the streamed weights");

// rows of a slab of layer l: the largest divisor of its K whose rows fit in slab elements
__host__ __device__ constexpr int slab_rows(int l, int slab) {
  int rows = 1;
  for (int d = 1; d <= stream_k(l); ++d)
    if (stream_k(l) % d == 0 && d * stream_w(l) <= slab) rows = d;
  return rows;
}
__host__ __device__ constexpr int slab_elems(int l, int slab) {
  return slab_rows(l, slab) * stream_w(l);
}

// the resident pieces, offsets from the end of the streamed ones
constexpr int kRW11 = 0;
constexpr int kRB11 = kRW11 + kPairIn * kG * kPad150;
constexpr int kRB12 = kRB11 + 152;
constexpr int kRB21 = kRB12 + 100;
constexpr int kRB22 = kRB21 + 100;
constexpr int kRBA1 = kRB22 + 52;
constexpr int kRBA2 = kRBA1 + 100;
constexpr int kRWA3 = kRBA2 + 100;
constexpr int kRBA3 = kRWA3 + 100;
constexpr int kRB30 = kRBA3 + 4;
constexpr int kRB31 = kRB30 + 152;
constexpr int kRB32 = kRB31 + 100;
constexpr int kRW33 = kRB32 + 100;
constexpr int kRB33 = kRW33 + 100;
constexpr int kResSize = kRB33 + 4;
static_assert(kResSize == 3244 && kStreamSize % 4 == 0, "16-byte pieces");

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float exp_of(float a) { return expf(a); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ double exp_of(double a) { return exp(a); }

// torch.relu: 0 for v <= 0 (-0.0 included), NaN stays NaN
template <typename T>
__device__ __forceinline__ T relu(T v) {
  return (v > static_cast<T>(0) || v != v) ? v : static_cast<T>(0);
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

// 16 bytes from global to shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// one element (4 or 8 bytes)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
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
    cp_async16(reinterpret_cast<char*>(dst) + 16 * c, reinterpret_cast<const char*>(src) + 16 * c);
}

// n elements from src[0, valid) into dst, zeros past valid (plain stores:
// dst is read only after the next barrier that follows a cp_async_wait_all)
template <typename T, int kThreads>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* src, int n, int64_t valid) {
  for (int e = threadIdx.x; e < n; e += kThreads) {
    if (e < valid) cp_async_elem(dst + e, src + e);
    else dst[e] = static_cast<T>(0);
  }
}

template <typename T, int Q, int N>
__device__ __forceinline__ void zero(T (&acc)[Q][N]) {
#pragma unroll
  for (int i = 0; i < Q; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = static_cast<T>(0);
}

template <typename T, int Q>
__device__ __forceinline__ void zero(T (&acc)[Q][4][4]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) zero(acc[q]);
}

// sum over k < 100 of a[k * BM] * w[k], as four runs of 25 from 0 then
// ((r0 + r1) + (r2 + r3))
template <typename T, int BM>
__device__ __forceinline__ T dot100(const T* a, const T* w) {
  T r[4] = {static_cast<T>(0), static_cast<T>(0), static_cast<T>(0), static_cast<T>(0)};
#pragma unroll 5
  for (int k = 0; k < 25; ++k)
#pragma unroll
    for (int u = 0; u < 4; ++u) r[u] = fma_rn(a[(25 * u + k) * BM], w[25 * u + k], r[u]);
  return add_rn(add_rn(r[0], r[1]), add_rn(r[2], r[3]));
}

// The block's state: its arguments, the tile's shape and the weight stream.
template <typename T, int RG, int SLAB>
struct Block {
  static constexpr int kThreads = kG * RG;
  static constexpr int BM = 4 * RG;

  const T* packed;
  const T* pairs;
  const unsigned char* mask;
  const T* self_rows;
  int64_t rows;       // R, candidate rows
  int64_t group;      // candidate rows a mask row
  int P;              // others a candidate row
  int C;              // candidate rows a tile
  int CP;             // pair rows a tile
  int CM;             // C rounded up to 4
  T* ring;            // [2][SLAB]
  T* xs;              // [BM][13] as read, then [13][BM]
  T* selfs;           // [C][6]
  int cur;            // the ring buffer that holds the slab in use
  int64_t tile;       // this tile
  int64_t next;       // the next tile of this block
  bool more;          // whether there is one
  bool mlp3_now;      // whether mlp3 runs after this tile

  __device__ int64_t valid(int64_t tile) const {
    const int64_t left = rows - tile * C;
    return left < C ? left : C;
  }

  // a tile's pairs into xs, zeros past its valid rows
  __device__ void load_pairs(int64_t tile) const {
    copy_rows_async<T, kThreads>(xs, pairs + tile * C * P * kPairIn, BM * kPairIn,
                                 valid(tile) * P * kPairIn);
  }

  __device__ void load_self(int64_t tile) const {
    copy_rows_async<T, kThreads>(selfs, self_rows + tile * C * kSelfIn, C * kSelfIn,
                                 valid(tile) * kSelfIn);
  }

  // this thread's pair row's present flag (rows past the tile's pairs: 0)
  __device__ T load_flag(int64_t tile) const {
    const int row = threadIdx.x;
    if (row >= CP) return static_cast<T>(0);
    const int c = row / P, p = row - c * P;
    const int64_t cand = tile * C + c;
    if (cand >= rows) return static_cast<T>(0);
    return mask[(cand / group) * P + p] ? static_cast<T>(1) : static_cast<T>(0);
  }

  // Slab `slab` of layer L has landed and the other buffer is free once every
  // thread passes the barrier: issue the slab after it into that buffer (after
  // the last slab of a tile, the next tile's first), with this tile's ego rows
  // and the next tile's pairs at layer 0's first slab.
  template <int L>
  __device__ void advance(int slab) {
    constexpr int slabs = stream_k(L) / slab_rows(L, SLAB);
    cp_async_wait_all();
    __syncthreads();
    int off = 0, n = 0;      // the next slab's first element and size
    if (slab + 1 < slabs) {
      off = stream_off(L) + (slab + 1) * slab_elems(L, SLAB);
      n = slab_elems(L, SLAB);
    } else if (L + 1 < kLayers && (L != kDual || mlp3_now)) {
      off = stream_off(L + 1);
      n = slab_elems(L + 1, SLAB);
    } else if (more) {
      n = slab_elems(0, SLAB);
    }
    copy_async<T, kThreads>(ring + (cur ^ 1) * SLAB, packed + off, n);
    if constexpr (L == kW12) {
      if (slab == 0) {
        load_self(tile);
        if (more) load_pairs(next);
      }
    }
    cp_async_commit();
  }

  __device__ const T* slab_data() const { return ring + cur * SLAB; }
};

// acc[i][j] += sum over k < KS of a[k][4 rg + i] * b[k][j], k in order, for a
// [KS][BM] and b at the thread's column group of a [KS][kG][PAD] piece (rows
// STRIDE elements apart)
template <typename T, int BM, int KS, int NC, int PAD, int STRIDE = kG * PAD>
__device__ __forceinline__ void pair_products(T (&acc)[4][NC], const T* a, const T* b, int rg) {
#pragma unroll 2
  for (int k = 0; k < KS; ++k) {
    T av[4];
    ld4(a + k * BM + 4 * rg, av);
    T bv[PAD];
#pragma unroll
    for (int v = 0; v < PAD / 4; ++v) ld4(b + k * STRIDE + 4 * v, bv + 4 * v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fma_rn(av[i], bv[j], acc[i][j]);
  }
}

// a pair product over the slabs of streamed layer L, a [K][BM]
template <int L, int PAD, typename T, int RG, int SLAB, int NC>
__device__ __forceinline__ void pair_layer(Block<T, RG, SLAB>& blk, T (&acc)[4][NC], const T* a,
                                           int rg, int cg) {
  constexpr int BM = 4 * RG, KS = slab_rows(L, SLAB), slabs = stream_k(L) / KS;
  static_assert(stream_w(L) == kG * PAD && NC <= PAD, "a grouped piece");
  for (int s = 0; s < slabs; ++s) {
    blk.template advance<L>(s);
    pair_products<T, BM, KS, NC, PAD>(acc, a + s * KS * BM, blk.slab_data() + cg * PAD, rg);
    blk.cur ^= 1;
  }
}

// f(acc + bias) into out [N][BM] at the thread's rows, columns NC cg + j < N
template <int N, bool RELU, int BM, typename T, int NC>
__device__ __forceinline__ void pair_store(T* out, const T (&acc)[4][NC], const T* bias, int rg,
                                           int cg) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = cg * NC + j;
    if (col < N) {
      const T b = bias[col];
      T v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = add_rn(acc[i][j], b);
        if (RELU) v[i] = relu(v[i]);
      }
      st4(out + col * BM + 4 * rg, v);
    }
  }
}

// The global state's product, C rows: item t of rgc_n x 25 is rows 4 (t %
// rgc_n) .. + 3 and columns 4 (t / rgc_n) .. + 3; a thread takes items tid + q
// kThreads, q < Q.  acc[q][i][j] += sum over k < KS of a[k][row i] b[k][col
// j], for b's rows STRIDE elements apart.
template <typename T, int BM, int KS, int STRIDE, int Q, int kThreads>
__device__ __forceinline__ void cand_products(T (&acc)[Q][4][4], const T* a, const T* b,
                                              int items, int rgc_n) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int t = threadIdx.x + q * kThreads;
    if (t < items) {
      const int rgc = t % rgc_n, cgc = t / rgc_n;
#pragma unroll 2
      for (int k = 0; k < KS; ++k) {
        T av[4], bv[4];
        ld4(a + k * BM + 4 * rgc, av);
        ld4(b + k * STRIDE + 4 * cgc, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[q][i][j] = fma_rn(av[i], bv[j], acc[q][i][j]);
      }
    }
  }
}

template <int N, bool RELU, typename T, int BM, int Q, int kThreads>
__device__ __forceinline__ void cand_store(T* out, const T (&acc)[Q][4][4], const T* bias,
                                           int items, int rgc_n) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int t = threadIdx.x + q * kThreads;
    if (t < items) {
      const int rgc = t % rgc_n, cgc = t / rgc_n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * cgc + j;
        if (col < N) {
          const T b = bias[col];
          T v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = add_rn(acc[q][i][j], b);
            if (RELU) v[i] = relu(v[i]);
          }
          st4(out + col * BM + 4 * rgc, v);
        }
      }
    }
  }
}

template <typename T, int RG, int SLAB>
constexpr size_t smem_bytes() {
  constexpr int BM = 4 * RG;
  return sizeof(T) * (kResSize + 2 * SLAB + kAct * BM + BM * kPairIn + BM * kSelfIn + 3 * BM +
                      kZ0 * BM) + sizeof(int64_t) * BM;
}

template <typename T, int RG, int SLAB>
__global__ void __launch_bounds__(kG * RG, 1)
sarl_value_gemm_kernel(const T* __restrict__ packed, const T* __restrict__ pairs,
                       const unsigned char* __restrict__ mask, const T* __restrict__ self_rows,
                       T* __restrict__ y, int64_t rows, int64_t group, int P) {
  constexpr int kThreads = kG * RG;
  constexpr int BM = 4 * RG;
  constexpr int kPer = (BM * kPairIn + kThreads - 1) / kThreads;
  // Wb's product: at most BM / 4 x 25 items of 4 x 4, up to kQ a thread
  constexpr int kQ = (RG * kE / 4 + kThreads - 1) / kThreads;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* res = reinterpret_cast<T*>(smem_raw);     // the resident weights
  T* ring = res + kResSize;                     // [2][SLAB]: the streamed slabs
  T* act = ring + 2 * SLAB;                     // [200][BM]
  T* xs = act + kAct * BM;                      // [BM][13], then [13][BM]
  T* selfs = xs + BM * kPairIn;                 // [C][6]
  T* sv = selfs + BM * kSelfIn;                 // [BM]: s by pair row
  T* wv = sv + BM;                              // [BM]: exp(s), then w
  T* fl = wv + BM;                              // [BM]: present, 1 or 0
  T* zb = fl + BM;                              // [56][BM]: mlp3's input, a batch of rows
  int64_t* yb = reinterpret_cast<int64_t*>(zb + kZ0 * BM);   // [BM]: their rows of y, or -1

  Block<T, RG, SLAB> blk;
  blk.packed = packed;
  blk.pairs = pairs;
  blk.mask = mask;
  blk.self_rows = self_rows;
  blk.rows = rows;
  blk.group = group;
  blk.P = P;
  blk.C = P > 0 ? BM / P : BM;
  blk.CP = blk.C * P;
  blk.CM = (blk.C + 3) / 4 * 4;
  blk.ring = ring;
  blk.xs = xs;
  blk.selfs = selfs;
  blk.cur = 0;
  const int C = blk.C, CP = blk.CP, CM = blk.CM, rgc_n = CM / 4;
  // a candidate's threads in the mean and the pooling: thread (c, kk) takes
  // the candidate c = tid % C and rows kk, kk + per, ... (threads past per C idle)
  const int per = kThreads / C, c_own = threadIdx.x % C, kk = threadIdx.x / C;
  // mlp3 runs on batches of BM / C tiles' rows, and after the block's last tile
  const int batch_tiles = BM / C;
  int batched = 0;                                   // tiles in the batch so far

  const int tid = threadIdx.x;
  const int rg = tid % RG;
  const int cg = tid / RG;
  const int64_t num_tiles = (rows + C - 1) / C;
  int64_t tile = blockIdx.x;
  if (tile >= num_tiles) return;

  copy_async<T, kThreads>(res, packed + kStreamSize, kResSize);
  blk.load_pairs(tile);
  copy_async<T, kThreads>(ring, packed, slab_elems(0, SLAB));
  cp_async_commit();
  T flag = blk.load_flag(tile);

  for (; tile < num_tiles; tile += gridDim.x) {
    blk.tile = tile;
    blk.next = tile + gridDim.x;
    blk.more = blk.next < num_tiles;
    blk.mlp3_now = batched + 1 == batch_tiles || !blk.more;
    cp_async_wait_all();
    __syncthreads();

    // the present flags; the pairs transposed in place: xs[k][m] = x[m][k]
    if (tid < BM) fl[tid] = flag;
    {
      T v[kPer];
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int e = tid + n * kThreads;
        if (e < BM * kPairIn) {
          const int m = e % BM, k = e / BM;
          v[n] = xs[m * kPairIn + k];
        }
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int e = tid + n * kThreads;
        if (e < BM * kPairIn) xs[e] = v[n];
      }
    }
    __syncthreads();

    // mlp1.0: h11 = relu(x W11 + b11) into act [0, 150)
    {
      T acc[4][kNC150];
      zero(acc);
      pair_products<T, BM, kPairIn, kNC150, kPad150>(acc, xs, res + kRW11 + cg * kPad150, rg);
      pair_store<kH1, true, BM>(act, acc, res + kRB11, rg, cg);
    }
    // mlp1.2: e = relu(h11 W12 + b12) into act [0, 100)
    {
      T acc[4][kNC100];
      zero(acc);
      pair_layer<kW12, kPad100>(blk, acc, act, rg, cg);
      __syncthreads();
      pair_store<kE, true, BM>(act, acc, res + kRB12, rg, cg);
    }
    __syncthreads();

    // the global state m [100][C] into act [100, 200) (columns C .. CM - 1,
    // rows of Wb's product that nothing reads, are left as they are)
    if (kk < per) {
      const T* f = fl + c_own * P;
      T count = static_cast<T>(0);
      for (int p = 0; p < P; ++p) count = add_rn(count, f[p]);
      const T inv = div_rn(static_cast<T>(1), count < static_cast<T>(1) ? static_cast<T>(1)
                                                                         : count);
      // four rows at a time, each summed on its own
      for (int k = kk; k < kE; k += 4 * per) {
        const T* e = act + k * BM + c_own * P;
        const bool ok1 = k + per < kE, ok2 = k + 2 * per < kE, ok3 = k + 3 * per < kE;
        T s0 = static_cast<T>(0), s1 = static_cast<T>(0);
        T s2 = static_cast<T>(0), s3 = static_cast<T>(0);
        for (int p = 0; p < P; ++p) {
          // torch.where(present, e, 0): an absent other adds 0, whatever its e
          const bool on = f[p] != static_cast<T>(0);
          const T zero = static_cast<T>(0);
          s0 = add_rn(s0, on ? e[p] : zero);
          if (ok1) s1 = add_rn(s1, on ? e[per * BM + p] : zero);
          if (ok2) s2 = add_rn(s2, on ? e[2 * per * BM + p] : zero);
          if (ok3) s3 = add_rn(s3, on ? e[3 * per * BM + p] : zero);
        }
        T* m = act + (kE + k) * BM + c_own;
        m[0] = mul_rn(s0, inv);
        if (ok1) m[per * BM] = mul_rn(s1, inv);
        if (ok2) m[2 * per * BM] = mul_rn(s2, inv);
        if (ok3) m[3 * per * BM] = mul_rn(s3, inv);
      }
    }

    // mlp2.0 and attention.0 in one pass over k: e [W21 | Wa] (pair rows)
    // and m Wb (candidate rows); then g = m Wb + b_a1 over m, and
    // [relu(e W21 + b21) | relu(e Wa + g)] into act [0, 200)
    {
      T acc[4][kNC200];
      T gacc[kQ][4][4];
      zero(acc);
      zero(gacc);
      const int items = rgc_n * (kE / 4);
      constexpr int KS = slab_rows(kW2a, SLAB), slabs = stream_k(kW2a) / KS;
      constexpr int W = stream_w(kW2a);
      for (int s = 0; s < slabs; ++s) {
        blk.template advance<kW2a>(s);
        const T* b = blk.slab_data();
        pair_products<T, BM, KS, kNC200, kPad200, W>(acc, act + s * KS * BM, b + cg * kPad200,
                                                     rg);
        cand_products<T, BM, KS, W, kQ, kThreads>(gacc, act + (kE + s * KS) * BM, b + kG * kPad200,
                                                 items, rgc_n);
        blk.cur ^= 1;
      }
      __syncthreads();
      cand_store<kE, false, T, BM, kQ, kThreads>(act + kE * BM, gacc, res + kRBA1, items, rgc_n);
      __syncthreads();
      // columns [0, 100) add b21; [100, 200) add g, whose g[col - 100][c] lies
      // at act[col][c] (a pair row past the tile's pairs takes row C - 1's)
      int cand[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = P > 0 ? (4 * rg + i) / P : 0;
        cand[i] = c < C ? c : C - 1;
      }
#pragma unroll
      for (int j = 0; j < kNC200; ++j) {
        const int col = cg * kNC200 + j;
        if (col < kE) {
          const T b = res[kRB21 + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = add_rn(acc[i][j], b);
        } else if (col < 2 * kE) {
          const T* g = act + col * BM;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = add_rn(acc[i][j], g[cand[i]]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kNC200; ++j) {
        const int col = cg * kNC200 + j;
        if (col < 2 * kE) {
          T v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = relu(acc[i][j]);
          st4(act + col * BM + 4 * rg, v);
        }
      }
    }

    // mlp2.2 and attention.2 in one pass: h = h21 W22 + b22 into act [0, 50),
    // a2 = relu(a1 W_a2 + b_a2) into act [100, 200)
    {
      T ah[4][kNC50], aa[4][kNC100];
      zero(ah);
      zero(aa);
      constexpr int KS = slab_rows(kDual, SLAB), slabs = stream_k(kDual) / KS;
      for (int s = 0; s < slabs; ++s) {
        blk.template advance<kDual>(s);
        const T* b = blk.slab_data() + cg * kPadDual;
        const T* a_h = act + s * KS * BM + 4 * rg;
        const T* a_a = act + (kE + s * KS) * BM + 4 * rg;
#pragma unroll 2
        for (int k = 0; k < KS; ++k) {
          T vh[4], va[4], bv[kPadDual];
          ld4(a_h + k * BM, vh);
          ld4(a_a + k * BM, va);
#pragma unroll
          for (int v = 0; v < kPadDual / 4; ++v) ld4(b + k * kG * kPadDual + 4 * v, bv + 4 * v);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < kNC50; ++j) ah[i][j] = fma_rn(vh[i], bv[j], ah[i][j]);
#pragma unroll
            for (int j = 0; j < kNC100; ++j) aa[i][j] = fma_rn(va[i], bv[kNC50 + j], aa[i][j]);
          }
        }
        blk.cur ^= 1;
      }
      __syncthreads();
      pair_store<kH, false, BM>(act, ah, res + kRB22, rg, cg);
      pair_store<kE, true, BM>(act + kE * BM, aa, res + kRBA2, rg, cg);
    }
    __syncthreads();

    // attention.4: s = a2 w_a3 + b_a3 by pair row
    for (int row = tid; row < CP; row += kThreads)
      sv[row] = add_rn(dot100<T, BM>(act + kE * BM + row, res + kRWA3), res[kRBA3]);
    __syncthreads();

    // the masked softmax, as the plain version writes it
    if (tid < C) {
      T total = static_cast<T>(0);
      for (int p = 0; p < P; ++p) {
        const int r = tid * P + p;
        const T s = sv[r];
        const T score = (fl[r] != static_cast<T>(0) && s != static_cast<T>(0)) ? exp_of(s)
                                                                                : static_cast<T>(0);
        wv[r] = score;
        total = add_rn(total, score);
      }
      const bool positive = total > static_cast<T>(0);
      const T inv = positive ? div_rn(static_cast<T>(1), total) : static_cast<T>(0);
      for (int p = 0; p < P; ++p) {
        const int r = tid * P + p;
        wv[r] = positive ? mul_rn(wv[r], inv) : static_cast<T>(0);
      }
    }
    __syncthreads();

    // mlp3's input [self | sum_j w_j h_j] into the batch's rows C batched ..
    if (kk < per) {
      const T* w = wv + c_own * P;
      T* z = zb + batched * C + c_own;
#pragma unroll 1
      for (int r = kk; r < kZ0; r += per) {
        T v = static_cast<T>(0);
        if (r < kSelfIn) {
          v = selfs[c_own * kSelfIn + r];
        } else {
          const T* h = act + (r - kSelfIn) * BM + c_own * P;
          for (int p = 0; p < P; ++p) v = add_rn(v, mul_rn(w[p], h[p]));
        }
        z[r * BM] = v;
      }
    }
    if (tid < C) {
      const int64_t cand = tile * C + tid;
      yb[batched * C + tid] = cand < rows ? cand : -1;
    }
    if (blk.more) flag = blk.load_flag(blk.next);
    ++batched;

    if (blk.mlp3_now) {
      // mlp3 over the batch, as pair products over its rows: relu(. W30 +
      // b30) into act [0, 150), relu(. W31 + b31) and relu(. W32 + b32) into
      // act [0, 100); rows past the batch's are computed and dropped
      {
        T acc[4][kNC150];
        zero(acc);
        pair_layer<kW30, kPad150>(blk, acc, zb, rg, cg);
        __syncthreads();
        pair_store<kZ1, true, BM>(act, acc, res + kRB30, rg, cg);
      }
      {
        T acc[4][kNC100];
        zero(acc);
        pair_layer<kW31, kPad100>(blk, acc, act, rg, cg);
        __syncthreads();
        pair_store<kE, true, BM>(act, acc, res + kRB31, rg, cg);
      }
      {
        T acc[4][kNC100];
        zero(acc);
        pair_layer<kW32, kPad100>(blk, acc, act, rg, cg);
        __syncthreads();
        pair_store<kE, true, BM>(act, acc, res + kRB32, rg, cg);
      }
      __syncthreads();

      // mlp3.6: V
      for (int row = tid; row < batched * C; row += kThreads) {
        const int64_t at = yb[row];
        if (at >= 0) y[at] = add_rn(dot100<T, BM>(act + row, res + kRW33), res[kRB33]);
      }
      batched = 0;
    }
  }
}

template <typename T, int RG, int SLAB>
int launch(const void* packed, const void* pairs, const void* mask, const void* self_rows,
           void* y, int64_t rows, int64_t group, int64_t others, void* stream) {
  constexpr int BM = 4 * RG;
  if (rows <= 0) return 0;
  if (others < 0 || others > BM || group <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t kSmem = smem_bytes<T, RG, SLAB>();
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
  static_assert(SLAB % 4 == 0, "16-byte slabs");
  const auto kernel = sarl_value_gemm_kernel<T, RG, SLAB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t C = others > 0 ? BM / others : BM;
  const int64_t tiles = (rows + C - 1) / C;
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<blocks, kG * RG, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(packed), static_cast<const T*>(pairs),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(self_rows),
      static_cast<T*>(y), rows, group, static_cast<int>(others));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: the layout above (16-byte aligned); pairs: [rows, others, 13]; mask:
// [rows / group, others] bool, the row that `group` consecutive candidate rows
// share; self_rows: [rows, 6]; y: [rows]; all contiguous on the current
// device, others at most 128.  Returns cudaGetLastError() after the launch.
extern "C" int sarl_value_f32(const void* packed, const void* pairs, const void* mask,
                              const void* self_rows, void* y, int64_t rows, int64_t group,
                              int64_t others, void* stream) {
  return launch<float, 32, 9500>(packed, pairs, mask, self_rows, y, rows, group, others,
                                 stream);   // 128 pair rows a tile
}

// float64: 64 pair rows a tile on 128 threads and slabs of 3 900, to fit
// shared memory; others at most 64
extern "C" int sarl_value_f64(const void* packed, const void* pairs, const void* mask,
                              const void* self_rows, void* y, int64_t rows, int64_t group,
                              int64_t others, void* stream) {
  return launch<double, 16, 3900>(packed, pairs, mask, self_rows, y, rows, group, others,
                                  stream);
}
