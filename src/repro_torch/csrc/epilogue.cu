// Hand-written Hopper (sm_90a) kernels for the Catmull-Rom activation unit.
//
// Two kernels, each the counterpart of one Pallas TPU kernel of
// src/repro/kernels/epilogue.py, behind a plain C interface that
// src/repro_torch/kernels/_build.py builds with nvcc and loads with ctypes:
//
//   repro_elementwise_2d  <- epilogue.py:elementwise_2d (_elementwise_kernel)
//   repro_glu_2d          <- epilogue.py:glu_2d (_glu_kernel)
//
// Both evaluate the same epilogue (tanh | sigmoid | silu | gelu_tanh |
// softplus, built on one tanh block) in f32, in the plain PyTorch
// version's operation order. The tanh block is one of the four approximant
// schemes of src/repro/core/approximant.py, chosen per launch:
//
//   cr_spline  epilogue.py:_cr_tanh_block     params [depth, 4]
//   pwl        approximant.py:PWL.block       params [depth, 2]
//   poly       approximant.py:PiecewisePoly   params [depth, degree + 1]
//   rational   approximant.py:PadeRational    params [3, K]
//
// Every multiply and add of the epilogue uses the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which the compiler never
// contracts into an FMA, so the kernel's epilogue rounds exactly where the
// plain version's separate PyTorch ops round. The scheme is a runtime
// switch, uniform across the grid, not a template parameter: the
// instantiations (epilogue x dtype x vector path x tile) stay as many as
// with one scheme, and so does the build time.
//
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper
// raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { EPI_TANH = 0, EPI_SIGMOID = 1, EPI_SILU = 2, EPI_GELU = 3, EPI_SOFTPLUS = 4 };
enum { DT_F32 = 0, DT_BF16 = 1 };
enum { SCHEME_CR = 0, SCHEME_PWL = 1, SCHEME_POLY = 2, SCHEME_RATIONAL = 3 };

constexpr int MAX_PARAMS = 2048;  // f32 params a kernel holds in shared memory (8 KB)
constexpr int MAX_POLY_COLS = 8;  // poly degree <= 7
constexpr int NEWTON_ITERS = 5;   // approximant.py:NEWTON_ITERS
constexpr int SM_COUNT = 132;     // H100 SXM streaming multiprocessors

// One approximant: its scheme, its [rows, cols] f32 params (row-major; in
// device memory as a kernel argument, in shared memory once the block has
// copied them) and its geometry. rows is the LUT depth of cr_spline, pwl
// and poly; rational reads no depth.
struct Table {
  const float* p;
  int scheme, rows, cols;
  float inv_period, x_max, sat;
};

// Copy the block's params into shared memory and point the table there.
// The caller synchronises the block before the first read.
__device__ __forceinline__ void load_params(float* s_par, Table& tb) {
  const int n = tb.rows * tb.cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_par[i] = tb.p[i];
  tb.p = s_par;
}

// approximant.py:_index_t_split: segment index and local t in [0, 1).
__device__ __forceinline__ int index_t_split(float av, const Table& tb, float& t) {
  const float u = __fmul_rn(av, tb.inv_period);
  const float k = fminf(fmaxf(floorf(u), 0.0f), (float)(tb.rows - 1));
  t = __fsub_rn(u, k);
  return (int)k;
}

// approximant.py:_finish: saturate at the domain edge, restore the sign.
__device__ __forceinline__ float finish(float y, float v, float av, const Table& tb, bool odd) {
  if (av >= tb.x_max) y = tb.sat;
  if (odd && v < 0.0f) y = -y;
  return y;
}

// epilogue.py:_cr_tanh_block on one f32 value: index/t split, window
// gather, Horner CR basis (_basis_weights_f32), 4-tap MAC, saturation,
// sign restore.
__device__ __forceinline__ float cr_block(float v, const Table& tb, bool odd) {
  const float av = odd ? fabsf(v) : v;
  float t;
  const int k = index_t_split(av, tb, t);
  const float4 p = reinterpret_cast<const float4*>(tb.p)[k];
  const float w0 = __fmul_rn(0.5f, __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(-t, 2.0f), t), 1.0f), t));
  const float w1 = __fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(3.0f, t), 5.0f), t), t), 2.0f));
  const float w2 = __fmul_rn(0.5f, __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(-3.0f, t), 4.0f), t), 1.0f), t));
  const float w3 = __fmul_rn(0.5f, __fmul_rn(__fmul_rn(__fsub_rn(t, 1.0f), t), t));
  float y = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p.x, w0), __fmul_rn(p.y, w1)),
                                __fmul_rn(p.z, w2)),
                      __fmul_rn(p.w, w3));
  return finish(y, v, av, tb, odd);
}

// approximant.py:PWL.block: y0 + t * dy from the (value, delta) row.
__device__ __forceinline__ float pwl_block(float v, const Table& tb, bool odd) {
  const float av = odd ? fabsf(v) : v;
  float t;
  const int k = index_t_split(av, tb, t);
  const float y = __fadd_rn(tb.p[2 * k], __fmul_rn(t, tb.p[2 * k + 1]));
  return finish(y, v, av, tb, odd);
}

// approximant.py:PiecewisePoly.block: Horner in t over the segment's
// coefficients, highest power first.
__device__ __forceinline__ float poly_block(float v, const Table& tb, bool odd) {
  const float av = odd ? fabsf(v) : v;
  float t;
  const int k = index_t_split(av, tb, t);
  const float* c = tb.p + k * tb.cols;
  float y = c[0];
  for (int j = 1; j < tb.cols; ++j) y = __fadd_rn(__fmul_rn(y, t), c[j]);
  return finish(y, v, av, tb, odd);
}

// approximant.py:PadeRational.block: num/den Horner chains in u = avc^2
// from the top coefficient, a linear seed for 1/den, NEWTON_ITERS Newton
// steps, then the overshoot clamp. No table lookup. The two clamps are
// written as compares so that a NaN passes through, as torch.clamp's does.
__device__ __forceinline__ float rational_block(float v, const Table& tb, bool odd) {
  const float av = odd ? fabsf(v) : v;
  const float avc = av > tb.x_max ? tb.x_max : av;   // keep den in range
  const float u = __fmul_rn(avc, avc);
  const int K = tb.cols;
  const float* pn = tb.p;            // num coefficients, u^0 first
  const float* pd = tb.p + K;        // den coefficients
  const float* ps = tb.p + 2 * K;    // seed [alpha, beta]
  float num = pn[K - 1], den = pd[K - 1];
  for (int j = K - 2; j >= 0; --j) {
    num = __fadd_rn(__fmul_rn(num, u), pn[j]);
    den = __fadd_rn(__fmul_rn(den, u), pd[j]);
  }
  num = __fmul_rn(num, avc);
  float r = __fsub_rn(ps[0], __fmul_rn(ps[1], den));
#pragma unroll
  for (int i = 0; i < NEWTON_ITERS; ++i) r = __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(den, r)));
  float y = __fmul_rn(num, r);
  if (y > tb.sat) y = tb.sat;
  return finish(y, v, av, tb, odd);
}

// approximant.py:block, the registry dispatch (one scheme per launch).
__device__ __forceinline__ float scheme_block(float v, const Table& tb, bool odd) {
  switch (tb.scheme) {
    case SCHEME_PWL: return pwl_block(v, tb, odd);
    case SCHEME_POLY: return poly_block(v, tb, odd);
    case SCHEME_RATIONAL: return rational_block(v, tb, odd);
    default: return cr_block(v, tb, odd);
  }
}

// epilogue.py:make_epilogue, the paper's identities on one tanh unit.
template <int EPI>
__device__ __forceinline__ float epilogue(float v, const Table& tb) {
  if (EPI == EPI_TANH) return scheme_block(v, tb, true);
  if (EPI == EPI_SIGMOID)
    return __fmul_rn(0.5f, __fadd_rn(1.0f, scheme_block(__fmul_rn(v, 0.5f), tb, true)));
  if (EPI == EPI_SILU)
    return __fmul_rn(v, __fmul_rn(0.5f, __fadd_rn(1.0f, scheme_block(__fmul_rn(v, 0.5f), tb, true))));
  if (EPI == EPI_GELU) {
    const float c = (float)0.7978845608028654;   // sqrt(2 / pi)
    const float a = (float)0.044715;
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(a, v), v), v);
    const float inner = __fmul_rn(c, __fadd_rn(v, cube));
    return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, scheme_block(inner, tb, true)));
  }
  // softplus: relu(v) + h(|v|) from its own even residual params
  return __fadd_rn(fmaxf(v, 0.0f), scheme_block(fabsf(v), tb, false));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// ---------------------------------------------------------------------------
// elementwise_2d
//
// Replaces: src/repro/kernels/epilogue.py:elementwise_2d (_elementwise_kernel).
// Bound on the card: bytes. It reads x once and writes y once; the math is
// a few dozen f32 operations per element against ~295 bf16 operations the
// card can do per byte of device memory.
// Design: a grid-stride loop over the flattened contiguous array with
// 16-byte vector loads and stores (4 f32 or 8 bf16 per access) when both
// pointers are 16-byte aligned, a scalar tail, and the ragged edge masked
// by the loop bound in place of the TPU's block padding. The scheme's
// params (at most MAX_PARAMS floats) are copied into shared memory once per
// block, so the per-element gather never touches device memory. Templated
// on the epilogue and the I/O dtype; the scheme is a uniform switch.
// ---------------------------------------------------------------------------

template <int EPI, typename T, bool VEC>
__global__ void __launch_bounds__(256)
repro_elementwise_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, Table tb) {
  __shared__ __align__(16) float s_par[MAX_PARAMS];
  load_params(s_par, tb);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const long long nv = n / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (long long i = start; i < nv; i += stride) {
      uint4 raw = xv[i];
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = from_f<T>(epilogue<EPI>(to_f(e[j]), tb));
      yv[i] = raw;
    }
    tail = nv * V;
  }
  for (long long i = tail + start; i < n; i += stride)
    y[i] = from_f<T>(epilogue<EPI>(to_f(x[i]), tb));
}

template <int EPI, typename T>
void launch_elementwise(const void* x, void* y, long long n, const Table& tb,
                        cudaStream_t stream) {
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long units = vec ? (n + (16 / sizeof(T)) - 1) / (16 / sizeof(T)) : n;
  const int threads = 256;
  long long blocks = (units + threads - 1) / threads;
  if (blocks > 8LL * SM_COUNT) blocks = 8LL * SM_COUNT;   // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec)
    repro_elementwise_kernel<EPI, T, true><<<(int)blocks, threads, 0, stream>>>(xt, yt, n, tb);
  else
    repro_elementwise_kernel<EPI, T, false><<<(int)blocks, threads, 0, stream>>>(xt, yt, n, tb);
}

template <typename T>
bool dispatch_elementwise(int epi, const void* x, void* y, long long n, const Table& tb,
                          cudaStream_t s) {
  switch (epi) {
    case EPI_TANH: launch_elementwise<EPI_TANH, T>(x, y, n, tb, s); return true;
    case EPI_SIGMOID: launch_elementwise<EPI_SIGMOID, T>(x, y, n, tb, s); return true;
    case EPI_SILU: launch_elementwise<EPI_SILU, T>(x, y, n, tb, s); return true;
    case EPI_GELU: launch_elementwise<EPI_GELU, T>(x, y, n, tb, s); return true;
    case EPI_SOFTPLUS: launch_elementwise<EPI_SOFTPLUS, T>(x, y, n, tb, s); return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// glu_2d
//
// Replaces: src/repro/kernels/epilogue.py:glu_2d (_glu_kernel).
// out[M, N] = epilogue(x[M, K] @ w_gate[K, N]) * (x[M, K] @ w_up[K, N]).
// Bound on the card: at decode (M = slots) the weight bytes, 2*K*N*2 B in
// bf16; at long prefill the tensor-core operations, 4*M*N*K.
// Design: each block owns one [BM, BN] output tile; a loop inside the block
// runs over K (the TPU's sequential K grid axis and its VMEM scratch have no
// counterpart: nothing carries over between blocks). Each K step stages one
// x tile and the matching w_gate and w_up tiles in shared memory and
// accumulates BOTH products into f32 accumulators. After the last K step
// the epilogue (one scheme evaluation) fires on the f32 gate accumulator,
// is multiplied by the f32
// up accumulator and cast once to the output dtype: gate and up are never
// rounded to bf16, which is the point of the fusion. bf16 inputs run on the
// tensor cores (nvcuda::wmma bf16 16x16x16, f32 accumulate); f32 inputs run
// an IEEE f32 SIMT path (FMA on CUDA cores, no TF32). M, N and K are masked
// by zero-filled tile loads and a bounds-checked store. At decode M is only
// the slot count, so a 16-row tile serves it. No pipelining, TMA or wgmma
// yet: the first kernel is the simple one.
// ---------------------------------------------------------------------------

// 8 consecutive bf16 of row r, columns [c, c+8), of a row-major [R, C]
// matrix into shared memory; zero outside the matrix.
__device__ __forceinline__ void load8(bf16* dst, const bf16* __restrict__ src, int r,
                                      int c, int R, int C, bool vec) {
  if (vec && r < R && c + 8 <= C) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src + (long long)r * C + c);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j] = (r < R && c + j < C) ? src[(long long)r * C + c + j] : __float2bfloat16_rn(0.0f);
}

template <int EPI, int BM, int BN, int BK, int WM, int WN>
__global__ void repro_glu_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                                const bf16* __restrict__ wu, bf16* __restrict__ out, int M,
                                int N, int K, Table tb, bool vec) {
  using namespace nvcuda;
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * WARPS_N * 32;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  constexpr int STAGE_BYTES = (BM * LDA + 2 * BK * LDB) * 2;
  constexpr int EPI_BYTES = 2 * BM * LDC * 4;
  constexpr int SMEM = STAGE_BYTES > EPI_BYTES ? STAGE_BYTES : EPI_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ __align__(16) float s_par[MAX_PARAMS];
  bf16* sa = reinterpret_cast<bf16*>(smem);                  // [BM][LDA]
  bf16* sg = sa + BM * LDA;                                  // [BK][LDB]
  bf16* su = sg + BK * LDB;                                  // [BK][LDB]
  float* cg = reinterpret_cast<float*>(smem);                // [BM][LDC] after the K loop
  float* cu = cg + BM * LDC;

  load_params(s_par, tb);   // read after the K loop's barriers
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_g[FM][FN], acc_u[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(acc_g[i][j], 0.0f);
      wmma::fill_fragment(acc_u[i][j], 0.0f);
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK / 8; idx += NT) {
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      load8(sa + r * LDA + c, x, m0 + r, k0 + c, M, K, vec);
    }
    for (int idx = threadIdx.x; idx < BK * BN / 8; idx += NT) {
      const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      load8(sg + r * LDB + c, wg, k0 + r, n0 + c, K, N, vec);
      load8(su + r * LDB + c, wu, k0 + r, n0 + c, K, N, vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], sa + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sg + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc_g[i][j], fa[i], fb, acc_g[i][j]);
        wmma::load_matrix_sync(fb, su + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc_u[i][j], fa[i], fb, acc_u[i][j]);
      }
    }
    __syncthreads();
  }

  // the staging buffers are free now: park both f32 accumulators there
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int off = (wm * WM + i * 16) * LDC + wn * WN + j * 16;
      wmma::store_matrix_sync(cg + off, acc_g[i][j], LDC, wmma::mem_row_major);
      wmma::store_matrix_sync(cu + off, acc_u[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      out[(long long)gm * N + gn] =
          __float2bfloat16_rn(__fmul_rn(epilogue<EPI>(cg[r * LDC + c], tb), cu[r * LDC + c]));
  }
}

template <int EPI, int BM, int BN, int BK, int TM, int TN>
__global__ void repro_glu_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                               const float* __restrict__ wu, float* __restrict__ out, int M,
                               int N, int K, Table tb) {
  constexpr int TX = BN / TN, NT = TX * (BM / TM);
  __shared__ float sa[BK][BM + 4];     // x tile, transposed: k-major
  __shared__ float sg[BK][BN + 4];
  __shared__ float su[BK][BN + 4];
  __shared__ __align__(16) float s_par[MAX_PARAMS];
  load_params(s_par, tb);   // read after the K loop's barriers
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc_g[TM][TN], acc_u[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_g[i][j] = acc_u[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      sa[c][r] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.0f;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += NT) {
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      sg[r][c] = ok ? wg[(long long)gk * N + gn] : 0.0f;
      su[r][c] = ok ? wu[(long long)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bg[TN], bu[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sa[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bg[j] = sg[kk][tx * TN + j];
        bu[j] = su[kk][tx * TN + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_g[i][j] = fmaf(a[i], bg[j], acc_g[i][j]);
          acc_u[i][j] = fmaf(a[i], bu[j], acc_u[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty * TM + i, gn = n0 + tx * TN + j;
      if (gm < M && gn < N)
        out[(long long)gm * N + gn] = __fmul_rn(epilogue<EPI>(acc_g[i][j], tb), acc_u[i][j]);
    }
}

template <int EPI>
void launch_glu(const void* x, const void* wg, const void* wu, void* out, int M, int N, int K,
                int dtype, const Table& tb, cudaStream_t s) {
  if (dtype == DT_BF16) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* gb = static_cast<const bf16*>(wg);
    const bf16* ub = static_cast<const bf16*>(wu);
    bf16* ob = static_cast<bf16*>(out);
    const bool vec = K % 8 == 0 && N % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)wg % 16 == 0 && (uintptr_t)wu % 16 == 0;
    if (M <= 16) {   // decode: one 16-row tile, narrow N tiles to spread the weights
      constexpr int BM = 16, BN = 32, BK = 64, WM = 16, WN = 16;
      dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
      repro_glu_bf16_kernel<EPI, BM, BN, BK, WM, WN><<<grid, (BM / WM) * (BN / WN) * 32, 0, s>>>(
          xb, gb, ub, ob, M, N, K, tb, vec);
    } else {
      constexpr int BM = 64, BN = 64, BK = 32, WM = 32, WN = 32;
      dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
      repro_glu_bf16_kernel<EPI, BM, BN, BK, WM, WN><<<grid, (BM / WM) * (BN / WN) * 32, 0, s>>>(
          xb, gb, ub, ob, M, N, K, tb, vec);
    }
    return;
  }
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(wg);
  const float* uf = static_cast<const float*>(wu);
  float* of = static_cast<float*>(out);
  if (M <= 16) {
    constexpr int BM = 16, BN = 64, BK = 32, TM = 1, TN = 4;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    repro_glu_f32_kernel<EPI, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
        xf, gf, uf, of, M, N, K, tb);
  } else {
    constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    repro_glu_f32_kernel<EPI, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
        xf, gf, uf, of, M, N, K, tb);
  }
}

// The params a kernel takes: the shape each scheme's block reads, at most
// MAX_PARAMS floats; rational has no softplus (its build targets tanh only).
bool params_ok(int scheme, int rows, int cols, int epi) {
  if (rows < 1 || cols < 1 || (long long)rows * cols > MAX_PARAMS) return false;
  switch (scheme) {
    case SCHEME_CR: return cols == 4;
    case SCHEME_PWL: return cols == 2;
    case SCHEME_POLY: return cols >= 2 && cols <= MAX_POLY_COLS;
    case SCHEME_RATIONAL: return rows == 3 && cols >= 2 && epi != EPI_SOFTPLUS;
  }
  return false;
}

}  // namespace

extern "C" int repro_elementwise_2d(const void* x, const void* params, void* y, int rows,
                                    int cols, int scheme, int p_rows, int p_cols, int epi,
                                    int dtype, float inv_period, float x_max, float saturation,
                                    void* stream) {
  if (!params_ok(scheme, p_rows, p_cols, epi) || rows < 0 || cols < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * cols;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table tb{static_cast<const float*>(params), scheme, p_rows, p_cols, inv_period, x_max,
                 saturation};
  bool ok = false;
  if (dtype == DT_F32)
    ok = dispatch_elementwise<float>(epi, x, y, n, tb, s);
  else if (dtype == DT_BF16)
    ok = dispatch_elementwise<bf16>(epi, x, y, n, tb, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int repro_glu_2d(const void* x, const void* w_gate, const void* w_up,
                            const void* params, void* out, int M, int N, int K, int scheme,
                            int p_rows, int p_cols, int epi, int dtype, float inv_period,
                            float x_max, float saturation, void* stream) {
  if (!params_ok(scheme, p_rows, p_cols, epi) || M < 1 || N < 1 || K < 1 ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table tb{static_cast<const float*>(params), scheme, p_rows, p_cols, inv_period, x_max,
                 saturation};
  switch (epi) {
    case EPI_TANH: launch_glu<EPI_TANH>(x, w_gate, w_up, out, M, N, K, dtype, tb, s); break;
    case EPI_SIGMOID: launch_glu<EPI_SIGMOID>(x, w_gate, w_up, out, M, N, K, dtype, tb, s); break;
    case EPI_SILU: launch_glu<EPI_SILU>(x, w_gate, w_up, out, M, N, K, dtype, tb, s); break;
    case EPI_GELU: launch_glu<EPI_GELU>(x, w_gate, w_up, out, M, N, K, dtype, tb, s); break;
    case EPI_SOFTPLUS: launch_glu<EPI_SOFTPLUS>(x, w_gate, w_up, out, M, N, K, dtype, tb, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
