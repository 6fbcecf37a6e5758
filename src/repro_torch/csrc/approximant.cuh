// The approximant activation unit on f32 values, shared by both kernels of
// this directory (elementwise.cu, epilogue.cu).
//
// The epilogue (tanh | sigmoid | silu | gelu_tanh | softplus) is built on
// one tanh block, which is one of the four approximant schemes of
// src/repro/core/approximant.py, chosen per launch:
//
//   cr_spline  epilogue.py:_cr_tanh_block     params [depth, 4]
//   pwl        approximant.py:PWL.block       params [depth, 2]
//   poly       approximant.py:PiecewisePoly   params [depth, degree + 1]
//   rational   approximant.py:PadeRational    params [3, K]
//
// Every multiply and add uses the round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn), which the compiler never contracts into an FMA, so
// a kernel rounds exactly where the plain PyTorch version's separate ops
// round. Everything here has internal linkage: each source that includes
// it gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// The tanh unit of scheme S (approximant.py:block) over E values in place,
// elements innermost so that their chains interleave. Each element rounds
// as the scalar datapath does:
//
//   poly      approximant.py:PiecewisePoly.block: Horner in t over the
//             segment's coefficients, highest power first;
//   rational  approximant.py:PadeRational.block: num/den Horner chains in
//             u = avc^2 from the top coefficient, a linear seed for 1/den,
//             NEWTON_ITERS Newton steps, then the overshoot clamp. No table
//             lookup. The two clamps are written as compares so that a NaN
//             passes through, as torch.clamp's does.
template <int S, int E>
__device__ __forceinline__ void block_n(float (&a)[E], const Table& tb, bool odd) {
  if constexpr (S == SCHEME_CR) {
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = cr_block(a[e], tb, odd);
  } else if constexpr (S == SCHEME_PWL) {
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = pwl_block(a[e], tb, odd);
  } else if constexpr (S == SCHEME_POLY) {
    // Horner at a fixed trip count: step j runs when j < cols (uniform)
    float av[E], t[E], y[E];
    const float* c[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      av[e] = odd ? fabsf(a[e]) : a[e];
      c[e] = tb.p + index_t_split(av[e], tb, t[e]) * tb.cols;
      y[e] = c[e][0];
    }
#pragma unroll
    for (int j = 1; j < MAX_POLY_COLS; ++j) {
      if (j < tb.cols) {
#pragma unroll
        for (int e = 0; e < E; ++e) y[e] = __fadd_rn(__fmul_rn(y[e], t[e]), c[e][j]);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = finish(y[e], a[e], av[e], tb, odd);
  } else {
    // each Horner and Newton step over all E elements
    const int K = tb.cols;
    const float* pn = tb.p;
    const float* pd = tb.p + K;
    const float* ps = tb.p + 2 * K;
    float av[E], avc[E], u[E], num[E], den[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      av[e] = odd ? fabsf(a[e]) : a[e];
      avc[e] = av[e] > tb.x_max ? tb.x_max : av[e];
      u[e] = __fmul_rn(avc[e], avc[e]);
      num[e] = pn[K - 1];
      den[e] = pd[K - 1];
    }
    for (int j = K - 2; j >= 0; --j) {
      const float cn = pn[j], cd = pd[j];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        num[e] = __fadd_rn(__fmul_rn(num[e], u[e]), cn);
        den[e] = __fadd_rn(__fmul_rn(den[e], u[e]), cd);
      }
    }
    float r[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      num[e] = __fmul_rn(num[e], avc[e]);
      r[e] = __fsub_rn(ps[0], __fmul_rn(ps[1], den[e]));
    }
#pragma unroll
    for (int i = 0; i < NEWTON_ITERS; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) r[e] = __fmul_rn(r[e], __fsub_rn(2.0f, __fmul_rn(den[e], r[e])));
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float y = __fmul_rn(num[e], r[e]);
      if (y > tb.sat) y = tb.sat;
      a[e] = finish(y, a[e], av[e], tb, odd);
    }
  }
}

// The registry dispatch on one value (one scheme per launch).
__device__ __forceinline__ float scheme_block(float v, const Table& tb, bool odd) {
  float a[1] = {v};
  switch (tb.scheme) {
    case SCHEME_PWL: block_n<SCHEME_PWL, 1>(a, tb, odd); break;
    case SCHEME_POLY: block_n<SCHEME_POLY, 1>(a, tb, odd); break;
    case SCHEME_RATIONAL: block_n<SCHEME_RATIONAL, 1>(a, tb, odd); break;
    default: block_n<SCHEME_CR, 1>(a, tb, odd); break;
  }
  return a[0];
}

// epilogue.py:make_epilogue, the paper's identities on one tanh unit, in
// two halves around the unit's one evaluation: epi_arg is the value the
// unit evaluates, epi_out the epilogue's result from x and the unit's
// output b. softplus's unit is its own even residual (odd = false).
template <int EPI>
__device__ __forceinline__ float epi_arg(float v) {
  if (EPI == EPI_TANH) return v;
  if (EPI == EPI_SIGMOID || EPI == EPI_SILU) return __fmul_rn(v, 0.5f);
  if (EPI == EPI_GELU) {
    const float c = (float)0.7978845608028654;   // sqrt(2 / pi)
    const float a = (float)0.044715;
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(a, v), v), v);
    return __fmul_rn(c, __fadd_rn(v, cube));
  }
  return fabsf(v);                                // softplus: h(|x|)
}

template <int EPI>
__device__ __forceinline__ float epi_out(float v, float b) {
  if (EPI == EPI_TANH) return b;
  if (EPI == EPI_SIGMOID) return __fmul_rn(0.5f, __fadd_rn(1.0f, b));
  if (EPI == EPI_SILU) return __fmul_rn(v, __fmul_rn(0.5f, __fadd_rn(1.0f, b)));
  if (EPI == EPI_GELU) return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, b));
  return __fadd_rn(fmaxf(v, 0.0f), b);            // softplus: relu(x) + h(|x|)
}

template <int EPI>
__device__ __forceinline__ float epilogue(float v, const Table& tb) {
  return epi_out<EPI>(v, scheme_block(epi_arg<EPI>(v), tb, EPI != EPI_SOFTPLUS));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Params the kernels take: at most MAX_PARAMS floats, each scheme's own
// column count, and no rational softplus (its Pade build targets tanh).
inline bool params_ok(int scheme, int rows, int cols, int epi) {
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
