// Hand-written Hopper (sm_90a) kernel for one approximant epilogue per
// element, behind a plain C interface that src/repro_torch/kernels/_build.py
// builds with nvcc and loads with ctypes:
//
//   repro_elementwise_2d  <- src/repro/kernels/epilogue.py:elementwise_2d
//                            (_elementwise_kernel)
//
// y = epilogue(x) over a contiguous [rows, cols] array, in f32 math with
// f32 or bf16 I/O, under any scheme of approximant.cuh, rounding exactly
// where the plain PyTorch version (kernels/epilogue.py:elementwise_2d_plain)
// rounds.
//
// Bound on the card: bytes at every shape, by the data-sheet rates. It reads
// x once and writes y once; a SiLU element costs 16-43 f32 operations
// against ~295 operations the card can do per byte of device memory. But
// the shapes the served model gives it are small: 12 KB each way at decode
// ([2, 3072] bf16), 0.75-1.5 MB at prefill ([128-256, 3072]). So what sets
// its time is latency, not bandwidth:
//
//   * at decode, the kernel's own span: the launch, one trip to device
//     memory for x and one for the params, the dependent arithmetic chain
//     of each thread, and the store;
//   * at prefill, the same trips plus the epilogue's instruction issue,
//     spread over the card's 528 warp schedulers.
//
// Design, against each of those:
//
//   * The launch geometry (blocks, threads, elements per thread) is chosen
//     by the caller (kernels/epilogue.py:_elementwise_geometry) and checked
//     here. Each thread takes E = 16 / sizeof(T) consecutive elements, read
//     and written as one 16-byte vector when both pointers are 16-byte
//     aligned (else element by element), so neighbouring threads touch
//     neighbouring addresses and every load carries the most bytes. At
//     decode that is 6 blocks. Spreading the same work over 48 blocks of
//     2-element threads was slower on the card, for every scheme: each
//     block pays its own params copy and barrier, and the interleaved
//     chains of 8 elements cost a thread little more than those of 2.
//   * The x loads are issued into registers first; the params then go to
//     shared memory by cp.async, and only then does the block wait. The two
//     trips to memory overlap instead of running one after the other.
//   * The scheme switch is taken once per thread, outside the elements:
//     each case runs the thread's E elements through the epilogue as
//     straight-line code (approximant.cuh:block_n), so their independent
//     chains interleave. poly's Horner has a compile-time trip count
//     (MAX_POLY_COLS) with a uniform predicate, and rational's Horner steps
//     run over all E elements per coefficient; neither changes the order of
//     operations of an element.
//   * Instantiations: epilogue x dtype, 10 in all, half of the vector /
//     scalar pair of kernels this one replaces.
//
// The entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a refused geometry or params) so the Python
// wrapper raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "approximant.cuh"

namespace {

constexpr int MAX_THREADS = 256;   // __launch_bounds__ of the kernel

// One 4-byte global -> shared copy that bypasses the registers; completed by
// cp_async_wait_all(). The "memory" clobbers keep every load written before
// it (the x loads) ahead of it.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Thread g of the grid takes elements [g * E, g * E + E) of the n, the
// ones below n; the caller's geometry covers n (checked at the entry
// point). vec: both pointers 16-byte aligned.
template <int EPI, typename T>
__global__ void __launch_bounds__(MAX_THREADS)
repro_elementwise_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, Table tb,
                         bool vec) {
  constexpr int E = 16 / sizeof(T);
  __shared__ __align__(16) float s_par[MAX_PARAMS];
  const long long first = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * E;
  const long long left = n - first;
  const int m = left >= E ? E : (left > 0 ? (int)left : 0);   // this thread's elements
  const bool whole = vec && m == E;

  // 1. x into registers: the load is in flight while the params copy
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
  if (whole) {
    raw = *reinterpret_cast<const uint4*>(x + first);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) e[j] = j < m ? x[first + j] : from_f<T>(0.0f);
  }

  // 2. the params into shared memory, then the block's one wait
  const int np = tb.rows * tb.cols;
  for (int i = threadIdx.x; i < np; i += blockDim.x) cp_async4(s_par + i, tb.p + i);
  cp_async_wait_all();
  __syncthreads();
  if (m == 0) return;
  tb.p = s_par;

  // 3. one uniform scheme switch around the thread's E elements
  float v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = to_f(e[j]);
  switch (tb.scheme) {
    case SCHEME_PWL: epilogue_n<EPI, SCHEME_PWL, E>(v, tb); break;
    case SCHEME_POLY: epilogue_n<EPI, SCHEME_POLY, E>(v, tb); break;
    case SCHEME_RATIONAL: epilogue_n<EPI, SCHEME_RATIONAL, E>(v, tb); break;
    default: epilogue_n<EPI, SCHEME_CR, E>(v, tb); break;
  }
#pragma unroll
  for (int j = 0; j < E; ++j) e[j] = from_f<T>(v[j]);

  // 4. store
  if (whole) {
    *reinterpret_cast<uint4*>(y + first) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (j < m) y[first + j] = e[j];
  }
}

template <int EPI, typename T>
void launch_elementwise(const void* x, void* y, long long n, const Table& tb, int blocks,
                        int threads, cudaStream_t s) {
  const bool vec = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  repro_elementwise_kernel<EPI, T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, tb, vec);
}

template <typename T>
bool dispatch_elementwise(int epi, const void* x, void* y, long long n, const Table& tb,
                          int blocks, int threads, cudaStream_t s) {
  switch (epi) {
    case EPI_TANH: launch_elementwise<EPI_TANH, T>(x, y, n, tb, blocks, threads, s); return true;
    case EPI_SIGMOID: launch_elementwise<EPI_SIGMOID, T>(x, y, n, tb, blocks, threads, s); return true;
    case EPI_SILU: launch_elementwise<EPI_SILU, T>(x, y, n, tb, blocks, threads, s); return true;
    case EPI_GELU: launch_elementwise<EPI_GELU, T>(x, y, n, tb, blocks, threads, s); return true;
    case EPI_SOFTPLUS: launch_elementwise<EPI_SOFTPLUS, T>(x, y, n, tb, blocks, threads, s); return true;
  }
  return false;
}

// The caller's geometry: the kernel's elements per thread (one 16-byte
// vector of T), whole warps within the launch bound, and blocks x threads x
// ept covering n with no block past it.
bool geometry_ok(long long n, int elem_bytes, int blocks, int threads, int ept) {
  if (ept != 16 / elem_bytes) return false;
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || blocks < 1) return false;
  const long long per_block = (long long)threads * ept;
  return (long long)blocks * per_block >= n && (long long)(blocks - 1) * per_block < n;
}

}  // namespace

extern "C" int repro_elementwise_2d(const void* x, const void* params, void* y, int rows,
                                    int cols, int scheme, int p_rows, int p_cols, int epi,
                                    int dtype, float inv_period, float x_max, float saturation,
                                    int blocks, int threads, int ept, void* stream) {
  if (!params_ok(scheme, p_rows, p_cols, epi) || rows < 0 || cols < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * cols;
  if (n == 0) return (int)cudaGetLastError();
  const int elem_bytes = dtype == DT_F32 ? 4 : 2;
  if (!geometry_ok(n, elem_bytes, blocks, threads, ept)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table tb{static_cast<const float*>(params), scheme, p_rows, p_cols, inv_period, x_max,
                 saturation};
  bool ok = false;
  if (dtype == DT_F32)
    ok = dispatch_elementwise<float>(epi, x, y, n, tb, blocks, threads, s);
  else if (dtype == DT_BF16)
    ok = dispatch_elementwise<bf16>(epi, x, y, n, tb, blocks, threads, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
