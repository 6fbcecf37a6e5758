// Hand-written Hopper (sm_90a) kernel for the fused GLU of the Catmull-Rom
// activation unit, behind a plain C interface that
// src/repro_torch/kernels/_build.py builds with nvcc and loads with ctypes:
//
//   repro_glu_2d  <- src/repro/kernels/epilogue.py:glu_2d (_glu_kernel), in
//                    four variants the caller names: a TMA + wgmma kernel
//                    for bf16 (the served path), a wmma kernel for bf16
//                    operands TMA cannot address, a TMA + cluster IEEE f32
//                    kernel for f32 (the f32 path), and an IEEE f32 SIMT
//                    kernel for f32 operands TMA cannot address
//
// The epilogue (approximant.cuh) runs in f32, in the plain PyTorch
// version's operation order. The scheme is a runtime switch, uniform
// across the grid, not a template parameter: the instantiations (epilogue
// x variant x tile) stay as many as with one scheme, and so does the build
// time. elementwise.cu holds the other kernel. The build compiles this file
// as one unit per epilogue (-DREPRO_GLU_PART=e, kernels/_build.py
// GLU_PARTS), in parallel with each other and with elementwise.cu: unit e
// instantiates the kernels of epilogue e only, and unit 0 also holds the
// entry points. Without the define the file is one whole unit.
//
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper
// raises on a refused launch.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "approximant.cuh"

#ifdef REPRO_GLU_PART
#define GLU_WHOLE 0
#else
#define GLU_WHOLE 1
#define REPRO_GLU_PART 0
#endif
// whether this unit holds epilogue e's kernels (e: approximant.cuh EPI_*)
#define GLU_HOLDS(e) (GLU_WHOLE || REPRO_GLU_PART == (e))
#if defined(REPRO_GLU_PHASES) && !GLU_WHOLE
#error "the phase stamps' buffer is one unit's own: build the file whole"
#endif

// One glu_2d launch, as it passes from the entry point to the unit that
// holds its epilogue's kernels (approximant.cuh's Table is each unit's own).
namespace repro_glu {
struct Launch {
  const void *x, *wg, *wu, *params;
  void* out;
  int M, N, K, scheme, p_rows, p_cols;
  float inv_period, x_max, saturation;
  int variant, split;
  cudaStream_t stream;
};
cudaError_t launch_tanh(const Launch& a);
cudaError_t launch_sigmoid(const Launch& a);
cudaError_t launch_silu(const Launch& a);
cudaError_t launch_gelu(const Launch& a);
cudaError_t launch_softplus(const Launch& a);
}  // namespace repro_glu

namespace {

// kernels/epilogue.py _GLU_VARIANT_IDS
enum { GLU_WMMA = 0, GLU_TMA_WGMMA = 1, GLU_SIMT_F32 = 2, GLU_TMA_F32 = 3 };

// ---------------------------------------------------------------------------
// glu_2d
//
// Replaces: src/repro/kernels/epilogue.py:glu_2d (_glu_kernel).
// out[M, N] = epilogue(x[M, K] @ w_gate[K, N]) * (x[M, K] @ w_up[K, N]).
// Bound on the card at every serving shape (M <= 256 rows): the weight
// bytes, 2*K*N*2 B in bf16 (12.58 MB at K=1024, N=3072), since the kernel
// does M operations per weight byte against the card's ~295 bf16
// operations per byte of device memory.
//
// In every variant gate and up are f32 sums kept across the whole K loop;
// the epilogue (one scheme evaluation) fires once on the complete f32 gate
// sum, is multiplied by the complete f32 up sum and cast once to the output
// dtype: gate and up are never rounded to bf16, which is the point of the
// fusion. The TPU's sequential K grid axis and its VMEM scratch have no
// counterpart: nothing carries over between blocks.
//
// Four variants, chosen by the Python wrapper (kernels/epilogue.py
// _glu_variant) and refused here when they do not fit the operands:
//
//   tma_wgmma  bf16, every operand addressable by TMA (16-byte aligned,
//              row strides multiples of 16 bytes): the Hopper kernel
//              below, repro_glu_bf16_tma_kernel. Every bf16 launch of the
//              served model takes it.
//   wmma       bf16 operands TMA cannot address: one output tile per block,
//              nvcuda::wmma 16x16x16 on plain zero-filled tile loads, no
//              pipelining (the first slice's kernel, kept for these only).
//   tma_f32    f32, every operand addressable by TMA (16-byte aligned, K
//              and N multiples of 4): repro_glu_f32_tma_kernel below, IEEE
//              f32 FMAs on the CUDA cores (no TF32: the f32 checks gate at
//              1e-4, and one Q2.13 LSB of the unit is 1.22e-4). Every f32
//              launch of the served and trained models takes it.
//   simt_f32   f32 operands TMA cannot address: one output tile per block,
//              the same IEEE f32 FMAs on plain zero-filled tile loads, no
//              pipelining (the first slice's kernel, kept for these only).
//
// M, N and K are masked by zero-filled tile loads and a bounds-checked
// store.
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

// ---------------------------------------------------------------------------
// glu_2d, variant tma_wgmma: repro_glu_bf16_tma_kernel
//
// Replaces: src/repro/kernels/epilogue.py:289 glu_2d (_glu_kernel) for bf16.
// Bound: the 2*K*N*2 weight bytes (12.58 MB at K=1024, N=3072, 3.76 us at
// 3.35 TB/s), read once from device memory. The design keeps those bytes
// streaming:
//
//   * Product written swapped: out^T[N, M] = W^T[N, K] . x^T[K, M]. The
//     weight tile fills wgmma's 64 rows (A, read MN-major from the swizzled
//     tile, the transpose flag set) and the M rows of x become wgmma's narrow
//     N (B, K-major), padded to 16 at decode and to 64 above. The other way
//     round (x as A) would leave 62 of 64 rows idle at decode, hold 16x the
//     accumulator registers, and stage a 64-row x tile for 2 real rows.
//   * Each CTA owns a 64-column N tile and ALL M rows (up to 256; above 256
//     the grid loops over 256-row M tiles): each weight byte is read from
//     device memory once. One or two consumer warpgroups split the M rows
//     and read the same weight tile.
//   * One producer warp keeps TMA loads in flight through a ring of 4
//     stages in dynamic shared memory (one full and one empty
//     mbarrier per stage): per stage a [TMA_BK x 64] tile of w_gate and of
//     w_up (64 bf16 = 128 B inner extent, 128-byte swizzle) and the matching
//     [M rows x TMA_BK] tile of x (small, read from L2 by every CTA). TMA
//     zero-fills boxes past the tensor's edge, which masks ragged K, N, M.
//   * K is split across a thread-block cluster of `split` CTAs (1, 2 or 4)
//     where the N tiles alone would leave SMs idle: at decode 48 N tiles x
//     4 = 192 CTAs, two per SM, each with its 4 K blocks all in flight, so
//     the whole 12.58 MB is requested at once. Each CTA parks its partial
//     f32 gate and up sums in its own shared memory; after a cluster
//     barrier each rank reduces an interleaved share of the tile's elements
//     over all ranks' partials through distributed shared memory, always in
//     rank order 0, 1, ..., so the result is deterministic, fires the
//     epilogue once on the complete gate sum and stores. Every rank, not
//     only the leader, takes a share: the epilogue (~50 f32 operations an
//     element) is the longest part of the tail at prefill, and sharing it
//     spreads it over all the cluster's SMs. A second cluster barrier keeps
//     every CTA's shared memory alive until all reads are done. No atomics,
//     no global scratch, no second launch.
//   * The producer prefetches the three tensor maps before the barriers
//     are set up, and copies the scheme params only after its loads are
//     issued, so nothing stands before the first TMA request.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 4, see
// PERF.md): the streaming K loop runs at about the rate two cuBLAS GEMMs
// reach on the same cold-L2 inputs; what is left above the bound is the
// fixed cost of a launch, the first bytes' latency, the two cluster
// barriers and, at prefill, the epilogue on the few warps of each CTA.
//
// The scheme params go to shared memory as in the other kernels, and the
// epilogue is the same device function, so given the same f32 sums the
// output is bit-exact to the plain version's operation order.
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

// Phase stamps of the TMA kernel, compiled in only with -DREPRO_GLU_PHASES
// (kernels/glu_phases.py): thread 0 of each CTA, and the producer at its
// last issue, write %globaltimer (ns) into 8 slots per CTA, read by
// kernels/glu_phases.py. Off, the macro is empty and costs nothing.
#ifdef REPRO_GLU_PHASES
constexpr int PHASE_SLOTS = 8, PHASE_CTAS = 8192;
__device__ unsigned long long g_glu_phases[PHASE_CTAS * PHASE_SLOTS];
__device__ __forceinline__ void phase_stamp(int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (cta < PHASE_CTAS) g_glu_phases[cta * PHASE_SLOTS + slot] = t;
}
#define GLU_PHASE(slot, who) \
  if (who) phase_stamp(slot)
#else
#define GLU_PHASE(slot, who)
#endif

constexpr int TMA_BK = 64;       // K rows per stage
constexpr int TMA_BN = 64;       // N columns per CTA: 128 B, one swizzle atom
constexpr int TMA_MAX_SPLIT = 4; // CTAs of a cluster splitting K
constexpr int RED_LD = TMA_BN + 4;   // f32 partial row stride: no bank conflicts
constexpr int SM_SMEM_BYTES = 233472;  // shared memory of one H100 SM (228 KB)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A wait
// that never ends (a lost transaction) traps after ~2^28 polls, seconds on
// the card, so the launch fails instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA box into shared memory, completing on `bar`'s tx count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d[64 x NW] += A[64 x 16] . B[16 x NW]: A MN-major (transposed), B K-major,
// bf16 in, f32 accumulate.
template <int NW> struct Wgmma;

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : F4(0), F4(4)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 0;\n}\n"
        : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef F4

// Shared-memory layout of one configuration: MT rows of x per consumer
// warpgroup, NWG consumer warpgroups, a ring of STAGES stages.
template <int MT, int NWG> struct TmaCfg {
  static constexpr int STAGES = 4;
  static constexpr int NW = MT < 64 ? MT : 64;   // wgmma N
  static constexpr int CH = MT / NW;             // wgmma chunks per warpgroup
  static constexpr int MROWS = MT * NWG;         // x rows per CTA (box height)
  static constexpr int THREADS = NWG * 128 + 32; // + one producer warp
  static constexpr int W_BYTES = TMA_BK * TMA_BN * 2;
  static constexpr int X_BYTES = MROWS * TMA_BK * 2;
  static constexpr int STAGE = 2 * W_BYTES + X_BYTES;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + alignment slack
  static_assert(NW == 16 || NW == 64, "wgmma N of 16 or 64");
  static_assert(MROWS <= 256, "TMA box height");
  static_assert(STAGE % 1024 == 0, "stages on swizzle-atom boundaries");
  static_assert(2 * MROWS * RED_LD * 4 <= STAGES * STAGE, "partials fit the ring");
};

template <int EPI, int MT, int NWG>
__global__ void __launch_bounds__(TmaCfg<MT, NWG>::THREADS, 1)
repro_glu_bf16_tma_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_g,
                          const __grid_constant__ CUtensorMap tm_u, bf16* __restrict__ out,
                          int M, int N, int K, Table tb) {
  using C = TmaCfg<MT, NWG>;
  constexpr int NW = C::NW, CH = C::CH, MROWS = C::MROWS;
  extern __shared__ uint8_t dsmem[];
  __shared__ __align__(16) float s_par[MAX_PARAMS];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  // swizzled tiles sit on 1024-byte boundaries (the 128-byte swizzle atom)
  uint8_t* ring = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);

  GLU_PHASE(0, threadIdx.x == 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = blockIdx.y * TMA_BN, m0 = blockIdx.z * MROWS;
  const int kb_all = (K + TMA_BK - 1) / TMA_BK;
  const int kb0 = rank * kb_all / split;
  const int nkb = (rank + 1) * kb_all / split - kb0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == NWG * 4 && lane == 0) {
    // fetch the three descriptors while the barriers are set up
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_g)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_u)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc_g[CH][NW / 2], acc_u[CH][NW / 2];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc_g[c][j] = acc_u[c][j] = 0.0f;

  if (warp == NWG * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < nkb; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(&empty[s], ((i / C::STAGES) - 1) & 1);
        uint8_t* st = ring + s * C::STAGE;
        const int k0 = (kb0 + i) * TMA_BK;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, &tm_g, n0, k0, &full[s]);
        tma_load_2d(st + C::W_BYTES, &tm_u, n0, k0, &full[s]);
        tma_load_2d(st + 2 * C::W_BYTES, &tm_x, k0, m0, &full[s]);
      }
      GLU_PHASE(1, true);
    }
    __syncwarp();
    // the scheme params, copied while the loads are in flight (not before
    // the first one); read after the barrier below the K loop
    for (int i = lane; i < tb.rows * tb.cols; i += 32) s_par[i] = tb.p[i];
  } else {
    // consumers: warpgroup g multiplies x rows [g*MT, (g+1)*MT) of the tile
    const int g = warp / 4;
    for (int i = 0; i < nkb; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      GLU_PHASE(2, i == 0 && threadIdx.x == 0);
      const uint32_t a_g = smem_u32(ring + s * C::STAGE);
      const uint32_t a_u = a_g + C::W_BYTES;
      const uint32_t b_x = a_g + 2 * C::W_BYTES + g * MT * 128;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        fence_regs<NW / 2>(acc_g[c]);
        fence_regs<NW / 2>(acc_u[c]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TMA_BK / 16; ++kk) {
        // A: weight rows k (128 B each, N contiguous); 16 K rows = 2 groups
        // of 8 at 1024 B. B: x rows (128 B each, K contiguous); a k16 step
        // is 32 B along the row, 8-row groups 1024 B apart.
        const uint64_t dg = sw128_desc(a_g + kk * 2048, TMA_BK * 128, 1024);
        const uint64_t du = sw128_desc(a_u + kk * 2048, TMA_BK * 128, 1024);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const uint64_t dx = sw128_desc(b_x + c * NW * 128 + kk * 32, 16, 1024);
          Wgmma<NW>::mma(acc_g[c], dg, dx);
          Wgmma<NW>::mma(acc_u[c], du, dx);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        fence_regs<NW / 2>(acc_g[c]);
        fence_regs<NW / 2>(acc_u[c]);
      }
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    }
  }
  GLU_PHASE(3, threadIdx.x == 0);
  __syncthreads();   // every wgmma has read its stage: the ring is free
  tb.p = s_par;

  // park the partial sums: red[m][n], m the x row, n the column in the tile
  float* red_g = reinterpret_cast<float*>(ring);
  float* red_u = red_g + MROWS * RED_LD;
  if (warp < NWG * 4) {
    const int g = warp / 4, w = warp % 4;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < NW / 2; ++j) {
        // wgmma accumulator layout: row (here n) w*16 + lane/4 (+8), column
        // (here m) 8*(j/4) + 2*(lane%4) (+1)
        const int n = w * 16 + lane / 4 + 8 * ((j % 4) / 2);
        const int m = g * MT + c * NW + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
        red_g[m * RED_LD + n] = acc_g[c][j];
        red_u[m * RED_LD + n] = acc_u[c][j];
      }
  }
  GLU_PHASE(4, threadIdx.x == 0);
  cluster.sync();   // every rank's partials are written and visible
  GLU_PHASE(5, threadIdx.x == 0);

  // Each rank reduces an interleaved share of the tile, 4 adjacent columns
  // per thread: one float4 from every rank (its own read locally, the
  // others through distributed shared memory), all loads independent.
  // Ranks past `split` are never added.
  const float4* peer_g[TMA_MAX_SPLIT];
  const float4* peer_u[TMA_MAX_SPLIT];
#pragma unroll
  for (int r = 0; r < TMA_MAX_SPLIT; ++r) {
    const bool local = r >= split || r == rank;
    peer_g[r] = reinterpret_cast<const float4*>(local ? red_g : cluster.map_shared_rank(red_g, r));
    peer_u[r] = reinterpret_cast<const float4*>(local ? red_u : cluster.map_shared_rank(red_u, r));
  }
  const int mvalid = min(MROWS, M - m0);
  constexpr int Q = TMA_BN / 4;   // float4 groups per row
  for (int idx = rank * C::THREADS + threadIdx.x; idx < mvalid * Q; idx += split * C::THREADS) {
    const int m = idx / Q, n = n0 + (idx % Q) * 4;
    if (n >= N) continue;   // N % 8 == 0: a group is all in or all out
    const int off = (m * RED_LD + (idx % Q) * 4) / 4;
    float4 pg[TMA_MAX_SPLIT], pu[TMA_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < TMA_MAX_SPLIT; ++r) {
      pg[r] = peer_g[r][off];
      pu[r] = peer_u[r][off];
    }
    float gs[4] = {pg[0].x, pg[0].y, pg[0].z, pg[0].w};
    float us[4] = {pu[0].x, pu[0].y, pu[0].z, pu[0].w};
#pragma unroll
    for (int r = 1; r < TMA_MAX_SPLIT; ++r)
      if (r < split) {   // fixed rank order: deterministic sums
        gs[0] = __fadd_rn(gs[0], pg[r].x); gs[1] = __fadd_rn(gs[1], pg[r].y);
        gs[2] = __fadd_rn(gs[2], pg[r].z); gs[3] = __fadd_rn(gs[3], pg[r].w);
        us[0] = __fadd_rn(us[0], pu[r].x); us[1] = __fadd_rn(us[1], pu[r].y);
        us[2] = __fadd_rn(us[2], pu[r].z); us[3] = __fadd_rn(us[3], pu[r].w);
      }
    __align__(8) bf16 o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __float2bfloat16_rn(__fmul_rn(epilogue<EPI>(gs[e], tb), us[e]));
    *reinterpret_cast<uint2*>(out + (long long)(m0 + m) * N + n) = *reinterpret_cast<uint2*>(o);
  }
  GLU_PHASE(6, threadIdx.x == 0);
  cluster.sync();   // no CTA leaves while a peer may still read its partials
  GLU_PHASE(7, threadIdx.x == 0);
}

// ---------------------------------------------------------------------------
// glu_2d, variant tma_f32: repro_glu_f32_tma_kernel
//
// Replaces: src/repro/kernels/epilogue.py:289 glu_2d (_glu_kernel) for f32,
// in IEEE f32 FMAs on the CUDA cores (no TF32, no 3xTF32).
// Bound: at decode and at the tensor-parallel and sharded-train shards (M <=
// 64) the 2*K*N*4 weight bytes (25.2 MB at K=1024, N=3072: 7.5 us at 3.35
// TB/s); above that the 4*M*K*N FFMA operations at 67 TFLOP/s. The first
// slice's kernel (simt_f32) walked all of K in each CTA, 16-32 rows a step,
// with scalar loads waited on between two barriers and no load in flight
// across steps, on 12-48 CTAs at decode: bound by latency, 1.6-11% of the
// bound. What the design does about each part of that:
//
//   * One producer warp streams [BK x BN] f32 tiles of w_gate and w_up
//     and the matching [BM x BK] tile of x by TMA through a ring of 4
//     stages (one full and one empty mbarrier each), so every CTA keeps
//     36-48 KB of loads in flight. TMA zero-fills boxes past the tensor's
//     edge, which masks ragged M, N, K. No swizzle: consumers read weight
//     rows along N in float4s, 8 or 16 threads over one 128 or 256-byte
//     row, which is conflict-free.
//   * K is split across a thread-block cluster of `split` CTAs (1-8,
//     computed by kernels/epilogue.py _glu_f32_geometry), so the decode
//     shapes run on 172-192 CTAs instead of 12-48. Each rank owns every
//     split-th float4 group of the tile. After its K loop a rank pushes
//     its partial gate and up sums of each group into the owner's receive
//     buffer through distributed shared memory (stores, not loads: their
//     latency is not waited on); after one cluster barrier each owner sums
//     its groups from its own shared memory in rank order 0, 1, ..., so
//     the result is deterministic, fires the epilogue once on the complete
//     gate sum and stores. No CTA reads a peer's shared memory, so none
//     waits at a second barrier before it leaves. At decode the receive
//     buffer has shared memory of its own, so a rank pushes as soon as its
//     K loop ends; the larger tiles reuse the ring and first wait until
//     every rank has left its K loop.
//   * Each CTA owns all M rows of its N tile up to 64 rows (above 64 the
//     grid runs 64-row M tiles, which read the weights again from L2), so
//     at decode and at the shards each weight byte is read from device
//     memory once. A consumer thread keeps TM rows x 4 columns of f32 gate
//     and of up sums in registers (64 at TM = 8); per four K rows it reads
//     TM float4s of x (a row's four K values; threads of a warp share
//     them) and per K row one float4 of each weight, then does 8*TM FFMAs,
//     so the CUDA cores, not shared memory, bound the compute-bound tiles.
//     The 64-row tile takes 16 K rows a stage, so an SM holds three of its
//     CTAs (12 consumer warps), whose loads hide each other's latency.
//   * At M <= 8 the tile is 32 columns wide and the 128 consumer threads
//     also split each stage's K rows 8 ways (their partials summed in
//     slice order in the ring before the push): narrow N tiles give the
//     cluster split enough tiles to fill the card at N = 768 (qwen3 at
//     TP 4) without a cluster above 8.
//
// Sums: each thread adds its K rows in order with fmaf (one rounding each);
// slices, then ranks, add in fixed order; the epilogue (approximant.cuh)
// runs once on the complete f32 gate sum, in the plain version's operation
// order. The result is bitwise deterministic.
// ---------------------------------------------------------------------------

constexpr int F32_MAX_SPLIT = 8;      // the portable cluster size
constexpr int F32_CONSUMERS = 128;    // four consumer warps
constexpr int F32_THREADS = F32_CONSUMERS + 32;   // + one producer warp

// One tile of tma_f32 (kernels/epilogue.py _F32_TILES mirrors it): a CTA
// owns BM rows x BN columns of out and takes BK rows of K a stage through a
// ring of STAGES; a consumer thread TM rows x 4 columns, over 1/KS of each
// stage's K rows; the launch bounds let an SM hold MINB CTAs. OWN_RECV: the
// partials' receive buffer has shared memory of its own, and the K slices'
// partials are summed in the ring first; else (one slice) the receive
// buffer reuses the ring, once every rank of the cluster has left its K
// loop.
template <int BM_, int BN_, int TM_, int BK_, int STAGES_, int MINB_, bool OWN_RECV_>
struct F32Cfg {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, BK = BK_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MINB_;
  static constexpr bool OWN_RECV = OWN_RECV_;
  static constexpr int CG = BN / 4;                       // float4 columns
  static constexpr int RG = BM / TM;                      // row groups
  static constexpr int KS = F32_CONSUMERS / (CG * RG);    // K slices
  static constexpr int KPS = BK / KS;                     // K rows a slice
  static constexpr int RED_LD = BN + 4;                   // a slice's partial row
  static constexpr int W_FLOATS = BK * BN;
  static constexpr int STAGE_FLOATS = 2 * W_FLOATS + BM * BK;
  static constexpr int STAGE = STAGE_FLOATS * 4;
  static constexpr int RING = STAGES * STAGE;
  // receive buffer: one float4 of gate and of up per (source rank, group),
  // a rank owning every split-th group of the tile
  static constexpr int RECV_F4 = BM * CG + F32_MAX_SPLIT;
  static constexpr int RECV = 2 * RECV_F4 * 16;
  static constexpr int SMEM = RING + (OWN_RECV ? RECV : 0) + 1024;   // + alignment slack
  static_assert(CG * RG * KS == F32_CONSUMERS, "threads cover the tile");
  static_assert(KPS % 4 == 0, "a slice reads x in float4s along K");
  static_assert(STAGE % 1024 == 0 && W_FLOATS * 4 % 1024 == 0, "TMA boxes aligned");
  static_assert(OWN_RECV ? 2 * KS * BM * RED_LD * 4 <= RING : KS == 1 && RECV <= RING,
                "partials fit the ring");
  static_assert(MIN_BLOCKS * (SMEM + MAX_PARAMS * 4 + 16 * STAGES + 1024) <= SM_SMEM_BYTES,
                "an SM holds MIN_BLOCKS CTAs");
};

__device__ __forceinline__ void fma4(float4& d, float a, const float4& b) {
  d.x = fmaf(a, b.x, d.x);
  d.y = fmaf(a, b.y, d.y);
  d.z = fmaf(a, b.z, d.z);
  d.w = fmaf(a, b.w, d.w);
}

__device__ __forceinline__ void add4(float4& d, const float4& b) {
  d.x = __fadd_rn(d.x, b.x);
  d.y = __fadd_rn(d.y, b.y);
  d.z = __fadd_rn(d.z, b.z);
  d.w = __fadd_rn(d.w, b.w);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int EPI, class C>
__global__ void __launch_bounds__(F32_THREADS, C::MIN_BLOCKS)
repro_glu_f32_tma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_g,
                         const __grid_constant__ CUtensorMap tm_u, float* __restrict__ out,
                         int M, int N, int K, Table tb) {
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, BK = C::BK, STAGES = C::STAGES;
  constexpr int PRODUCER = F32_CONSUMERS / 32;   // the producer's warp index
  extern __shared__ uint8_t dsmem[];
  __shared__ __align__(16) float s_par[MAX_PARAMS];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* base = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(base);
  float4* recv_g = reinterpret_cast<float4*>(base + (C::OWN_RECV ? C::RING : 0));
  float4* recv_u = recv_g + C::RECV_F4;

  GLU_PHASE(0, threadIdx.x == 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int kb_all = (K + BK - 1) / BK;
  const int kb0 = rank * kb_all / split;
  const int nkb = (rank + 1) * kb_all / split - kb0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == PRODUCER && lane == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_g)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_u)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F32_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // with a receive buffer of its own, this CTA is ready for its peers'
  // partials from here on: they wait for that below, after their K loop
  if constexpr (C::OWN_RECV) cluster_arrive_relaxed();

  // a consumer's place: column group, row group, K slice
  const int cgi = threadIdx.x % C::CG;
  const int rg = (threadIdx.x / C::CG) % C::RG;
  const int slice = threadIdx.x / (C::CG * C::RG);
  float4 acc_g[TM], acc_u[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc_g[r] = acc_u[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  if (warp == PRODUCER) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < nkb; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        float* st = ring + s * C::STAGE_FLOATS;
        const int k0 = (kb0 + i) * BK;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, &tm_g, n0, k0, &full[s]);
        tma_load_2d(st + C::W_FLOATS, &tm_u, n0, k0, &full[s]);
        tma_load_2d(st + 2 * C::W_FLOATS, &tm_x, k0, m0, &full[s]);
      }
      GLU_PHASE(1, true);
    }
    __syncwarp();
    // the scheme params, copied while the loads are in flight; read after
    // the cluster barrier below the K loop
    for (int i = lane; i < tb.rows * tb.cols; i += 32) s_par[i] = tb.p[i];
  } else {
    for (int i = 0; i < nkb; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      GLU_PHASE(2, i == 0 && threadIdx.x == 0);
      const float* sg = ring + s * C::STAGE_FLOATS;   // [BK][BN]
      const float* su = sg + C::W_FLOATS;             // [BK][BN]
      const float* sx = sg + 2 * C::W_FLOATS;         // [BM][BK]
#pragma unroll
      for (int k4 = 0; k4 < C::KPS; k4 += 4) {
        const int kk = slice * C::KPS + k4;
        float4 xv[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r)
          xv[r] = *reinterpret_cast<const float4*>(sx + (rg * TM + r) * BK + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 g = *reinterpret_cast<const float4*>(sg + (kk + j) * BN + cgi * 4);
          const float4 u = *reinterpret_cast<const float4*>(su + (kk + j) * BN + cgi * 4);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float a = j == 0 ? xv[r].x : j == 1 ? xv[r].y : j == 2 ? xv[r].z : xv[r].w;
            fma4(acc_g[r], a, g);
            fma4(acc_u[r], a, u);
          }
        }
      }
      __syncwarp();   // every lane of the warp has read the stage
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  GLU_PHASE(3, threadIdx.x == 0);
  const int mvalid = min(BM, M - m0);
  const int slots = (BM * C::CG + split - 1) / split;   // groups a rank owns
  if constexpr (C::KS > 1) {
    // park each K slice's partials in the ring: red[slice][m][n]
    __syncthreads();   // every consumer has read its last stage
    if (warp < PRODUCER) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int off = (slice * BM + rg * TM + r) * C::RED_LD + cgi * 4;
        *reinterpret_cast<float4*>(ring + off) = acc_g[r];
        *reinterpret_cast<float4*>(ring + C::KS * BM * C::RED_LD + off) = acc_u[r];
      }
    }
    __syncthreads();
  }
  // Wait until every destination can take the partials: with a receive
  // buffer of its own, until every rank has started (the arrive above);
  // else until every rank has left its K loop and its ring is free.
  if constexpr (!C::OWN_RECV) cluster_arrive();
  cluster_wait();
  GLU_PHASE(4, threadIdx.x == 0);

  // Push: group idx (row m, float4 column q) belongs to rank idx % split;
  // each rank stores its partial float4s of gate and up (its K slices
  // summed in slice order) into the owner's buffer at [rank][idx / split],
  // through distributed shared memory for the other ranks. Rows past M
  // are skipped.
  auto push = [&](int idx, const float4& g, const float4& u) {
    const int owner = idx % split, off = rank * slots + idx / split;
    (owner == rank ? recv_g : cluster.map_shared_rank(recv_g, owner))[off] = g;
    (owner == rank ? recv_u : cluster.map_shared_rank(recv_u, owner))[off] = u;
  };
  if constexpr (C::KS > 1) {
    const float* red_g = ring;
    const float* red_u = ring + C::KS * BM * C::RED_LD;
    for (int idx = threadIdx.x; idx < mvalid * C::CG; idx += F32_THREADS) {
      const int off = (idx / C::CG) * C::RED_LD + (idx % C::CG) * 4;
      float4 pg[C::KS], pu[C::KS];
#pragma unroll
      for (int sl = 0; sl < C::KS; ++sl) {
        pg[sl] = *reinterpret_cast<const float4*>(red_g + sl * BM * C::RED_LD + off);
        pu[sl] = *reinterpret_cast<const float4*>(red_u + sl * BM * C::RED_LD + off);
      }
#pragma unroll
      for (int sl = 1; sl < C::KS; ++sl) {   // slice order
        add4(pg[0], pg[sl]);
        add4(pu[0], pu[sl]);
      }
      push(idx, pg[0], pu[0]);
    }
  } else if (warp < PRODUCER) {
#pragma unroll
    for (int r = 0; r < TM; ++r)
      if (rg * TM + r < mvalid) push((rg * TM + r) * C::CG + cgi, acc_g[r], acc_u[r]);
  }
  cluster.sync();   // every rank's partials have landed and are visible
  GLU_PHASE(5, threadIdx.x == 0);
  tb.p = s_par;

  // Each rank reduces the groups it owns from its own buffer, the ranks
  // always in order 0, 1, ..., so the sums are deterministic (all loads
  // issued before the adds). No peer touches this CTA's shared memory from
  // here on, so it leaves without another barrier.
  for (int slot = threadIdx.x; slot < slots; slot += F32_THREADS) {
    const int idx = slot * split + rank;
    const int m = idx / C::CG, n = n0 + (idx % C::CG) * 4;
    if (m >= mvalid || n >= N) continue;   // N % 4 == 0: a group is all in or all out
    float4 pg[F32_MAX_SPLIT], pu[F32_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < F32_MAX_SPLIT; ++r)
      if (r < split) {
        pg[r] = recv_g[r * slots + slot];
        pu[r] = recv_u[r * slots + slot];
      }
#pragma unroll
    for (int r = 1; r < F32_MAX_SPLIT; ++r)
      if (r < split) {
        add4(pg[0], pg[r]);
        add4(pu[0], pu[r]);
      }
    float4 o;
    o.x = __fmul_rn(epilogue<EPI>(pg[0].x, tb), pu[0].x);
    o.y = __fmul_rn(epilogue<EPI>(pg[0].y, tb), pu[0].y);
    o.z = __fmul_rn(epilogue<EPI>(pg[0].z, tb), pu[0].z);
    o.w = __fmul_rn(epilogue<EPI>(pg[0].w, tb), pu[0].w);
    *reinterpret_cast<float4*>(out + (long long)(m0 + m) * N + n) = o;
  }
  GLU_PHASE(6, threadIdx.x == 0);
  GLU_PHASE(7, threadIdx.x == 0);
}

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query: no -lcuda at link time.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] matrix as a 2-D tensor map with [box_rows,
// box_cols] boxes, zeros outside the matrix: bf16 with the 128-byte swizzle
// wgmma reads, or f32 unswizzled (tma_f32's threads read rows along N).
bool encode_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
               int box_cols, bool f32 = false) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The K split: double it while the tiles leave SMs idle, every CTA keeps
// at least a ring's worth (`stages`) of K blocks, and all CTAs still fit on
// the card at once.
int glu_split(int tiles, int kb_all, int stages, int smem, int threads) {
  const int static_smem = MAX_PARAMS * 4 + 2 * stages * 8;
  int per_sm = SM_SMEM_BYTES / (smem + static_smem + 1024);
  if (per_sm > 2048 / threads) per_sm = 2048 / threads;
  int split = 1;
  while (split < TMA_MAX_SPLIT && tiles * split < SM_COUNT &&
         kb_all / (2 * split) >= stages && tiles * 2 * split <= per_sm * SM_COUNT)
    split *= 2;
  return split;
}

template <int EPI, int MT, int NWG>
cudaError_t launch_glu_tma(const void* x, const void* wg, const void* wu, void* out, int M,
                           int N, int K, const Table& tb, cudaStream_t s) {
  using C = TmaCfg<MT, NWG>;
  const void* kern = reinterpret_cast<const void*>(&repro_glu_bf16_tma_kernel<EPI, MT, NWG>);
  // the >48 KB opt-in, once per instantiation (one card per process)
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (opt_in != cudaSuccess) return opt_in;
  CUtensorMap tm_x, tm_g, tm_u;
  if (!encode_2d(&tm_x, x, M, K, C::MROWS, TMA_BK) ||
      !encode_2d(&tm_g, wg, K, N, TMA_BK, TMA_BN) ||
      !encode_2d(&tm_u, wu, K, N, TMA_BK, TMA_BN))
    return cudaErrorInvalidValue;
  const int n_tiles = (N + TMA_BN - 1) / TMA_BN;
  const int m_tiles = (M + C::MROWS - 1) / C::MROWS;
  const int split =
      glu_split(n_tiles * m_tiles, (K + TMA_BK - 1) / TMA_BK, C::STAGES, C::SMEM, C::THREADS);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n_tiles, m_tiles);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  bf16* o = static_cast<bf16*>(out);
  Table t = tb;
  void* args[] = {&tm_x, &tm_g, &tm_u, &o, &M, &N, &K, &t};
  return cudaLaunchKernelExC(&cfg, kern, args);
}

// tma_f32's tiles by M: decode (up to 8 rows), up to 32 rows, and 64-row M
// tiles above; PERF.md names the alternatives tried against them on an
// H100.
using F32Decode = F32Cfg<8, 32, 4, 32, 4, 3, true>;
using F32Rows32 = F32Cfg<32, 64, 4, 16, 4, 3, false>;
using F32Rows64 = F32Cfg<64, 64, 8, 16, 4, 3, false>;

// The f32 variant's launch. The split (the cluster's size) comes from the
// caller (kernels/epilogue.py _glu_f32_geometry): 1-8 CTAs, each with at
// least one K block, or the launch is refused.
template <int EPI, class C>
cudaError_t launch_glu_f32_tma(const void* x, const void* wg, const void* wu, void* out, int M,
                               int N, int K, int split, const Table& tb, cudaStream_t s) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK;
  if (split < 1 || split > F32_MAX_SPLIT || split > (K + BK - 1) / BK)
    return cudaErrorInvalidValue;
  const void* kern = reinterpret_cast<const void*>(&repro_glu_f32_tma_kernel<EPI, C>);
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (opt_in != cudaSuccess) return opt_in;
  CUtensorMap tm_x, tm_g, tm_u;
  if (!encode_2d(&tm_x, x, M, K, BM, BK, true) ||
      !encode_2d(&tm_g, wg, K, N, BK, BN, true) ||
      !encode_2d(&tm_u, wu, K, N, BK, BN, true))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + BN - 1) / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(F32_THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  float* o = static_cast<float*>(out);
  Table t = tb;
  void* args[] = {&tm_x, &tm_g, &tm_u, &o, &M, &N, &K, &t};
  return cudaLaunchKernelExC(&cfg, kern, args);
}

// Whether TMA can address the operands: 16-byte aligned bases, row strides
// (K and N bf16) multiples of 16 bytes.
bool tma_addressable(const void* x, const void* wg, const void* wu, int N, int K) {
  return N % 8 == 0 && K % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)wg % 16 == 0 &&
         (uintptr_t)wu % 16 == 0;
}

// The same for f32 (K and N multiples of 4), and out 16-byte aligned for
// tma_f32's float4 stores.
bool tma_f32_addressable(const void* x, const void* wg, const void* wu, const void* out, int N,
                         int K) {
  return N % 4 == 0 && K % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)wg % 16 == 0 &&
         (uintptr_t)wu % 16 == 0 && (uintptr_t)out % 16 == 0;
}

template <int EPI>
cudaError_t launch_glu(const void* x, const void* wg, const void* wu, void* out, int M, int N,
                       int K, int variant, int split, const Table& tb, cudaStream_t s) {
  if (variant == GLU_TMA_F32) {
    if (M <= 8) return launch_glu_f32_tma<EPI, F32Decode>(x, wg, wu, out, M, N, K, split, tb, s);
    if (M <= 32) return launch_glu_f32_tma<EPI, F32Rows32>(x, wg, wu, out, M, N, K, split, tb, s);
    return launch_glu_f32_tma<EPI, F32Rows64>(x, wg, wu, out, M, N, K, split, tb, s);
  }
  if (variant == GLU_TMA_WGMMA) {
    if (M <= 16) return launch_glu_tma<EPI, 16, 1>(x, wg, wu, out, M, N, K, tb, s);
    if (M <= 64) return launch_glu_tma<EPI, 64, 1>(x, wg, wu, out, M, N, K, tb, s);
    if (M <= 128) return launch_glu_tma<EPI, 64, 2>(x, wg, wu, out, M, N, K, tb, s);
    return launch_glu_tma<EPI, 128, 2>(x, wg, wu, out, M, N, K, tb, s);   // 256-row M tiles
  }
  if (variant == GLU_WMMA) {
    const bool vec = K % 8 == 0 && N % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)wg % 16 == 0 && (uintptr_t)wu % 16 == 0;
    constexpr int BM = 64, BN = 64, BK = 32, WM = 32, WN = 32;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    repro_glu_bf16_kernel<EPI, BM, BN, BK, WM, WN><<<grid, (BM / WM) * (BN / WN) * 32, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
        static_cast<bf16*>(out), M, N, K, tb, vec);
    return cudaGetLastError();
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
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_epi(const repro_glu::Launch& a) {
  const Table tb{static_cast<const float*>(a.params), a.scheme, a.p_rows, a.p_cols,
                 a.inv_period, a.x_max, a.saturation};
  return launch_glu<EPI>(a.x, a.wg, a.wu, a.out, a.M, a.N, a.K, a.variant, a.split, tb,
                         a.stream);
}

}  // namespace

namespace repro_glu {
#if GLU_HOLDS(0)
cudaError_t launch_tanh(const Launch& a) { return launch_epi<EPI_TANH>(a); }
#endif
#if GLU_HOLDS(1)
cudaError_t launch_sigmoid(const Launch& a) { return launch_epi<EPI_SIGMOID>(a); }
#endif
#if GLU_HOLDS(2)
cudaError_t launch_silu(const Launch& a) { return launch_epi<EPI_SILU>(a); }
#endif
#if GLU_HOLDS(3)
cudaError_t launch_gelu(const Launch& a) { return launch_epi<EPI_GELU>(a); }
#endif
#if GLU_HOLDS(4)
cudaError_t launch_softplus(const Launch& a) { return launch_epi<EPI_SOFTPLUS>(a); }
#endif
}  // namespace repro_glu

#if GLU_HOLDS(0)
#ifdef REPRO_GLU_PHASES
// Copy the phase stamps of the last TMA launch (ctas x 8 u64) to host memory
// and clear them.
extern "C" int repro_glu_phases(void* dst, int ctas) {
  if (ctas < 1 || ctas > PHASE_CTAS) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)ctas * PHASE_SLOTS * 8;
  cudaError_t rc = cudaMemcpyFromSymbol(dst, g_glu_phases, bytes);
  if (rc != cudaSuccess) return (int)rc;
  static unsigned long long zeros[PHASE_CTAS * PHASE_SLOTS];
  return (int)cudaMemcpyToSymbol(g_glu_phases, zeros, sizeof(zeros));
}
#endif

extern "C" int repro_glu_2d(const void* x, const void* w_gate, const void* w_up,
                            const void* params, void* out, int M, int N, int K, int scheme,
                            int p_rows, int p_cols, int epi, int dtype, float inv_period,
                            float x_max, float saturation, int variant, int split,
                            void* stream) {
  if (!params_ok(scheme, p_rows, p_cols, epi) || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  // the variant the caller names must fit the operands; nothing is retried
  const bool fits =
      (variant == GLU_SIMT_F32 && dtype == DT_F32) ||
      (variant == GLU_TMA_F32 && dtype == DT_F32 &&
       tma_f32_addressable(x, w_gate, w_up, out, N, K)) ||
      (variant == GLU_WMMA && dtype == DT_BF16) ||
      (variant == GLU_TMA_WGMMA && dtype == DT_BF16 && tma_addressable(x, w_gate, w_up, N, K));
  if (!fits) return (int)cudaErrorInvalidValue;
  // tma_f32 takes its cluster's size from the caller (checked at its
  // launch); the other variants take none
  if (variant != GLU_TMA_F32 && split != 0) return (int)cudaErrorInvalidValue;
  const repro_glu::Launch a{x, w_gate, w_up, params, out, M, N, K, scheme, p_rows, p_cols,
                            inv_period, x_max, saturation, variant, split,
                            static_cast<cudaStream_t>(stream)};
  cudaError_t rc;
  switch (epi) {
    case EPI_TANH: rc = repro_glu::launch_tanh(a); break;
    case EPI_SIGMOID: rc = repro_glu::launch_sigmoid(a); break;
    case EPI_SILU: rc = repro_glu::launch_silu(a); break;
    case EPI_GELU: rc = repro_glu::launch_gelu(a); break;
    case EPI_SOFTPLUS: rc = repro_glu::launch_softplus(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
#endif  // GLU_HOLDS(0)
