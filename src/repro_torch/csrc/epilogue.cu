// Hand-written Hopper (sm_90a) kernel for the fused GLU of the Catmull-Rom
// activation unit, behind a plain C interface that
// src/repro_torch/kernels/_build.py builds with nvcc and loads with ctypes:
//
//   repro_glu_2d  <- src/repro/kernels/epilogue.py:glu_2d (_glu_kernel), in
//                    three variants the caller names: a TMA + wgmma kernel
//                    for bf16 (the served path), a wmma kernel for bf16
//                    operands TMA cannot address, and an IEEE f32 SIMT
//                    kernel
//
// The epilogue (approximant.cuh) runs in f32, in the plain PyTorch
// version's operation order. The scheme is a runtime switch, uniform
// across the grid, not a template parameter: the instantiations (epilogue
// x variant x tile) stay as many as with one scheme, and so does the build
// time. elementwise.cu holds the other kernel; each source is compiled on
// its own, in parallel.
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

namespace {

// kernels/epilogue.py _GLU_VARIANT_IDS
enum { GLU_WMMA = 0, GLU_TMA_WGMMA = 1, GLU_SIMT_F32 = 2 };

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
// Three variants, chosen by the Python wrapper (kernels/epilogue.py
// _glu_variant) and refused here when they do not fit the operands:
//
//   tma_wgmma  bf16, every operand addressable by TMA (16-byte aligned,
//              row strides multiples of 16 bytes): the Hopper kernel
//              below, repro_glu_bf16_tma_kernel. Every bf16 launch of the
//              served model takes it.
//   wmma       bf16 operands TMA cannot address: one output tile per block,
//              nvcuda::wmma 16x16x16 on plain zero-filled tile loads, no
//              pipelining (the first slice's kernel, kept for these only).
//   simt_f32   f32: an IEEE f32 SIMT path (FMA on CUDA cores, no TF32), the
//              path of the f32-logits checks; TF32 would break their 1e-4
//              gates.
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

// A row-major bf16 [rows, cols] matrix as a 2-D tensor map with
// [box_rows, box_cols] boxes, 128-byte swizzle, zeros outside the matrix.
bool encode_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
               int box_cols) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
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

// Whether TMA can address the operands: 16-byte aligned bases, row strides
// (K and N bf16) multiples of 16 bytes.
bool tma_addressable(const void* x, const void* wg, const void* wu, int N, int K) {
  return N % 8 == 0 && K % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)wg % 16 == 0 &&
         (uintptr_t)wu % 16 == 0;
}

template <int EPI>
cudaError_t launch_glu(const void* x, const void* wg, const void* wu, void* out, int M, int N,
                       int K, int variant, const Table& tb, cudaStream_t s) {
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

}  // namespace

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
                            float x_max, float saturation, int variant, void* stream) {
  if (!params_ok(scheme, p_rows, p_cols, epi) || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  // the variant the caller names must fit the operands; nothing is retried
  const bool fits =
      (variant == GLU_SIMT_F32 && dtype == DT_F32) ||
      (variant == GLU_WMMA && dtype == DT_BF16) ||
      (variant == GLU_TMA_WGMMA && dtype == DT_BF16 && tma_addressable(x, w_gate, w_up, N, K));
  if (!fits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table tb{static_cast<const float*>(params), scheme, p_rows, p_cols, inv_period, x_max,
                 saturation};
  cudaError_t rc;
  switch (epi) {
    case EPI_TANH: rc = launch_glu<EPI_TANH>(x, w_gate, w_up, out, M, N, K, variant, tb, s); break;
    case EPI_SIGMOID: rc = launch_glu<EPI_SIGMOID>(x, w_gate, w_up, out, M, N, K, variant, tb, s); break;
    case EPI_SILU: rc = launch_glu<EPI_SILU>(x, w_gate, w_up, out, M, N, K, variant, tb, s); break;
    case EPI_GELU: rc = launch_glu<EPI_GELU>(x, w_gate, w_up, out, M, N, K, variant, tb, s); break;
    case EPI_SOFTPLUS: rc = launch_glu<EPI_SOFTPLUS>(x, w_gate, w_up, out, M, N, K, variant, tb, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
