// Tiled matmul for Hopper (sm_90a): C[m, n] = A[m, k] @ B[k, n] at a tuned
// block (bm, bk, bn) and grid order, the kernel LoopTune's schedules drive.
//
// Replaces: repro/kernels/matmul.py::_mm_kernel (launched by `matmul`), the
// Pallas TPU kernel.  It computes the same function, not the same block
// structure:
//   * each CTA owns one output tile and walks k inside the CTA, in place of
//     the TPU's sequential k grid dimension; the f32 accumulator lives in
//     registers, starts at zero and the tile is written once;
//   * grid_order maps the linear block index to (i, j): n fastest for "mn",
//     m fastest for "nm".  That is the launch order, and so the L2 reuse a
//     schedule's traversal order buys on this card;
//   * ragged edges are masked in the kernel (no padding copy);
//   * A and B are both f32 or both bf16; the accumulator is f32; C is f32
//     or bf16.  B may be given transposed ((N, K) row-major, the
//     "bsd,vd->bsv" logits form) via trans_b.
//
// Two routes, chosen by the launch's arguments alone (`tc_eligible`, and
// `looptune_matmul_plan`, which kernels/matmul.py::launch_plan matches):
//
// "wgmma" -- bf16 operands with K % 8 == 0 and N % 8 == 0 (every A and B row
// then starts on a 16-byte boundary), any M.  Bound on this card:
// max(2*M*K*N / 989 TFLOP/s, bytes / 3.35 TB/s) with bytes = (M*K + K*N) * 2
// + M*N * out_size.  Prefill (M = 1024) is bound by the tensor cores, decode
// (M = 4) by reading B once.
//   * one or two consumer warpgroups a CTA (m tile 64 or 128), each owning
//     64 rows; no producer warp: every thread issues the loads;
//   * K is walked in 64-value chunks (one 128-byte swizzle row); a ring
//     stage holds kc chunks of A and of B, loaded by 16-byte cp.async with
//     zero fill straight into the 128-byte-swizzled layout the wgmma
//     descriptors read (hopper.cuh).  K past its end and B columns past N
//     are zero filled, and A rows past M (and B rows past N when B is (N,
//     K)) are zeroed once and never loaded: zeros add nothing to the sum,
//     as the TPU kernel's zero padding adds nothing;
//   * the ring keeps stages - 2 steps in flight ahead of the one being
//     multiplied, and one wgmma batch in flight behind it (wait_group 1):
//     a single barrier a step orders both;
//   * C += A.B by wgmma.mma_async m64nNk16 with N the n tile, bf16 operands
//     from shared memory, f32 accumulation.  A (M, K) is K-major.  B (K, N)
//     row-major, the weight as the model stores it, is MN-major: 64-column
//     chunks of rows of k, read with the transpose bit, the next 64 columns
//     one chunk further on (LBO).  B (N, K) with trans_b is K-major, loaded
//     as A is.  A bf16 x bf16 product is exact in f32;
//   * stores are masked, from the accumulator fragments, as f32 pairs or
//     bf16 pairs.
//   Block mapping (the registry's block, clamped to (M, K, N)): the m tile
//   is 64 if bm <= 64 else 128; the n tile the power of two >= bn in [64,
//   256] (at most 128 f32 accumulator registers a thread); bk sets kc =
//   clamp(ceil(bk / 64), 1, 4) chunks a stage (fewer if three stages would
//   not fit in shared memory), and the ring has 4 stages.
//   When M <= 64 (a decode step: one m tile, bound by reading B once) the
//   plan differs: with an n tile of 64 and N = 2048 there are only 32 CTAs,
//   and a CTA walking K alone is bound by the latency of its chain of
//   dependent wgmma batches on one accumulator and of its loads, not by
//   bytes.  So K is split over two warpgroups of the CTA (n tile <= 128;
//   four run no faster): a stage holds one chunk for each, warpgroup w
//   multiplies chunk w into its own accumulator, and the two partial tiles
//   are summed once in shared memory (no atomics; the tile is stored once).
//   The ring then has as many stages as fit, up to 16 (7 at n tile 64).
//   PERF.md has the measurements (benchmarks/port/matmul_decode_plans.py).
//   Wasting 60 of the tile's 64 rows costs no bytes: they are zeroed once
//   and never loaded.  At least 3 stages, at most steps + 2.  No TMA, warp
//   specialisation, setmaxnreg, persistent CTAs or clusters yet.
//
// "simt" -- every f32 launch (TF32 cannot meet the 1e-5 f32 limit) and bf16
// with K or N off a multiple of 8.  Bound: max(2*M*K*N / FP32 peak, bytes /
// 3.35 TB/s); f32 FMAs without TF32, as the reference computes, so the FP32
// non-tensor peak applies (67 TFLOP/s on H100 SXM, 51 on PCIe): prefill is
// bound by the FMAs, decode (M = 4) by reading B once.
//   Block mapping (the registry's block, clamped to (M, K, N)), as on the
//   tensor-core route: the m tile is 64 if bm <= 64 else 128, the n tile 64
//   if bn <= 64 else 128, and bk sets a ring stage's k depth, the power of
//   two >= bk in [8, 64]; the ring has up to 4 stages in the shared memory
//   (in a third of it at 64 x 64, whose 80-register threads then run three
//   CTAs an SM).  A thin block does not give thin CTAs, nor a large one
//   serial sub-tiles.
//   * 256 threads, 16 x 16, each with a register micro-tile of (TM / 16) x
//     (TN / 16) <= 8 x 8 outputs read from shared memory as float4.  A and
//     B (N, K) arrive k-contiguous and stay so (cp.async cannot transpose): a
//     thread reads 4 k values of one of its rows as one float4.  B (K, N)
//     arrives n-contiguous: a thread reads 4 of its columns as one float4.
//     Staged k-contiguous rows are padded by 4 floats (an odd number of
//     16-byte units a row), so the 16 rows of B (N, K) a half-warp reads lie
//     in distinct bank groups, and a half-warp reads one row of A
//     (broadcast): no bank conflicts by construction.  At 8 x 8, 16 float4
//     loads feed 256 FMAs;
//   * loads: a ring of stages in dynamic shared memory, filled by 16-byte
//     cp.async with zero fill past M, N and K where rows allow it (K % 4 == 0
//     for A and B (N, K), N % 4 == 0 for B (K, N), 16-byte aligned bases),
//     by 4-byte cp.async for other f32 shapes, and by loads through
//     registers that widen bf16 to f32.  stages - 1 steps are in flight while
//     one is multiplied; one barrier a step;
//   * each output sums k in order in f32 and is stored once (f32 or bf16).
//   When M <= 16 (decode) the plan differs: the m tile is 4 (M <= 4) or 16,
//   the n tile the power of two >= bn in [16, 128] as long as at least 128
//   CTAs remain to stream B (16 columns at N = 2048, up to 64 at N = 8192:
//   on an H100 a 16-CTA tile took 0.20 ms where 128 CTAs took 0.045), and K
//   is split over the CTA's 1024 / tn groups of tn / 4 threads.  A stage
//   holds 4 k values for each group, each group sums its own partial tile,
//   and the partial tiles are summed once in shared memory, in group order
//   (no atomics).  The ring has up to 4 stages in half the shared memory, so
//   two CTAs can share an SM.  PERF.md has the measurements
//   (benchmarks/port/matmul_decode_plans.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// wait until at most n of this thread's committed cp.async groups are in
// flight (n <= 14, uniform over the CTA)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  using namespace hopper;
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    default: cp_async_wait<14>(); break;
  }
}

constexpr int kSmem = 232448;  // dynamic shared memory a block may use

// raises a kernel's dynamic shared memory limit to kSmem, once a device
template <auto Kernel>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// ---------------------------------------------------------------------------
// "simt" route: f32 FMAs fed by a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;                  // threads of a SIMT CTA
constexpr int kSimtStages = 4;                 // ring stages at most
constexpr int kDecodeM = 16;                   // M <= 16: the decode plan
constexpr int kDecodeCtas = 128;               // ... whose n tile leaves this many CTAs
constexpr int kDecodeSmem = kSmem / 2 - 1024;  // two decode CTAs an SM
constexpr int kPad = 4;                        // floats after each staged row

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

// floats of one ring stage: A [tm][kd + 4] (k contiguous), then B [kd][tn + 4]
// (B (K, N): n contiguous) or [tn][kd + 4] (B (N, K): k contiguous), sized for
// the larger of the two so that the plan does not depend on the B layout
__host__ __device__ constexpr int simt_stage_floats(int tm, int tn, int kd) {
  return tm * (kd + kPad) + (kd + kPad) * (tn + kPad);
}

struct SimtPlan {
  int tm, tn, kd, stages, ctas, ks;
};

SimtPlan simt_plan(int M, int K, int N, int bm, int bk, int bn) {
  bm = bm < M ? bm : M;
  bk = bk < K ? bk : K;
  bn = bn < N ? bn : N;
  SimtPlan p;
  int budget;
  if (M <= kDecodeM) {  // one m tile; K split over ks groups of tn / 4 threads
    p.tm = M <= 4 ? 4 : 16;
    p.tn = 16;  // the power of two >= bn in [16, 128] that leaves >= 128 CTAs
    while (p.tn < bn && p.tn < 128 && cdiv(N, 2 * p.tn) >= kDecodeCtas) p.tn *= 2;
    p.ks = 4 * kThreads / p.tn;
    p.kd = 4 * p.ks;  // 4 k values a group a stage
    budget = kDecodeSmem;
  } else {
    p.tm = bm <= 64 ? 64 : 128;
    p.tn = bn <= 64 ? 64 : 128;
    p.kd = 8;
    while (p.kd < bk && p.kd < 64) p.kd *= 2;
    p.ks = 1;
    // 64 x 64: a third of the shared memory, so that three CTAs share an SM
    budget = p.tm * p.tn <= 64 * 64 ? kSmem / 3 - 1024 : kSmem;
  }
  const int fit = budget / (simt_stage_floats(p.tm, p.tn, p.kd) * 4);
  p.stages = fit < kSimtStages ? fit : kSimtStages;
  p.ctas = cdiv(M, p.tm) * cdiv(N, p.tn);
  return p;
}

// the ring, or the decode plan's partial tiles if they are larger
size_t simt_smem_bytes(const SimtPlan& p) {
  const size_t ring = (size_t)p.stages * simt_stage_floats(p.tm, p.tn, p.kd) * 4;
  const size_t part = p.ks > 1 ? (size_t)p.ks * p.tm * p.tn * 4 : 0;
  return ring > part ? ring : part;
}

struct SimtArgs {
  const void* A;
  const void* B;
  void* C;
  int M, K, N, kd, stages, order_nm, in_bf16, out_bf16;
  int vec_a, vec_b;  // the operand's rows allow 16-byte copies
};

__device__ __forceinline__ int simt_steps(int K, int kd) {
  return (K + kd - 1) / kd;  // k stages of the SIMT ring
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void store_out(const SimtArgs& a, size_t at, float v) {
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.C)[at] = __float2bfloat16(v);
  else
    static_cast<float*>(a.C)[at] = v;
}

// rows [r0, r0 + rows) x k [k0, k0 + 2^kl) of a row-major (R, K) matrix into
// dst [rows][2^kl + 4] (k contiguous); rows past R and k past K are zero
__device__ __forceinline__ void stage_k_rows(float* dst, const void* src, int R, int r0,
                                             int rows, int K, int k0, int kl, int vec,
                                             int bf16, int tid) {
  using namespace hopper;
  const int kd = 1 << kl, pitch = kd + kPad;
  if (bf16) {  // through registers, widened to f32
    const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(src);
    for (int e = tid; e < rows << kl; e += kThreads) {
      const int r = e >> kl, kk = e & (kd - 1), gr = r0 + r, gk = k0 + kk;
      dst[r * pitch + kk] = gr < R && gk < K ? __bfloat162float(s[(size_t)gr * K + gk]) : 0.f;
    }
  } else if (vec) {  // K % 4 == 0: a 16-byte piece is wholly in or out
    const float* s = static_cast<const float*>(src);
    for (int e = tid; e < rows << (kl - 2); e += kThreads) {
      const int r = e >> (kl - 2), kk = 4 * (e & (kd / 4 - 1)), gr = r0 + r, gk = k0 + kk;
      const bool in = gr < R && gk < K;
      cp_async16(smem_u32(dst + r * pitch + kk), in ? s + (size_t)gr * K + gk : s, in ? 16 : 0);
    }
  } else {
    const float* s = static_cast<const float*>(src);
    for (int e = tid; e < rows << kl; e += kThreads) {
      const int r = e >> kl, kk = e & (kd - 1), gr = r0 + r, gk = k0 + kk;
      const bool in = gr < R && gk < K;
      cp_async4(smem_u32(dst + r * pitch + kk), in ? s + (size_t)gr * K + gk : s, in ? 4 : 0);
    }
  }
}

// k [k0, k0 + 2^kl) x columns [n0, n0 + TN) of a row-major (K, N) matrix into
// dst [2^kl][TN + 4] (n contiguous); k past K and columns past N are zero
template <int TN>
__device__ __forceinline__ void stage_n_rows(float* dst, const void* src, int K, int k0,
                                             int kl, int N, int n0, int vec, int bf16,
                                             int tid) {
  using namespace hopper;
  constexpr int pitch = TN + kPad;
  if (bf16) {
    const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(src);
    for (int e = tid; e < TN << kl; e += kThreads) {
      const int kr = e / TN, c = e % TN, gk = k0 + kr, gn = n0 + c;
      dst[kr * pitch + c] = gk < K && gn < N ? __bfloat162float(s[(size_t)gk * N + gn]) : 0.f;
    }
  } else if (vec) {  // N % 4 == 0
    const float* s = static_cast<const float*>(src);
    for (int e = tid; e < (TN / 4) << kl; e += kThreads) {
      const int kr = e / (TN / 4), c = 4 * (e % (TN / 4)), gk = k0 + kr, gn = n0 + c;
      const bool in = gk < K && gn < N;
      cp_async16(smem_u32(dst + kr * pitch + c), in ? s + (size_t)gk * N + gn : s, in ? 16 : 0);
    }
  } else {
    const float* s = static_cast<const float*>(src);
    for (int e = tid; e < TN << kl; e += kThreads) {
      const int kr = e / TN, c = e % TN, gk = k0 + kr, gn = n0 + c;
      const bool in = gk < K && gn < N;
      cp_async4(smem_u32(dst + kr * pitch + c), in ? s + (size_t)gk * N + gn : s, in ? 4 : 0);
    }
  }
}

// One TM x TN output tile a CTA (M > 16), thread (ty, tx) of 16 x 16 owning
// rows ty + 16 i (i < TM / 16) and TN / 16 columns: with B (K, N) the float4
// runs 4 tx + 64 q (q < TN / 64), read from the n-contiguous stage as float4;
// with B (N, K) the columns tx + 16 j, read as float4 along k from the
// k-contiguous stage.  A is read as float4 along k.  Each output sums k in
// order, in f32.
template <int TM, int TN, int TB>
__global__ void __launch_bounds__(kThreads, 1) simt_matmul(const SimtArgs a) {
  using namespace hopper;
  constexpr int RM = TM / 16, RN = TN / 16;
  extern __shared__ float4 simt_smem[];
  float* const smem = reinterpret_cast<float*>(simt_smem);
  const int kd = a.kd, kl = __ffs(kd) - 1, pk = kd + kPad;  // kd is a power of two
  const int b_off = TM * pk, stage = simt_stage_floats(TM, TN, kd);

  const int gm = cdiv(a.M, TM), gn = cdiv(a.N, TN);
  const int l = blockIdx.x;
  const int bi = a.order_nm ? l % gm : l / gn;
  const int bj = a.order_nm ? l / gm : l % gn;
  const int m0 = bi * TM, n0 = bj * TN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  auto load = [&](int t, int s) {  // k stage t into ring stage s
    float* const st = smem + s * stage;
    stage_k_rows(st, a.A, a.M, m0, TM, a.K, t * kd, kl, a.vec_a, a.in_bf16, tid);
    if constexpr (TB)
      stage_k_rows(st + b_off, a.B, a.N, n0, TN, a.K, t * kd, kl, a.vec_b, a.in_bf16, tid);
    else
      stage_n_rows<TN>(st + b_off, a.B, a.K, t * kd, kl, a.N, n0, a.vec_b, a.in_bf16, tid);
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int steps = simt_steps(a.K, kd);
  for (int t = 0; t < a.stages - 1; ++t) {
    if (t < steps) load(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait_n(a.stages - 2);  // this thread's copies of step t landed
    // every thread's copies of step t landed, and every thread is done with
    // step t - 1, whose stage the next load refills
    __syncthreads();
    if (t + a.stages - 1 < steps) load(t + a.stages - 1, (t + a.stages - 1) % a.stages);
    cp_async_commit();
    const float* const As = smem + (t % a.stages) * stage;
    const float* const Bs = As + b_off;
#pragma unroll 2
    for (int k4 = 0; k4 < kd; k4 += 4) {  // kd >= 8
      float4 av[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        av[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * pk + k4);
      if constexpr (TB) {
        float4 bv[RN];
#pragma unroll
        for (int j = 0; j < RN; ++j)
          bv[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * pk + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j)
              acc[i][j] = fmaf(lane4(av[i], kk), lane4(bv[j], kk), acc[i][j]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 bv[RN / 4];
#pragma unroll
          for (int q = 0; q < RN / 4; ++q)
            bv[q] = *reinterpret_cast<const float4*>(Bs + (k4 + kk) * (TN + kPad) + 64 * q +
                                                     4 * tx);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j)
              acc[i][j] = fmaf(lane4(av[i], kk), lane4(bv[j / 4], j % 4), acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= a.M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + (TB ? tx + 16 * j : 64 * (j / 4) + 4 * tx + j % 4);
      if (col < a.N) store_out(a, (size_t)row * a.N + col, acc[i][j]);
    }
  }
}

// M <= 16 (a decode step, bound by reading B once): one MT x TN tile a CTA,
// MT >= M.  Its 256 threads are KS = 1024 / TN groups of TN / 4; a ring stage
// holds KD = 4 KS values of k, and group g multiplies values 4g..4g+3 of each
// stage into its own MT x 4 partial tile (thread c of the group: columns
// 4c..4c+3 with B (K, N), c + (TN / 4) j with B (N, K)).  The KS partial
// tiles are summed once in shared memory, in group order: no atomics, each
// output stored once.
template <int MT, int TN, int TB>
__global__ void __launch_bounds__(kThreads, 1) simt_matmul_decode(const SimtArgs a) {
  using namespace hopper;
  constexpr int CG = TN / 4, KS = kThreads / CG, KD = 4 * KS, PK = KD + kPad;
  constexpr int KL = ilog2(KD), B_OFF = MT * PK, STAGE = simt_stage_floats(MT, TN, KD);
  extern __shared__ float4 simt_smem[];
  float* const smem = reinterpret_cast<float*>(simt_smem);
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, c = tid % CG, g = tid / CG;

  auto load = [&](int t, int s) {
    float* const st = smem + s * STAGE;
    stage_k_rows(st, a.A, a.M, 0, MT, a.K, t * KD, KL, a.vec_a, a.in_bf16, tid);
    if constexpr (TB)
      stage_k_rows(st + B_OFF, a.B, a.N, n0, TN, a.K, t * KD, KL, a.vec_b, a.in_bf16, tid);
    else
      stage_n_rows<TN>(st + B_OFF, a.B, a.K, t * KD, KL, a.N, n0, a.vec_b, a.in_bf16, tid);
  };

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  const int steps = simt_steps(a.K, KD);
  for (int t = 0; t < a.stages - 1; ++t) {
    if (t < steps) load(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait_n(a.stages - 2);
    __syncthreads();
    if (t + a.stages - 1 < steps) load(t + a.stages - 1, (t + a.stages - 1) % a.stages);
    cp_async_commit();
    const float* const As = smem + (t % a.stages) * STAGE;
    const float* const Bs = As + B_OFF;
    float4 av[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) av[m] = *reinterpret_cast<const float4*>(As + m * PK + 4 * g);
    if constexpr (TB) {
      float4 bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(Bs + (c + CG * j) * PK + 4 * g);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[m][j] = fmaf(lane4(av[m], kk), lane4(bv[j], kk), acc[m][j]);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(Bs + (4 * g + kk) * (TN + kPad) +
                                                           4 * c);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(lane4(av[m], kk), lane4(bv, j), acc[m][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring

  float* const part = smem;  // [KS][MT][TN]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(g * MT + m) * TN + (TB ? c + CG * j : 4 * c + j)] = acc[m][j];
  __syncthreads();
  for (int o = tid; o < MT * TN; o += kThreads) {
    const int m = o / TN, col = o % TN;
    if (m >= a.M || n0 + col >= a.N) continue;
    float sum = 0.f;
    for (int gg = 0; gg < KS; ++gg) sum += part[(gg * MT + m) * TN + col];
    store_out(a, (size_t)m * a.N + n0 + col, sum);
  }
}

template <int TM, int TN, int TB>
int launch_simt(const SimtPlan& p, const SimtArgs& a, cudaStream_t s) {
  const cudaError_t err = allow_smem<simt_matmul<TM, TN, TB>>();
  if (err != cudaSuccess) return (int)err;
  simt_matmul<TM, TN, TB><<<p.ctas, kThreads, simt_smem_bytes(p), s>>>(a);
  return (int)cudaGetLastError();
}

template <int MT, int TN, int TB>
int launch_simt_decode(const SimtPlan& p, const SimtArgs& a, cudaStream_t s) {
  const cudaError_t err = allow_smem<simt_matmul_decode<MT, TN, TB>>();
  if (err != cudaSuccess) return (int)err;
  simt_matmul_decode<MT, TN, TB><<<p.ctas, kThreads, simt_smem_bytes(p), s>>>(a);
  return (int)cudaGetLastError();
}

template <int TB>
int launch_simt_tile(const SimtPlan& p, const SimtArgs& a, cudaStream_t s) {
  if (p.ks > 1) {
    switch (p.tm * 1000 + p.tn) {
      case 4016: return launch_simt_decode<4, 16, TB>(p, a, s);
      case 4032: return launch_simt_decode<4, 32, TB>(p, a, s);
      case 4064: return launch_simt_decode<4, 64, TB>(p, a, s);
      case 4128: return launch_simt_decode<4, 128, TB>(p, a, s);
      case 16016: return launch_simt_decode<16, 16, TB>(p, a, s);
      case 16032: return launch_simt_decode<16, 32, TB>(p, a, s);
      case 16064: return launch_simt_decode<16, 64, TB>(p, a, s);
      case 16128: return launch_simt_decode<16, 128, TB>(p, a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (p.tm * 1000 + p.tn) {
    case 64064: return launch_simt<64, 64, TB>(p, a, s);
    case 64128: return launch_simt<64, 128, TB>(p, a, s);
    case 128064: return launch_simt<128, 64, TB>(p, a, s);
    case 128128: return launch_simt<128, 128, TB>(p, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// "wgmma" route: bf16 operands on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kChunk = 64;      // k values of a 128-byte swizzle row
constexpr int kTcRing = kSmem - 1024;           // less the 1024-byte alignment slack
constexpr int kTcStages = 4;                    // ring stages when M > 64
constexpr int kTcDeepStages = 16;               // at most, when M <= 64
constexpr int kTcMaxKc = 4;                     // 64-value chunks a stage

bool tc_eligible(int K, int N, int bf16) { return bf16 && K % 8 == 0 && N % 8 == 0; }

struct TcPlan {
  int tm, tn, kc, stages, ctas, ks;
};

TcPlan tc_plan(int M, int K, int N, int bm, int bk, int bn) {
  bm = bm < M ? bm : M;
  bk = bk < K ? bk : K;
  bn = bn < N ? bn : N;
  TcPlan p;
  p.tm = bm <= 64 ? 64 : 128;
  p.tn = 64;
  while (p.tn < bn && p.tn < 256) p.tn *= 2;
  const int chunks = cdiv(K, kChunk);
  // M <= 64: split K over two warpgroups (n tile <= 128), each its own
  // chunk of a stage
  p.ks = M <= 64 && p.tn <= 128 ? 2 : 1;
  p.kc = M <= 64 ? p.ks : cdiv(bk, kChunk);
  if (p.kc > kTcMaxKc) p.kc = kTcMaxKc;
  if (p.kc > chunks && p.ks == 1) p.kc = chunks;
  while (p.kc > 1 && 3 * p.kc * (p.tm + p.tn) * 128 > kTcRing) --p.kc;
  const int fit = kTcRing / (p.kc * (p.tm + p.tn) * 128);
  int stages = M <= 64 ? kTcDeepStages : kTcStages;
  if (stages > fit) stages = fit;
  const int steps = cdiv(chunks, p.kc);
  if (stages > steps + 2) stages = steps + 2;
  p.stages = stages < 3 ? 3 : stages;
  p.ctas = cdiv(M, p.tm) * cdiv(N, p.tn);
  return p;
}

struct TcArgs {
  const __nv_bfloat16* A;
  const __nv_bfloat16* B;
  void* C;
  int M, K, N, kc, stages, order_nm, out_bf16;
};

// threads of a CTA: TM / 64 warpgroups over M, each KS warpgroups over K
template <int TM, int KS>
__host__ __device__ constexpr int tc_threads() { return TM / 64 * KS * kWG; }

// TM / 64 warpgroups, each 64 rows of the TM x TN tile; with KS > 1 (TM =
// 64 only) KS warpgroups share those rows and split K: warpgroup w takes
// chunk w of every stage into its own accumulator, and the KS partial tiles
// are summed in shared memory once at the end.  TB = 1: B is (N, K)
// row-major (K-major); TB = 0: B is (K, N) row-major (MN-major).
template <int TM, int TN, int TB, int KS>
__global__ void __launch_bounds__(tc_threads<TM, KS>(), 1)
tc_matmul(const TcArgs a) {
  using namespace hopper;
  static_assert(KS == 1 || TM == 64, "K is split only over a 64-row tile");
  constexpr int NT = tc_threads<TM, KS>();
  constexpr uint32_t A_CHUNK = TM * 128;  // bytes of one 64-value chunk of the A tile
  constexpr uint32_t B_CHUNK = TN * 128;  // ... and of the B tile
  constexpr int NCH = TN / 64;            // 64-column chunks of an MN-major B chunk
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t a_bytes = a.kc * A_CHUNK;
  const uint32_t stage_bytes = a_bytes + a.kc * B_CHUNK;  // A chunks, then B chunks

  const int gm = cdiv(a.M, TM), gn = cdiv(a.N, TN);
  const int l = blockIdx.x;
  const int bi = a.order_nm ? l % gm : l / gn;
  const int bj = a.order_nm ? l / gm : l % gn;
  const int m0 = bi * TM, n0 = bj * TN;
  const int rows = min(TM, a.M - m0);  // A rows to load
  const int cols = min(TN, a.N - n0);  // B rows to load when B is (N, K)
  const int tid = threadIdx.x;
  const int wg = tid / kWG, warp = (tid % kWG) / 32, lane = tid % 32;
  const int wm = KS == 1 ? wg : 0;  // this warpgroup's 64 rows of the tile

  const int kchunks = (a.K + kChunk - 1) / kChunk;  // 64-value chunks of K
  const int kend = min(a.K, kchunks * kChunk);
  const int steps = cdiv(kchunks, a.kc);
  const int ahead = a.stages - 2;  // steps loaded ahead of the one multiplied

  // A rows past M (and B rows past N when B is K-major) are never loaded:
  // zero them once in every stage
  {
    const int zr_a = TM - rows, zr_b = TB ? TN - cols : 0;
    const int per_chunk = (zr_a + zr_b) * 8;
    for (int e = tid; e < a.stages * a.kc * per_chunk; e += NT) {
      const int p = e % 8, r = (e / 8) % (zr_a + zr_b), sc = e / per_chunk;
      const int s = sc / a.kc, c = sc % a.kc;
      const uint32_t off = s * stage_bytes + (r < zr_a
          ? c * A_CHUNK + sw128(rows + r, p)
          : a_bytes + c * B_CHUNK + sw128(cols + r - zr_a, p));
      *reinterpret_cast<uint4*>(gbase + off) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const __nv_bfloat16* const A = a.A + (size_t)m0 * a.K;
  auto load = [&](int t, int s) {  // k step t (kc chunks) into stage s
    const uint32_t sa = base + s * stage_bytes, sb = sa + a_bytes;
    const int k0 = t * a.kc * kChunk;
    // A: 16-byte piece p of chunk c of row r, p fastest (a row's chunks are
    // contiguous in memory)
    for (int e = tid; e < rows * a.kc * 8; e += NT) {
      const int p = e % 8, c = (e / 8) % a.kc, r = e / (8 * a.kc);
      const int k = k0 + c * kChunk + 8 * p;
      const bool in = k < kend;
      cp_async16(sa + c * A_CHUNK + sw128(r, p), A + (size_t)r * a.K + (in ? k : 0),
                 in ? 16 : 0);
    }
    if constexpr (TB) {  // B (N, K): rows of n, as A
      const __nv_bfloat16* const B = a.B + (size_t)n0 * a.K;
      for (int e = tid; e < cols * a.kc * 8; e += NT) {
        const int p = e % 8, c = (e / 8) % a.kc, r = e / (8 * a.kc);
        const int k = k0 + c * kChunk + 8 * p;
        const bool in = k < kend;
        cp_async16(sb + c * B_CHUNK + sw128(r, p), B + (size_t)r * a.K + (in ? k : 0),
                   in ? 16 : 0);
      }
    } else {  // B (K, N): chunk c, k row kr, n chunk nc, piece p (a k row's TN
              // columns are contiguous in memory)
      for (int e = tid; e < a.kc * kChunk * NCH * 8; e += NT) {
        const int p = e % 8, nc = (e / 8) % NCH, kr = (e / (8 * NCH)) % kChunk,
                  c = e / (8 * NCH * kChunk);
        const int k = k0 + c * kChunk + kr, n = n0 + nc * 64 + 8 * p;
        const bool in = k < kend && n < a.N;
        cp_async16(sb + c * B_CHUNK + nc * 8192 + sw128(kr, p),
                   a.B + (in ? (size_t)k * a.N + n : 0), in ? 16 : 0);
      }
    }
  };

  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < ahead; ++t) {
    if (t < steps) load(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait_n(ahead - 1);  // step t's copies (this thread's) landed
    fence_proxy_async_shared();
    // every thread's copies of step t landed, and every warpgroup has
    // retired its batch of step t - 2, whose stage the next load refills
    __syncthreads();
    if (t + ahead < steps) load(t + ahead, (t + ahead) % a.stages);
    cp_async_commit();
    const uint32_t sa = base + (t % a.stages) * stage_bytes + wm * 64 * 128;
    const uint32_t sb = base + (t % a.stages) * stage_bytes + a_bytes;
    fence_regs(acc);  // the zeroed accumulator is written before the fence
    wgmma_fence();
    for (int c = KS == 1 ? 0 : wg; c < (KS == 1 ? a.kc : wg + 1); ++c) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da = desc_kmajor(sa + c * A_CHUNK + ks * 32);
        const uint64_t db = TB ? desc_kmajor(sb + c * B_CHUNK + ks * 32)
                               : desc_mnmajor(sb + c * B_CHUNK + ks * 2048, 8192);
        // B (N, K) is K-major; B (K, N) is MN-major: the transpose bit
        wgmma_ss<TB ? 0 : 1>(acc, da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the batch of step t - 1 retired; step t's may run on
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();

  if constexpr (KS > 1) {  // sum the split-K partial tiles into warpgroup 0's
    __syncthreads();        // every warpgroup is done with the ring
    float* part = reinterpret_cast<float*>(gbase);  // [KS - 1][TN / 2][128]
    const int lt = tid % kWG;
    if (wg > 0) {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) part[((wg - 1) * (TN / 2) + i) * kWG + lt] = acc[i];
    }
    __syncthreads();
    if (wg > 0) return;
#pragma unroll
    for (int w = 1; w < KS; ++w)
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] += part[((w - 1) * (TN / 2) + i) * kWG + lt];
  }

  // accumulator register i: row 16 warp + lane / 4 + 8 ((i >> 1) & 1), column
  // 8 (i >> 2) + 2 (lane % 4) + (i & 1) of this warpgroup's 64 x TN
  const int r0 = m0 + wm * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < TN / 4; ++j) {
    const int row = r0 + 8 * (j & 1), col = c0 + 8 * (j >> 1);
    if (row < a.M && col < a.N) {  // N is even: col < N holds col + 1 < N
      const size_t at = (size_t)row * a.N + col;
      if (a.out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.C) + at) =
            __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(a.C) + at) =
            make_float2(acc[2 * j], acc[2 * j + 1]);
    }
  }
}

template <int TM, int TN, int TB, int KS>
int launch_tc(const TcPlan& p, const TcArgs& a, cudaStream_t s) {
  const cudaError_t err = allow_smem<tc_matmul<TM, TN, TB, KS>>();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 1024 + (size_t)p.stages * p.kc * (TM + TN) * 128;
  tc_matmul<TM, TN, TB, KS><<<p.ctas, tc_threads<TM, KS>(), smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int TB>
int launch_tc_tile(const TcPlan& p, const TcArgs& a, cudaStream_t s) {
  if (p.tm == 128) {
    switch (p.tn) {
      case 64: return launch_tc<128, 64, TB, 1>(p, a, s);
      case 128: return launch_tc<128, 128, TB, 1>(p, a, s);
      default: return launch_tc<128, 256, TB, 1>(p, a, s);
    }
  }
  switch (p.tn * 8 + p.ks) {
    case 64 * 8 + 1: return launch_tc<64, 64, TB, 1>(p, a, s);
    case 64 * 8 + 2: return launch_tc<64, 64, TB, 2>(p, a, s);
    case 128 * 8 + 1: return launch_tc<64, 128, TB, 1>(p, a, s);
    case 128 * 8 + 2: return launch_tc<64, 128, TB, 2>(p, a, s);
    case 256 * 8 + 1: return launch_tc<64, 256, TB, 1>(p, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_tc_plan(const TcPlan& p, const TcArgs& a, int trans_b, cudaStream_t s) {
  return trans_b ? launch_tc_tile<1>(p, a, s) : launch_tc_tile<0>(p, a, s);
}

}  // namespace

extern "C" {

// How a launch is laid out, as kernels/matmul.py::launch_plan computes it:
// out[0] = route (1 = "wgmma", 0 = "simt"), out[1..2] = CTA tile rows and
// columns, out[3] = k chunks a ring stage ("wgmma") or k values a ring stage
// ("simt"), out[4] = ring stages, out[5] = number of CTAs, out[6] = the
// warpgroups ("wgmma") or thread groups ("simt") that split K.
int looptune_matmul_plan(int M, int K, int N, int bm, int bk, int bn, int order_nm,
                         int bf16, int* out) {
  (void)order_nm;  // the grid order changes no plan, only the CTAs' order
  if (M < 1 || K < 1 || N < 1 || bm < 1 || bk < 1 || bn < 1)
    return (int)cudaErrorInvalidValue;
  if (tc_eligible(K, N, bf16)) {
    const TcPlan p = tc_plan(M, K, N, bm, bk, bn);
    const int v[7] = {1, p.tm, p.tn, p.kc, p.stages, p.ctas, p.ks};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
  } else {
    const SimtPlan p = simt_plan(M, K, N, bm, bk, bn);
    const int v[7] = {0, p.tm, p.tn, p.kd, p.stages, p.ctas, p.ks};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
  }
  return 0;
}

// Launches on `stream` without synchronising; returns cudaGetLastError()
// of the launch (0 on success).  a: (M, K); b: (K, N), or (N, K) when
// trans_b; c: (M, N); all contiguous row-major.  On the "wgmma" route every
// base is 16-byte aligned (else cudaErrorMisalignedAddress).
int looptune_matmul(const void* a, const void* b, void* c, int M, int K, int N,
                    int bm, int bk, int bn, int order_nm, int trans_b,
                    int in_bf16, int out_bf16, void* stream) {
  if (M < 1 || K < 1 || N < 1 || bm < 1 || bk < 1 || bn < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc_eligible(K, N, in_bf16)) {
    if (reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
        reinterpret_cast<uintptr_t>(c) % 16)
      return (int)cudaErrorMisalignedAddress;
    const TcPlan p = tc_plan(M, K, N, bm, bk, bn);
    const TcArgs args{static_cast<const __nv_bfloat16*>(a),
                      static_cast<const __nv_bfloat16*>(b), c, M, K, N, p.kc, p.stages,
                      order_nm, out_bf16};
    return launch_tc_plan(p, args, trans_b, s);
  }
  const SimtPlan p = simt_plan(M, K, N, bm, bk, bn);
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const SimtArgs args{a, b, c, M, K, N, p.kd, p.stages, order_nm, in_bf16, out_bf16,
                      K % 4 == 0 && aligned(a),
                      (trans_b ? K % 4 == 0 : N % 4 == 0) && aligned(b)};
  return trans_b ? launch_simt_tile<1>(p, args, s) : launch_simt_tile<0>(p, args, s);
}

}  // extern "C"
