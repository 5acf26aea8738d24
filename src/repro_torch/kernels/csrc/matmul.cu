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
// with K or N off a multiple of 8.  Bound: max(2*M*K*N / FP32 FMA peak,
// bytes / 3.35 TB/s); the kernel is f32 arithmetic without TF32, as the
// reference is, so the FP32 non-tensor peak applies (67 TFLOP/s on H100
// SXM, 51 on PCIe).  The design stages A and B slabs in shared memory and
// gives each thread a register micro-tile (RM x RN outputs, RM + RN
// shared-memory loads per RM * RN FMAs); bf16 is widened with
// __bfloat162float.  Blocks of any size are accepted, because the registry
// can hold any:
//   * shared memory: a bk-deep slab is staged in sub-chunks of at most KC
//     (8 to 128) k values, so no block ever needs more than ~35 KB of static
//     shared memory, whatever bk is;
//   * registers: the CTA tile is walked in sub-tiles of (TR*RM) x (TC*RN)
//     outputs (kSubTiles below), each held in registers while k runs, so a
//     tile larger than the threads can hold is computed a sub-tile at a
//     time;
//   * small blocks: when bm*bn is below the 256 threads of a CTA, one CTA
//     covers G neighbouring blocks along the fast grid dimension, i.e. the
//     CTA tile is (bm, G*bn) for "mn" and (G*bm, bn) for "nm", with
//     G = min(256 / (bm*bn), blocks along that dimension,
//             CTAs / (2 * SMs)):
//     grouping stops while at least two CTAs per SM remain, so a thin
//     decode product keeps the parallelism its tuned block asked for.  The
//     blocks are independent and share the k stepping, so this changes no
//     value, only how many threads idle.
//   The sub-tile shape is the one that wastes the fewest padded outputs on
//   the CTA tile (ties: the first listed, which has the larger register
//   micro-tile).  Thin sub-tiles stage deeper k chunks (larger KC), so each
//   chunk still moves ~8K values and keeps enough loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// TR x TC threads; each owns RM x RN outputs of a (TR*RM) x (TC*RN)
// sub-tile at rows ty + i*TR and columns tx + j*TC (strided, so a warp reads
// consecutive shared-memory words of B and broadcasts words of A).
template <typename TIn, typename TOut, int TR, int TC, int RM, int RN, int KC>
__global__ void __launch_bounds__(kThreads)
tiled_matmul(const TIn* __restrict__ A, const TIn* __restrict__ B,
             TOut* __restrict__ C, int M, int K, int N, int bk, int tm, int tn,
             int order_nm, int trans_b) {
  static_assert(TR * TC == kThreads, "thread layout");
  constexpr int SM = TR * RM;
  constexpr int SN = TC * RN;
  __shared__ float As[KC][SM];
  __shared__ float Bs[KC][SN];

  const int gmc = (M + tm - 1) / tm;
  const int gnc = (N + tn - 1) / tn;
  const int l = blockIdx.x;
  const int bi = order_nm ? l % gmc : l / gnc;
  const int bj = order_nm ? l / gmc : l % gnc;
  const int m_lo = bi * tm, m_hi = min(m_lo + tm, M);
  const int n_lo = bj * tn, n_hi = min(n_lo + tn, N);

  const int tid = threadIdx.x;
  const int tx = tid % TC, ty = tid / TC;

  for (int sm = m_lo; sm < m_hi; sm += SM) {
    for (int sn = n_lo; sn < n_hi; sn += SN) {
      float acc[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

      for (int kb = 0; kb < K; kb += bk) {
        const int kend = min(kb + bk, K);
        for (int k0 = kb; k0 < kend; k0 += KC) {
          const int kc = min(KC, kend - k0);
          // A slab (SM x kc), read along k, stored k-major
          for (int e = tid; e < SM * kc; e += kThreads) {
            const int r = e / kc, kk = e % kc;
            const int gm = sm + r;
            As[kk][r] = gm < m_hi ? to_f(A[(size_t)gm * K + k0 + kk]) : 0.f;
          }
          // B slab (kc x SN), read along n (or along k when transposed)
          if (!trans_b) {
            for (int e = tid; e < kc * SN; e += kThreads) {
              const int kk = e / SN, c = e % SN;
              const int gn = sn + c;
              Bs[kk][c] = gn < n_hi ? to_f(B[(size_t)(k0 + kk) * N + gn]) : 0.f;
            }
          } else {
            for (int e = tid; e < kc * SN; e += kThreads) {
              const int c = e / kc, kk = e % kc;
              const int gn = sn + c;
              Bs[kk][c] = gn < n_hi ? to_f(B[(size_t)gn * K + k0 + kk]) : 0.f;
            }
          }
          __syncthreads();
#pragma unroll 4
          for (int kk = 0; kk < kc; ++kk) {
            float a[RM], b[RN];
#pragma unroll
            for (int i = 0; i < RM; ++i) a[i] = As[kk][ty + i * TR];
#pragma unroll
            for (int j = 0; j < RN; ++j) b[j] = Bs[kk][tx + j * TC];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
              for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
          __syncthreads();
        }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int gm = sm + ty + i * TR;
        if (gm >= m_hi) continue;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int gn = sn + tx + j * TC;
          if (gn < n_hi) C[(size_t)gm * N + gn] = from_f<TOut>(acc[i][j]);
        }
      }
    }
  }
}

struct SubTile {
  int sm, sn;
};
// must list the template configurations launch() instantiates, in order
constexpr int kConfigs = 9;
constexpr SubTile kSubTiles[kConfigs] = {{64, 64}, {16, 256}, {256, 16},
                                         {4, 1024}, {1, 1024}, {4, 64},
                                         {64, 4}, {1, 256}, {16, 16}};

struct Plan {
  int tm, tn, config, ctas;
};

Plan make_plan(int M, int N, int bm, int bn, int order_nm, int sms) {
  bm = bm < M ? bm : M;
  bn = bn < N ? bn : N;
  int tm = bm, tn = bn;
  if ((long long)bm * bn < kThreads) {
    const int fast = order_nm ? cdiv(M, bm) : cdiv(N, bn);
    const long long ctas = (long long)cdiv(M, bm) * cdiv(N, bn);
    long long g = kThreads / (bm * bn);
    if (g > fast) g = fast;
    if (g > ctas / (2 * sms)) g = ctas / (2 * sms);
    if (g < 1) g = 1;
    if (order_nm) tm = bm * (int)g; else tn = bn * (int)g;
  }
  int best = 0;
  long long best_pad = -1;
  for (int c = 0; c < kConfigs; ++c) {
    const long long pad = (long long)cdiv(tm, kSubTiles[c].sm) * kSubTiles[c].sm *
                          cdiv(tn, kSubTiles[c].sn) * kSubTiles[c].sn;
    if (best_pad < 0 || pad < best_pad) {
      best_pad = pad;
      best = c;
    }
  }
  return Plan{tm, tn, best, cdiv(M, tm) * cdiv(N, tn)};
}

template <typename TIn, typename TOut>
void launch(const Plan& p, const void* a, const void* b, void* c, int M, int K,
            int N, int bk, int order_nm, int trans_b, cudaStream_t s) {
  const TIn* A = static_cast<const TIn*>(a);
  const TIn* B = static_cast<const TIn*>(b);
  TOut* C = static_cast<TOut*>(c);
  const dim3 grid(p.ctas), block(kThreads);
#define LT_LAUNCH(TR, TC, RM, RN, KC)                                              \
  tiled_matmul<TIn, TOut, TR, TC, RM, RN, KC><<<grid, block, 0, s>>>(              \
      A, B, C, M, K, N, bk, p.tm, p.tn, order_nm, trans_b)
  switch (p.config) {
    case 0: LT_LAUNCH(16, 16, 4, 4, 32); break;
    case 1: LT_LAUNCH(4, 64, 4, 4, 32); break;
    case 2: LT_LAUNCH(64, 4, 4, 4, 32); break;
    case 3: LT_LAUNCH(1, 256, 4, 4, 8); break;
    case 4: LT_LAUNCH(1, 256, 1, 4, 8); break;
    case 5: LT_LAUNCH(4, 64, 1, 1, 128); break;
    case 6: LT_LAUNCH(64, 4, 1, 1, 128); break;
    case 7: LT_LAUNCH(1, 256, 1, 1, 32); break;
    default: LT_LAUNCH(16, 16, 1, 1, 128); break;
  }
#undef LT_LAUNCH
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1)
    sms = 132;
  return sms;
}

// ---------------------------------------------------------------------------
// "wgmma" route: bf16 operands on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kChunk = 64;      // k values of a 128-byte swizzle row
constexpr int kTcSmem = 232448;                 // dynamic shared memory a block may use
constexpr int kTcRing = kTcSmem - 1024;         // less the 1024-byte alignment slack
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
  // the attribute is set once a device, at the most any plan asks for
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(tc_matmul<TM, TN, TB, KS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }
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
// columns, out[3] = k chunks a ring stage ("wgmma") or the register sub-tile
// configuration, an index into kSubTiles ("simt"), out[4] = ring stages
// ("wgmma", else 0), out[5] = number of CTAs, out[6] = warpgroups that
// split K ("wgmma", else 0).
int looptune_matmul_plan(int M, int K, int N, int bm, int bk, int bn, int order_nm,
                         int bf16, int* out) {
  if (M < 1 || K < 1 || N < 1 || bm < 1 || bk < 1 || bn < 1)
    return (int)cudaErrorInvalidValue;
  if (tc_eligible(K, N, bf16)) {
    const TcPlan p = tc_plan(M, K, N, bm, bk, bn);
    const int v[7] = {1, p.tm, p.tn, p.kc, p.stages, p.ctas, p.ks};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
  } else {
    const Plan p = make_plan(M, N, bm, bn, order_nm, sm_count());
    const int v[7] = {0, p.tm, p.tn, p.config, 0, p.ctas, 0};
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
  const Plan p = make_plan(M, N, bm, bn, order_nm, sm_count());
  bk = bk < K ? bk : K;
  if (in_bf16) {
    if (out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(p, a, b, c, M, K, N, bk, order_nm, trans_b, s);
    else
      launch<__nv_bfloat16, float>(p, a, b, c, M, K, N, bk, order_nm, trans_b, s);
  } else {
    if (out_bf16)
      launch<float, __nv_bfloat16>(p, a, b, c, M, K, N, bk, order_nm, trans_b, s);
    else
      launch<float, float>(p, a, b, c, M, K, N, bk, order_nm, trans_b, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
