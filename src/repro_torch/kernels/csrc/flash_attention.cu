// Flash attention forward for Hopper (sm_90a): online-softmax attention over
// q (B, S, H, D) and k, v (B, T, HKV, D), with causal masking, a sliding
// window, a score softcap and grouped-query heads.
//
// Replaces: repro/kernels/flash_attention.py::_fa_kernel (launched by
// `flash_attention`), the Pallas TPU kernel.  It computes the same function
// for every argument that kernel takes, not the same block structure:
//   * one CTA per (b*h, q tile); a loop over kv tiles inside the CTA takes
//     the place of the TPU's sequential n_kv grid dimension.  m, l and the
//     accumulator are f32 in registers;
//   * q, k and v are read through their (b, s, h) strides with the head dim
//     contiguous, and the kv head is h / (H / HKV): no repeat copies of k/v
//     for GQA, no transposes and no padding copies.  Ragged S and T are
//     masked in the kernel;
//   * the softcap is cap * tanh(s / cap); masked scores are NEG_INF = -1e30;
//     l is clamped to >= 1e-30; out is in q's dtype;
//   * kv tiles that lie wholly outside the causal/window mask of every row
//     of the q tile are skipped.  That changes no row with a visible key: in
//     the TPU kernel a masked tile before the first visible one is scaled
//     away by alpha = exp(-1e30 - m) = 0, and one after it adds p = 0.
//   * with an lse pointer (training: the backward's input), each row's
//     log-sum-exp m + log(max(l, 1e-30)) goes to lse (B, H, S) f32, with the
//     l the row is divided by (T_pad for a row with no visible key), as
//     repro/models/layers.py::_flash_fwd_impl returns it; serving passes
//     none and writes nothing more;
//   * a row with no visible key (a window that ends before T, or S > T with
//     a window) is left as the TPU kernel leaves it: there m stays -1e30, so
//     p = exp(0) = 1 at every position of the zero-padded kv range, and the
//     row is sum(v[0:T]) / T_pad with T_pad = cdiv(T, bk) * bk for the
//     registry's bk (clamped to T).  A q tile that holds such a row visits
//     every kv tile (fully masked rows are always a suffix of the q rows),
//     and the epilogue divides by T_pad.
//
// Two routes, chosen by (dtype, D) alone (`plan` below):
//
// "wgmma" — bf16 at D = 64 (musicgen-large), 96 (phi3-mini), 128 (jamba-v0.1-52b
//   and most of the zoo) and 256 (gemma3-12b), on the tensor cores, by two
//   kernels: flash_fwd_tc at D = 64 and 128, flash_fwd_ws at D = 96 and 256
//   (below).  flash_fwd_tc:
//   * one or two consumer warpgroups a CTA, each owning 64 q rows of one
//     (b, h); no producer warp: all threads issue the loads;
//   * S = Q·Kᵀ by wgmma.mma_async m64nNk16 (N = the kv tile), bf16 operands
//     read from shared memory in their natural K-major layout (head dim
//     contiguous), f32 accumulation; 1/sqrt(D) multiplies the f32 score after
//     the product (a bf16 x bf16 product is exact in f32, and q·scale rounded
//     to bf16 would add an error the reference lacks: 1/sqrt(128) is not a
//     power of two);
//   * the online softmax runs on the accumulator fragments: a thread holds
//     two rows, each spread over a quad of lanes, so row max and row sum are
//     two xor-shuffles (l is summed per thread and reduced once at the end);
//     exp is exp2f((s - m) * log2 e), the difference first, so a row that has
//     seen only -1e30 gets p = exp2(0) = 1 exactly, as in the TPU kernel;
//   * O += P·V by wgmma m64n64k16 per 64-column chunk of the head dim, with
//     P rounded to bf16 in registers as the A operand (the f32 accumulator
//     layout packs pairwise into the A fragment) and V read from shared
//     memory as an MN-major B operand (transpose bit), from its (kv, D)
//     layout as loaded.  Rounding p to bf16 is what the JAX model's own
//     attention does (repro/models/layers.py:164, p.astype(v_blk.dtype));
//     the Pallas kernel keeps p in f32, and the bf16 limit of 3e-2 covers
//     the difference;
//   * Q is loaded once; K and V go through a ring of two shared-memory
//     stages by 16-byte cp.async with zero fill, written straight into the
//     128-byte-swizzled layout the wgmma descriptors read (hopper.cuh): tile
//     j+1 is in flight while tile j is multiplied.  cp.async rather than TMA:
//     the strided (B, T, HKV, D) views, the GQA head index and the zero fill
//     past T come from plain addresses, with no tensor map to encode a call
//     and no driver entry point to link;
//   * block mapping: the "fa" registry block (bq, bk), clamped to (S, T),
//     becomes q tile = 64 if bq <= 64 else 128 (one or two warpgroups) and
//     kv tile = the power of two >= bk in [16, 4096 / W], W the staged width
//     (wgmma's N: 16, 32 or 64 at D = 64; 16 or 32 at D = 128).  The cap
//     is the largest tile at
//     which ptxas keeps a thread within ~128 registers (117 at D = 64 x 64
//     keys, 128 at D = 128 x 32), so two CTAs of 256 threads fit an SM: the
//     loop is latency-bound (one tile's products, softmax and the next
//     loads run one after another in each warpgroup), and four warpgroups an
//     SM hide more of it than two with larger tiles.  Measured on an H100
//     SXM (700 W) at jamba's prefill (4, 1024, 32/8, 128): 0.163 ms at
//     128 x 32 against 0.193 ms at 128 x 128 (201 registers); at D = 64 a
//     128-key tile takes 165 registers, one CTA an SM.  bk also sets T_pad
//     above.  The default (128, 128) is 128 x 64 at D = 64 and 128 x 32 at
//     D = 128 (shared memory: Q 32 KB + 2 stages x (K + V) 32 KB);
//   * K/V rows past the CTA's last visible key, and Q rows past S, are zero
//     filled; ragged S and T are masked as on the SIMT route.  A warpgroup
//     skips the kv tiles outside its own rows' range; the whole fence, issue
//     and wait sequence sits inside that branch, so ptxas serialises no
//     wgmma.
//   Bound on this card: max(bytes / 3.35 TB/s, 4*B*H*D*(visible pairs) /
//   989 TFLOP/s).  At jamba's prefill (4, 1024, 32/8, 128) the 34.4 GFLOP of
//   visible pairs bound it (34.8 us), at musicgen's (4, 256, 32, 64) the
//   16.8 MB of q, k, v and o (5.0 us).  flash_fwd_tc has no warp
//   specialisation, setmaxnreg or TMA (flash_fwd_ws has).  Overlapping a
//   tile's softmax with the previous tile's P·V (K one tile ahead of V in
//   the ring, two warpgroups and no producer) measured no faster on the
//   card and was not kept.
//   flash_fwd_ws, at D = 96 and 256 (phi3-mini's and gemma3-12b's heads):
//   * warp-specialised: one CTA of three warpgroups a (b, h, 128 q rows).
//     Warpgroups 0 and 1 are the consumers of 64 q rows each, raised to 240
//     registers by setmaxnreg; warpgroup 2 is the producer, lowered to 24,
//     one thread of which issues every load (168 x 384 at launch, one CTA
//     an SM).  ptxas gives the consumers their 240 only because no block is
//     shared between the roles: the barrier waits poll and trap inside one
//     PTX block (hopper.cuh's mbar_wait).  With the trap a C-level branch to
//     one block, every wait site was held to the launch's 168 and D = 256
//     spilled 528-880 bytes a thread;
//   * loads by TMA (cp.async.bulk.tensor.4d) through tensor maps over the
//     strided (B, S|T, H|HKV, D) views, encoded each launch by
//     cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint and
//     passed as __grid_constant__ parameters: the head dim first, the other
//     three by stride; the GQA head is a coordinate (h / G).  Q lands once;
//     K and V go through a ring of stages (as many as fit, at most 4), each
//     with a full mbarrier (the producer's expect_tx) and an empty one a
//     consumer, so that S of a tile starts as soon as its K lands.  A
//     consumer waits for and releases only the tiles of its own run of the
//     CTA's range; the producer refills a stage once each consumer whose
//     run held it has let it go.  TMA zero-fills only past S and T: the
//     keys between the CTA's last visible one and the tile's end are real,
//     and the mask (and the `full` test, false for any tile that reaches
//     past kv_hi) removes them; a row that sees no key still visits all of
//     [0, T), where only rows past T are zero, and gets sum(v[0:T]) / T_pad;
//   * no padded column: at D = 256 the head dim is 4 chunks of 64 under the
//     128-byte swizzle; at D = 96 it is 3 chunks of 32 under the 64-byte
//     swizzle (rows of 64 bytes), so Q·Kᵀ runs its six k16 steps on 64-byte
//     K-major descriptors (SBO 512) and P·V is one m64n96k16 a k-step, V
//     MN-major over the three chunks (LBO the chunk stride, SBO 512);
//   * tiles: 128 q rows x 64 keys at D = 256 (S 32 f32 registers a thread,
//     P 16, O 128; Q 64 KB + 2 stages of K and V 32 KB each = 197,736 bytes
//     with the barriers); at D = 96, 64 keys for bk <= 64 and 128 above (S
//     64, P 32, O 48; 4 stages, 222,408 bytes).  O += P·V is one m64nDk16 a
//     k-step (n256 or n96) with P from registers, V MN-major;
//   * overlap (kWsMode): S of tile j + 1 and P·V of tile j are issued
//     together and tile j + 1's softmax runs while P·V does (wgmma_wait<1>),
//     and the two consumers take turns at issuing their products through
//     two named barriers, one's softmax under the other's products; turns
//     are counted by kv tile, so that a consumer outside its run still takes
//     its turns and never waits on a tile past the turn it is at;
//   * everything else as flash_fwd_tc: the strided views, GQA, ragged S and
//     T, causal, window, softcap, -1e30 masks, l >= 1e-30, 1/sqrt(D) on the
//     f32 score (without a softcap folded into the exponent's one FFMA), p
//     rounded to bf16 for P·V, the optional lse, causal tiles longest first.
//   Bound: as flash_fwd_tc's.  ptxas -v: 168 registers at launch (the
//   consumers run at up to 240), no spill, HGMMA 20 / 28 / 40 in
//   <96, 64> / <96, 128> / <256, 64>.  Measured on an H100 SXM (700 W),
//   causal, bf16 (chip_smoke.py's timing_flash; the overlap modes from
//   benchmarks/port/flash_fwd_plans.py):
//     phi3-mini (4, 1024, 32/32, 96): 0.118 ms (flash_fwd_tc, 128 padded
//       columns: 0.150; SDPA 0.087; bound 0.030, bytes);
//     gemma3-12b (4, 1024, 16/8, 256): 0.106 ms (0.240; SDPA 0.091; bound
//       0.035); at its training shape (2, 4096, 16/8, 256) 0.481 ms causal
//       (1.514; SDPA 0.461; bound 0.278) and 0.271 with the window of 1024
//       (0.766; bound 0.122).
//     The overlap modes lie within 1-6 % of each other: mode 0 (none)
//     0.1203 / 0.1112 / 0.5179 / 0.2842 ms at those four shapes, mode 1
//     0.1202 / 0.1088 / 0.4850 / 0.2716, mode 2 (turns only) 0.1194 /
//     0.1113 / 0.5170 / 0.2848, mode 3 (both) 0.1182 / 0.1078 / 0.4891 /
//     0.2744; both are kept (kWsMode = 3).  At D = 96 a 64-key tile ran
//     0.1207 against 0.1182 for 128 keys.  Tried in exploratory runs and
//     not kept: a persistent variant (one CTA an SM walking the work items,
//     the next item's Q loaded under the last one's P·V), no faster at the
//     prefill shapes and slower at the training ones; skipping the rescale
//     when no row of a warp moved its max (a vote), slower; a second copy
//     of the softmax without the mask for wholly visible tiles, slower
//     with the earlier per-score mask than masking every tile.
//
// "simt" — f32 at every D, and bf16 at D = 8, 16, 32 (the JAX kernel tests'
//   head dims, which no model here uses; D = 8 would need zero padding to
//   wgmma's depth of 16): f32 FMAs from shared memory.  f32 stays there
//   because the f32 limit is 3e-5 (the JAX kernel tests') and TF32 products
//   keep about 3 decimal digits.  1/sqrt(D) multiplies the f32 score after
//   the product, as on the "wgmma" route, so that Q is staged as it is; p
//   stays f32 for the p @ v product.
//   * 256 threads, 16 (ty) x 16 (tx).  A thread owns the q rows 64 i + 4 ty
//     + e (e < 4, i < TQ / 64) of both products, so the row statistics and
//     the alpha rescale stay in its registers; score columns tx + 16 j
//     (j < TK / 16) and output columns 64 c + 4 tx + e (only those below D:
//     at D < 64 the lanes with 4 tx < D, at D = 96 the second run on lanes
//     tx < 8, the others multiplying zeros).  At 128 x 64 that is an 8 x 4
//     score tile and an 8 x 4 (D = 64) or 8 x 8 (D = 128) output tile;
//   * S = Q·Kᵀ reads Q and K head-dim-contiguous as float4: at 8 x 4, 12
//     loads feed 128 FMAs.  Rows are padded by 4 floats, an odd number of
//     16-byte units, so the 16 K rows a half-warp reads lie in distinct bank
//     groups, and a half-warp reads one Q row (a broadcast);
//   * the softmax runs on the score registers: the row max over the 16 lanes
//     of a half-warp is four xor-shuffles, and l is summed per thread and over
//     the lanes once at the end; exp is ex2.approx (hopper.cuh) on
//     (s - m) log2 e, the difference first, so a row that has seen only
//     -1e30 gets p = 1 exactly; a kv tile wholly visible to every row of the
//     CTA skips the mask;
//   * P is written transposed, (kv, q) with rows padded by 4 floats, a float4
//     of 4 rows a (thread, column), so that O += P·V reads P and V as float4:
//     at 8 x 4, 3 loads feed 32 FMAs; at 8 x 8, 4 feed 64;
//   * K and V go through a two-stage cp.async ring (16-byte copies where the
//     bases and strides are 16-byte multiples, else 4-byte; bf16 widened
//     through registers), zero-filled past the CTA's last visible key: tile
//     j+1 is in flight while tile j is multiplied.  Q is staged the same way
//     once, with the first tile.  Causal q tiles run longest first;
//   * block mapping: q tile TQ = 64 if bq <= 64 or D = 256, else 128; kv
//     tile TK = the power of two >= bk in [16, 64], halved while Q, two (K, V)
//     stages and P (4 (TQ (D + 4) + 4 TK (D + 4) + TK (TQ + 4)) bytes) exceed
//     232,448 bytes: the default (128, 128) runs 128 x 64 at D <= 96 (138,240
//     bytes at D = 64, 187,392 at D = 96, one CTA an SM), 128 x 32 at
//     D = 128 and 64 x 32 at D = 256 (208,384 bytes).  At D = 256 a 128-row
//     q tile holds 128 accumulators a thread and ptxas spilled it (255
//     registers, 52 bytes of spill stores, on an H100 SXM at 700 W), so
//     that route has no 128-row instance.
//
// Head dims with an instance: 8, 16, 32, 64, 96, 128 and 256 (the JAX kernel
// tests' and the model zoo's); the plan refuses any other D.
//   Bound on this card: max(bytes / 3.35 TB/s, 4*B*H*D*(visible pairs) /
//   67 TFLOP/s of f32 FMAs): at musicgen's (4, 256, 32, 64) in f32, causal,
//   the 1.08 GFLOP of visible pairs, 16.1 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

inline int cdiv(int x, int y) { return (x + y - 1) / y; }
inline int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

struct Args {
  int S, T, H, G;                 // G = H / HKV
  long long qsb, qss, qsh;        // element strides of q (head dim contiguous)
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  float scale, softcap;           // softcap <= 0: none
  int causal, has_window, window; // window clamped to [-(S+T), S+T]
  int t_pad;                      // cdiv(T, bk) * bk
  int vec_q, vec_kv;              // SIMT route: f32 q / k and v rows on 16-byte boundaries
  float* lse;                     // (B, H, S) f32 log-sum-exp, or null
};

// the keys row qi sees are [vis_lo, vis_hi); both ends grow with qi
__device__ __forceinline__ int vis_lo(const Args& a, int qi) {
  return a.has_window ? max(0, qi - a.window + 1) : 0;
}
__device__ __forceinline__ int vis_hi(const Args& a, int qi) {
  return a.causal ? min(a.T, qi + 1) : a.T;
}

// ---------------------------------------------------------------------------
// "simt" route: f32 at every D, bf16 at D = 8, 16, 32
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;  // 16 (ty) x 16 (tx)
constexpr int kPad = 4;            // floats a staged row is padded by
constexpr int kSmemMax = 232448;   // dynamic shared memory a CTA can have

// Q [TQ][D + 4], two stages of K and V [TK][D + 4], P transposed [TK][TQ + 4]
__host__ __device__ constexpr size_t simt_smem_bytes(int d, int tq, int tk) {
  return sizeof(float) * (size_t)(tq * (d + kPad) + 4 * tk * (d + kPad) + tk * (tq + kPad));
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(x[0], x[1]);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(x[2], x[3]);
}

// rows [k0, k0 + TK) of one Q, K or V head into dst [TK][D + kPad] f32, rows
// >= kv_hi zero: f32 by 16-byte cp.async (vec) or 4-byte cp.async, bf16
// through registers, widened
template <typename T, int D, int TK>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ss, int k0,
                                           int kv_hi, int vec, int tid) {
  using namespace hopper;
  constexpr int DP = D + kPad;
  if constexpr (sizeof(T) == 2) {
    for (int e = tid; e < TK * D; e += kSimtThreads) {
      const int r = e / D, d = e % D, kj = k0 + r;
      dst[r * DP + d] = kj < kv_hi ? to_f(src[kj * ss + d]) : 0.f;
    }
  } else if (vec) {
    for (int e = tid; e < TK * (D / 4); e += kSimtThreads) {
      const int r = e / (D / 4), d = 4 * (e % (D / 4)), kj = k0 + r;
      const bool in = kj < kv_hi;
      cp_async16(smem_u32(dst + r * DP + d), in ? src + kj * ss + d : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < TK * D; e += kSimtThreads) {
      const int r = e / D, d = e % D, kj = k0 + r;
      const bool in = kj < kv_hi;
      cp_async4(smem_u32(dst + r * DP + d), in ? src + kj * ss + d : src, in ? 4 : 0);
    }
  }
}

// One (b, h, TQ q rows) a CTA, the kv tiles of its visible range in turn.
// Thread (ty, tx) owns the q rows 64 (i / 4) + 4 ty + i % 4 (i < TQ / 16) of
// both products, score columns tx + 16 j (j < TK / 16) and output columns
// 64 c + 4 tx + e (c < QD, e < 4; below D only).
template <typename T, int D, int TQ, int TK>
__global__ void __launch_bounds__(kSimtThreads, 1)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, const Args a) {
  using namespace hopper;
  constexpr int DP = D + kPad, PP = TQ + kPad;
  constexpr int RQ = TQ / 16;        // q rows a thread
  constexpr int CK = TK / 16;        // score columns a thread
  constexpr int QD = (D + 63) / 64;  // runs of 4 output columns a thread
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);  // [TQ][DP]
  float* const KV = Qs + TQ * DP;                      // [2][K, V][TK][DP]
  float* const Pt = KV + 4 * TK * DP;                  // [TK][PP]: P transposed

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * TQ;  // longest causal tiles first
  const int last = min(q0 + TQ, a.S) - 1;
  // output columns 64 c + 4 tx .. + 3 exist below D only: below D = 64 some
  // lanes hold none, and at D = 96 the second run is held by lanes tx < 8
  auto cols_ok = [&](int c) { return D % 64 == 0 || 64 * c + 4 * tx < D; };
  const bool has_cols = cols_ok(0);
  const T* const qb = q + b * a.qsb + h * a.qsh;
  const T* const kb = k + b * a.ksb + (h / a.G) * a.ksh;
  const T* const vb = v + b * a.vsb + (h / a.G) * a.vsh;
  auto row = [&](int i) { return 64 * (i / 4) + 4 * ty + i % 4; };

  // Keys row qi sees: [lo(qi), hi(qi)).  Both ends grow with qi, so the
  // tile needs [lo(q0), hi(last)) unless its last row sees nothing; then it
  // visits all of [0, T) (a row that sees nothing is sum(v) / T_pad).
  int kv_lo = 0, kv_hi = a.T;
  if (vis_lo(a, last) < vis_hi(a, last)) {
    kv_lo = vis_lo(a, q0);
    kv_hi = vis_hi(a, last);
  }
  const int n_tiles = (kv_hi - kv_lo + TK - 1) / TK;
  auto load_kv = [&](int j) {  // kv tile j into ring stage j % 2
    float* const st = KV + (j & 1) * 2 * TK * DP;
    stage_rows<T, D, TK>(st, kb, a.kss, kv_lo + j * TK, kv_hi, a.vec_kv, tid);
    stage_rows<T, D, TK>(st + TK * DP, vb, a.vss, kv_lo + j * TK, kv_hi, a.vec_kv, tid);
  };
  stage_rows<T, D, TQ>(Qs, qb, a.qss, q0, a.S, a.vec_q, tid);  // Q once, rows past S zero
  load_kv(0);
  cp_async_commit();

  float acc[RQ][4 * QD], m[RQ], l[RQ];  // l: this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * QD; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_lo + j * TK;
    cp_async_wait<0>();  // this thread's copies of tile j landed
    // every thread's copies of tile j (and Q) landed, and every thread is
    // done with tile j - 1: its ring stage and P are free
    __syncthreads();
    if (j + 1 < n_tiles) load_kv(j + 1);  // in flight while tile j is multiplied
    cp_async_commit();
    const float* const Ks = KV + (j & 1) * 2 * TK * DP;
    const float* const Vs = Ks + TK * DP;

    float s[RQ][CK];  // S = Q Kᵀ, the head dim in order
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int jj = 0; jj < CK; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qa[RQ], kk[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + row(i) * DP + d);
#pragma unroll
      for (int jj = 0; jj < CK; ++jj)
        kk[jj] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * jj) * DP + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int jj = 0; jj < CK; ++jj) {
          s[i][jj] = fmaf(qa[i].x, kk[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qa[i].y, kk[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qa[i].z, kk[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qa[i].w, kk[jj].w, s[i][jj]);
        }
    }

    // every key of the tile visible to every row of the CTA: no mask
    const bool full = k0 + TK <= a.T && (!a.causal || k0 + TK - 1 <= q0) &&
                      (!a.has_window || k0 > last - a.window);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + row(i);
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < CK; ++jj) {
        float x = s[i][jj] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        if (!full) {
          const int kj = k0 + tx + 16 * jj;
          const bool vis = qi < a.S && kj < a.T && (!a.causal || kj <= qi) &&
                           (!a.has_window || kj > qi - a.window);
          x = vis ? x : kNegInf;
        }
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the 16 lanes of the half-warp that hold row i
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2_approx((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < CK; ++jj) {
        const float p = ex2_approx((s[i][jj] - m_new) * kLog2e);
        s[i][jj] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < 4 * QD; ++c) {
        acc[i][c] *= alpha;  // the SIMT accumulator's alpha rescale
      }
    }
#pragma unroll
    for (int i4 = 0; i4 < RQ / 4; ++i4)  // P transposed: a float4 of 4 rows a column
#pragma unroll
      for (int jj = 0; jj < CK; ++jj)
        *reinterpret_cast<float4*>(Pt + (tx + 16 * jj) * PP + 64 * i4 + 4 * ty) =
            make_float4(s[4 * i4][jj], s[4 * i4 + 1][jj], s[4 * i4 + 2][jj], s[4 * i4 + 3][jj]);
    __syncthreads();  // P is whole

    if (has_cols) {  // O += P V, the keys in order
#pragma unroll 4
      for (int kk = 0; kk < TK; ++kk) {
        float4 pa[RQ / 4], vv[QD];
#pragma unroll
        for (int i4 = 0; i4 < RQ / 4; ++i4)
          pa[i4] = *reinterpret_cast<const float4*>(Pt + kk * PP + 64 * i4 + 4 * ty);
#pragma unroll
        for (int c = 0; c < QD; ++c)
          vv[c] = cols_ok(c) ? *reinterpret_cast<const float4*>(Vs + kk * DP + 64 * c + 4 * tx)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < 4 * QD; ++c)
            acc[i][c] = fmaf(lane4(pa[i / 4], i % 4), lane4(vv[c / 4], c % 4), acc[i][c]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + row(i);
    if (qi >= a.S || !has_cols) continue;
    const float lv = fmaxf(vis_lo(a, qi) < vis_hi(a, qi) ? l[i] : (float)a.t_pad, 1e-30f);
    if (a.lse != nullptr && tx == 0) a.lse[((long long)b * a.H + h) * a.S + qi] = m[i] + logf(lv);
    T* const orow = o + (((long long)b * a.S + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < QD; ++c) {
      if (!cols_ok(c)) continue;
      const float out[4] = {acc[i][4 * c] / lv, acc[i][4 * c + 1] / lv, acc[i][4 * c + 2] / lv,
                            acc[i][4 * c + 3] / lv};
      store4(orow + 64 * c + 4 * tx, out);
    }
  }
}

// ---------------------------------------------------------------------------
// "wgmma" route, kernel flash_fwd_tc: bf16 at D = 64 and 128
// ---------------------------------------------------------------------------

constexpr int kWG = 128;      // threads of a warpgroup
constexpr int kWgRows = 64;   // q rows of a warpgroup: wgmma's M
// the head dim as staged: whole 64-column swizzle chunks
__host__ __device__ constexpr int tc_width(int d) { return (d + 63) / 64 * 64; }
// kv tile <= kTcKvCap / tc_width(D): 64 keys at D = 64, 32 at D = 128
constexpr int kTcKvCap = 4096;
constexpr size_t tc_smem_bytes(int d, int qt, int tk) {
  return 1024 + (size_t)tc_width(d) * 2 * (qt + 4 * tk);  // alignment slack, Q, 2 x (K, V)
}

template <int D, int TK>
__global__ void __launch_bounds__(2 * kWG, 1)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             const Args a) {
  using namespace hopper;
  constexpr int NC = tc_width(D) / 64;  // 64-column chunks of the head dim as staged
  constexpr int PR = D / 8;             // 16-byte pieces of a row
  constexpr int NS = TK / 2;          // score registers a thread
  constexpr uint32_t CHUNK = TK * 128;        // bytes of one chunk of a K or V tile
  constexpr uint32_t TILE = NC * CHUNK;       // bytes of a K or V tile
  extern __shared__ uint8_t smem_raw[];

  const int nthr = blockDim.x;
  const int qt = nthr / kWG * kWgRows;                    // q rows of the CTA
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NC][qt rows]
  const uint32_t sKV = sQ + (uint32_t)(NC * qt * 128);       // [2][K, V][NC][TK rows]

  const int tid = threadIdx.x;
  const int wg = tid / kWG, warp = (tid % kWG) / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * qt;  // longest causal tiles first
  const int last = min(q0 + qt, a.S) - 1;

  const __nv_bfloat16* qb = q + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* kb = k + b * a.ksb + (h / a.G) * a.ksh;
  const __nv_bfloat16* vb = v + b * a.vsb + (h / a.G) * a.vsh;

  // the CTA's kv range, as the SIMT kernel's: [lo(q0), hi(last)) unless its
  // last row sees nothing, then all of [0, T)
  int kv_lo = 0, kv_hi = a.T;
  if (vis_lo(a, last) < vis_hi(a, last)) {
    kv_lo = vis_lo(a, q0);
    kv_hi = vis_hi(a, last);
  }
  // this warpgroup's rows [w0, w1] and kv range, by the same rule; a
  // warpgroup with no row below S has an empty range
  const int w0 = q0 + wg * kWgRows, w1 = min(w0 + kWgRows, a.S) - 1;
  int wk_lo = 1, wk_hi = 0;
  if (w0 <= w1) {
    wk_lo = 0;
    wk_hi = a.T;
    if (vis_lo(a, w1) < vis_hi(a, w1)) {
      wk_lo = vis_lo(a, w0);
      wk_hi = vis_hi(a, w1);
    }
  }

  for (int e = tid; e < qt * PR; e += nthr) {  // Q once, rows past S zero
    const int r = e / PR, c = e % PR;
    const int qi = q0 + r;
    const bool in = qi < a.S;
    cp_async16(sQ + (uint32_t)((c >> 3) * qt * 128) + sw128(r, c & 7),
               qb + (long long)(in ? qi : 0) * a.qss + c * 8, in ? 16 : 0);
  }
  auto load_kv = [&](int k0, uint32_t st) {  // rows past kv_hi zero
    for (int e = tid; e < TK * PR; e += nthr) {
      const int r = e / PR, c = e % PR;
      const int kj = k0 + r;
      const bool in = kj < kv_hi;
      const long long row = in ? kj : 0;
      const uint32_t off = (uint32_t)(c >> 3) * CHUNK + sw128(r, c & 7);
      cp_async16(st + off, kb + row * a.kss + c * 8, in ? 16 : 0);
      cp_async16(st + TILE + off, vb + row * a.vss + c * 8, in ? 16 : 0);
    }
  };
  const int n_tiles = (kv_hi - kv_lo + TK - 1) / TK;
  load_kv(kv_lo, sKV);
  cp_async_commit();  // group 0: Q and the first kv tile

  float acc[NC][32];  // O, 64 rows x D a warpgroup, by 64-column chunk
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows rA and rB
  const int rA = w0 + warp * 16 + lane / 4, rB = rA + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t sQw = sQ + (uint32_t)(wg * kWgRows * 128);  // this warpgroup's Q rows

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_lo + j * TK;
    const uint32_t st = sKV + (uint32_t)(j & 1) * 2 * TILE;
    if (j + 1 < n_tiles) load_kv(k0 + TK, sKV + (uint32_t)((j + 1) & 1) * 2 * TILE);
    cp_async_commit();  // (empty on the last tile: the count below stays right)
    cp_async_wait<1>();  // tile j (and Q) landed, tile j+1 may still be in flight
    fence_proxy_async_shared();
    __syncthreads();

    if (k0 < wk_hi && k0 + TK > wk_lo) {  // uniform over the warpgroup
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t koff = (uint32_t)(ks & 3) * 32;
        wgmma_ss(s, desc_kmajor(sQw + (uint32_t)((ks >> 2) * qt * 128) + koff),
                 desc_kmajor(st + (uint32_t)(ks >> 2) * CHUNK + koff), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // every key of the tile visible to every row of the warpgroup: no mask
      const bool full = k0 + TK <= a.T && (!a.causal || k0 + TK - 1 <= w0) &&
                        (!a.has_window || k0 > w1 - a.window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = s[i] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        if (!full) {
          const int qi = (i & 2) ? rB : rA;
          const int kj = k0 + 8 * (i >> 2) + cq + (i & 1);
          const bool vis = qi < a.S && kj < a.T && (!a.causal || kj <= qi) &&
                           (!a.has_window || kj > qi - a.window);
          x = vis ? x : kNegInf;
        }
        s[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the quad that holds each row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f((m0 - mn0) * kLog2e), alpha1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float p = exp2f((s[i] - ((i & 2) ? mn1 : mn0)) * kLog2e);
        s[i] = p;
        if (i & 2) rs1 += p;
        else rs0 += p;
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          acc[c][i] *= (i & 2) ? alpha1 : alpha0;  // the accumulator's alpha rescale
        }
      uint32_t pa[TK / 16][4];  // P in bf16, the A fragments of the k-steps
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[ks][r] = pack_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_rs_n64_mn(acc[c], pa[ks],
                          desc_mnmajor(st + TILE + (uint32_t)c * CHUNK + (uint32_t)ks * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) fence_regs(pa[ks]);
    }
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? rB : rA;
    if (qi >= a.S) continue;
    const float l = fmaxf(vis_lo(a, qi) < vis_hi(a, qi) ? (half ? l1 : l0) : (float)a.t_pad,
                          1e-30f);
    if (a.lse != nullptr && lane % 4 == 0)
      a.lse[((long long)b * a.H + h) * a.S + qi] = (half ? m1 : m0) + logf(l);
    __nv_bfloat16* orow = o + (((long long)b * a.S + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int i = 4 * jb + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 64 + 8 * jb + cq) =
            __floats2bfloat162_rn(acc[c][i] / l, acc[c][i + 1] / l);
      }
  }
}

// ---------------------------------------------------------------------------
// "wgmma" route, kernel flash_fwd_ws: bf16 at D = 96 and 256, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWsThreads = 3 * kWG;  // two consumer warpgroups, then the producer
constexpr int kWsRows = 2 * kWgRows;   // q rows of a CTA
// the overlaps the consumers run: bit 0, S of tile j + 1 and P·V of tile j
// issued together, tile j + 1's softmax running under P·V; bit 1, the two
// consumer warpgroups take turns at issuing their products (named barriers)
constexpr int kWsMode = 3;
// the head dim in chunks of W values, one swizzle atom wide: W = 64 (rows of
// 128 bytes, the 128-byte swizzle) at D = 256, W = 32 (rows of 64 bytes, the
// 64-byte swizzle) at D = 96, so that no column is padded
__host__ __device__ constexpr int ws_chunk(int d) { return d % 64 == 0 ? 64 : 32; }
__host__ __device__ constexpr int ws_kv_tile(int d, int bk) {
  return d == 256 || bk <= 64 ? 64 : 128;
}
constexpr int kWsBarsMax = 1 + 6 * 4;  // Q's; full K, V and empty K, V of each consumer a stage
// K/V ring stages: as many as fit beside Q and the barriers, at most 4
__host__ __device__ constexpr int ws_stages(int d, int tk) {
  return (kSmemMax - 1024 - 8 * kWsBarsMax - kWsRows * d * 2) / (4 * tk * d) < 4
             ? (kSmemMax - 1024 - 8 * kWsBarsMax - kWsRows * d * 2) / (4 * tk * d)
             : 4;
}
// alignment slack, Q, the (K, V) ring, then the mbarriers
__host__ __device__ constexpr size_t ws_smem_bytes(int d, int tk) {
  return 1024 + (size_t)kWsRows * d * 2 + (size_t)ws_stages(d, tk) * 4 * tk * d +
         8 * (1 + 6 * ws_stages(d, tk));
}

// where a tensor map puts the (row, head, batch) coordinates: map dims 1..3;
// a head or batch dim of extent 1 or stride 0 has extent 1 in the map and
// takes coordinate 0 (h_on, b_on = 0)
struct TmaPlace {
  int s, h, b, h_on, b_on;
};
struct WsPlaces {
  TmaPlace q, k, v;
};

__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         const TmaPlace& p, int col, int row, int h, int b) {
  const int hv = p.h_on ? h : 0, bv = p.b_on ? b : 0;
  auto at = [&](int d) { return p.s == d ? row : p.h == d ? hv : bv; };
  hopper::tma_load_4d(dst, &map, bar, col, at(1), at(2), at(3));
}

// consumer cw's run of the CTA's kv tiles, [jlo, jhi): the tiles that hold a
// key one of its rows [w0, w1] sees (by the CTA's rule: all of [0, T) when
// its last row sees nothing); empty when it has no row below S
template <int TK>
__device__ __forceinline__ void ws_run(const Args& a, int q0, int cw, int kv_lo, int n_tiles,
                                       int& jlo, int& jhi) {
  const int w0 = q0 + cw * kWgRows, w1 = min(w0 + kWgRows, a.S) - 1;
  jlo = jhi = 0;
  if (w0 > w1) return;
  int lo = 0, hi = a.T;
  if (vis_lo(a, w1) < vis_hi(a, w1)) {
    lo = vis_lo(a, w0);
    hi = vis_hi(a, w1);
  }
  jlo = (lo - kv_lo) / TK;
  jhi = min(n_tiles, (hi - kv_lo + TK - 1) / TK);
  if (jhi < jlo) jhi = jlo;
}

// the accumulator's rescale by each row's alpha (two rows a thread)
template <int N>
__device__ __forceinline__ void ws_rescale(float (&acc)[N], float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] *= (i & 2) ? alpha1 : alpha0;  // the warp-specialised kernel's alpha rescale
  }
}

// One (b, h, 128 q rows) a CTA.  Warpgroup 2 is the producer: one thread
// loads Q once and the CTA's kv tiles by TMA into a ring of NST stages, K and
// V each with a full mbarrier a stage and an empty one a stage and consumer.
// Warpgroups 0 and 1 are the consumers, 64 q rows each: S = Q·Kᵀ
// (m64nTKk16, both operands from shared memory), the online softmax on the
// fragments, O += P·V (m64nDk16, P from registers, V MN-major).  A consumer
// waits for and releases only the tiles of its own run; the producer
// refills a stage once each consumer whose run held the stage's last tile
// has released it.  Turns (MODE bit 1) are counted by kv tile, n_tiles + 1
// a consumer, so that no consumer waits on a tile past the turn it is at.
template <int D, int TK, int MODE>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_ws(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
             const Args a, const WsPlaces pl) {
  using namespace hopper;
  constexpr int W = ws_chunk(D);                 // values a chunk row
  constexpr int NC = D / W;                      // chunks of the head dim
  constexpr uint32_t ROWB = 2 * W;               // bytes a chunk row
  constexpr uint32_t SBO = 8 * ROWB;             // bytes between 8-row groups
  constexpr int KS_CHUNK = W / 16;               // k16 steps of Q·Kᵀ a chunk
  constexpr int NST = ws_stages(D, TK);
  constexpr uint32_t QCH = kWsRows * ROWB, KCH = TK * ROWB;  // bytes a chunk of Q; of K or V
  constexpr uint32_t TILE = NC * KCH;            // bytes of a K or V tile
  constexpr int NS = TK / 2;                     // score registers a thread
  static_assert(NST >= 2, "the ring needs two stages");
  extern __shared__ uint8_t smem_raw[];

  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NC][128 rows]
  const uint32_t sK = sQ + NC * QCH;                          // [NST][NC][TK rows]
  const uint32_t sV = sK + NST * TILE;
  const uint32_t bars = sV + NST * TILE;
  const uint32_t qbar = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + NST + s); };
  auto empty_k = [&](int s, int c) { return bars + 8u * (1 + 2 * NST + 2 * s + c); };
  auto empty_v = [&](int s, int c) { return bars + 8u * (1 + 4 * NST + 2 * s + c); };

  // the warpgroup, broadcast from lane 0 so that the compiler sees it uniform
  // over the warp: the role branches below must be, for setmaxnreg to count
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kWsRows;  // longest causal tiles first
  const int last = min(q0 + kWsRows, a.S) - 1;
  // the CTA's kv range, as flash_fwd_tc's: [lo(q0), hi(last)) unless its
  // last row sees nothing, then all of [0, T).  TMA zero-fills only past T:
  // keys in [kv_hi, T) of the last tile are real, and the mask removes them
  int kv_lo = 0, kv_hi = a.T;
  if (vis_lo(a, last) < vis_hi(a, last)) {
    kv_lo = vis_lo(a, q0);
    kv_hi = vis_hi(a, last);
  }
  const int n_tiles = (kv_hi - kv_lo + TK - 1) / TK;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      for (int c = 0; c < 2; ++c) {
        mbar_init(empty_k(s, c), kWG);
        mbar_init(empty_v(s, c), kWG);
      }
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    setmaxnreg_dec<24>();
    if (tid == 2 * kWG) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      int jlo[2], jhi[2];
      ws_run<TK>(a, q0, 0, kv_lo, n_tiles, jlo[0], jhi[0]);
      ws_run<TK>(a, q0, 1, kv_lo, n_tiles, jlo[1], jhi[1]);
      const int hk = h / a.G;
      mbar_arrive_expect_tx(qbar, NC * QCH);  // Q once, rows past S zero
      for (int c = 0; c < NC; ++c) tma_tile(sQ + c * QCH, tq, qbar, pl.q, c * W, q0, h, b);
      // stage s is free for tile j once each consumer that held tile j - NST
      // released it: that was round (j - NST - jlo) / NST of its barrier
      auto wait_free = [&](int j, bool is_v) {
        const int jp = j - NST;
        for (int c = 0; c < 2; ++c)
          if (jp >= 0 && jlo[c] <= jp && jp < jhi[c])
            mbar_wait(is_v ? empty_v(j % NST, c) : empty_k(j % NST, c),
                      ((jp - jlo[c]) / NST) & 1);
      };
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NST, k0 = kv_lo + j * TK;
        wait_free(j, false);
        mbar_arrive_expect_tx(full_k(s), TILE);
        for (int c = 0; c < NC; ++c)
          tma_tile(sK + s * TILE + c * KCH, tk, full_k(s), pl.k, c * W, k0, hk, b);
        wait_free(j, true);
        mbar_arrive_expect_tx(full_v(s), TILE);
        for (int c = 0; c < NC; ++c)
          tma_tile(sV + s * TILE + c * KCH, tv, full_v(s), pl.v, c * W, k0, hk, b);
      }
    }
  } else {  // the consumers
    setmaxnreg_inc<240>();
    const int cw = wg, warp = (tid % kWG) / 32, lane = tid % 32;
    const int w0 = q0 + cw * kWgRows, w1 = min(w0 + kWgRows, a.S) - 1;
    int jlo, jhi;
    ws_run<TK>(a, q0, cw, kv_lo, n_tiles, jlo, jhi);
    const int rA = w0 + warp * 16 + lane / 4, rB = rA + 8;
    const int cq = 2 * (lane % 4);
    const uint32_t sQw = sQ + (uint32_t)(cw * kWgRows) * ROWB;  // this warpgroup's Q rows
    // the keys rows rA and rB see, [lo, hi), hi >= lo (empty past S and for a
    // row that sees nothing); a score's mask is one unsigned compare of its
    // key against them (the tile's first key and cq subtracted per tile)
    const int loA = rA < a.S ? vis_lo(a, rA) : 0, loB = rB < a.S ? vis_lo(a, rB) : 0;
    const int hiA = rA < a.S ? max(loA, vis_hi(a, rA)) : 0;
    const int hiB = rB < a.S ? max(loB, vis_hi(a, rB)) : 0;

    auto desc_k = [&](uint32_t addr) {  // K-major operands: Q, K
      return W == 64 ? desc_kmajor(addr) : desc_sw64(addr, 16, SBO);
    };
    auto wait_k = [&](int j) { mbar_wait(full_k(j % NST), (j / NST) & 1); };
    auto wait_v = [&](int j) { mbar_wait(full_v(j % NST), (j / NST) & 1); };
    // turn t (0..n_tiles): wait for the other consumer's turn to end, issue,
    // end this one (consumer 1 ends its last turn on no one's behalf)
    auto turn_begin = [&]() {
      if constexpr ((MODE & 2) != 0) named_bar_sync(1 + cw, 2 * kWG);
    };
    auto turn_end = [&](int t) {
      if constexpr ((MODE & 2) != 0) {
        if (!(cw == 1 && t == n_tiles)) named_bar_arrive(2 - cw, 2 * kWG);
      }
    };
    auto empty_turns = [&](int t0, int t1) {  // turns [t0, t1) that issue nothing
      if constexpr ((MODE & 2) != 0) {
        for (int t = t0; t < t1; ++t) {
          turn_begin();
          turn_end(t);
        }
      }
    };

    float acc[D / 2];  // O, 64 rows x D a warpgroup
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[NS];             // S of one tile, then its p
    uint32_t pa[TK / 16][4];  // P in bf16: the A fragments of P·V's k-steps
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows rA and rB

    // a k-step's descriptor is its operand's base descriptor plus the step's
    // byte offset / 16 (the start address field, bits [0, 14)).  The bases
    // pass through an empty asm each tile, so that the compiler cannot hoist
    // all 2 D / 16 step descriptors out of the loop into live registers
    const uint64_t q_desc = desc_k(sQw);
    auto issue_s = [&](int j) {  // S = Q·K_jᵀ, one commit group
      uint64_t qd = q_desc, kd = desc_k(sK + (j % NST) * TILE);
      asm volatile("" : "+l"(qd), "+l"(kd));
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t koff = (uint32_t)(ks % KS_CHUNK) * 32;
        wgmma_ss(sc, qd + (((uint32_t)(ks / KS_CHUNK) * QCH + koff) >> 4),
                 kd + (((uint32_t)(ks / KS_CHUNK) * KCH + koff) >> 4), 1);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {  // O += P·V_j, one commit group
      const uint32_t sv = sV + (j % NST) * TILE;
      uint64_t vd = W == 64 ? desc_mnmajor(sv, KCH) : desc_sw64(sv, KCH, SBO);
      asm volatile("" : "+l"(vd));
      fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) fence_regs(pa[ks]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks)
        wgmma_rs_mn(acc, pa[ks], vd + (((uint32_t)ks * 16 * ROWB) >> 4), 1);
      wgmma_commit();
    };
    // tile j's softmax on sc (its finished S): softcap, mask, the running
    // max and sum; sc becomes p, and each row's alpha is returned.  Without
    // a softcap the scores stay unscaled until the exponent: the max of
    // x * scale is max(x) * scale exactly (scale > 0, rounding is monotone),
    // and p = 2^(x * scale log2 e - m log2 e) is one FFMA and one ex2.  A row
    // whose max is still -1e30 (no visible key yet) takes (0, 0) there, so
    // that its p is 2^0 = 1 as (x - m) = 0 gives it.  Every tile is masked:
    // a tile known wholly visible would save the compares at the price of a
    // second copy of this code, which measured slower
    auto softmax = [&](int j, float& alpha0, float& alpha1) {
      fence_regs(sc);
      const int base = kv_lo + j * TK + cq;  // key of score register 0
      const int la = loA - base, na = hiA - loA, lb = loB - base, nb = hiB - loB;
      const float mult = a.softcap > 0.f ? 1.f : a.scale;  // sc's units to the score's
      if (a.softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = a.softcap * tanhf(sc[i] * a.scale / a.softcap);
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i >> 2) + (i & 1);  // the score's key - base
        const bool vis = (i & 2) ? (unsigned)(c - lb) < (unsigned)nb
                                 : (unsigned)(c - la) < (unsigned)na;
        const float x = vis ? sc[i] : kNegInf;
        sc[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the quad that holds each row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 == kNegInf ? kNegInf : mx0 * mult);
      const float mn1 = fmaxf(m1, mx1 == kNegInf ? kNegInf : mx1 * mult);
      alpha0 = ex2_approx((m0 - mn0) * kLog2e);
      alpha1 = ex2_approx((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      const float c0 = mn0 == kNegInf ? 0.f : mult * kLog2e, o0 = mn0 == kNegInf ? 0.f : -mn0 * kLog2e;
      const float c1 = mn1 == kNegInf ? 0.f : mult * kLog2e, o1 = mn1 == kNegInf ? 0.f : -mn1 * kLog2e;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float p = ex2_approx(fmaf(sc[i], (i & 2) ? c1 : c0, (i & 2) ? o1 : o0));
        sc[i] = p;
        if (i & 2) rs1 += p;
        else rs0 += p;
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
    };

    if constexpr ((MODE & 2) != 0) {
      if (cw == 1) named_bar_arrive(1, 2 * kWG);  // turn 0 is consumer 0's
    }
    mbar_wait(qbar, 0);
    float alpha0, alpha1;
    if constexpr ((MODE & 1) != 0) {
      // turn jlo issues S of tile jlo; turn j + 1 issues S of tile j + 1 and
      // P·V of tile j, and tile j + 1's softmax runs while P·V does
      empty_turns(0, jlo);
      if (jlo < jhi) {
        wait_k(jlo);
        turn_begin();
        issue_s(jlo);
        turn_end(jlo);
        wgmma_wait<0>();
        mbar_arrive(empty_k(jlo % NST, cw));
        softmax(jlo, alpha0, alpha1);
        pack_p();
        for (int j = jlo; j + 1 < jhi; ++j) {
          wait_k(j + 1);
          wait_v(j);
          turn_begin();
          issue_s(j + 1);
          issue_pv(j);
          turn_end(j + 1);
          wgmma_wait<1>();  // S of tile j + 1
          mbar_arrive(empty_k((j + 1) % NST, cw));
          softmax(j + 1, alpha0, alpha1);
          wgmma_wait<0>();  // P·V of tile j
          fence_regs(acc);
          mbar_arrive(empty_v(j % NST, cw));
          ws_rescale(acc, alpha0, alpha1);
          pack_p();
        }
        wait_v(jhi - 1);  // the last tile's P·V
        turn_begin();
        issue_pv(jhi - 1);
        turn_end(jhi);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty_v((jhi - 1) % NST, cw));
        empty_turns(jhi + 1, n_tiles + 1);
      } else {
        empty_turns(jlo, n_tiles + 1);
      }
    } else {
      // one tile at a time: S, its softmax, then P·V; turn j issues S of tile j
      empty_turns(0, jlo);
      for (int j = jlo; j < jhi; ++j) {
        wait_k(j);
        turn_begin();
        issue_s(j);
        turn_end(j);
        wgmma_wait<0>();
        mbar_arrive(empty_k(j % NST, cw));
        softmax(j, alpha0, alpha1);
        fence_regs(acc);
        ws_rescale(acc, alpha0, alpha1);
        pack_p();
        wait_v(j);
        issue_pv(j);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty_v(j % NST, cw));
      }
      empty_turns(jhi, n_tiles + 1);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = half ? rB : rA;
      if (qi >= a.S) continue;
      const float l = fmaxf(vis_lo(a, qi) < vis_hi(a, qi) ? (half ? l1 : l0) : (float)a.t_pad,
                            1e-30f);
      if (a.lse != nullptr && lane % 4 == 0)
        a.lse[((long long)b * a.H + h) * a.S + qi] = (half ? m1 : m0) + logf(l);
      __nv_bfloat16* orow = o + (((long long)b * a.S + qi) * a.H + h) * D;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int i = 4 * jb + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jb + cq) =
            __floats2bfloat162_rn(acc[i] / l, acc[i + 1] / l);
      }
    }
  }
}


// the SIMT q tile: 64 rows if bq <= 64, or at D > 128 (a 128-row tile spills)
__host__ __device__ constexpr int simt_q_tile(int d, int bq) { return bq <= 64 || d > 128 ? 64 : 128; }

template <typename T, int D, int TQ, int TK>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B, const Args& a,
                cudaStream_t s) {
  constexpr size_t smem = simt_smem_bytes(D, TQ, TK);
  if constexpr (smem > (size_t)kSmemMax || simt_q_tile(D, TQ) != TQ) {
    return (int)cudaErrorInvalidValue;  // the plan never picks it
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_simt<T, D, TQ, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * a.H, cdiv(a.S, TQ));
    flash_fwd_simt<T, D, TQ, TK><<<grid, kSimtThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), a);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D>
int launch_simt_tile(int tq, int tk, const void* q, const void* k, const void* v, void* o,
                     int B, const Args& a, cudaStream_t s) {
  switch (tq * 1000 + tk) {
    case 64016: return launch_simt<T, D, 64, 16>(q, k, v, o, B, a, s);
    case 64032: return launch_simt<T, D, 64, 32>(q, k, v, o, B, a, s);
    case 64064: return launch_simt<T, D, 64, 64>(q, k, v, o, B, a, s);
    case 128016: return launch_simt<T, D, 128, 16>(q, k, v, o, B, a, s);
    case 128032: return launch_simt<T, D, 128, 32>(q, k, v, o, B, a, s);
    case 128064: return launch_simt<T, D, 128, 64>(q, k, v, o, B, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_d(int D, int tq, int tk, const void* q, const void* k, const void* v, void* o,
             int B, const Args& a, cudaStream_t s) {
  switch (D) {
    case 8: return launch_simt_tile<T, 8>(tq, tk, q, k, v, o, B, a, s);
    case 16: return launch_simt_tile<T, 16>(tq, tk, q, k, v, o, B, a, s);
    case 32: return launch_simt_tile<T, 32>(tq, tk, q, k, v, o, B, a, s);
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 takes the "wgmma" route here
    switch (D) {
      case 64: return launch_simt_tile<T, 64>(tq, tk, q, k, v, o, B, a, s);
      case 96: return launch_simt_tile<T, 96>(tq, tk, q, k, v, o, B, a, s);
      case 128: return launch_simt_tile<T, 128>(tq, tk, q, k, v, o, B, a, s);
      case 256: return launch_simt_tile<T, 256>(tq, tk, q, k, v, o, B, a, s);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int D, int TK>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int qt,
              const Args& a, cudaStream_t s) {
  // the attribute is set once a device, at the largest size (a q tile of 128)
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_tc<D, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tc_smem_bytes(D, 2 * kWgRows, TK));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }
  const size_t smem = tc_smem_bytes(D, qt, TK);
  const dim3 grid(B * a.H, cdiv(a.S, qt));
  flash_fwd_tc<D, TK><<<grid, qt / kWgRows * kWG, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc_tk(int tk, const void* q, const void* k, const void* v, void* o, int B, int qt,
                 const Args& a, cudaStream_t s) {
  if (tk == 16) return launch_tc<D, 16>(q, k, v, o, B, qt, a, s);
  if constexpr (kTcKvCap / tc_width(D) >= 32) {
    if (tk == 32) return launch_tc<D, 32>(q, k, v, o, B, qt, a, s);
  }
  if constexpr (kTcKvCap / tc_width(D) >= 64) {
    if (tk == 64) return launch_tc<D, 64>(q, k, v, o, B, qt, a, s);
  }
  return (int)cudaErrorInvalidValue;
}


// A 4-D tensor map over a bf16 view (B, rows, heads, D) with the head dim
// contiguous, given its extents and element strides (row, head, batch): the
// head dim first, then the other three by stride (a head or batch dim of
// extent 1 or stride 0 last, at extent 1), a box of W values by `box_rows`
// rows, W one swizzle atom (128 or 64 bytes) wide, zero fill past the
// extents.  `p` gets where the coordinates go.  A row stride of 0 is refused
int encode_map(CUtensorMap* m, TmaPlace* p, const void* base, int D, int W, int box_rows,
               long long n_s, long long st_s, long long n_h, long long st_h, long long n_b,
               long long st_b) {
  const hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if (st_s == 0 && n_s > 1) return (int)cudaErrorInvalidValue;
  const long long n[3] = {n_s, n_h, n_b}, st[3] = {st_s, st_h, st_b};
  const bool flat[3] = {n_s == 1, n_h == 1 || st_h == 0, n_b == 1 || st_b == 0};
  long long wide = D;  // the stride a dim of extent 1 is given: the largest
  for (int i = 0; i < 3; ++i)
    if (!flat[i] && st[i] > wide) wide = st[i];
  int order[3] = {0, 1, 2};
  auto key = [&](int i) { return flat[i] ? LLONG_MAX : st[i]; };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && key(order[j]) < key(order[j - 1]); --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 1, 1, 1}, strides[3];
  cuuint32_t box[4] = {(cuuint32_t)W, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  int pos[3];
  for (int r = 0; r < 3; ++r) {
    const int i = order[r];
    pos[i] = r + 1;
    dims[r + 1] = flat[i] ? 1 : (cuuint64_t)n[i];
    strides[r] = (cuuint64_t)(2 * (flat[i] ? wide : st[i]));
  }
  box[pos[0]] = (cuuint32_t)box_rows;
  *p = TmaPlace{pos[0], pos[1], pos[2], !flat[1], !flat[2]};
  const CUresult r =
      enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
          unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int TK>
int launch_ws(const void* q, const void* k, const void* v, void* o, int B, int HKV,
              const Args& a, cudaStream_t s) {
  constexpr size_t smem = ws_smem_bytes(D, TK);
  static_assert(smem <= (size_t)kSmemMax, "the ring must fit the card's shared memory");
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_ws<D, TK, kWsMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }
  constexpr int W = ws_chunk(D);
  CUtensorMap mq, mk, mv;
  WsPlaces pl;
  int bad = encode_map(&mq, &pl.q, q, D, W, kWsRows, a.S, a.qss, a.H, a.qsh, B, a.qsb);
  if (!bad) bad = encode_map(&mk, &pl.k, k, D, W, TK, a.T, a.kss, HKV, a.ksh, B, a.ksb);
  if (!bad) bad = encode_map(&mv, &pl.v, v, D, W, TK, a.T, a.vss, HKV, a.vsh, B, a.vsb);
  if (bad) return bad;
  const dim3 grid(B * a.H, cdiv(a.S, kWsRows));
  flash_fwd_ws<D, TK, kWsMode><<<grid, kWsThreads, smem, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), a, pl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan, as kernels/flash_attention.py::launch_plan computes it:
// out[0..4] = q rows, kv columns, T_pad, route (1 = "wgmma", 0 = "simt"),
// kernel (1 = flash_fwd_ws, 0 = the route's other kernel: flash_fwd_tc or
// flash_fwd_simt).  A head dim the kernel has no instance for is refused
// (cudaErrorInvalidValue).
int looptune_flash_attention_plan(int S, int T, int bq, int bk, int D, int bf16, int* out) {
  if (S < 1 || T < 1 || bq < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  if (D != 8 && D != 16 && D != 32 && D != 64 && D != 96 && D != 128 && D != 256)
    return (int)cudaErrorInvalidValue;
  bq = bq < S ? bq : S;
  bk = bk < T ? bk : T;
  out[2] = cdiv(T, bk) * bk;
  out[3] = bf16 && D >= 64;
  out[4] = out[3] && (D == 96 || D == 256);
  if (out[4]) {
    out[0] = kWsRows;
    out[1] = ws_kv_tile(D, bk);
  } else if (out[3]) {
    out[0] = bq <= kWgRows ? kWgRows : 2 * kWgRows;
    int tk = 16;
    while (tk < bk && tk < kTcKvCap / tc_width(D)) tk *= 2;
    out[1] = tk;
  } else {
    const int tq = simt_q_tile(D, bq);
    int tk = 16;
    while (tk < bk && tk < 64) tk *= 2;
    while (tk > 16 && simt_smem_bytes(D, tq, tk) > (size_t)kSmemMax) tk /= 2;
    out[0] = tq;
    out[1] = tk;
  }
  return 0;
}

// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).  q: (B, S, H, D), k and v: (B, T, HKV, D)
// through element strides (b, s, h) with the head dim contiguous; o: (B, S,
// H, D) contiguous.  All of q, k, v, o are f32, or all bf16 (bf16 = 1).  lse:
// null, or (B, H, S) f32 contiguous for each row's log-sum-exp.
// D in {8, 16, 32, 64, 96, 128, 256}; H a multiple of HKV.  softcap <= 0 means none.
// On the "wgmma" route every base is 16-byte aligned and every stride a
// multiple of 8 elements (the wrapper checks).
int looptune_flash_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int S, int T, int H, int HKV, int D, long long qsb,
                             long long qss, long long qsh, long long ksb, long long kss,
                             long long ksh, long long vsb, long long vss, long long vsh,
                             int bq, int bk, float scale, float softcap, int causal,
                             int has_window, int window, int bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || H < 1 || HKV < 1 || H % HKV != 0 || bq < 1 || bk < 1)
    return (int)cudaErrorInvalidValue;
  int plan[5];
  const int bad = looptune_flash_attention_plan(S, T, bq, bk, D, bf16, plan);
  if (bad) return bad;
  if (cdiv(S, plan[0]) > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  const int wmax = S + T;
  const int w = clampi(window, -wmax, wmax);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_q = !bf16 && al16(q) && qsb % 4 == 0 && qss % 4 == 0 && qsh % 4 == 0;
  const int vec_kv = !bf16 && al16(k) && al16(v) && ksb % 4 == 0 && kss % 4 == 0 &&
                     ksh % 4 == 0 && vsb % 4 == 0 && vss % 4 == 0 && vsh % 4 == 0;
  const Args a{S, T, H, H / HKV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
               scale, softcap, causal, has_window, w, plan[2], vec_q, vec_kv,
               static_cast<float*>(lse)};
  if (plan[4]) {
    if (D == 256) return launch_ws<256, 64>(q, k, v, o, B, HKV, a, s);
    if (plan[1] == 64) return launch_ws<96, 64>(q, k, v, o, B, HKV, a, s);
    return launch_ws<96, 128>(q, k, v, o, B, HKV, a, s);
  }
  if (plan[3]) {
    if (D == 64) return launch_tc_tk<64>(plan[1], q, k, v, o, B, plan[0], a, s);
    return launch_tc_tk<128>(plan[1], q, k, v, o, B, plan[0], a, s);
  }
  if (bf16) return launch_d<__nv_bfloat16>(D, plan[0], plan[1], q, k, v, o, B, a, s);
  return launch_d<float>(D, plan[0], plan[1], q, k, v, o, B, a, s);
}

}  // extern "C"
