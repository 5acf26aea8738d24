// Flash attention backward for Hopper (sm_90a): the gradients dq, dk, dv of
// the forward kernel's function (flash_attention.cu) over q (B, S, H, D) and
// k, v (B, T, HKV, D), with causal masking, a sliding window, a score softcap
// and grouped-query heads, from out, dout and the forward's log-sum-exp.
//
// Replaces: repro/models/layers.py::_flash_bwd, the JAX package's
// hand-written backward of its model attention (a jnp custom_vjp over the
// blocked scan, not a Pallas kernel: the JAX package has no backward
// kernel).  It computes that function, in the port forward's layout and with
// its 1/sqrt(D) placement (the scale multiplies the f32 score after the
// product, so dq and dk are multiplied by it at the end):
//   raw = scale q.k, sc = cap tanh(raw / cap) (or raw), masked to -1e30;
//   p = exp(sc - lse);  dv = p^T dout;  dp = dout v^T;
//   ds = p (dp - delta) (1 - tanh^2(raw / cap)), 0 where masked;
//   dq = scale ds k;  dk = scale ds^T q,
// with delta = rowsum(dout . out), which the reference computes outside its
// scan: on the "simt" route the wrapper computes it in torch ops, on the
// "wgmma" route the dq kernel as its first step (below).  p is not masked, as in
// the reference: a row with no visible key has lse = -1e30 (its l is
// T_pad, which the f32 sum -1e30 + log(T_pad) does not see), so it gets p = 1
// at every key and adds its dout to each key's dv, and nothing to dq or dk.
// GQA: dk and dv of a kv head sum over its group of q heads.  Outputs in the
// inputs' dtype, from f32 accumulators.
//
// Both routes make two launches and use no atomics, so results repeat bit
// for bit: a dk/dv kernel with one CTA per (b, kv head, key tile), which
// loops over the group's q heads and the q tiles whose rows can see the tile
// (all of them for a tile that holds a row with no visible key), and a dq
// kernel with one CTA per (b, q head, q tile), which loops over the kv tiles
// its rows can see (as the forward's CTA does), the longest causal tiles
// first.  Each recomputes S and dP.  The dk/dv CTAs are dispatched key tile
// 0 first (blockIdx.y is the key tile, and the card dispatches x fastest),
// which under causal masking is the tile that walks the most q tiles.  Two
// routes, chosen by (dtype, D) alone (looptune_flash_attention_bwd_plan,
// kernels/flash_attention.py::bwd_launch_plan):
//
// "wgmma" — bf16 at D = 64 (musicgen-large), 96 (phi3-mini), 128 (jamba
//   and most of the zoo) and 256 (gemma3-12b), the forward's tensor-core
//   head dims:
//   * every product on wgmma.mma_async with bf16 operands and f32
//     accumulators, in one of the two operand forms the forward's
//     tensor-core route runs (hopper.cuh): form K, both operands K-major in
//     shared memory (the forward's q.k^T), and form R, a bf16 A fragment
//     packed from an f32 accumulator in registers times an MN-major B (the
//     forward's p.v, the transpose bit set);
//   * flash_bwd_dkdv_tc: one or two consumer warpgroups a CTA, each owning
//     64 keys (wgmma's M).  K and V are staged once; Q, dout, lse and delta
//     go through a two-stage ring over (q head, q tile), tile j+1 in flight
//     while tile j is multiplied.  For each q tile (wgmma's N = NQ, the
//     plan's q tile), four commit groups, each overlapping the next step's
//     arithmetic: S^T = K.Q^T, then dP^T = V.dout^T, in form K; P^T on the
//     accumulator fragments while dP^T runs (a thread holds two key rows and
//     NQ / 4 q columns, whose lse and delta it reads from shared memory as
//     float2); dv += P^T.dout in form R; dS^T on the fragments while it
//     runs; then dk += dS^T.Q in form R.  P^T and dS^T are rounded to bf16
//     as A fragments, and dout and Q, as staged, are read as MN-major B (the
//     q rows are the reduced dim);
//   * flash_bwd_dq_tc launches first: one or two warpgroups a CTA, each
//     owning 64 q rows.  While Q and dout are staged once, a pair of threads
//     a row computes delta = rowsum(dout . out) from 16-byte loads (f32
//     products and sums, as the torch rowsum) and writes it for the dk/dv
//     kernel, which launches second: that saves the five torch ops (two
//     widening copies, a product, a sum and a transpose) and ~200 MB of
//     traffic they took at musicgen's shape.  lse and delta sit in registers
//     (a thread holds two rows); K and V go through the two-stage ring over
//     the kv tiles the rows can see.  S = Q.K^T, then dP = dout.V^T, in form
//     K (P computed while dP runs), dS on the fragments, dq += dS.K in form R
//     with K as the MN-major B;
//   * bf16 rows go by 16-byte cp.async with zero fill straight into the
//     128-byte-swizzled layout the descriptors read, with no widening: rows
//     past S or T and, at D = 96, the 32 columns past D (staged as 128
//     zero-padded columns, as the forward stages them; zeroed once in
//     shared memory) are zero.  The products over the head dim run D / 16
//     k-steps and never read the padding; those into it write zero columns,
//     which are not stored;
//   * exp is ex2.approx of (score - lse) log2 e, the difference first, so a
//     row with no visible key gets p = 1 exactly; a warpgroup skips the
//     tiles none of its rows and keys pair in, and a tile every pair of
//     which is visible skips the mask.  The whole fence, issue and wait
//     sequence sits inside those branches, so ptxas serialises no wgmma;
//   * P and dS are rounded to bf16 for their products, where the reference
//     keeps both in f32 (layers.py:209-217); the forward's tensor-core route
//     rounds p the same way, and the bf16 limit of 3e-2 covers it;
//   * tiles (kTcTiles below): the dk/dv CTA's warpgroups and q tile and the
//     dq CTA's warpgroups and kv tile at each head dim (one warpgroup where
//     T or S fits 64 rows).  The loop is latency-bound (each warpgroup's
//     products, fragment arithmetic and waits run in turn), so warpgroups
//     an SM count most: one warpgroup a CTA with 32-wide tiles, 152 and 114
//     registers a thread at D = 64 (three dk/dv or four dq CTAs an SM), 220
//     and 150 at D = 128, measured fastest of the tables weighed
//     (benchmarks/port/flash_bwd_plans.py: at (4, 1024, 32, 64) 0.453 ms
//     against 0.650 with two warpgroups and 64-wide tiles, on an H100 SXM at
//     700 W).  A 64-wide q tile at D = 128 holds dK and dV (64 + 64 f32) and
//     S^T and dP^T (32 + 32) and spills.  ptxas's counts are in
//     chip_smoke.py's build line (no instance may spill).  No TMA, warp
//     specialisation or setmaxnreg yet;
//   * D = 256, where dK and dV of 64 keys alone are 2 x 64 x 256 f32, 256
//     registers a thread of one warpgroup: flash_bwd_dkdv_split gives each of
//     the two to a warpgroup of its own, on the same 64 keys, and splits the
//     products by role, so none is computed twice: warpgroup 0 S^T = K.Q^T,
//     P^T and dv += P^T.dout, warpgroup 1 dP^T = V.dout^T, dS^T and dk +=
//     dS^T.Q (each 128 accumulator registers, 16 of S^T or dP^T at the q
//     tile of 32).  P^T (1 - tanh^2) goes from warpgroup 0 to warpgroup 1
//     through 8 KB of shared memory, thread t to thread t + 128 (the same
//     fragment positions), between two CTA barriers; K and V (32 KB each,
//     four 128-byte swizzle atoms a row) are staged once and Q and dout go
//     through the same two-stage ring (64 KB): 140,800 bytes, one CTA an
//     SM.  The dq kernel is the one above with dQ (64 x 256 f32, 128
//     registers) in one warpgroup and a kv tile of 16, so that its ring
//     (32 KB) leaves two CTAs an SM (99,584 bytes).
//
// "simt" — f32 at every D, and bf16 at D = 8, 16, 32 (the smoke configs'
//   f32 D = 16 training among them): the first design.  SIMT f32
//   FMAs from shared memory, 256 threads, 16 (ty) x 16 (tx), 64 x 64 tiles
//   in both kernels: in the score products a thread owns q rows 4 ty + i and
//   kv columns tx + 16 j (i, j < 4), reading Q (a broadcast over the
//   half-warp) and K (16 rows padded by 4 floats: distinct bank groups) as
//   float4; in the accumulations it owns rows 4 ty + e (kv rows in dkdv, q
//   rows in dq) and head-dim columns 64 c + 4 tx + e (below D only, as the
//   forward's SIMT route), reading P / dS as float4 along those rows.  bf16
//   inputs are widened as they are staged; f32 rows go by 16-byte cp.async
//   (hopper.cuh) where aligned.  No double buffering: each tile is staged,
//   then multiplied.  The products' head-dim loop is not unrolled, so that
//   at D <= 64 a thread fits 128 registers without spilling and two CTAs
//   share an SM: 2.51 ms against 3.44 at one CTA an SM (~168 registers) at
//   (4, 1024, 32, 64) bf16 causal, 2.16 against 2.66 in f32 (an H100 SXM at
//   700 W).  Shared memory is 4 (4 TL (D + 4) + 2 TL (TL + 4) + 2 TL) bytes
//   in dkdv at tile TL: 170.5 KB at D = 128 and TL = 64.  At D = 256 the
//   64-row tiles would take 301,568 bytes, so both kernels take 32-row
//   tiles there (TL = 32: a thread owns 2 rows of each product and of its
//   accumulators, 139.3 KB in dkdv); the products and the masks are the
//   same code at either tile.
//
// Instances: D = 8, 16, 32, 64, 96, 128 and 256, the forward's head dims
// (every smoke config's 16, musicgen-large's 64, the zoo's 96 and 128,
// gemma3-12b's 256); any other D is refused.
//
// Bound on this card: max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s), the FLOP
// 10 B H D (visible pairs) of the function's five products (S recomputed,
// dP, dv, dk, dq) and the bytes q, k, v, out, dout read once, lse and delta,
// and dq, dk, dv written once.  At musicgen-large's training shape (4, 1024,
// 32, 64) bf16, causal: 4.3e10 FLOP (43 us) against 134 MB (40 us).  Both
// routes compute S and dP in each launch: seven products, 14 B H D (visible
// pairs) FLOP, 61 us on the tensor cores.  At gemma3-12b's (2, 4096, 16/8,
// 256) bf16: causal 6.87e11 FLOP (695 us) against 404 MB (121 us); its local
// layers' window of 1024 keys sees 3.67e6 pairs a head, 3.01e11 FLOP (304
// us).  There the dk/dv kernel computes each of its four products once (the
// role split) and the dq kernel its three, as at the other head dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;  // 16 (ty) x 16 (tx)
constexpr int kPad = 4;        // floats a staged row is padded by
constexpr int kSmemMax = 232448;
// the SIMT tile, q rows and kv rows in both kernels: 64, and 32 at D = 256, where four
// 64-row f32 tiles of 260 floats alone would take more shared memory than a CTA has
__host__ __device__ constexpr int simt_tile(int d) { return d > 128 ? 32 : 64; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ constexpr int cdiv(int x, int y) { return (x + y - 1) / y; }

struct Args {
  int S, T, H, G;                  // G = H / HKV
  long long qsb, qss, qsh;         // element strides (head dim contiguous)
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long osb, oss, osh;         // dout's
  float scale, softcap;            // softcap <= 0: none
  int causal, has_window, window;  // window clamped to [-(S+T), S+T]
  int vec_q, vec_kv, vec_do;       // f32 rows on 16-byte boundaries
};

__device__ __forceinline__ int vis_lo(const Args& a, int qi) {
  return a.has_window ? max(0, qi - a.window + 1) : 0;
}
__device__ __forceinline__ int vis_hi(const Args& a, int qi) {
  return a.causal ? min(a.T, qi + 1) : a.T;
}

__host__ __device__ constexpr size_t dkdv_smem_bytes(int d) {
  return sizeof(float) * (size_t)(4 * simt_tile(d) * (d + kPad) +
                                  2 * simt_tile(d) * (simt_tile(d) + kPad) + 2 * simt_tile(d));
}
__host__ __device__ constexpr size_t dq_smem_bytes(int d) {
  return sizeof(float) * (size_t)(4 * simt_tile(d) * (d + kPad) +
                                  simt_tile(d) * (simt_tile(d) + kPad) + 2 * simt_tile(d));
}

// R consecutive floats at p (16-byte aligned for R = 4, 8-byte for R = 2), and back
template <int R>
__device__ __forceinline__ void load_run(const float* p, float (&x)[R]) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}
template <int R>
__device__ __forceinline__ void store_run(float* p, const float (&x)[R]) {
  if constexpr (R == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
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

// rows [r0, r0 + TL) of one head into dst [TL][D + kPad] f32, rows >= r_hi zero: f32 by
// 16-byte cp.async (vec) or 4-byte cp.async, bf16 through registers, widened
template <typename T, int D, int TL>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ss, int r0,
                                           int r_hi, int vec, int tid) {
  using namespace hopper;
  constexpr int DP = D + kPad;
  if constexpr (sizeof(T) == 2) {
    for (int e = tid; e < TL * D; e += kThreads) {
      const int r = e / D, d = e % D, rj = r0 + r;
      dst[r * DP + d] = rj < r_hi ? to_f(src[rj * ss + d]) : 0.f;
    }
  } else if (vec) {
    for (int e = tid; e < TL * (D / 4); e += kThreads) {
      const int r = e / (D / 4), d = 4 * (e % (D / 4)), rj = r0 + r;
      const bool in = rj < r_hi;
      cp_async16(smem_u32(dst + r * DP + d), in ? src + rj * ss + d : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < TL * D; e += kThreads) {
      const int r = e / D, d = e % D, rj = r0 + r;
      const bool in = rj < r_hi;
      cp_async4(smem_u32(dst + r * DP + d), in ? src + rj * ss + d : src, in ? 4 : 0);
    }
  }
}

// lse and delta of q rows [q0, q0 + TL) into shared memory (0 past S)
template <int TL>
__device__ __forceinline__ void stage_stats(float* lse_s, float* dl_s, const float* lse,
                                            const float* delta, int q0, int S, int tid) {
  if (tid < TL) {
    const int qi = q0 + tid;
    lse_s[tid] = qi < S ? lse[qi] : 0.f;
    dl_s[tid] = qi < S ? delta[qi] : 0.f;
  }
}

// s = Q K^T and dp = dO V^T at the thread's q rows R ty + i and kv columns tx + 16 j
// (R = TL / 16 of each), the head dim in order
template <int D, int R>
__device__ __forceinline__ void score_products(const float* Qs, const float* Ks,
                                               const float* dOs, const float* Vs, int tx,
                                               int ty, float (&s)[R][R], float (&dp)[R][R]) {
  constexpr int DP = D + kPad;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    float4 qa[R], kk[R];
#pragma unroll
    for (int i = 0; i < R; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (R * ty + i) * DP + d);
#pragma unroll
    for (int j = 0; j < R; ++j) kk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qa[i].x, kk[j].x, s[i][j]);
        s[i][j] = fmaf(qa[i].y, kk[j].y, s[i][j]);
        s[i][j] = fmaf(qa[i].z, kk[j].z, s[i][j]);
        s[i][j] = fmaf(qa[i].w, kk[j].w, s[i][j]);
      }
  }
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    float4 oa[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) oa[i] = *reinterpret_cast<const float4*>(dOs + (R * ty + i) * DP + d);
#pragma unroll
    for (int j = 0; j < R; ++j) vv[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        dp[i][j] = fmaf(oa[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(oa[i].y, vv[j].y, dp[i][j]);
        dp[i][j] = fmaf(oa[i].z, vv[j].z, dp[i][j]);
        dp[i][j] = fmaf(oa[i].w, vv[j].w, dp[i][j]);
      }
  }
}

// from the products s and dp at q rows q0 + R ty + i and keys k0 + tx + 16 j:
// p (into p) and ds (into s)
template <int R>
__device__ __forceinline__ void score_grads(const Args& a, int q0, int k0, const float* lse_s,
                                            const float* dl_s, int tx, int ty, float (&s)[R][R],
                                            const float (&dp)[R][R], float (&p)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int kj = k0 + tx + 16 * j;
      float x = s[i][j] * a.scale, fac = 1.f;
      if (a.softcap > 0.f) {
        const float th = tanhf(x / a.softcap);
        x = a.softcap * th;
        fac = 1.f - th * th;
      }
      const bool in = qi < a.S && kj < a.T;
      const bool vis = in && (!a.causal || kj <= qi) && (!a.has_window || kj > qi - a.window);
      const float pv = in ? exp2f(((vis ? x : kNegInf) - lse_s[r]) * kLog2e) : 0.f;
      const float ds = pv * (dp[i][j] - dl_s[r]) * fac;  // ds = p (dP - delta)
      p[i][j] = pv;
      s[i][j] = vis ? ds : 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               const Args a) {
  using namespace hopper;
  constexpr int TL = simt_tile(D), R = TL / 16;  // rows of a tile, rows of a thread
  constexpr int DP = D + kPad, PP = TL + kPad;
  constexpr int QD = (D + 63) / 64;  // runs of 4 head-dim columns a thread
  extern __shared__ float4 smem4[];
  float* const Ks = reinterpret_cast<float*>(smem4);  // [TL][DP]
  float* const Vs = Ks + TL * DP;
  float* const Qs = Vs + TL * DP;
  float* const dOs = Qs + TL * DP;
  float* const Ps = dOs + TL * DP;  // [q][key]
  float* const dSs = Ps + TL * PP;  // [q][key]
  float* const lse_s = dSs + TL * PP;
  float* const dl_s = lse_s + TL;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int hkv = a.H / a.G;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int k0 = blockIdx.y * TL, k_end = min(k0 + TL, a.T);
  auto cols_ok = [&](int c) { return D % 64 == 0 || 64 * c + 4 * tx < D; };
  const bool has_cols = cols_ok(0);

  stage_rows<T, D, TL>(Ks, k + b * a.ksb + hk * a.ksh, a.kss, k0, a.T, a.vec_kv, tid);
  stage_rows<T, D, TL>(Vs, v + b * a.vsb + hk * a.vsh, a.vss, k0, a.T, a.vec_kv, tid);
  cp_async_commit();

  float dka[R][4 * QD], dva[R][4 * QD];
#pragma unroll
  for (int e = 0; e < R; ++e)
#pragma unroll
    for (int c = 0; c < 4 * QD; ++c) dka[e][c] = dva[e][c] = 0.f;

  const int n_qt = cdiv(a.S, TL);
  for (int hh = 0; hh < a.G; ++hh) {
    const int h = hk * a.G + hh;
    const T* const qb = q + b * a.qsb + h * a.qsh;
    const T* const ob = dout + b * a.osb + h * a.osh;
    const float* const lb = lse + ((long long)b * a.H + h) * a.S;
    const float* const db = delta + ((long long)b * a.H + h) * a.S;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * TL, last = min(q0 + TL, a.S) - 1;
      // the tile's rows see keys in [lo(q0), hi(last)), unless its last row
      // sees none: then every key gets that row's p = 1 (uniform over the CTA)
      const bool blind = vis_lo(a, last) >= vis_hi(a, last);
      if (!blind && (k0 >= vis_hi(a, last) || k_end <= vis_lo(a, q0))) continue;
      __syncthreads();  // every thread is done with the previous tile's Q, dO, P, dS
      stage_rows<T, D, TL>(Qs, qb, a.qss, q0, a.S, a.vec_q, tid);
      stage_rows<T, D, TL>(dOs, ob, a.oss, q0, a.S, a.vec_do, tid);
      stage_stats<TL>(lse_s, dl_s, lb, db, q0, a.S, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      float s[R][R], dp[R][R], p[R][R];
      score_products<D, R>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
      score_grads<R>(a, q0, k0, lse_s, dl_s, tx, ty, s, dp, p);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          Ps[(R * ty + i) * PP + tx + 16 * j] = p[i][j];
          dSs[(R * ty + i) * PP + tx + 16 * j] = s[i][j];
        }
      __syncthreads();  // P and dS are whole

      if (has_cols) {  // dv += P^T dO, dk += dS^T Q, the q rows in order
#pragma unroll 4
        for (int qq = 0; qq < TL; ++qq) {
          float pa[R], da[R];
          load_run<R>(Ps + qq * PP + R * ty, pa);
          load_run<R>(dSs + qq * PP + R * ty, da);
          float4 oo[QD], qv[QD];
#pragma unroll
          for (int c = 0; c < QD; ++c) {
            const bool ok = cols_ok(c);
            oo[c] = ok ? *reinterpret_cast<const float4*>(dOs + qq * DP + 64 * c + 4 * tx)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
            qv[c] = ok ? *reinterpret_cast<const float4*>(Qs + qq * DP + 64 * c + 4 * tx)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int e = 0; e < R; ++e)
#pragma unroll
            for (int c = 0; c < 4 * QD; ++c) {
              dva[e][c] = fmaf(pa[e], lane4(oo[c / 4], c % 4), dva[e][c]);
              dka[e][c] = fmaf(da[e], lane4(qv[c / 4], c % 4), dka[e][c]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();  // a tile no q row sees still has its K, V copies in flight

  if (!has_cols) return;
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int kj = k0 + R * ty + e;
    if (kj >= a.T) continue;
    const long long at = (((long long)b * a.T + kj) * hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < QD; ++c) {
      if (!cols_ok(c)) continue;
      const float gk[4] = {dka[e][4 * c] * a.scale, dka[e][4 * c + 1] * a.scale,
                           dka[e][4 * c + 2] * a.scale, dka[e][4 * c + 3] * a.scale};
      const float gv[4] = {dva[e][4 * c], dva[e][4 * c + 1], dva[e][4 * c + 2],
                           dva[e][4 * c + 3]};
      store4(dk + at + 64 * c + 4 * tx, gk);
      store4(dv + at + 64 * c + 4 * tx, gv);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, const Args a) {
  using namespace hopper;
  constexpr int TL = simt_tile(D), R = TL / 16;
  constexpr int DP = D + kPad, PP = TL + kPad;
  constexpr int QD = (D + 63) / 64;
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);  // [TL][DP]
  float* const dOs = Qs + TL * DP;
  float* const Ks = dOs + TL * DP;
  float* const Vs = Ks + TL * DP;
  float* const dSt = Vs + TL * DP;  // [key][q]: dS transposed
  float* const lse_s = dSt + TL * PP;
  float* const dl_s = lse_s + TL;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * TL;  // longest causal tiles first
  const int last = min(q0 + TL, a.S) - 1;
  auto cols_ok = [&](int c) { return D % 64 == 0 || 64 * c + 4 * tx < D; };
  const bool has_cols = cols_ok(0);
  const T* const kb = k + b * a.ksb + (h / a.G) * a.ksh;
  const T* const vb = v + b * a.vsb + (h / a.G) * a.vsh;

  // the keys the tile's rows see, as the forward's CTA: [lo(q0), hi(last)),
  // or all of [0, T) when its last row sees none (those rows add nothing to
  // dq, but the range stays the forward's)
  int kv_lo = 0, kv_hi = a.T;
  if (vis_lo(a, last) < vis_hi(a, last)) {
    kv_lo = vis_lo(a, q0);
    kv_hi = vis_hi(a, last);
  }
  stage_rows<T, D, TL>(Qs, q + b * a.qsb + h * a.qsh, a.qss, q0, a.S, a.vec_q, tid);
  stage_rows<T, D, TL>(dOs, dout + b * a.osb + h * a.osh, a.oss, q0, a.S, a.vec_do, tid);
  stage_stats<TL>(lse_s, dl_s, lse + ((long long)b * a.H + h) * a.S,
                  delta + ((long long)b * a.H + h) * a.S, q0, a.S, tid);

  float dqa[R][4 * QD];
#pragma unroll
  for (int e = 0; e < R; ++e)
#pragma unroll
    for (int c = 0; c < 4 * QD; ++c) dqa[e][c] = 0.f;

  const int n_tiles = cdiv(kv_hi - kv_lo, TL);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_lo + j * TL;
    __syncthreads();  // every thread is done with the previous tile's K and dS
    stage_rows<T, D, TL>(Ks, kb, a.kss, k0, kv_hi, a.vec_kv, tid);
    stage_rows<T, D, TL>(Vs, vb, a.vss, k0, kv_hi, a.vec_kv, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[R][R], dp[R][R], p[R][R];
    score_products<D, R>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
    score_grads<R>(a, q0, k0, lse_s, dl_s, tx, ty, s, dp, p);
#pragma unroll
    for (int jj = 0; jj < R; ++jj) {  // dS transposed: a run of R q rows a key
      float col[R];
#pragma unroll
      for (int i = 0; i < R; ++i) col[i] = s[i][jj];
      store_run<R>(dSt + (tx + 16 * jj) * PP + R * ty, col);
    }
    __syncthreads();  // dS is whole

    if (has_cols) {  // dq += dS K, the keys in order
#pragma unroll 4
      for (int kk = 0; kk < TL; ++kk) {
        float da[R];
        load_run<R>(dSt + kk * PP + R * ty, da);
        float4 kv[QD];
#pragma unroll
        for (int c = 0; c < QD; ++c)
          kv[c] = cols_ok(c) ? *reinterpret_cast<const float4*>(Ks + kk * DP + 64 * c + 4 * tx)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int e = 0; e < R; ++e)
#pragma unroll
          for (int c = 0; c < 4 * QD; ++c)
            dqa[e][c] = fmaf(da[e], lane4(kv[c / 4], c % 4), dqa[e][c]);
      }
    }
  }
  cp_async_wait<0>();

  if (!has_cols) return;
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int qi = q0 + R * ty + e;
    if (qi >= a.S) continue;
    const long long at = (((long long)b * a.S + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < QD; ++c) {
      if (!cols_ok(c)) continue;
      const float g[4] = {dqa[e][4 * c] * a.scale, dqa[e][4 * c + 1] * a.scale,
                          dqa[e][4 * c + 2] * a.scale, dqa[e][4 * c + 3] * a.scale};
      store4(dq + at + 64 * c + 4 * tx, g);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, void* dk, void* dv, int B, const Args& a,
           cudaStream_t s) {
  constexpr int TL = simt_tile(D);
  constexpr size_t sm1 = dkdv_smem_bytes(D), sm2 = dq_smem_bytes(D);
  static_assert(sm1 <= (size_t)kSmemMax && sm2 <= (size_t)kSmemMax, "shared memory");
  if (cdiv(a.S, TL) > 65535 || cdiv(a.T, TL) > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm2);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  flash_bwd_dkdv<T, D><<<dim3(B * (a.H / a.G), cdiv(a.T, TL)), kThreads, sm1, s>>>(
      qt, kt, vt, ot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<T, D><<<dim3(B * a.H, cdiv(a.S, TL)), kThreads, sm2, s>>>(
      qt, kt, vt, ot, lse, delta, static_cast<T*>(dq), a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
             const Args& a, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 takes the "wgmma" route here
    switch (D) {
      case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
      case 96: return launch<T, 96>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
      case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
      case 256: return launch<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// "wgmma" route: bf16 at D = 64, 96, 128 and 256 on the tensor cores
// ---------------------------------------------------------------------------

using bf16_t = __nv_bfloat16;
constexpr int kWG = 128;     // threads of a warpgroup
constexpr int kWgRows = 64;  // rows a warpgroup owns: wgmma's M (keys in dk/dv, q rows in dq)
// the head dim as staged: whole 64-column swizzle chunks (D = 96 -> 128)
__host__ __device__ constexpr int tc_width(int d) { return (d + 63) / 64 * 64; }
// the route's tiles at D = 64, 96, 128, 256: {64-key groups of a dk/dv CTA (its warpgroups,
// but at D = 256, where two warpgroups split one group's work by role), its q tile (wgmma's
// N of S^T and dP^T), warpgroups of a dq CTA, its kv tile (N of S and dP)}
constexpr int kTcTiles[4][4] = {{1, 32, 1, 32}, {1, 32, 1, 32}, {1, 32, 1, 32}, {1, 32, 1, 16}};
// CTAs of two warpgroups an SM that ptxas budgets a thread's registers for
constexpr int kTcMinBlocks = 1;
constexpr int tc_tile(int d, int i) {
  return kTcTiles[d == 64 ? 0 : (d == 96 ? 1 : (d == 128 ? 2 : 3))][i];
}
// alignment slack, K and V [NC][kr rows], two ring stages of Q and dout [NC][NQ rows],
// and of lse and delta [NQ] f32
constexpr size_t tc_dkdv_smem(int d, int kr, int nq) {
  return 1024 + (size_t)tc_width(d) * 2 * (2 * kr + 4 * nq) + 16 * (size_t)nq;
}
// alignment slack, Q and dout [NC][qr rows], two ring stages of K and V [NC][TK rows],
// delta [qr] f32
constexpr size_t tc_dq_smem(int d, int qr, int tk) {
  return 1024 + (size_t)tc_width(d) * 2 * (2 * qr + 4 * tk) + 4 * (size_t)qr;
}
// D = 256's dk/dv CTA: alignment slack, K and V [4][64 rows], two ring stages of Q and
// dout [4][NQ rows] and of lse and delta [NQ] f32, and P^T (1 - tanh^2) [NQ / 2][128] f32
constexpr size_t tc_split_smem(int nq) {
  return 1024 + 512 * (size_t)(2 * 64 + 4 * nq) + 16 * (size_t)nq + 4 * (size_t)(nq / 2) * 128;
}

// rows [r0, r0 + rows) of one head, row stride ss, into a 128-byte-swizzled tile whose
// 64-column chunks are `chunk` bytes apart: 16-byte cp.async, rows >= r_hi zero
template <int D>
__device__ __forceinline__ void tc_stage(uint32_t dst, uint32_t chunk, const bf16_t* src,
                                         long long ss, int r0, int rows, int r_hi, int tid,
                                         int nthr) {
  using namespace hopper;
  constexpr int PR = D / 8;  // 16-byte pieces of a row
  for (int e = tid; e < rows * PR; e += nthr) {
    const int r = e / PR, c = e % PR, rj = r0 + r;
    const bool in = rj < r_hi;
    cp_async16(dst + (uint32_t)(c >> 3) * chunk + sw128(r, c & 7),
               src + (long long)(in ? rj : 0) * ss + c * 8, in ? 16 : 0);
  }
}

// D = 96: the pieces past D of `rows` rows of a tile (chunk stride `chunk`), zeroed once
template <int D>
__device__ __forceinline__ void tc_zero_pad(uint32_t dst, uint32_t chunk, int rows, int tid,
                                            int nthr) {
  constexpr int PR = D / 8, PAD = tc_width(D) / 8 - PR;
  if constexpr (PAD > 0) {
    for (int e = tid; e < rows * PAD; e += nthr) {
      const int r = e / PAD, c = PR + e % PAD;
      const uint32_t at = dst + (uint32_t)(c >> 3) * chunk + hopper::sw128(r, c & 7);
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0u) : "memory");
    }
  }
}

// the bf16 pair (x, y) at p
__device__ __forceinline__ void store_pair(bf16_t* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// whether a dk/dv CTA over keys [k0, k_end) visits q tile qt of nq rows, the same for
// every head of the group: the tile's rows see a key of the CTA, or it holds a row that
// sees no key at all
__device__ __forceinline__ bool visits_qtile(const Args& a, int qt, int nq, int k0, int k_end) {
  const int q0 = qt * nq, last = min(q0 + nq, a.S) - 1;
  return vis_lo(a, last) >= vis_hi(a, last) || (k0 < vis_hi(a, last) && k_end > vis_lo(a, q0));
}

// a dk/dv ring item, (head h, q tile from q0): Q and dout of NQ rows into the stage at st
// (Q's chunks, then dout's), their lse and delta into stats[0, 2 NQ)
template <int D, int NQ>
__device__ __forceinline__ void tc_load_qitem(uint32_t st, float* stats, const bf16_t* q,
                                              const bf16_t* dout, const float* lse,
                                              const float* delta, const Args& a, int b, int h,
                                              int q0, int tid, int nthr) {
  using namespace hopper;
  constexpr uint32_t QCHUNK = NQ * 128, QTILE = tc_width(D) / 64 * QCHUNK;
  tc_stage<D>(st, QCHUNK, q + b * a.qsb + h * a.qsh, a.qss, q0, NQ, a.S, tid, nthr);
  tc_stage<D>(st + QTILE, QCHUNK, dout + b * a.osb + h * a.osh, a.oss, q0, NQ, a.S, tid, nthr);
  const long long row = ((long long)b * a.H + h) * a.S;
  for (int e = tid; e < 2 * NQ; e += nthr) {
    const int qi = q0 + e % NQ;
    const bool in = qi < a.S;
    cp_async4(smem_u32(stats + e), (e < NQ ? lse : delta) + row + (in ? qi : 0), in ? 4 : 0);
  }
}

// dk and dv: one CTA per (b, kv head, kr = 64 x warpgroups keys).  Warpgroup wg owns keys
// k0 + 64 wg .. + 63; a thread's two key rows are kA and kA + 8, its accumulator columns
// 8 j + cq + {0, 1} (the wgmma register layout, hopper.cuh).
template <int D, int NQ>
__global__ void __launch_bounds__(2 * kWG, kTcMinBlocks)
flash_bwd_dkdv_tc(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                  const bf16_t* __restrict__ v, const bf16_t* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16_t* __restrict__ dk, bf16_t* __restrict__ dv, const Args a) {
  using namespace hopper;
  constexpr int NC = tc_width(D) / 64;   // 64-column chunks of the head dim as staged
  constexpr int NS = NQ / 2;             // S^T and dP^T registers a thread
  constexpr uint32_t QCHUNK = NQ * 128;  // bytes of one chunk of a Q or dout tile
  constexpr uint32_t QTILE = NC * QCHUNK;
  extern __shared__ uint8_t smem_raw[];

  const int nthr = blockDim.x, kr = nthr / kWG * kWgRows;
  const uint32_t kchunk = (uint32_t)kr * 128;
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NC][kr rows]
  const uint32_t sV = sK + NC * kchunk;
  const uint32_t sQ = sV + NC * kchunk;  // [2 stages][Q, dout][NC][NQ rows]
  float* const stats = reinterpret_cast<float*>(smem_raw + (sQ + 4 * QTILE - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int wg = tid / kWG, warp = (tid % kWG) / 32, lane = tid % 32;
  const int hkv = a.H / a.G;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int k0 = blockIdx.y * kr, k_end = min(k0 + kr, a.T);
  const int wk0 = k0 + wg * kWgRows, wk_end = min(wk0 + kWgRows, a.T);
  const int kA = wk0 + warp * 16 + lane / 4, kB = kA + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t sKw = sK + (uint32_t)(wg * kWgRows * 128), sVw = sV + (uint32_t)(wg * kWgRows * 128);

  // the q tiles the CTA visits (visits_qtile) and the ring's items, (head, q tile)
  const int n_qt = cdiv(a.S, NQ);
  auto next_qt = [&](int qt) {
    while (qt < n_qt && !visits_qtile(a, qt, NQ, k0, k_end)) ++qt;
    return qt;
  };
  int n_vis = 0;
  for (int qt = 0; qt < n_qt; ++qt) n_vis += visits_qtile(a, qt, NQ, k0, k_end);
  const int n_items = a.G * n_vis;
  auto load_item = [&](int stage, int hh, int qt) {  // Q, dout, lse, delta of (head, q tile)
    tc_load_qitem<D, NQ>(sQ + (uint32_t)stage * 2 * QTILE, stats + stage * 2 * NQ, q, dout, lse,
                         delta, a, b, hk * a.G + hh, qt * NQ, tid, nthr);
  };

  float dka[NC][32], dva[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;

  if (n_items > 0) {
    tc_zero_pad<D>(sK, kchunk, kr, tid, nthr);
    tc_zero_pad<D>(sV, kchunk, kr, tid, nthr);
    for (int t = 0; t < 4; ++t) tc_zero_pad<D>(sQ + t * QTILE, QCHUNK, NQ, tid, nthr);  // the ring's
    tc_stage<D>(sK, kchunk, k + b * a.ksb + hk * a.ksh, a.kss, k0, kr, a.T, tid, nthr);
    tc_stage<D>(sV, kchunk, v + b * a.vsb + hk * a.vsh, a.vss, k0, kr, a.T, tid, nthr);
    int hh = 0, qt = next_qt(0);
    load_item(0, hh, qt);
    cp_async_commit();  // group 0: K, V and the first item
    for (int it = 0; it < n_items; ++it) {
      int nh = hh, nq = next_qt(qt + 1);
      if (nq == n_qt) {
        ++nh;
        nq = next_qt(0);
      }
      if (it + 1 < n_items) load_item((it + 1) & 1, nh, nq);
      cp_async_commit();   // (empty on the last item: the count below stays right)
      cp_async_wait<1>();  // item it landed, item it + 1 may still be in flight
      fence_proxy_async_shared();
      __syncthreads();

      const int q0 = qt * NQ, last = min(q0 + NQ, a.S) - 1;
      const bool blind = vis_lo(a, last) >= vis_hi(a, last);
      if (wk0 < a.T &&
          (blind || (wk0 < vis_hi(a, last) && wk_end > vis_lo(a, q0)))) {  // uniform over the warpgroup
        const uint32_t st = sQ + (uint32_t)(it & 1) * 2 * QTILE;
        const float* const ls = stats + (it & 1) * 2 * NQ;
        float s[NS], dp[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)  // S^T = K Q^T
          wgmma_ss(s, desc_kmajor(sKw + (uint32_t)(ks >> 2) * kchunk + (uint32_t)(ks & 3) * 32),
                   desc_kmajor(st + (uint32_t)(ks >> 2) * QCHUNK + (uint32_t)(ks & 3) * 32), 1);
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)  // dP^T = V dout^T, in flight while P^T is computed
          wgmma_ss(dp, desc_kmajor(sVw + (uint32_t)(ks >> 2) * kchunk + (uint32_t)(ks & 3) * 32),
                   desc_kmajor(st + QTILE + (uint32_t)(ks >> 2) * QCHUNK + (uint32_t)(ks & 3) * 32),
                   1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        // P^T on the fragments, packed to bf16 pair by pair (the A fragments of dv's
        // product); s keeps P^T (1 - tanh^2) in f32 for dS^T, 0 where masked.  Every (key,
        // q) pair of the warpgroup's tile visible: no mask
        const bool full = q0 + NQ <= a.S && wk0 + kWgRows <= a.T &&
                          (!a.causal || wk0 + kWgRows - 1 <= q0) &&
                          (!a.has_window || wk0 > q0 + NQ - 1 - a.window);
        uint32_t pa[NQ / 16][4], da[NQ / 16][4];
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
          float pv[2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float x = s[i] * a.scale, fac = 1.f;
            if (a.softcap > 0.f) {
              const float th = tanhf(x / a.softcap);
              x = a.softcap * th;
              fac = 1.f - th * th;
            }
            bool in = true, vis = true;
            if (!full) {
              const int kj = (e & 2) ? kB : kA, qi = q0 + 8 * j + cq + (e & 1);
              in = qi < a.S && kj < a.T;
              vis = in && (!a.causal || kj <= qi) && (!a.has_window || kj > qi - a.window);
            }
            const float p = in ? ex2_approx(((vis ? x : kNegInf) - ((e & 1) ? l2.y : l2.x)) *
                                            kLog2e)
                               : 0.f;
            pv[e & 1] = p;
            if (e & 1) pa[i / 8][(i / 2) % 4] = pack_bf16(pv[0], pv[1]);
            s[i] = vis ? p * fac : 0.f;
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(dva[c]);
        wgmma_fence();
        // dv += P^T dout (the q rows reduced), in flight while dS^T is computed
#pragma unroll
        for (int ks = 0; ks < NQ / 16; ++ks)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_rs_n64_mn(dva[c], pa[ks],
                            desc_mnmajor(st + QTILE + (uint32_t)c * QCHUNK + (uint32_t)ks * 2048),
                            1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(ls + NQ + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float dl = (e & 1) ? d2.y : d2.x;
            const float ds = s[i] * (dp[i] - dl);  // dS^T = P^T (dP^T - delta), by fragment
            dp[i] = ds;
          }
        }
#pragma unroll
        for (int ks = 0; ks < NQ / 16; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            da[ks][r] = pack_bf16(dp[8 * ks + 2 * r], dp[8 * ks + 2 * r + 1]);
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(dka[c]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < NQ / 16; ++ks)  // dk += dS^T Q
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_rs_n64_mn(dka[c], da[ks],
                            desc_mnmajor(st + (uint32_t)c * QCHUNK + (uint32_t)ks * 2048), 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          fence_regs(dka[c]);
          fence_regs(dva[c]);
        }
#pragma unroll
        for (int ks = 0; ks < NQ / 16; ++ks) {
          fence_regs(pa[ks]);
          fence_regs(da[ks]);
        }
      }
      __syncthreads();  // every warpgroup is done with this stage before it is refilled
      hh = nh;
      qt = nq;
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = half ? kB : kA;
    if (kj >= a.T) continue;
    const long long at = (((long long)b * a.T + kj) * hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        if (c * 64 + 8 * jb >= D) continue;  // a padded column (D = 96)
        const int i = 4 * jb + 2 * half, col = c * 64 + 8 * jb + cq;
        store_pair(dk + at + col, dka[c][i] * a.scale, dka[c][i + 1] * a.scale);
        store_pair(dv + at + col, dva[c][i], dva[c][i + 1]);
      }
  }
}

// dk and dv at D = 256: one CTA of two warpgroups per (b, kv head, 64 keys), which split
// the work by role over the same keys (each one's accumulator, 64 x 256 f32, is 128
// registers a thread; both in one warpgroup would be 256).  Warpgroup 0 computes S^T =
// K Q^T, P^T and dv += P^T dout; warpgroup 1 dP^T = V dout^T, dS^T and dk += dS^T Q.
// P^T (1 - tanh^2) passes from the one to the other through shared memory, thread t to
// thread t + 128, which holds the same fragment positions.  K and V are staged once; Q,
// dout, lse and delta go through the two-stage ring over (q head, q tile) of the dk/dv
// kernel above, and every q tile the CTA visits is visible to its keys or blind.
template <int NQ>
__global__ void __launch_bounds__(2 * kWG, 1)
flash_bwd_dkdv_split(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                     const bf16_t* __restrict__ v, const bf16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16_t* __restrict__ dk, bf16_t* __restrict__ dv, const Args a) {
  using namespace hopper;
  constexpr int D = 256, NC = D / 64;
  constexpr int NS = NQ / 2;                  // S^T or dP^T registers a thread
  constexpr uint32_t KCHUNK = kWgRows * 128;  // bytes of one chunk of K or V
  constexpr uint32_t QCHUNK = NQ * 128;       // of one chunk of a Q or dout tile
  constexpr uint32_t QTILE = NC * QCHUNK;
  extern __shared__ uint8_t smem_raw[];

  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NC][64 rows]
  const uint32_t sV = sK + NC * KCHUNK;
  const uint32_t sQ = sV + NC * KCHUNK;  // [2 stages][Q, dout][NC][NQ rows]
  float* const stats = reinterpret_cast<float*>(smem_raw + (sQ + 4 * QTILE - smem_u32(smem_raw)));
  float* const pf_s = stats + 4 * NQ;  // [NS][kWG]: P^T (1 - tanh^2) by fragment

  const int tid = threadIdx.x, nthr = 2 * kWG;
  const int wg = tid / kWG, t = tid % kWG, warp = t / 32, lane = t % 32;
  const int hkv = a.H / a.G;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int k0 = blockIdx.y * kWgRows, k_end = min(k0 + kWgRows, a.T);
  const int kA = k0 + warp * 16 + lane / 4, kB = kA + 8;
  const int cq = 2 * (lane % 4);

  const int n_qt = cdiv(a.S, NQ);
  auto next_qt = [&](int qt) {
    while (qt < n_qt && !visits_qtile(a, qt, NQ, k0, k_end)) ++qt;
    return qt;
  };
  int n_vis = 0;
  for (int qt = 0; qt < n_qt; ++qt) n_vis += visits_qtile(a, qt, NQ, k0, k_end);
  const int n_items = a.G * n_vis;
  auto load_item = [&](int stage, int hh, int qt) {  // Q, dout, lse, delta of (head, q tile)
    tc_load_qitem<D, NQ>(sQ + (uint32_t)stage * 2 * QTILE, stats + stage * 2 * NQ, q, dout, lse,
                         delta, a, b, hk * a.G + hh, qt * NQ, tid, nthr);
  };

  float acc[NC][32];  // warpgroup 0: dv; warpgroup 1: dk / scale
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  // the first product's A (K or V) and the stage's offsets of its B (Q or dout) and of the
  // second product's B (dout or Q)
  const uint32_t sA = wg ? sV : sK, b1 = wg ? QTILE : 0u, b2 = wg ? 0u : QTILE;

  if (n_items > 0) {
    tc_stage<D>(sK, KCHUNK, k + b * a.ksb + hk * a.ksh, a.kss, k0, kWgRows, a.T, tid, nthr);
    tc_stage<D>(sV, KCHUNK, v + b * a.vsb + hk * a.vsh, a.vss, k0, kWgRows, a.T, tid, nthr);
    int hh = 0, qt = next_qt(0);
    load_item(0, hh, qt);
    cp_async_commit();  // group 0: K, V and the first item
    for (int it = 0; it < n_items; ++it) {
      int nh = hh, nq = next_qt(qt + 1);
      if (nq == n_qt) {
        ++nh;
        nq = next_qt(0);
      }
      if (it + 1 < n_items) load_item((it + 1) & 1, nh, nq);
      cp_async_commit();   // (empty on the last item: the count below stays right)
      cp_async_wait<1>();  // item it landed, item it + 1 may still be in flight
      fence_proxy_async_shared();
      __syncthreads();

      const int q0 = qt * NQ;
      const uint32_t st = sQ + (uint32_t)(it & 1) * 2 * QTILE;
      const float* const ls = stats + (it & 1) * 2 * NQ;
      float x[NS];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
#pragma unroll
      for (int i = 0; i < NS; ++i) x[i] = 0.f;
      fence_regs(x);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(x, desc_kmajor(sA + (uint32_t)(ks >> 2) * KCHUNK + (uint32_t)(ks & 3) * 32),
                 desc_kmajor(st + b1 + (uint32_t)(ks >> 2) * QCHUNK + (uint32_t)(ks & 3) * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);

      uint32_t fa[NQ / 16][4] = {};  // the second product's A: P^T (warpgroup 0) or dS^T, bf16
      if (wg == 0) {
        // P^T on the fragments, packed pair by pair; P^T (1 - tanh^2), 0 where masked, to
        // warpgroup 1.  Every (key, q) pair of the tile visible: no mask
        const bool full = q0 + NQ <= a.S && k0 + kWgRows <= a.T &&
                          (!a.causal || k0 + kWgRows - 1 <= q0) &&
                          (!a.has_window || k0 > q0 + NQ - 1 - a.window);
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
          float pv[2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float sc = x[i] * a.scale, fac = 1.f;
            if (a.softcap > 0.f) {
              const float th = tanhf(sc / a.softcap);
              sc = a.softcap * th;
              fac = 1.f - th * th;
            }
            bool in = true, vis = true;
            if (!full) {
              const int kj = (e & 2) ? kB : kA, qi = q0 + 8 * j + cq + (e & 1);
              in = qi < a.S && kj < a.T;
              vis = in && (!a.causal || kj <= qi) && (!a.has_window || kj > qi - a.window);
            }
            const float p = in ? ex2_approx(((vis ? sc : kNegInf) - ((e & 1) ? l2.y : l2.x)) *
                                            kLog2e)
                               : 0.f;
            pv[e & 1] = p;
            if (e & 1) fa[i / 8][(i / 2) % 4] = pack_bf16(pv[0], pv[1]);
            pf_s[i * kWG + t] = vis ? p * fac : 0.f;
          }
        }
      }
      __syncthreads();  // P^T (1 - tanh^2) is whole (uniform: both warpgroups visit the item)
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(ls + NQ + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float dl = (e & 1) ? d2.y : d2.x;
            const float ds = pf_s[i * kWG + t] * (x[i] - dl);  // dS^T = P^T (dP^T - delta), the dK warpgroup's
            x[i] = ds;
          }
        }
#pragma unroll
        for (int ks = 0; ks < NQ / 16; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            fa[ks][r] = pack_bf16(x[8 * ks + 2 * r], x[8 * ks + 2 * r + 1]);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NQ / 16; ++ks)  // dv += P^T dout, or dk += dS^T Q
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_rs_n64_mn(acc[c], fa[ks],
                          desc_mnmajor(st + b2 + (uint32_t)c * QCHUNK + (uint32_t)ks * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int ks = 0; ks < NQ / 16; ++ks) fence_regs(fa[ks]);
      __syncthreads();  // both warpgroups are done with this stage and with pf_s
      hh = nh;
      qt = nq;
    }
    cp_async_wait<0>();
  }

  bf16_t* const dst = wg ? dk : dv;
  const float sc = wg ? a.scale : 1.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = half ? kB : kA;
    if (kj >= a.T) continue;
    const long long at = (((long long)b * a.T + kj) * hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int i = 4 * jb + 2 * half;
        store_pair(dst + at + c * 64 + 8 * jb + cq, acc[c][i] * sc, acc[c][i + 1] * sc);
      }
  }
}

// dq: one CTA per (b, q head, qr = 64 x warpgroups q rows), the longest causal tiles
// first.  Warpgroup wg owns rows q0 + 64 wg .. + 63; a thread's two rows are rA and rA + 8.
// It launches first and writes delta = rowsum(dout . out) of its rows, which the dk/dv
// kernel then reads.
template <int D, int TK>
__global__ void __launch_bounds__(2 * kWG, kTcMinBlocks)
flash_bwd_dq_tc(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                const bf16_t* __restrict__ v, const bf16_t* __restrict__ dout,
                const bf16_t* __restrict__ out, const float* __restrict__ lse,
                float* __restrict__ delta, bf16_t* __restrict__ dq, const Args a) {
  using namespace hopper;
  constexpr int NC = tc_width(D) / 64;
  constexpr int NS = TK / 2;              // S and dP registers a thread
  constexpr uint32_t CHUNK = TK * 128;    // bytes of one chunk of a K or V tile
  constexpr uint32_t TILE = NC * CHUNK;
  extern __shared__ uint8_t smem_raw[];

  const int nthr = blockDim.x, qr = nthr / kWG * kWgRows;
  const uint32_t qchunk = (uint32_t)qr * 128;
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NC][qr rows]
  const uint32_t sO = sQ + NC * qchunk;
  const uint32_t sKV = sO + NC * qchunk;  // [2 stages][K, V][NC][TK rows]

  const int tid = threadIdx.x;
  const int wg = tid / kWG, warp = (tid % kWG) / 32, lane = tid % 32;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * qr;  // longest causal tiles first
  const int last = min(q0 + qr, a.S) - 1;
  const bf16_t* const kb = k + b * a.ksb + (h / a.G) * a.ksh;
  const bf16_t* const vb = v + b * a.vsb + (h / a.G) * a.vsh;

  // the CTA's kv range, as the forward's: [lo(q0), hi(last)) unless its last row sees
  // nothing, then all of [0, T) (those rows add nothing to dq); the warpgroup's by the
  // same rule, empty for a warpgroup with no row below S
  int kv_lo = 0, kv_hi = a.T;
  if (vis_lo(a, last) < vis_hi(a, last)) {
    kv_lo = vis_lo(a, q0);
    kv_hi = vis_hi(a, last);
  }
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
  const int rA = w0 + warp * 16 + lane / 4, rB = rA + 8;
  const int cq = 2 * (lane % 4);
  const long long srow = ((long long)b * a.H + h) * a.S;
  const float lA = rA < a.S ? lse[srow + rA] : 0.f, lB = rB < a.S ? lse[srow + rB] : 0.f;

  tc_zero_pad<D>(sQ, qchunk, qr, tid, nthr);
  tc_zero_pad<D>(sO, qchunk, qr, tid, nthr);
  for (int t = 0; t < 4; ++t) tc_zero_pad<D>(sKV + t * TILE, CHUNK, TK, tid, nthr);  // the ring's
  tc_stage<D>(sQ, qchunk, q + b * a.qsb + h * a.qsh, a.qss, q0, qr, a.S, tid, nthr);
  tc_stage<D>(sO, qchunk, dout + b * a.osb + h * a.osh, a.oss, q0, qr, a.S, tid, nthr);
  auto load_kv = [&](int kt0, uint32_t st) {  // rows past kv_hi zero
    tc_stage<D>(st, CHUNK, kb, a.kss, kt0, TK, kv_hi, tid, nthr);
    tc_stage<D>(st + TILE, CHUNK, vb, a.vss, kt0, TK, kv_hi, tid, nthr);
  };
  const int n_tiles = cdiv(kv_hi - kv_lo, TK);
  load_kv(kv_lo, sKV);
  cp_async_commit();  // group 0: Q, dout and the first kv tile

  // delta of the CTA's rows while the copies fly, a pair of threads a row (half the
  // head dim each, 16-byte loads of out and dout): into global memory for the dk/dv
  // kernel and into shared memory for this one
  float* const dl_s = reinterpret_cast<float*>(smem_raw + (sKV + 4 * TILE - smem_u32(smem_raw)));
  {
    const int r = tid / 2, qi = q0 + r;
    float acc = 0.f;
    if (qi < a.S) {
      const int c0 = (tid & 1) * (D / 2);
      const bf16_t* const orow = out + (((long long)b * a.S + qi) * a.H + h) * D + c0;
      const bf16_t* const grow = dout + b * a.osb + qi * a.oss + h * a.osh + c0;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
        const __nv_bfloat162* const o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* const g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), gf = __bfloat1622float2(g2[e]);
          acc = fmaf(of.x, gf.x, acc);
          acc = fmaf(of.y, gf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      dl_s[r] = acc;
      if (qi < a.S) delta[srow + qi] = acc;
    }
  }
  __syncthreads();
  const float dA = dl_s[rA - q0], dB = dl_s[rB - q0];

  float dqa[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[c][i] = 0.f;
  const uint32_t sQw = sQ + (uint32_t)(wg * kWgRows * 128), sOw = sO + (uint32_t)(wg * kWgRows * 128);

  for (int j = 0; j < n_tiles; ++j) {
    const int kt0 = kv_lo + j * TK;
    const uint32_t st = sKV + (uint32_t)(j & 1) * 2 * TILE;
    if (j + 1 < n_tiles) load_kv(kt0 + TK, sKV + (uint32_t)((j + 1) & 1) * 2 * TILE);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async_shared();
    __syncthreads();

    if (kt0 < wk_hi && kt0 + TK > wk_lo) {  // uniform over the warpgroup
      float s[NS], dp[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)  // S = Q K^T
        wgmma_ss(s, desc_kmajor(sQw + (uint32_t)(ks >> 2) * qchunk + (uint32_t)(ks & 3) * 32),
                 desc_kmajor(st + (uint32_t)(ks >> 2) * CHUNK + (uint32_t)(ks & 3) * 32), 1);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)  // dP = dout V^T, in flight while P is computed
        wgmma_ss(dp, desc_kmajor(sOw + (uint32_t)(ks >> 2) * qchunk + (uint32_t)(ks & 3) * 32),
                 desc_kmajor(st + TILE + (uint32_t)(ks >> 2) * CHUNK + (uint32_t)(ks & 3) * 32),
                 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // s becomes P (1 - tanh^2), 0 where masked; every (q, key) pair of the
      // warpgroup's tile visible: no mask
      const bool full = w0 + kWgRows <= a.S && kt0 + TK <= a.T &&
                        (!a.causal || kt0 + TK - 1 <= w0) &&
                        (!a.has_window || kt0 > w0 + kWgRows - 1 - a.window);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int half = (i >> 1) & 1;
        float x = s[i] * a.scale, fac = 1.f;
        if (a.softcap > 0.f) {
          const float th = tanhf(x / a.softcap);
          x = a.softcap * th;
          fac = 1.f - th * th;
        }
        bool in = true, vis = true;
        if (!full) {
          const int qi = half ? rB : rA, kj = kt0 + 8 * (i >> 2) + cq + (i & 1);
          in = qi < a.S && kj < a.T;
          vis = in && (!a.causal || kj <= qi) && (!a.has_window || kj > qi - a.window);
        }
        const float p = in ? ex2_approx(((vis ? x : kNegInf) - (half ? lB : lA)) * kLog2e) : 0.f;
        s[i] = vis ? p * fac : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float dl = ((i >> 1) & 1) ? dB : dA;
        const float ds = s[i] * (dp[i] - dl);  // dS = P (dP - delta), by fragment
        s[i] = ds;
      }
      uint32_t da[TK / 16][4];  // dS in bf16: the A fragments over the keys
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) da[ks][r] = pack_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(dqa[c]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks)  // dq += dS K, the keys reduced
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_rs_n64_mn(dqa[c], da[ks],
                          desc_mnmajor(st + (uint32_t)c * CHUNK + (uint32_t)ks * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(dqa[c]);
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) fence_regs(da[ks]);
    }
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? rB : rA;
    if (qi >= a.S) continue;
    bf16_t* const row = dq + (((long long)b * a.S + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        if (c * 64 + 8 * jb >= D) continue;  // a padded column (D = 96)
        const int i = 4 * jb + 2 * half;
        store_pair(row + c * 64 + 8 * jb + cq, dqa[c][i] * a.scale, dqa[c][i + 1] * a.scale);
      }
  }
}

// the plan's rows a CTA: 64 x the table's warpgroups, one warpgroup where n fits 64 rows
inline int tc_rows(int n, int warpgroups) { return n <= kWgRows ? kWgRows : kWgRows * warpgroups; }

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout, const void* out,
              const float* lse, float* delta, void* dq, void* dk, void* dv, int B, const Args& a,
              cudaStream_t s) {
  constexpr int NQ = tc_tile(D, 1), TK = tc_tile(D, 3);
  static_assert(D != 256 || tc_split_smem(NQ) <= (size_t)kSmemMax, "shared memory");
  // the attributes are set once a device, at the largest size (two warpgroups)
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !attr_set[dev]) {
    if constexpr (D == 256)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_split<NQ>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)tc_split_smem(NQ));
    else
      err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<D, NQ>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)tc_dkdv_smem(D, 2 * kWgRows, NQ));
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dq_tc<D, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tc_dq_smem(D, 2 * kWgRows, TK));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }
  const int kr = tc_rows(a.T, tc_tile(D, 0)), qr = tc_rows(a.S, tc_tile(D, 2));
  if (cdiv(a.T, kr) > 65535 || cdiv(a.S, qr) > 65535) return (int)cudaErrorInvalidValue;
  const bf16_t* qt = static_cast<const bf16_t*>(q);
  const bf16_t* kt = static_cast<const bf16_t*>(k);
  const bf16_t* vt = static_cast<const bf16_t*>(v);
  const bf16_t* ot = static_cast<const bf16_t*>(dout);
  flash_bwd_dq_tc<D, TK><<<dim3(B * a.H, cdiv(a.S, qr)), qr / kWgRows * kWG,
                           tc_dq_smem(D, qr, TK), s>>>(
      qt, kt, vt, ot, static_cast<const bf16_t*>(out), lse, delta, static_cast<bf16_t*>(dq), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (D == 256)  // kr = 64: the two warpgroups share the keys
    flash_bwd_dkdv_split<NQ><<<dim3(B * (a.H / a.G), cdiv(a.T, kr)), 2 * kWG,
                               tc_split_smem(NQ), s>>>(
        qt, kt, vt, ot, lse, delta, static_cast<bf16_t*>(dk), static_cast<bf16_t*>(dv), a);
  else
    flash_bwd_dkdv_tc<D, NQ><<<dim3(B * (a.H / a.G), cdiv(a.T, kr)), kr / kWgRows * kWG,
                               tc_dkdv_smem(D, kr, NQ), s>>>(
        qt, kt, vt, ot, lse, delta, static_cast<bf16_t*>(dk), static_cast<bf16_t*>(dv), a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan, as kernels/flash_attention.py::bwd_launch_plan computes it:
// out[0..4] = route (1 = "wgmma", 0 = "simt"), keys of a dk/dv CTA, its q tile,
// q rows of a dq CTA, its kv tile.  A head dim with no instance is refused
// (cudaErrorInvalidValue).
int looptune_flash_attention_bwd_plan(int S, int T, int D, int bf16, int* out) {
  if (S < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (D != 8 && D != 16 && D != 32 && D != 64 && D != 96 && D != 128 && D != 256)
    return (int)cudaErrorInvalidValue;
  out[0] = bf16 && D >= 64;
  if (out[0]) {
    out[1] = tc_rows(T, tc_tile(D, 0));
    out[2] = tc_tile(D, 1);
    out[3] = tc_rows(S, tc_tile(D, 2));
    out[4] = tc_tile(D, 3);
  } else {
    out[1] = out[2] = out[3] = out[4] = simt_tile(D);
  }
  return 0;
}

// Launches both kernels on `stream` without synchronising; returns the first
// cudaGetLastError() that is not 0 (0 on success).  q: (B, S, H, D), k and v:
// (B, T, HKV, D), dout: (B, S, H, D), each through element strides (b, s, h)
// with the head dim contiguous; out: the forward's (B, S, H, D), contiguous;
// lse and delta: (B, H, S) f32 contiguous.  On the "simt" route delta is the
// caller's rowsum(dout . out) and out is not read; on the "wgmma" route the dq
// kernel launches first, computes delta from out and dout and writes it, and
// the dk/dv kernel reads it.  dq (B, S, H, D), dk and dv (B, T, HKV, D)
// contiguous, written whole.  All of
// q, k, v, dout, dq, dk, dv f32, or all bf16 (bf16 = 1).  D in {8, 16, 32,
// 64, 96, 128, 256}; H a multiple of HKV; softcap <= 0 means none.  The route and
// tiles are looptune_flash_attention_bwd_plan's; on the "wgmma" route every
// base is 16-byte aligned and every stride a multiple of 8 elements (the
// wrapper checks).
int looptune_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 const void* out, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int S, int T, int H, int HKV, int D,
                                 long long qsb, long long qss, long long qsh, long long ksb,
                                 long long kss, long long ksh, long long vsb, long long vss,
                                 long long vsh, long long osb, long long oss, long long osh,
                                 float scale, float softcap, int causal, int has_window,
                                 int window, int bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || H < 1 || HKV < 1 || H % HKV != 0)
    return (int)cudaErrorInvalidValue;
  const int wmax = S + T;
  const int w = window < -wmax ? -wmax : (window > wmax ? wmax : window);
  auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_q = !bf16 && al16(q) && qsb % 4 == 0 && qss % 4 == 0 && qsh % 4 == 0;
  const int vec_kv = !bf16 && al16(k) && al16(v) && ksb % 4 == 0 && kss % 4 == 0 &&
                     ksh % 4 == 0 && vsb % 4 == 0 && vss % 4 == 0 && vsh % 4 == 0;
  const int vec_do = !bf16 && al16(dout) && osb % 4 == 0 && oss % 4 == 0 && osh % 4 == 0;
  const Args a{S, T, H, H / HKV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,
               scale, softcap, causal, has_window, w, vec_q, vec_kv, vec_do};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* const dl = static_cast<float*>(delta);
  if (bf16 && D == 64) return launch_tc<64>(q, k, v, dout, out, l, dl, dq, dk, dv, B, a, s);
  if (bf16 && D == 96) return launch_tc<96>(q, k, v, dout, out, l, dl, dq, dk, dv, B, a, s);
  if (bf16 && D == 128) return launch_tc<128>(q, k, v, dout, out, l, dl, dq, dk, dv, B, a, s);
  if (bf16 && D == 256) return launch_tc<256>(q, k, v, dout, out, l, dl, dq, dk, dv, B, a, s);
  if (bf16) return launch_d<__nv_bfloat16>(D, q, k, v, dout, l, dl, dq, dk, dv, B, a, s);
  return launch_d<float>(D, q, k, v, dout, l, dl, dq, dk, dv, B, a, s);
}

}  // extern "C"
