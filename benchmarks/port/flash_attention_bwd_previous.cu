// The previous design of csrc/flash_attention_bwd.cu (SIMT f32 FMAs at every
// dtype and head dim: bf16 widened as it is staged, no double buffering, S and
// dP computed in both launches), kept unchanged as the baseline of
// benchmarks/port/flash_bwd_plans.py.  It exports the same launch entry point
// and is loaded through the same wrapper.
//
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
// with delta = rowsum(dout . out), which the wrapper computes in torch ops
// (the reference computes it outside its scan too).  p is not masked, as in
// the reference: a row with no visible key has lse = -1e30 (its l is
// T_pad, which the f32 sum -1e30 + log(T_pad) does not see), so it gets p = 1
// at every key and adds its dout to each key's dv, and nothing to dq or dk.
// GQA: dk and dv of a kv head sum over its group of q heads.  Outputs in the
// inputs' dtype, from f32 accumulators.
//
// Design: the simple one that is right, two launches and no atomics, so
// results repeat bit for bit:
//   * flash_bwd_dkdv: one CTA per (b, kv head, 64-key tile).  K and V are
//     staged once; the CTA loops over the group's q heads and the 64-row q
//     tiles whose rows can see the tile (all of them for a tile that holds a
//     row with no visible key), staging Q, dout, lse and delta, recomputing
//     S and dP = dout V^T, and accumulating dv += P^T dout and dk += dS^T Q
//     in registers;
//   * flash_bwd_dq: one CTA per (b, q head, 64-row q tile), the longest
//     causal tiles first.  Q, dout, lse and delta are staged once; the CTA
//     loops over the kv tiles its rows can see (as the forward's CTA does),
//     recomputes S and dP and accumulates dq += dS K.
//   Both are SIMT f32 FMAs from shared memory, 256 threads, 16 (ty) x 16
//   (tx): in the score products a thread owns q rows 4 ty + i and kv
//   columns tx + 16 j (i, j < 4), reading Q (a broadcast over the half-warp)
//   and K (16 rows padded by 4 floats: distinct bank groups) as float4; in
//   the accumulations it owns rows 4 ty + e (kv rows in dkdv, q rows in dq)
//   and head-dim columns 64 c + 4 tx + e (below D only, as the forward's
//   SIMT route), reading P / dS as float4 along those rows.  bf16 inputs are
//   widened as they are staged; f32 rows go by 16-byte cp.async
//   (hopper.cuh) where aligned.  No double buffering: each tile is staged,
//   then multiplied.  The products' head-dim loop is not unrolled, so that
//   at D <= 64 a thread fits 128 registers without spilling and two CTAs
//   share an SM: 2.51 ms against 3.44 at one CTA an SM (~168 registers) at
//   (4, 1024, 32, 64) bf16 causal, 2.16 against 2.66 in f32 (an H100 SXM
//   at 700 W).
//   Instances: D = 8, 16, 32, 64, 96 and 128 (every smoke config's 16,
//   musicgen-large's 64, the zoo's 96 and 128).  Shared memory is 4 (4 x 64
//   (D + 4) + 2 x 64 x 68 + 128) bytes in dkdv (170.5 KB at D = 128); D =
//   256 would fit shared memory at 32-row q tiles, but its dk and dv
//   accumulators alone are 128 registers a thread: no instance, the launch
//   is refused.
//
// Bound on this card: max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s), the FLOP
// 10 B H D (visible pairs) of the five products (S recomputed, dP, dv, dk,
// dq) and the bytes q, k, v, out, dout read once, lse and delta, and dq,
// dk, dv written once.  At musicgen-large's training shape (4, 1024, 32, 64)
// bf16, causal: 4.3e10 FLOP (43 us) against 134 MB (40 us).  SIMT f32 FMAs
// (67 TFLOP/s at most) put this design far above that bound; wgmma, TMA and
// warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;  // 16 (ty) x 16 (tx)
constexpr int kTile = 64;      // q rows and kv rows of a tile, in both kernels
constexpr int kPad = 4;        // floats a staged row is padded by
constexpr int kPP = kTile + kPad;
constexpr int kSmemMax = 232448;

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
  return sizeof(float) * (size_t)(4 * kTile * (d + kPad) + 2 * kTile * kPP + 2 * kTile);
}
__host__ __device__ constexpr size_t dq_smem_bytes(int d) {
  return sizeof(float) * (size_t)(4 * kTile * (d + kPad) + kTile * kPP + 2 * kTile);
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

// rows [r0, r0 + kTile) of one head into dst [kTile][D + kPad] f32, rows >=
// r_hi zero: f32 by 16-byte cp.async (vec) or 4-byte cp.async, bf16 through
// registers, widened
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ss, int r0,
                                           int r_hi, int vec, int tid) {
  using namespace hopper;
  constexpr int DP = D + kPad;
  if constexpr (sizeof(T) == 2) {
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D, d = e % D, rj = r0 + r;
      dst[r * DP + d] = rj < r_hi ? to_f(src[rj * ss + d]) : 0.f;
    }
  } else if (vec) {
    for (int e = tid; e < kTile * (D / 4); e += kThreads) {
      const int r = e / (D / 4), d = 4 * (e % (D / 4)), rj = r0 + r;
      const bool in = rj < r_hi;
      cp_async16(smem_u32(dst + r * DP + d), in ? src + rj * ss + d : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D, d = e % D, rj = r0 + r;
      const bool in = rj < r_hi;
      cp_async4(smem_u32(dst + r * DP + d), in ? src + rj * ss + d : src, in ? 4 : 0);
    }
  }
}

// lse and delta of q rows [q0, q0 + kTile) into shared memory (0 past S)
__device__ __forceinline__ void stage_stats(float* lse_s, float* dl_s, const float* lse,
                                            const float* delta, int q0, int S, int tid) {
  if (tid < kTile) {
    const int qi = q0 + tid;
    lse_s[tid] = qi < S ? lse[qi] : 0.f;
    dl_s[tid] = qi < S ? delta[qi] : 0.f;
  }
}

// s = Q K^T and dp = dO V^T at the thread's q rows 4 ty + i and kv columns
// tx + 16 j, the head dim in order
template <int D>
__device__ __forceinline__ void score_products(const float* Qs, const float* Ks,
                                               const float* dOs, const float* Vs, int tx,
                                               int ty, float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int DP = D + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    float4 qa[4], kk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * DP + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) kk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i].x, kk[j].x, s[i][j]);
        s[i][j] = fmaf(qa[i].y, kk[j].y, s[i][j]);
        s[i][j] = fmaf(qa[i].z, kk[j].z, s[i][j]);
        s[i][j] = fmaf(qa[i].w, kk[j].w, s[i][j]);
      }
  }
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    float4 oa[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) oa[i] = *reinterpret_cast<const float4*>(dOs + (4 * ty + i) * DP + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dp[i][j] = fmaf(oa[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(oa[i].y, vv[j].y, dp[i][j]);
        dp[i][j] = fmaf(oa[i].z, vv[j].z, dp[i][j]);
        dp[i][j] = fmaf(oa[i].w, vv[j].w, dp[i][j]);
      }
  }
}

// from the products s and dp at q rows q0 + 4 ty + i and keys k0 + tx + 16 j:
// p (into p) and ds (into s)
__device__ __forceinline__ void score_grads(const Args& a, int q0, int k0, const float* lse_s,
                                            const float* dl_s, int tx, int ty, float (&s)[4][4],
                                            const float (&dp)[4][4], float (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
  constexpr int DP = D + kPad;
  constexpr int QD = (D + 63) / 64;  // runs of 4 head-dim columns a thread
  extern __shared__ float4 smem4[];
  float* const Ks = reinterpret_cast<float*>(smem4);  // [kTile][DP]
  float* const Vs = Ks + kTile * DP;
  float* const Qs = Vs + kTile * DP;
  float* const dOs = Qs + kTile * DP;
  float* const Ps = dOs + kTile * DP;  // [q][key]
  float* const dSs = Ps + kTile * kPP;  // [q][key]
  float* const lse_s = dSs + kTile * kPP;
  float* const dl_s = lse_s + kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int hkv = a.H / a.G;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int k0 = blockIdx.y * kTile, k_end = min(k0 + kTile, a.T);
  auto cols_ok = [&](int c) { return D % 64 == 0 || 64 * c + 4 * tx < D; };
  const bool has_cols = cols_ok(0);

  stage_rows<T, D>(Ks, k + b * a.ksb + hk * a.ksh, a.kss, k0, a.T, a.vec_kv, tid);
  stage_rows<T, D>(Vs, v + b * a.vsb + hk * a.vsh, a.vss, k0, a.T, a.vec_kv, tid);
  cp_async_commit();

  float dka[4][4 * QD], dva[4][4 * QD];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < 4 * QD; ++c) dka[e][c] = dva[e][c] = 0.f;

  const int n_qt = cdiv(a.S, kTile);
  for (int hh = 0; hh < a.G; ++hh) {
    const int h = hk * a.G + hh;
    const T* const qb = q + b * a.qsb + h * a.qsh;
    const T* const ob = dout + b * a.osb + h * a.osh;
    const float* const lb = lse + ((long long)b * a.H + h) * a.S;
    const float* const db = delta + ((long long)b * a.H + h) * a.S;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile, last = min(q0 + kTile, a.S) - 1;
      // the tile's rows see keys in [lo(q0), hi(last)), unless its last row
      // sees none: then every key gets that row's p = 1 (uniform over the CTA)
      const bool blind = vis_lo(a, last) >= vis_hi(a, last);
      if (!blind && (k0 >= vis_hi(a, last) || k_end <= vis_lo(a, q0))) continue;
      __syncthreads();  // every thread is done with the previous tile's Q, dO, P, dS
      stage_rows<T, D>(Qs, qb, a.qss, q0, a.S, a.vec_q, tid);
      stage_rows<T, D>(dOs, ob, a.oss, q0, a.S, a.vec_do, tid);
      stage_stats(lse_s, dl_s, lb, db, q0, a.S, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      float s[4][4], dp[4][4], p[4][4];
      score_products<D>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
      score_grads(a, q0, k0, lse_s, dl_s, tx, ty, s, dp, p);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(4 * ty + i) * kPP + tx + 16 * j] = p[i][j];
          dSs[(4 * ty + i) * kPP + tx + 16 * j] = s[i][j];
        }
      __syncthreads();  // P and dS are whole

      if (has_cols) {  // dv += P^T dO, dk += dS^T Q, the q rows in order
#pragma unroll 4
        for (int qq = 0; qq < kTile; ++qq) {
          const float4 pa = *reinterpret_cast<const float4*>(Ps + qq * kPP + 4 * ty);
          const float4 da = *reinterpret_cast<const float4*>(dSs + qq * kPP + 4 * ty);
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
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < 4 * QD; ++c) {
              dva[e][c] = fmaf(lane4(pa, e), lane4(oo[c / 4], c % 4), dva[e][c]);
              dka[e][c] = fmaf(lane4(da, e), lane4(qv[c / 4], c % 4), dka[e][c]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();  // a tile no q row sees still has its K, V copies in flight

  if (!has_cols) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kj = k0 + 4 * ty + e;
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
  constexpr int DP = D + kPad;
  constexpr int QD = (D + 63) / 64;
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);  // [kTile][DP]
  float* const dOs = Qs + kTile * DP;
  float* const Ks = dOs + kTile * DP;
  float* const Vs = Ks + kTile * DP;
  float* const dSt = Vs + kTile * DP;  // [key][q]: dS transposed
  float* const lse_s = dSt + kTile * kPP;
  float* const dl_s = lse_s + kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kTile;  // longest causal tiles first
  const int last = min(q0 + kTile, a.S) - 1;
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
  stage_rows<T, D>(Qs, q + b * a.qsb + h * a.qsh, a.qss, q0, a.S, a.vec_q, tid);
  stage_rows<T, D>(dOs, dout + b * a.osb + h * a.osh, a.oss, q0, a.S, a.vec_do, tid);
  stage_stats(lse_s, dl_s, lse + ((long long)b * a.H + h) * a.S,
              delta + ((long long)b * a.H + h) * a.S, q0, a.S, tid);

  float dqa[4][4 * QD];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < 4 * QD; ++c) dqa[e][c] = 0.f;

  const int n_tiles = cdiv(kv_hi - kv_lo, kTile);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_lo + j * kTile;
    __syncthreads();  // every thread is done with the previous tile's K and dS
    stage_rows<T, D>(Ks, kb, a.kss, k0, kv_hi, a.vec_kv, tid);
    stage_rows<T, D>(Vs, vb, a.vss, k0, kv_hi, a.vec_kv, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4];
    score_products<D>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
    score_grads(a, q0, k0, lse_s, dl_s, tx, ty, s, dp, p);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)  // dS transposed: a float4 of 4 q rows a key
      *reinterpret_cast<float4*>(dSt + (tx + 16 * jj) * kPP + 4 * ty) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    __syncthreads();  // dS is whole

    if (has_cols) {  // dq += dS K, the keys in order
#pragma unroll 4
      for (int kk = 0; kk < kTile; ++kk) {
        const float4 da = *reinterpret_cast<const float4*>(dSt + kk * kPP + 4 * ty);
        float4 kv[QD];
#pragma unroll
        for (int c = 0; c < QD; ++c)
          kv[c] = cols_ok(c) ? *reinterpret_cast<const float4*>(Ks + kk * DP + 64 * c + 4 * tx)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < 4 * QD; ++c)
            dqa[e][c] = fmaf(lane4(da, e), lane4(kv[c / 4], c % 4), dqa[e][c]);
      }
    }
  }
  cp_async_wait<0>();

  if (!has_cols) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int qi = q0 + 4 * ty + e;
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
  constexpr size_t sm1 = dkdv_smem_bytes(D), sm2 = dq_smem_bytes(D);
  static_assert(sm1 <= (size_t)kSmemMax && sm2 <= (size_t)kSmemMax, "shared memory");
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
  flash_bwd_dkdv<T, D><<<dim3(B * (a.H / a.G), cdiv(a.T, kTile)), kThreads, sm1, s>>>(
      qt, kt, vt, ot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<T, D><<<dim3(B * a.H, cdiv(a.S, kTile)), kThreads, sm2, s>>>(
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
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
    case 96: return launch<T, 96>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` without synchronising; returns the first
// cudaGetLastError() that is not 0 (0 on success).  q: (B, S, H, D), k and v:
// (B, T, HKV, D), dout: (B, S, H, D), each through element strides (b, s, h)
// with the head dim contiguous; lse and delta: (B, H, S) f32 contiguous; dq
// (B, S, H, D), dk and dv (B, T, HKV, D) contiguous, written whole.  All of
// q, k, v, dout, dq, dk, dv f32, or all bf16 (bf16 = 1).  D in {8, 16, 32,
// 64, 96, 128}; H a multiple of HKV; softcap <= 0 means none.
int looptune_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* dk,
                                 void* dv, int B, int S, int T, int H, int HKV, int D,
                                 long long qsb, long long qss, long long qsh, long long ksb,
                                 long long kss, long long ksh, long long vsb, long long vss,
                                 long long vsh, long long osb, long long oss, long long osh,
                                 float scale, float softcap, int causal, int has_window,
                                 int window, int bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || H < 1 || HKV < 1 || H % HKV != 0)
    return (int)cudaErrorInvalidValue;
  if (cdiv(S, kTile) > 65535 || cdiv(T, kTile) > 65535) return (int)cudaErrorInvalidValue;
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
  const float* dl = static_cast<const float*>(delta);
  if (bf16) return launch_d<__nv_bfloat16>(D, q, k, v, dout, l, dl, dq, dk, dv, B, a, s);
  return launch_d<float>(D, q, k, v, dout, l, dl, dq, dk, dv, B, a, s);
}

}  // extern "C"
