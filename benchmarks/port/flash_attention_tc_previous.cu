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
//   and most of the zoo) and 256 (gemma3-12b):
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
//   * D = 96 is staged as 128 columns (two swizzle chunks, the second half
//     full): Q·Kᵀ runs its six k-steps of 16 and never reads the padding;
//     P·V runs n64 on both chunks, and the 32 padded output columns (zero
//     V columns, zeroed once in shared memory) are not stored.  That is a
//     third more P·V work than D needs, the price of one layout for every D;
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
//     (wgmma's N: 16, 32 or 64 at D = 64; 16 or 32 at D = 96 and 128; 16 at
//     D = 256, where the 64 x 256 accumulator is 128 registers a thread and
//     P·V is one k-step).  The cap is the largest tile at
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
//   16.8 MB of q, k, v and o (5.0 us).  No warp specialisation, setmaxnreg
//   or TMA yet.  Overlapping a tile's softmax with the previous tile's P·V
//   (K one tile ahead of V in the ring) measured no faster on the card and
//   was not kept.
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
// "wgmma" route: bf16 at D = 64 and 128 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWG = 128;      // threads of a warpgroup
constexpr int kWgRows = 64;   // q rows of a warpgroup: wgmma's M
// the head dim as staged: whole 64-column swizzle chunks (D = 96 -> 128)
__host__ __device__ constexpr int tc_width(int d) { return (d + 63) / 64 * 64; }
// kv tile <= kTcKvCap / tc_width(D): 64 keys at D = 64, 32 at D = 96 and 128,
// 16 at D = 256
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
  constexpr int PR = D / 8;             // 16-byte pieces of a row loaded (the rest zero)
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
  if constexpr (PR < NC * 8) {  // D = 96: the pieces past D are never loaded; zero them once
    for (int e = tid; e < (qt + 4 * TK) * (NC * 8 - PR); e += nthr) {
      const int r = e / (NC * 8 - PR), c = PR + e % (NC * 8 - PR);
      const uint32_t at = r < qt ? sQ + (uint32_t)((c >> 3) * qt * 128) + sw128(r, c & 7)
                                 : sKV + (uint32_t)((r - qt) / TK) * TILE +
                                       (uint32_t)(c >> 3) * CHUNK + sw128((r - qt) % TK, c & 7);
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0u) : "memory");
    }
  }
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
        if (c * 64 + 8 * jb >= D) continue;  // a padded column (D = 96)
        const int i = 4 * jb + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 64 + 8 * jb + cq) =
            __floats2bfloat162_rn(acc[c][i] / l, acc[c][i + 1] / l);
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

}  // namespace

extern "C" {

// The launch plan, as kernels/flash_attention.py::launch_plan computes it:
// out[0..3] = q rows, kv columns, T_pad, route (1 = "wgmma", 0 = "simt").
// A head dim the kernel has no instance for is refused (cudaErrorInvalidValue).
int looptune_flash_attention_plan(int S, int T, int bq, int bk, int D, int bf16, int* out) {
  if (S < 1 || T < 1 || bq < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  if (D != 8 && D != 16 && D != 32 && D != 64 && D != 96 && D != 128 && D != 256)
    return (int)cudaErrorInvalidValue;
  bq = bq < S ? bq : S;
  bk = bk < T ? bk : T;
  out[2] = cdiv(T, bk) * bk;
  out[3] = bf16 && D >= 64;
  if (out[3]) {
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
  int plan[4];
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
  if (plan[3]) {
    switch (D) {
      case 64: return launch_tc_tk<64>(plan[1], q, k, v, o, B, plan[0], a, s);
      case 96: return launch_tc_tk<96>(plan[1], q, k, v, o, B, plan[0], a, s);
      case 128: return launch_tc_tk<128>(plan[1], q, k, v, o, B, plan[0], a, s);
      default: return launch_tc_tk<256>(plan[1], q, k, v, o, B, plan[0], a, s);
    }
  }
  if (bf16) return launch_d<__nv_bfloat16>(D, plan[0], plan[1], q, k, v, o, B, a, s);
  return launch_d<float>(D, plan[0], plan[1], q, k, v, o, B, a, s);
}

}  // extern "C"
