// The previous design of csrc/flash_attention.cu (its SIMT route: 128
// threads, 8 x 4 score tiles, K and V staged synchronously), kept unchanged
// as the baseline of benchmarks/port/flash_simt_plans.py.  It exports the
// same C entry points and is loaded through the same wrapper.
//
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
// "wgmma" — bf16 at D = 64 (musicgen-large) and D = 128 (jamba-v0.1-52b):
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
//     and no libcuda entry point to link;
//   * block mapping: the "fa" registry block (bq, bk), clamped to (S, T),
//     becomes q tile = 64 if bq <= 64 else 128 (one or two warpgroups) and
//     kv tile = the power of two >= bk in [16, 4096 / D] (wgmma's N: 16, 32
//     or 64 at D = 64; 16 or 32 at D = 128).  The cap is the largest tile at
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
//   wgmma's depth of 16): the SIMT kernel, f32 FMAs from shared memory.  f32
//   stays there because the f32 limit is 3e-5 (the JAX kernel tests') and
//   TF32 products keep about 3 decimal digits.  q is widened to f32 and
//   scaled by 1/sqrt(D) before the product, as in the TPU kernel; p stays f32
//   for the p @ v product.  Block mapping:
//     q tile  = 8 * clamp(cdiv(bq, 8), 1, 8)    -> 8, 16, ..., 64 rows,
//     kv tile = 16 * clamp(cdiv(bk, 16), 1, 4)  -> 16, 32, 48 or 64 keys,
//   (128 threads: 8 row groups of 16 lanes; a thread owns up to 8 q rows and
//   up to 4 kv columns of the score tile, and the same q rows by D/16 columns
//   of the output).  Each thread computes an 8 x 4 score micro-tile per kv
//   tile (12 shared loads per 32 FMAs), bound by FP32 issue.  Q and K rows
//   are padded to D + 1 floats and P rows to 65 against bank conflicts.
//   Shared memory (~65 KB at D = 64, 115,456 bytes at D = 128) is dynamic,
//   after cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowGroups = 8;                  // threads along q rows
constexpr int kLanes = 16;                     // threads along kv columns / head dim
constexpr int kMaxRQ = 8;                      // q rows per thread
constexpr int kMaxCK = 4;                      // kv columns per thread
constexpr int kMaxTQ = kRowGroups * kMaxRQ;    // 64
constexpr int kMaxTK = kLanes * kMaxCK;        // 64
constexpr int kPP = kMaxTK + 1;                // padded P row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(kMaxTQ * (d + 1) + kMaxTK * (d + 1) + kMaxTK * d +
                                  kMaxTQ * kPP);
}

struct Args {
  int S, T, H, G;                 // G = H / HKV
  long long qsb, qss, qsh;        // element strides of q (head dim contiguous)
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  int rq, ck;                     // q rows and kv columns per thread (SIMT route)
  float scale, softcap;           // softcap <= 0: none
  int causal, has_window, window; // window clamped to [-(S+T), S+T]
  int t_pad;                      // cdiv(T, bk) * bk
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, const Args a) {
  constexpr int DP = D + 1;
  constexpr int CD = (D + kLanes - 1) / kLanes;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kMaxTQ][DP], pre-scaled
  float* Ks = Qs + kMaxTQ * DP;        // [kMaxTK][DP]
  float* Vs = Ks + kMaxTK * DP;        // [kMaxTK][D]
  float* Ps = Vs + kMaxTK * D;         // [kMaxTQ][kPP]

  const int tq = kRowGroups * a.rq;
  const int tk = kLanes * a.ck;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * tq;
  const int q_end = min(q0 + tq, a.S);
  const int tid = threadIdx.x;
  const int tx = tid % kLanes, ty = tid / kLanes;

  const T* qb = q + b * a.qsb + h * a.qsh;
  const T* kb = k + b * a.ksb + (h / a.G) * a.ksh;
  const T* vb = v + b * a.vsb + (h / a.G) * a.vsh;

  for (int e = tid; e < tq * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int qi = q0 + r;
    Qs[r * DP + d] = qi < a.S ? to_f(qb[(long long)qi * a.qss + d]) * a.scale : 0.f;
  }

  // Keys row qi sees: [lo(qi), hi(qi)).  Both ends grow with qi, so the
  // tile needs [lo(q0), hi(last)) unless its last row sees nothing.
  const int last = q_end - 1;
  const int lo_last = a.has_window ? max(0, last - a.window + 1) : 0;
  const int hi_last = a.causal ? min(a.T, last + 1) : a.T;
  int kv_lo = 0, kv_hi = a.T;
  if (lo_last < hi_last) {
    kv_lo = a.has_window ? max(0, q0 - a.window + 1) : 0;
    kv_hi = hi_last;
  }

  float m_i[kMaxRQ], l_i[kMaxRQ], acc[kMaxRQ][CD];
#pragma unroll
  for (int i = 0; i < kMaxRQ; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += tk) {
    __syncthreads();  // Qs written; the previous tile's Ks/Vs/Ps read
    for (int e = tid; e < tk * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int kj = k0 + c;
      const bool in = kj < kv_hi;
      Ks[c * DP + d] = in ? to_f(kb[(long long)kj * a.kss + d]) : 0.f;
      Vs[c * D + d] = in ? to_f(vb[(long long)kj * a.vss + d]) : 0.f;
    }
    __syncthreads();

    float s[kMaxRQ][kMaxCK];
#pragma unroll
    for (int i = 0; i < kMaxRQ; ++i)
#pragma unroll
      for (int j = 0; j < kMaxCK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[kMaxRQ], kk[kMaxCK];
#pragma unroll
      for (int i = 0; i < kMaxRQ; ++i)
        qa[i] = i < a.rq ? Qs[(ty + i * kRowGroups) * DP + d] : 0.f;
#pragma unroll
      for (int j = 0; j < kMaxCK; ++j)
        kk[j] = j < a.ck ? Ks[(tx + j * kLanes) * DP + d] : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxRQ; ++i)
#pragma unroll
        for (int j = 0; j < kMaxCK; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kMaxRQ; ++i) {
      if (i >= a.rq) break;  // uniform over the CTA: the shuffles below see every lane
      const int r = ty + i * kRowGroups;
      const int qi = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kMaxCK; ++j) {
        const int kj = k0 + tx + j * kLanes;
        float x = s[i][j];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const bool vis = j < a.ck && qi < a.S && kj < a.T && (!a.causal || kj <= qi) &&
                         (!a.has_window || kj > qi - a.window);
        x = vis ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxCK; ++j) {
        if (j < a.ck) {
          const float p = expf(s[i][j] - m_new);
          Ps[r * kPP + tx + j * kLanes] = p;
          rs += p;
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < tk; ++j) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int d = tx + c * kLanes;
        vv[c] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMaxRQ; ++i) {
        if (i < a.rq) {
          const float p = Ps[(ty + i * kRowGroups) * kPP + j];
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRQ; ++i) {
    if (i >= a.rq) break;
    const int qi = q0 + ty + i * kRowGroups;
    if (qi >= a.S) continue;
    const int lo = a.has_window ? max(0, qi - a.window + 1) : 0;
    const int hi = a.causal ? min(a.T, qi + 1) : a.T;
    const float l = fmaxf(lo < hi ? l_i[i] : (float)a.t_pad, 1e-30f);
    T* orow = o + (((long long)b * a.S + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + c * kLanes;
      if (d < D) orow[d] = from_f<T>(acc[i][c] / l);
    }
  }
}

// ---------------------------------------------------------------------------
// "wgmma" route: bf16 at D = 64 and 128 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWG = 128;      // threads of a warpgroup
constexpr int kWgRows = 64;   // q rows of a warpgroup: wgmma's M
constexpr int kTcKvCap = 4096;  // kv tile <= kTcKvCap / D: 64 keys at D = 64, 32 at D = 128
constexpr float kLog2e = 1.4426950408889634f;

// the keys row qi sees are [vis_lo, vis_hi); both ends grow with qi
__device__ __forceinline__ int vis_lo(const Args& a, int qi) {
  return a.has_window ? max(0, qi - a.window + 1) : 0;
}
__device__ __forceinline__ int vis_hi(const Args& a, int qi) {
  return a.causal ? min(a.T, qi + 1) : a.T;
}

constexpr size_t tc_smem_bytes(int d, int qt, int tk) {
  return 1024 + (size_t)d * 2 * (qt + 4 * tk);  // alignment slack, Q, 2 x (K, V)
}

template <int D, int TK>
__global__ void __launch_bounds__(2 * kWG, 1)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             const Args a) {
  using namespace hopper;
  constexpr int NC = D / 64;          // 64-column chunks of the head dim
  constexpr int PR = D / 8;           // 16-byte pieces of a row
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

inline int cdiv(int x, int y) { return (x + y - 1) / y; }
inline int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, const Args& a,
           cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.H, cdiv(a.S, kRowGroups * a.rq));
  flash_fwd<T, D><<<grid, kThreads, smem, s>>>(static_cast<const T*>(q),
                                               static_cast<const T*>(k),
                                               static_cast<const T*>(v),
                                               static_cast<T*>(o), a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o, int B,
             const Args& a, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, a, s);
    case 16: return launch<T, 16>(q, k, v, o, B, a, s);
    case 32: return launch<T, 32>(q, k, v, o, B, a, s);
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 takes the "wgmma" route here
    if (D == 64) return launch<T, 64>(q, k, v, o, B, a, s);
    if (D == 128) return launch<T, 128>(q, k, v, o, B, a, s);
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
  switch (tk) {
    case 16: return launch_tc<D, 16>(q, k, v, o, B, qt, a, s);
    case 32: return launch_tc<D, 32>(q, k, v, o, B, qt, a, s);
    default: break;
  }
  if constexpr (kTcKvCap / D >= 64) {
    if (tk == 64) return launch_tc<D, 64>(q, k, v, o, B, qt, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The launch plan, as kernels/flash_attention.py::launch_plan computes it:
// out[0..3] = q rows, kv columns, T_pad, route (1 = "wgmma", 0 = "simt").
int looptune_flash_attention_plan(int S, int T, int bq, int bk, int D, int bf16, int* out) {
  if (S < 1 || T < 1 || bq < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  bq = bq < S ? bq : S;
  bk = bk < T ? bk : T;
  out[2] = cdiv(T, bk) * bk;
  out[3] = bf16 && (D == 64 || D == 128);
  if (out[3]) {
    out[0] = bq <= kWgRows ? kWgRows : 2 * kWgRows;
    int tk = 16;
    while (tk < bk && tk < kTcKvCap / D) tk *= 2;
    out[1] = tk;
  } else {
    out[0] = kRowGroups * clampi(cdiv(bq, kRowGroups), 1, kMaxRQ);
    out[1] = kLanes * clampi(cdiv(bk, kLanes), 1, kMaxCK);
  }
  return 0;
}

// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).  q: (B, S, H, D), k and v: (B, T, HKV, D)
// through element strides (b, s, h) with the head dim contiguous; o: (B, S,
// H, D) contiguous.  All of q, k, v, o are f32, or all bf16 (bf16 = 1).
// D in {8, 16, 32, 64, 128}; H a multiple of HKV.  softcap <= 0 means none.
// On the "wgmma" route every base is 16-byte aligned and every stride a
// multiple of 8 elements (the wrapper checks).
// lse: the current wrapper's log-sum-exp output, which this design does not
// write (the timing script passes null)
int looptune_flash_attention(const void* q, const void* k, const void* v, void* o,
                             void* /*lse*/, int B, int S, int T, int H, int HKV, int D, long long qsb,
                             long long qss, long long qsh, long long ksb, long long kss,
                             long long ksh, long long vsb, long long vss, long long vsh,
                             int bq, int bk, float scale, float softcap, int causal,
                             int has_window, int window, int bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || H < 1 || HKV < 1 || H % HKV != 0 || bq < 1 || bk < 1)
    return (int)cudaErrorInvalidValue;
  int plan[4];
  looptune_flash_attention_plan(S, T, bq, bk, D, bf16, plan);
  if (cdiv(S, plan[0]) > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  const int wmax = S + T;
  const int w = clampi(window, -wmax, wmax);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{S, T, H, H / HKV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
               plan[0] / kRowGroups, plan[1] / kLanes, scale, softcap, causal, has_window,
               w, plan[2]};
  if (plan[3]) {
    if (D == 64) return launch_tc_tk<64>(plan[1], q, k, v, o, B, plan[0], a, s);
    return launch_tc_tk<128>(plan[1], q, k, v, o, B, plan[0], a, s);
  }
  if (bf16) return launch_d<__nv_bfloat16>(D, q, k, v, o, B, a, s);
  return launch_d<float>(D, q, k, v, o, B, a, s);
}

}  // extern "C"
