// Flash attention forward for Hopper (sm_90a): online-softmax attention over
// q (B, S, H, D) and k, v (B, T, HKV, D), with causal masking, a sliding
// window, a score softcap and grouped-query heads.
//
// Replaces: repro/kernels/flash_attention.py::_fa_kernel (launched by
// `flash_attention`), the Pallas TPU kernel.  It computes the same function
// for every argument that kernel takes, not the same block structure:
//   * one CTA per (b*h, q tile); a loop over kv tiles inside the CTA takes
//     the place of the TPU's sequential n_kv grid dimension.  m, l and the
//     accumulator are f32 in registers, the score tile's probabilities in
//     shared memory;
//   * q, k and v are read through their (b, s, h) strides with the head dim
//     contiguous, and the kv head is h / (H / HKV): no repeat copies of k/v
//     for GQA, no transposes and no padding copies.  Ragged S and T are
//     masked in the kernel;
//   * the same arithmetic as the TPU kernel: q is widened to f32 and scaled
//     by 1/sqrt(D) (given as an f32 scalar) before the product; the softcap
//     is cap * tanh(s / cap); masked scores are NEG_INF = -1e30; p stays f32
//     for the p @ v product; l is clamped to >= 1e-30; out is in q's dtype;
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
// Block mapping: the "fa" registry block (bq, bk), clamped to (S, T) as the
// TPU wrapper clamps it, becomes the CTA tile
//     q tile  = 8 * clamp(cdiv(bq, 8), 1, 8)    -> 8, 16, ..., 64 rows,
//     kv tile = 16 * clamp(cdiv(bk, 16), 1, 4)  -> 16, 32, 48 or 64 keys,
// (128 threads: 8 row groups of 16 lanes; a thread owns up to 8 q rows and
// up to 4 kv columns of the score tile, and the same q rows by D/16 columns
// of the output).  bk also sets T_pad above.  The default block (128, 128)
// maps to 64 x 64.
//
// Bound on this card: max(bytes / 3.35 TB/s, 4*B*H*D*(visible pairs) / peak).
// At the model's prefill (B 4, S = T 256, H 32, D 64, bf16, causal) the
// bytes (q, k, v, o once: 16.8 MB, ~5 us) bound it, not the 1.08 GFLOP of
// causal products (~1.1 us at the bf16 tensor rate).  This kernel is SIMT
// f32 FMAs from shared memory: each thread computes an 8 x 4 score
// micro-tile per kv tile (12 shared loads per 32 FMAs) and the p @ v
// product against broadcast rows of v, so it is bound by FP32 issue far
// above that bound.  Q and K rows are padded to D + 1 floats and P rows to
// 65 against bank conflicts.  No mma/wgmma, TMA or cp.async pipelining yet.
// Shared memory (~65 KB at D = 64, 115,456 bytes at D = 128) is above the
// 48 KB static limit, so it is dynamic, after cudaFuncSetAttribute.  At
// D = 128 (jamba-v0.1-52b, GQA 32/8) the CTA tile is the same 64 x 64; a
// thread's output accumulator grows to 8 q rows x 8 columns (64 f32
// registers, against 32 at D = 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  int rq, ck;                     // q rows and kv columns per thread
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
    case 64: return launch<T, 64>(q, k, v, o, B, a, s);
    case 128: return launch<T, 128>(q, k, v, o, B, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The CTA tile a launch uses: out[0..2] = q rows, kv columns, T_pad.
int looptune_flash_attention_plan(int S, int T, int bq, int bk, int* out) {
  if (S < 1 || T < 1 || bq < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  bq = bq < S ? bq : S;
  bk = bk < T ? bk : T;
  out[0] = kRowGroups * clampi(cdiv(bq, kRowGroups), 1, kMaxRQ);
  out[1] = kLanes * clampi(cdiv(bk, kLanes), 1, kMaxCK);
  out[2] = cdiv(T, bk) * bk;
  return 0;
}

// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).  q: (B, S, H, D), k and v: (B, T, HKV, D)
// through element strides (b, s, h) with the head dim contiguous; o: (B, S,
// H, D) contiguous.  All of q, k, v, o are f32, or all bf16 (bf16 = 1).
// D in {8, 16, 32, 64, 128}; H a multiple of HKV.  softcap <= 0 means none.
int looptune_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                             int S, int T, int H, int HKV, int D, long long qsb,
                             long long qss, long long qsh, long long ksb, long long kss,
                             long long ksh, long long vsb, long long vss, long long vsh,
                             int bq, int bk, float scale, float softcap, int causal,
                             int has_window, int window, int bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || H < 1 || HKV < 1 || H % HKV != 0 || bq < 1 || bk < 1)
    return (int)cudaErrorInvalidValue;
  int plan[3];
  looptune_flash_attention_plan(S, T, bq, bk, plan);
  if (cdiv(S, plan[0]) > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  const int wmax = S + T;
  Args a{S, T, H, H / HKV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
         plan[0] / kRowGroups, plan[1] / kLanes, scale, softcap, causal, has_window,
         clampi(window, -wmax, wmax), plan[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_d<__nv_bfloat16>(D, q, k, v, o, B, a, s);
  return launch_d<float>(D, q, k, v, o, B, a, s);
}

}  // extern "C"
