// Tiled matmul for Hopper (sm_90a): C[m, n] = A[m, k] @ B[k, n] at a tuned
// block (bm, bk, bn) and grid order, the kernel LoopTune's schedules drive.
//
// Replaces: repro/kernels/matmul.py::_mm_kernel (launched by `matmul`), the
// Pallas TPU kernel.  It computes the same function, not the same block
// structure:
//   * each CTA owns one (bm, bn) output tile (or a group of neighbouring
//     tiles, below) and walks k in steps of bk inside the CTA, in place of
//     the TPU's sequential k grid dimension; the f32 accumulator lives in
//     registers and the tile is written once;
//   * grid_order maps the linear block index to (i, j): n fastest for "mn",
//     m fastest for "nm".  That is the launch order, and so the L2 reuse a
//     schedule's traversal order buys on this card;
//   * ragged edges are masked in the kernel (no padding copy);
//   * A and B are both f32 or both bf16 (widened with __bfloat162float);
//     the accumulator is f32; C is f32 or bf16.  B may be given transposed
//     ((N, K) row-major, the "bsd,vd->bsv" logits form) via trans_b.
//
// Bound on this card: max(2*M*K*N / FP32 FMA peak, bytes / 3.35 TB/s) with
// bytes = (M*K + K*N) * in_size + M*N * out_size.  The kernel is f32
// arithmetic without TF32, as the reference is, so the FP32 non-tensor peak
// applies (67 TFLOP/s on H100 SXM, 51 on PCIe), not the TF32 tensor rate.
// Decode (M = 4) is far below the ridge point: it is bound by reading B
// once, so the design keeps every B element read once per CTA row of tiles
// and coalesced along n.  Prefill (M = 1024) is bound by FP32 issue: the
// design stages A and B slabs in shared memory and gives each thread a
// register micro-tile (RM x RN outputs, RM + RN shared-memory loads per
// RM * RN FMAs).  No wgmma, TMA or cp.async pipelining yet.
//
// Blocks of any size are accepted, because the registry can hold any:
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

namespace {

constexpr int kThreads = 256;

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

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

}  // namespace

extern "C" {

// How a launch is laid out: out[0..3] = CTA tile rows, CTA tile columns,
// sub-tile configuration (index into kSubTiles), number of CTAs.
int looptune_matmul_plan(int M, int N, int bm, int bn, int order_nm, int* out) {
  if (M < 1 || N < 1 || bm < 1 || bn < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, N, bm, bn, order_nm, sm_count());
  out[0] = p.tm;
  out[1] = p.tn;
  out[2] = p.config;
  out[3] = p.ctas;
  return 0;
}

// Launches on `stream` without synchronising; returns cudaGetLastError()
// of the launch (0 on success).  a: (M, K); b: (K, N), or (N, K) when
// trans_b; c: (M, N); all contiguous row-major.
int looptune_matmul(const void* a, const void* b, void* c, int M, int K, int N,
                    int bm, int bk, int bn, int order_nm, int trans_b,
                    int in_bf16, int out_bf16, void* stream) {
  if (M < 1 || K < 1 || N < 1 || bm < 1 || bk < 1 || bn < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, N, bm, bn, order_nm, sm_count());
  bk = bk < K ? bk : K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
