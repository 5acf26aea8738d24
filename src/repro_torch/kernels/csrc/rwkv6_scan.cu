// RWKV-6 chunked scan for Hopper (sm_90a): the Finch time-mix recurrence
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
// over r, k, v (B, S, H, N) (f32 or bf16), log-decay logw (B, S, H, N) f32 <= 0,
// bonus u (H, N) f32, and an optional carried state s0 (B, H, N, N) f32.
// Writes y (B, S, H, N) f32 and the final state (B, H, N, N) f32.
//
// Replaces: repro/kernels/rwkv6_scan.py::_rwkv_kernel (launched by
// `rwkv6_chunk_scan`), the Pallas TPU kernel.  It computes the same chunked
// function, not the same block structure.  The TPU kernel walks the chunks
// of a stream in order on one core, carrying the state; here a chunk's
// intra-chunk work depends only on its own tokens, and only the state
// crosses chunks, so one wrapper call makes two launches:
//
//   Pass 1, rwkv6_chunk_intra: one CTA per (b, h, chunk), B * H * C CTAs
//   (8192 at the rwkv6-7b.prefill-4x4096 cell).  It stages the chunk's r,
//   k, v and logw by cp.async through the (b, s, h) strides with the head
//   dim contiguous (no transposes, no padding copies; bf16 r and k raw beside
//   the f32 rows, v raw in the upper half of its f32 rows and widened in
//   place), v in a second group that lands while the first steps run.
//   Positions >= S, and rows past the chunk up to the next 16, are zero:
//   r = k = v = 0 and logw = 0, the TPU kernel's state-neutral padding.
//   The chunk is taken in sub-chunks of 16 rows, so that no exponential is
//   of a positive number: the TPU kernel's k e^{-cum} leaves f32 once a
//   chunk's decay sum passes about -88, which trained decays do within a
//   few dozen tokens.  Per column, cum = the inclusive cumsum of logw within
//   each sub-chunk and GX_I = the chunk's sum before sub-chunk I.  Then:
//     A_ts = sum_n r_tn k_sn e^{cum_ex_tn - cum_sn} for s < t in one
//       sub-chunk, pair by pair (120 pairs a sub-chunk; the exponent is a
//       sum of logw over the positions between, <= 0);
//     the u-bonus diagonal sum_n r u k; r~ = r e^{cum_ex} and
//       k^ = k e^{cum_last - cum} within the sub-chunk; r_dec = r~ e^{GX}
//       within the chunk, written to scratch for pass 2;
//     a walk over the sub-chunks from a zero state D, one barrier each:
//       y_t = r~_t D_I + sum_s A_ts v_s + (sum_n r u k)_t v_t, written to y,
//       and D_{I+1} = diag(e^{cum_last}) D_I + k^_I^T v_I in registers (a
//       4 x 4 block a thread), read out through two shared buffers.
//   D after the last sub-chunk is the chunk's state increment against its
//   last row, sum_s diag(e^{cum_T - cum_s}) k_s^T v_s; it goes to scratch
//   with the chunk's decay e^{GX_end} (N values).
//   Pass 2, rwkv6_state_walk: one CTA per (b, h, slice of 32 state columns),
//   B * H * N / 32 CTAs (512 at the model), three an SM.  Column j of the
//   state needs only v[:, j], so the slices are independent.  From s0 (or
//   zeros) it walks the chunks in order: r_dec, y's slice, the increment's
//   slice and the decay arrive by cp.async (the next chunk's r_dec while this
//   chunk's y is stored), it adds the inter-chunk term r_dec S_{c-1} to y_c,
//   then S_c = diag(e^{w_last}) S_{c-1} + dS_c.  It writes the final state.
//   Pass 1 storing r_dec (67 MB at the model, read back once) was measured
//   against pass 2 restaging r and logw and deriving r_dec again
//   (benchmarks/port/rwkv6_scan_passes.py, PERF.md).
// Everything is f32 from the loads on and products are f32 FMAs.  Every
// exponential is of a sum of logw <= 0, so nothing overflows: a factor
// that underflows to 0 stands for a decay below e^-87, which no f32 sum
// of the other terms would keep.
//
// Chunk tile: the requested chunk, clamped to S (as the TPU wrapper clamps
// it) and to kMaxL = 128.  Shared memory at L = 128, N = 64: pass 1 holds
// r~, k^, v and cum as f32 rows padded to N + 4, the sub-chunks' A (L x 16),
// the two state buffers, the sums at sub-chunk starts, short vectors, and
// bf16 r and k as staged: 222,208 bytes (185,344 for f32 inputs; one CTA an
// SM); pass 2 holds r_dec, its 64 x 32 state and increment slices, the
// decay and y's slice: 71,936 bytes.  Scratch: B * H * C * (N^2 + N) +
// B * S * H * N f32.
//
// Bound on this card: max(bytes / 3.35 TB/s, operations / FP32 peak).  The
// bytes are r, k, v, logw read and y and the final state written, once;
// the operations the least any form of the recurrence does: per token one
// read-out r_t S (2N^2) and one rank-1 update k_t^T v_t (2N^2).  The bound
// is the bytes.  This form does per token and head N^2 (r~ D) + N^2 (the D
// update) + 7.5 N (the pairs, with as many exponentials) + 16 N (A v) FMAs
// in pass 1 and N^2 in pass 2, and moves what pass 1 leaves for pass 2 (y,
// dS, r_dec).  No tensor cores: the 2e-4 limit keeps f32 products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;                   // chunk tile
constexpr int kSub = 16;                     // sub-chunk: rows whose decays are taken pair by pair
constexpr int kPairs = kSub * (kSub - 1) / 2;  // (t, s), s < t, of a sub-chunk
constexpr int kSliceCols = 32;               // state columns a pass-2 CTA carries
constexpr int kSmem = 232448;                // dynamic shared memory a block may use

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// rows of a chunk tile of L tokens, rounded up to whole 16-row sub-chunks
__host__ __device__ constexpr int tile_rows(int L) { return kSub * cdiv(L, kSub); }

// Pass 1's shared memory, in floats: r~, k^, v and logw/cum [LT][N + 4];
// the sub-chunks' products A [LT][16]; the chunk's state, two buffers
// [2][N][N + 4]; the sums at sub-chunk starts [9][N]; the u-bonus diagonal
// [LT] and u [N]; then, for bf16 inputs, r and k as staged [LT][N + 8] bf16
// each
__host__ __device__ constexpr int pass1_floats(int L, int N, int bf16) {
  return 4 * tile_rows(L) * (N + 4) + tile_rows(L) * kSub + 2 * N * (N + 4) +
         (kMaxL / kSub + 1) * N + tile_rows(L) + N + (bf16 ? tile_rows(L) * (N + 8) : 0);
}
// Pass 2's: r_dec [LT][N + 4]; the state slice and the chunk's increment
// slice [N][cols + 4] each, its decay [N]; y's slice [LT][cols + 4]
__host__ __device__ constexpr int pass2_floats(int L, int N) {
  return tile_rows(L) * (N + 4) + 2 * N * (cmin(N, kSliceCols) + 4) + N +
         tile_rows(L) * (cmin(N, kSliceCols) + 4);
}

struct Args {
  int S, H, L, n_chunks;
  long long rsb, rss, rsh;  // element strides (b, s, h); the head dim is contiguous
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long wsb, wss, wsh;
  int vec_r, vec_k, vec_v, vec_w;  // the rows allow 16-byte copies (else 4-byte)
};

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 exp4(float4 v, float sign) {
  return make_float4(expf(sign * v.x), expf(sign * v.y), expf(sign * v.z), expf(sign * v.w));
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
// 4 consecutive values at `p`: f32 as they are, bf16 widened
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, 4);
  memcpy(&hi, &raw.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// `rows` rows of LEN elements of T by cp.async: row i from src + i * stride
// (elements) to shared byte address dst + i * pitch, zero filled from row
// `valid` on; 16-byte pieces when `vec`, else 4-byte
template <typename T, int LEN>
__device__ __forceinline__ void stage(uint32_t dst, int pitch, const T* src, long long stride,
                                      int rows, int valid, int vec, int tid) {
  using namespace hopper;
  constexpr int BYTES = LEN * (int)sizeof(T);
  const int shift = vec ? __ffs(BYTES / 16) - 1 : __ffs(BYTES / 4) - 1;  // pieces a row: 2^shift
  for (int e = tid; e < rows << shift; e += kThreads) {
    const int i = e >> shift, p = e & ((1 << shift) - 1);
    const bool in = i < valid;
    const char* g = reinterpret_cast<const char*>(src + (in ? i * stride : 0));
    if (vec)
      cp_async16(dst + i * pitch + 16 * p, g + 16 * p, in ? 16 : 0);
    else
      cp_async4(dst + i * pitch + 4 * p, g + 4 * p, in ? 4 : 0);
  }
}

// f32 rows [LT][N + 4] whose upper halves hold bf16 as staged, widened in
// place: every thread reads its pieces, then all write
template <int N>
__device__ __forceinline__ void widen_rows(float* buf, int LT, int tid) {
  constexpr int P = N + 4, PE = cmin(8, N), PR = N / PE, PER = cdiv(kMaxL * PR, kThreads);
  const __nv_bfloat16* raw = reinterpret_cast<const __nv_bfloat16*>(buf);
  float4 x[PER][PE / 4];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = tid + q * kThreads, i = e / PR, n = PE * (e % PR);
#pragma unroll
    for (int h = 0; h < PE / 4; ++h)
      x[q][h] = i < LT ? load4(raw + i * 2 * P + N + n + 4 * h) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = tid + q * kThreads, i = e / PR, n = PE * (e % PR);
#pragma unroll
    for (int h = 0; h < PE / 4; ++h)
      if (i < LT) *reinterpret_cast<float4*>(buf + i * P + n + 4 * h) = x[q][h];
  }
  __syncthreads();
}

// cum: the inclusive cumsum of logw down each column of each 16-row
// sub-chunk, in place (one thread a (sub-chunk, column) in turn), then
// GX[I] = the chunk's exclusive sum at sub-chunk I's first row, and
// GX[n_sub] the chunk's whole sum, from the sub-chunks' totals
template <int N>
__device__ __forceinline__ void sub_cumsum(float* C, float* GX, int n_sub, int tid) {
  constexpr int P = N + 4;
  for (int e = tid; e < n_sub * N; e += kThreads) {
    const int I = e / N, n = e % N;
    float x = 0.f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      x += C[(kSub * I + i) * P + n];
      C[(kSub * I + i) * P + n] = x;
    }
    GX[(I + 1) * N + n] = x;
  }
  __syncthreads();
  if (tid < N) {
    float g = 0.f;
    GX[tid] = 0.f;
    for (int I = 1; I <= n_sub; ++I) GX[I * N + tid] = g += GX[I * N + tid];
  }
  __syncthreads();
}

// The rows' split among threads for the elementwise steps: TPR threads a
// row, NPT consecutive values each, taken 4 at a time in batches of 4
template <int N>
struct RowSplit {
  static constexpr int TPR = cmin(kThreads / kMaxL, N / 4), NPT = N / TPR, STEPS = NPT / 4,
                       BATCH = cmin(STEPS, 4);
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_chunk_intra(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ u,
                  float* __restrict__ y, float* __restrict__ dS, float* __restrict__ decay,
                  float* __restrict__ rd, const Args a) {
  using namespace hopper;
  constexpr int P = N + 4, NB = N + 8;  // f32 and staged-bf16 row pitches
  constexpr int NQ = N / 4;             // float4 columns of a row
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int L = a.L, LT = tile_rows(L), n_sub = LT / kSub;
  float* const R = smem;              // [LT][P]  r~ (f32 r staged in place)
  float* const K = R + LT * P;        // [LT][P]  k^ (f32 k staged in place)
  float* const V = K + LT * P;        // [LT][P]  v (bf16 staged in the upper halves)
  float* const C = V + LT * P;        // [LT][P]  logw, then each sub-chunk's cum
  float* const A = C + LT * P;        // [LT][kSub] the sub-chunks' own products
  float* const D = A + LT * kSub;     // [2][N][P] the chunk's state, two buffers
  float* const GX = D + 2 * N * P;    // [kMaxL / kSub + 1][N] sums at sub-chunk starts
  float* const DG = GX + (kMaxL / kSub + 1) * N;  // [LT] u-bonus diagonal
  float* const U = DG + LT;                       // [N]
  T* const RS = BF16 ? reinterpret_cast<T*>(U + N) : reinterpret_cast<T*>(R);
  T* const KS = BF16 ? RS + LT * NB : reinterpret_cast<T*>(K);
  constexpr int SP = BF16 ? NB : P;  // pitch of the staged r and k, in elements

  const int c = blockIdx.x % a.n_chunks, bh = blockIdx.x / a.n_chunks;
  const int b = bh / a.H, h = bh % a.H;
  const int t0 = c * L, rows_in = cmin(L, a.S - t0);
  const int tid = threadIdx.x;
  const long long y_row = (long long)a.H * N;  // y and r_dec are (B, S, H, N) f32

  stage<float, N>(smem_u32(C), P * 4, w + b * a.wsb + t0 * a.wss + h * a.wsh, a.wss, LT,
                  rows_in, a.vec_w, tid);
  stage<T, N>(smem_u32(RS), SP * (int)sizeof(T), r + b * a.rsb + t0 * a.rss + h * a.rsh, a.rss,
              LT, rows_in, a.vec_r, tid);
  stage<T, N>(smem_u32(KS), SP * (int)sizeof(T), k + b * a.ksb + t0 * a.kss + h * a.ksh, a.kss,
              LT, rows_in, a.vec_k, tid);
  cp_async_commit();
  stage<T, N>(smem_u32(V) + (BF16 ? 2 * N : 0), P * 4, v + b * a.vsb + t0 * a.vss + h * a.vsh,
              a.vss, LT, rows_in, a.vec_v, tid);
  cp_async_commit();
  for (int e = tid; e < N; e += kThreads) U[e] = u[h * N + e];
  cp_async_wait<1>();  // logw, r and k landed (this thread's copies)
  __syncthreads();
  sub_cumsum<N>(C, GX, n_sub, tid);

  // A[t][j] = sum_n r_t k_s e^{cum_ex_t - cum_s} for s = t - t % 16 + j < t,
  // pair by pair: both cums are the sub-chunk's and the exponent is a sum of
  // logw over (s, t), <= 0.  Entries j >= t % 16 are zero.
  for (int e = tid; e < LT * kSub; e += kThreads)
    if (e % kSub >= (e / kSub) % kSub) A[e] = 0.f;
  for (int e = tid; e < n_sub * kPairs; e += kThreads) {
    const int I = e / kPairs, q = e % kPairs;
    int ti = 1;
    while ((ti + 1) * ti / 2 <= q) ++ti;
    const int sj = q - ti * (ti - 1) / 2, t = kSub * I + ti, s = kSub * I + sj;
    const T* const rt = RS + t * SP;
    const T* const ks = KS + s * SP;
    const float* const ct = C + (t - 1) * P;  // cum_ex of t: cum of the row before
    const float* const cs = C + s * P;
    float acc = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      const float4 rv = load4(rt + n), kv = load4(ks + n), ex = load4(ct + n), cv = load4(cs + n);
      acc = fmaf(rv.x * kv.x, expf(ex.x - cv.x), acc);
      acc = fmaf(rv.y * kv.y, expf(ex.y - cv.y), acc);
      acc = fmaf(rv.z * kv.z, expf(ex.z - cv.z), acc);
      acc = fmaf(rv.w * kv.w, expf(ex.w - cv.w), acc);
    }
    A[t * kSub + sj] = acc;
  }
  __syncthreads();  // raw r and k are read: their f32 rows may now be overwritten

  // thread (row i, values n0..n0 + NPT): the u-bonus diagonal sum_n r u k,
  // r~ = r e^{cum_ex} and k^ = k e^{cum_last - cum} against the sub-chunk's
  // own sums.  Every exponent is <= 0.
  {
    using RS_ = RowSplit<N>;
    const int i = tid / RS_::TPR, n0 = (tid % RS_::TPR) * RS_::NPT;
    const int I = i / kSub, last = kSub * I + kSub - 1;
    float dg = 0.f;
    if (i < LT) {
#pragma unroll
      for (int b0 = 0; b0 < RS_::STEPS; b0 += RS_::BATCH) {
        float4 rv[RS_::BATCH], kv[RS_::BATCH], cv[RS_::BATCH], cx[RS_::BATCH], cl[RS_::BATCH];
#pragma unroll
        for (int q = 0; q < RS_::BATCH; ++q) {
          const int n = n0 + 4 * (b0 + q);
          rv[q] = load4(RS + i * SP + n);
          kv[q] = load4(KS + i * SP + n);
          cv[q] = load4(C + i * P + n);
          cx[q] = i % kSub ? load4(C + (i - 1) * P + n) : make_float4(0.f, 0.f, 0.f, 0.f);
          cl[q] = load4(C + last * P + n);
        }
#pragma unroll
        for (int q = 0; q < RS_::BATCH; ++q) {
          const int n = n0 + 4 * (b0 + q);
          const float4 uu = load4(U + n);
#pragma unroll
          for (int z = 0; z < 4; ++z) dg += lane4(rv[q], z) * (lane4(uu, z) * lane4(kv[q], z));
          const float4 dx = make_float4(cl[q].x - cv[q].x, cl[q].y - cv[q].y, cl[q].z - cv[q].z,
                                        cl[q].w - cv[q].w);
          *reinterpret_cast<float4*>(R + i * P + n) = mul4(rv[q], exp4(cx[q], 1.f));
          *reinterpret_cast<float4*>(K + i * P + n) = mul4(kv[q], exp4(dx, 1.f));
        }
      }
    }
#pragma unroll
    for (int off = RS_::TPR / 2; off > 0; off >>= 1) dg += __shfl_xor_sync(0xffffffffu, dg, off);
    if (i < LT && tid % RS_::TPR == 0) DG[i] = dg;
  }
  if (tid < N) decay[((long long)bh * a.n_chunks + c) * N + tid] = expf(GX[n_sub * N + tid]);

  cp_async_wait<0>();  // v landed
  __syncthreads();
  // r_dec = r~ e^{GX} against the chunk's start, to scratch for pass 2: a
  // row's float4s from consecutive threads, so that the stores coalesce
  // (stores of each thread's own row segment took 0.53 ms more of pass 1 at
  // (4, 4096, 64, 64) on an H100)
  {
    float* const rdb = rd + ((long long)b * a.S + t0) * y_row + h * N;
    for (int e = tid; e < rows_in * NQ; e += kThreads) {
      const int i = e / NQ, n = 4 * (e % NQ);
      *reinterpret_cast<float4*>(rdb + i * y_row + n) =
          mul4(load4(R + i * P + n), exp4(load4(GX + (i / kSub) * N + n), 1.f));
    }
  }
  if constexpr (BF16) widen_rows<N>(V, LT, tid);

  // The walk over the sub-chunks, from a zero state D_0:
  //   y_t = r~_t D_I + sum_{s < t in I} A_ts v_s + (sum_n r u k)_t v_t
  //   D_{I+1} = diag(e^{cum_last}) D_I + k^_I^T v_I
  // Thread (tn, tj) holds the 4 x 4 block of D at rows 4 tn, columns 4 tj
  // in registers and writes it to D's buffer I % 2 for the read-out; thread
  // (ty, tx) computes the float4 of y at row 16 I + ty, columns 4 tx.  One
  // barrier a sub-chunk: buffer I % 2 is written again only two sub-chunks
  // on, after every thread has passed the barrier between.
  const bool owner = tid < NQ * NQ, reader = tid < kSub * NQ;
  const int tn = tid / NQ, tj = tid % NQ, ty = tid / NQ, tx = tid % NQ;
  float dreg[4][4] = {};
  float* const yb = y + ((long long)b * a.S + t0) * y_row + h * N;
  for (int I = 0; I < n_sub; ++I) {
    float* const DI = D + (I & 1) * N * P;
    if (owner)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        *reinterpret_cast<float4*>(DI + (4 * tn + x) * P + 4 * tj) =
            make_float4(dreg[x][0], dreg[x][1], dreg[x][2], dreg[x][3]);
    __syncthreads();
    if (reader) {
      const int row = kSub * I + ty;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* const rr = R + row * P;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float rn = rr[n];
        const float4 dv = load4(DI + n * P + 4 * tx);
        acc = make_float4(fmaf(rn, dv.x, acc.x), fmaf(rn, dv.y, acc.y), fmaf(rn, dv.z, acc.z),
                          fmaf(rn, dv.w, acc.w));
      }
      const float* const ar = A + row * kSub;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float aj = ar[j];
        const float4 vv = load4(V + (kSub * I + j) * P + 4 * tx);
        acc = make_float4(fmaf(aj, vv.x, acc.x), fmaf(aj, vv.y, acc.y), fmaf(aj, vv.z, acc.z),
                          fmaf(aj, vv.w, acc.w));
      }
      const float dg = DG[row];  // the u-bonus term
      const float4 vr = load4(V + row * P + 4 * tx);
      if (row < rows_in)
        *reinterpret_cast<float4*>(yb + row * y_row + 4 * tx) =
            make_float4(fmaf(dg, vr.x, acc.x), fmaf(dg, vr.y, acc.y), fmaf(dg, vr.z, acc.z),
                        fmaf(dg, vr.w, acc.w));
    }
    if (owner) {
      const float4 cl = load4(C + (kSub * I + kSub - 1) * P + 4 * tn);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float e = expf(lane4(cl, x));
#pragma unroll
        for (int z = 0; z < 4; ++z) dreg[x][z] *= e;
      }
#pragma unroll 4
      for (int s = kSub * I; s < kSub * I + kSub; ++s) {
        const float4 kv = load4(K + s * P + 4 * tn), vv = load4(V + s * P + 4 * tj);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int z = 0; z < 4; ++z)
            dreg[x][z] = fmaf(lane4(kv, x), lane4(vv, z), dreg[x][z]);
      }
    }
  }
  // the chunk's increment, against its last row: sum_s diag(e^{cum_T - cum_s}) k_s^T v_s
  if (owner) {
    float* const out = dS + ((long long)bh * a.n_chunks + c) * N * N;
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(out + (4 * tn + x) * N + 4 * tj) =
          make_float4(dreg[x][0], dreg[x][1], dreg[x][2], dreg[x][3]);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 3)
rwkv6_state_walk(const float* __restrict__ rd, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_out,
                 const float* __restrict__ dS, const float* __restrict__ decay, const Args a) {
  using namespace hopper;
  constexpr int P = N + 4, CW = cmin(N, kSliceCols), SP = CW + 4;
  // the product y += r_dec S: thread (ty, tx) owns the float4 at column 4 tx
  // of rows ty + TY x
  constexpr int TX = CW / 4, TY = kThreads / TX, RPT = cmax(1, kMaxL / TY);
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int L = a.L, LT = tile_rows(L);
  float* const R = smem;          // [LT][P]  r_dec of the chunk (pass 1's)
  float* const SS = R + LT * P;   // [N][SP]  state columns j0 .. j0 + CW
  float* const DS = SS + N * SP;  // [N][SP]  the chunk's increment, those columns
  float* const DC = DS + N * SP;  // [N]      the chunk's decay
  float* const YS = DC + N;       // [LT][SP] the chunk's y from pass 1, those columns

  const int bh = blockIdx.x / (N / CW), j0 = (blockIdx.x % (N / CW)) * CW;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const long long y_row = (long long)a.H * N;  // y and r_dec are (B, S, H, N) f32
  const float* const rdb = rd + (long long)b * a.S * y_row + h * N;
  float* const yb = y + (long long)b * a.S * y_row + h * N + j0;

  for (int e = tid; e < N * CW; e += kThreads) {
    const int n = e / CW, j = e % CW;
    SS[n * SP + j] = s0 != nullptr ? s0[((long long)bh * N + n) * N + j0 + j] : 0.f;
  }
  stage<float, N>(smem_u32(R), P * 4, rdb, y_row, LT, cmin(L, a.S), 1, tid);
  cp_async_commit();

  for (int c = 0; c < a.n_chunks; ++c) {
    const int t0 = c * L, rows_in = cmin(L, a.S - t0);
    const long long at = (long long)bh * a.n_chunks + c;
    cp_async_wait<0>();  // chunk c's r_dec landed (this thread's copies)
    // every thread's copies landed, and the previous state update is done
    __syncthreads();
    // the chunk's y (pass 1's), increment and decay land during the product
    stage<float, CW>(smem_u32(YS), SP * 4, yb + t0 * y_row, y_row, LT, rows_in, 1, tid);
    stage<float, CW>(smem_u32(DS), SP * 4, dS + at * N * N + j0, N, N, N, 1, tid);
    stage<float, N>(smem_u32(DC), N * 4, decay + at * N, N, 1, 1, 1, tid);
    cp_async_commit();

    // y_c += r_dec S_{c-1}
    float acc[RPT][4] = {};
#pragma unroll
    for (int n = 0; n < N; n += 4) {
      float4 sv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = load4(SS + (n + q) * SP + 4 * tx);
#pragma unroll
      for (int x = 0; x < RPT; ++x) {
        if (ty + TY * x >= LT) continue;
        const float4 rv = load4(R + (ty + TY * x) * P + n);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int z = 0; z < 4; ++z) acc[x][z] = fmaf(lane4(rv, q), lane4(sv[q], z), acc[x][z]);
      }
    }
    cp_async_wait<0>();  // this chunk's y, increment and decay landed
    // ... every thread's, and every read of r_dec and of S_{c-1} is done
    __syncthreads();
    if (c + 1 < a.n_chunks)
      stage<float, N>(smem_u32(R), P * 4, rdb + (t0 + L) * y_row, y_row, LT,
                      cmin(L, a.S - t0 - L), 1, tid);
    cp_async_commit();
#pragma unroll
    for (int x = 0; x < RPT; ++x) {
      const int row = ty + TY * x;
      if (row >= rows_in) continue;
      const float4 yv = load4(YS + row * SP + 4 * tx);
      *reinterpret_cast<float4*>(yb + (t0 + row) * y_row + 4 * tx) =
          make_float4(yv.x + acc[x][0], yv.y + acc[x][1], yv.z + acc[x][2], yv.w + acc[x][3]);
    }
    // S_c = diag(e^{w_last}) S_{c-1} + dS_c
    for (int e = tid; e < N * CW; e += kThreads) {
      const int n = e / CW, j = e % CW;
      SS[n * SP + j] = fmaf(DC[n], SS[n * SP + j], DS[n * SP + j]);
    }
  }
  __syncthreads();
  for (int e = tid; e < N * CW; e += kThreads) {
    const int n = e / CW, j = e % CW;
    s_out[((long long)bh * N + n) * N + j0 + j] = SS[n * SP + j];
  }
}

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

struct Ptrs {
  const void *r, *k, *v;
  const float *w, *u, *s0;
  float *y, *s_out, *dS, *decay, *rd;
};

template <typename T, int N>
int launch(const Ptrs& q, int B, const Args& a, cudaStream_t s) {
  cudaError_t err = allow_smem<rwkv6_chunk_intra<T, N>>();
  if (err == cudaSuccess) err = allow_smem<rwkv6_state_walk<N>>();
  if (err != cudaSuccess) return (int)err;
  const T* r = static_cast<const T*>(q.r);
  rwkv6_chunk_intra<T, N><<<B * a.H * a.n_chunks, kThreads,
                            pass1_floats(a.L, N, sizeof(T) == 2) * 4, s>>>(
      r, static_cast<const T*>(q.k), static_cast<const T*>(q.v), q.w, q.u, q.y, q.dS, q.decay,
      q.rd, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_state_walk<N><<<B * a.H * (N / cmin(N, kSliceCols)), kThreads,
                        pass2_floats(a.L, N) * 4, s>>>(q.rd, q.s0, q.y, q.s_out, q.dS, q.decay,
                                                       a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int N, const Ptrs& q, int B, const Args& a, cudaStream_t s) {
  switch (N) {
    case 4: return launch<T, 4>(q, B, a, s);
    case 8: return launch<T, 8>(q, B, a, s);
    case 16: return launch<T, 16>(q, B, a, s);
    case 32: return launch<T, 32>(q, B, a, s);
    case 64: return launch<T, 64>(q, B, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 1: 16-byte copies; 0: 4-byte copies; -1: neither (a bf16 view off a
// 4-byte boundary)
int copy_width(const void* p, long long sb, long long ss, long long sh, int N, int bytes) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const long long q = 16 / bytes;
  if (at % 16 == 0 && sb % q == 0 && ss % q == 0 && sh % q == 0 && N * bytes % 16 == 0) return 1;
  if (at % 4 == 0 && (bytes == 4 || (sb % 2 == 0 && ss % 2 == 0 && sh % 2 == 0))) return 0;
  return -1;
}

}  // namespace

extern "C" {

// Launches pass 1 and pass 2 on `stream` without synchronising; returns the
// first failing launch's cudaGetLastError() (0 on success).  r, k, v:
// (B, S, H, N), all f32 or all bf16 (bf16 = 1), and logw (B, S, H, N) f32,
// through element strides (b, s, h) with the head dim contiguous (bf16 views
// on 4-byte boundaries, else cudaErrorMisalignedAddress); u: (H, N) f32
// contiguous; s0: (B, H, N, N) f32 contiguous, or null for a zero start; y:
// (B, S, H, N) f32 and s_out: (B, H, N, N) f32, contiguous; scratch: B * H *
// C * (N^2 + N) + B * S * H * N f32, C = ceil(S / L).  N in {4, 8, 16, 32, 64}; L, the chunk
// tile, in [1, min(S, 128)].
int looptune_rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_out, void* scratch,
                        int B, int S, int H, int N, int L, long long rsb, long long rss,
                        long long rsh, long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh, long long wsb,
                        long long wss, long long wsh, int bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || L < 1 || L > kMaxL || L > S)
    return (int)cudaErrorInvalidValue;
  const int eb = bf16 ? 2 : 4;
  const int vr = copy_width(r, rsb, rss, rsh, N, eb), vk = copy_width(k, ksb, kss, ksh, N, eb),
            vv = copy_width(v, vsb, vss, vsh, N, eb), vw = copy_width(w, wsb, wss, wsh, N, 4);
  if (vr < 0 || vk < 0 || vv < 0 || vw < 0) return (int)cudaErrorMisalignedAddress;
  const int n_chunks = (S + L - 1) / L;
  const Args a{S, H, L, n_chunks, rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh,
               wsb, wss, wsh, vr, vk, vv, vw};
  float* const dS = static_cast<float*>(scratch);
  float* const decay = dS + (size_t)B * H * n_chunks * N * N;
  const Ptrs q{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
               static_cast<const float*>(s0), static_cast<float*>(y),
               static_cast<float*>(s_out), dS, decay, decay + (size_t)B * H * n_chunks * N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_n<__nv_bfloat16>(N, q, B, a, st);
  return launch_n<float>(N, q, B, a, st);
}

}  // extern "C"
