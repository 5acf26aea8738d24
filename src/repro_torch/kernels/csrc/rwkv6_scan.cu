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
//   (2048 at rwkv6-7b's prefill).  It stages the chunk's r, k, v and logw by
//   cp.async through the (b, s, h) strides with the head dim contiguous (no
//   transposes, no padding copies; bf16 r and k raw beside the f32 rows, v
//   raw in the upper half of its f32 rows and widened in place), v in a
//   second group that lands while the first steps run.  Positions >= S, and
//   rows past the chunk up to the next 64, are zero: r = k = v = 0 and
//   logw = 0, the TPU kernel's state-neutral padding.  Then, as the TPU
//   kernel per chunk of L tokens: cum = inclusive cumsum of logw down each
//   column (one thread a column segment, in registers), and in one step the
//   u-bonus diagonal sum_n r u k, r_dec = r e^{cum_ex} (cum_ex read as the
//   previous row's cum, the TPU kernel's cum - logw in exact arithmetic) and
//   k_dec = k e^{-cum}.  The products run in two phases of four groups of
//   64 threads, each thread with an 8 x 8 register tile (8 x 4 in two
//   groups of phase 2), balanced at 4096 FMAs a thread a phase at L = 128:
//     phase 1: A = strict_lower(r_dec k_dec^T) on its 64 x 64 blocks on or
//       below the diagonal, one a group (3 of 4 at L = 128), and dS_c =
//       k_dec^T v over the first 64 tokens (group 4);
//     phase 2: y_c = A v + (sum_n r u k) v, written to y (rows 0-63, and
//       rows 64-127 in two column halves), and dS_c over the rest of the
//       tokens (the same registers), written as e^{w_last} dS_c with the
//       decay e^{w_last} (N values) to scratch that the wrapper allocates.
//   Last it writes r_dec to scratch too, for pass 2.
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
// Everything is f32 from the loads on and products are f32 FMAs; each
// product reads its shared-memory operands as float4.  e^{-cum} overflows f32
// once a chunk's decay sum passes about -88, here as in the TPU kernel and
// the model's chunk loop: a limit of the formulation that ROADMAP.md
// records, not changed here.
//
// Chunk tile: the requested chunk, clamped to S (as the TPU wrapper clamps
// it) and to kMaxL = 128.  Shared memory at L = 128, N = 64: pass 1 holds
// r_dec, k_dec, v and cum as f32 rows padded to N + 4, the A tile in the cum
// rows' place once the decay is done, short vectors, and bf16 r and k as
// staged: 208,896 bytes (172,032 for f32 inputs; one CTA an SM); pass 2 holds
// r_dec, its 64 x 32 state and increment slices, the decay and y's slice:
// 71,936 bytes.  Scratch: B * H * C * (N^2 + N) + B * S * H * N f32, 101 MB
// at the model.
//
// Bound on this card: max(bytes / 3.35 TB/s, operations / FP32 peak).  At the
// model's prefill (B 4, S 1024, H 64, N 64, L 128, bf16 r/k/v, with s0) the
// bytes in and out are 243 MB, ~73 us.  The operations counted are the least
// any form of the recurrence does: per token one read-out r_t S (2N^2) and
// one rank-1 update k_t^T v_t (2N^2), 4.3 GFLOP, ~64 us at 67 TFLOP/s: the
// bound is the bytes.  The chunked form at L = 128 needs 4LN^2 + 2L(L-1)N a
// chunk and stream (the strictly lower triangles of r_dec k_dec^T and A v),
// 8.6 GFLOP, ~128 us in FP32; this kernel computes the diagonal 64 x 64
// blocks whole (10.7 GFLOP).  The two passes also move what pass 1 leaves
// for pass 2 (y, dS, r_dec: ~570 MB in all, ~170 us).  No tensor cores: the
// 2e-4 limit keeps f32 products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;                   // chunk tile
constexpr int kBlk = 64;                     // row blocks of the intra-chunk products
constexpr int kGroup = 64;                   // threads of a pass-1 product group
constexpr int kSliceCols = 32;               // state columns a pass-2 CTA carries
constexpr int kSmem = 232448;                // dynamic shared memory a block may use

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// rows of a chunk tile of L tokens, rounded up to whole 64-row blocks
__host__ __device__ constexpr int tile_rows(int L) { return kBlk * cdiv(L, kBlk); }

// Pass 1's shared memory, in floats: r_dec, k_dec, v [LT][N + 4]; logw/cum
// [LT][N + 4], then the A tile [LT][LT] in its place; the u-bonus diagonal
// [LT], w_last [N], u [N] and the scan's segment sums [kThreads]; then, for
// bf16 inputs, r and k as staged [LT][N + 8] bf16 each
__host__ __device__ constexpr int pass1_floats(int L, int N, int bf16) {
  return 3 * tile_rows(L) * (N + 4) + cmax(tile_rows(L) * (N + 4), tile_rows(L) * tile_rows(L)) +
         tile_rows(L) + 2 * N + kThreads + (bf16 ? tile_rows(L) * (N + 8) : 0);
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

// cum: inclusive cumsum of logw down each column of rows [0, LT), in place.
// Thread (segment sg, column n) sums its segment of rows in order in
// registers; the segment totals meet in `seg`, and each segment adds those
// before it.
template <int N>
__device__ __forceinline__ void column_cumsum(float* C, float* seg, int LT, int tid) {
  constexpr int P = N + 4, SEGS = kThreads / N, MAXLEN = cdiv(kMaxL, SEGS);
  const int n = tid % N, sg = tid / N, len = cdiv(LT, SEGS), i0 = sg * len;
  float x[MAXLEN];
#pragma unroll
  for (int q = 0; q < MAXLEN; ++q) x[q] = q < len && i0 + q < LT ? C[(i0 + q) * P + n] : 0.f;
#pragma unroll
  for (int q = 1; q < MAXLEN; ++q) x[q] += x[q - 1];
  seg[sg * N + n] = x[MAXLEN - 1];
  __syncthreads();
  float off = 0.f;
  for (int s = 0; s < sg; ++s) off += seg[s * N + n];
#pragma unroll
  for (int q = 0; q < MAXLEN; ++q)
    if (q < len && i0 + q < LT) C[(i0 + q) * P + n] = x[q] + off;
  __syncthreads();
}

// The rows' split among threads for the elementwise steps: TPR threads a
// row, NPT consecutive values each, taken 4 at a time in batches of 4
template <int N>
struct RowSplit {
  static constexpr int TPR = cmin(kThreads / kMaxL, N / 4), NPT = N / TPR, STEPS = NPT / 4,
                       BATCH = cmin(STEPS, 4);
};

// y rows row0 + ty + 8 x (x < 8) at CPT columns of thread tx (col0 + 4 tx
// + (N / 2) (c / 4) + c % 4): the sum over s < s_end of A v, then the u-bonus
// term; rows from rows_in on are not stored
template <int N, int CPT>
__device__ __forceinline__ void y_rows(const float* A, const float* V, const float* DG,
                                       float* yb, long long y_row, int LT, int row0, int col0,
                                       int ty, int tx, int s_end, int rows_in) {
  constexpr int P = N + 4, H = CPT / 4;
  float acc[8][CPT] = {};
  const float* const ar = A + (row0 + ty) * LT;
  const float* const vc = V + col0 + 4 * tx;
#pragma unroll 2
  for (int s = 0; s < s_end; s += 4) {
    float4 av[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) av[x] = load4(ar + 8 * x * LT + s);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 vv[H];
#pragma unroll
      for (int c = 0; c < H; ++c) vv[c] = load4(vc + (s + q) * P + (N / 2) * c);
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[x][c] = fmaf(lane4(av[x], q), lane4(vv[c / 4], c % 4), acc[x][c]);
    }
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int row = row0 + ty + 8 * x;
    if (row >= rows_in) continue;
    const float dg = DG[row];  // the u-bonus term
#pragma unroll
    for (int c = 0; c < H; ++c) {
      const float4 vr = load4(vc + row * P + (N / 2) * c);
      *reinterpret_cast<float4*>(yb + row * y_row + col0 + 4 * tx + (N / 2) * c) =
          make_float4(fmaf(dg, vr.x, acc[x][4 * c]), fmaf(dg, vr.y, acc[x][4 * c + 1]),
                      fmaf(dg, vr.z, acc[x][4 * c + 2]), fmaf(dg, vr.w, acc[x][4 * c + 3]));
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_chunk_intra(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ u,
                  float* __restrict__ y, float* __restrict__ dS, float* __restrict__ decay,
                  float* __restrict__ rd, const Args a) {
  using namespace hopper;
  constexpr int P = N + 4, NB = N + 8;  // f32 and staged-bf16 row pitches
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int L = a.L, LT = tile_rows(L);
  float* const R = smem;           // [LT][P]  r_dec (f32 r staged in place)
  float* const K = R + LT * P;     // [LT][P]  k_dec (f32 k staged in place)
  float* const V = K + LT * P;     // [LT][P]  v (bf16 staged in the upper halves)
  float* const C = V + LT * P;     // [LT][P]  logw, then cum; then A [LT][LT]
  float* const A = C;
  float* const DG = C + cmax(LT * P, LT * LT);  // [LT] u-bonus diagonal
  float* const WL = DG + LT;                     // [N]  cum of the chunk's last row
  float* const U = WL + N;                       // [N]
  float* const SEG = U + N;                      // [kThreads]
  T* const RS = BF16 ? reinterpret_cast<T*>(SEG + kThreads) : reinterpret_cast<T*>(R);
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
  column_cumsum<N>(C, SEG, LT, tid);

  // the u-bonus diagonal sum_n r u k (before the decay), r_dec = r e^{cum_ex}
  // and k_dec = k e^{-cum}: thread (row i, values n0..n0 + NPT)
  {
    using RS_ = RowSplit<N>;
    const int i = tid / RS_::TPR, n0 = (tid % RS_::TPR) * RS_::NPT;
    float dg = 0.f;
    if (i < LT) {
#pragma unroll
      for (int b0 = 0; b0 < RS_::STEPS; b0 += RS_::BATCH) {
        float4 rv[RS_::BATCH], kv[RS_::BATCH], cv[RS_::BATCH], cx[RS_::BATCH];
#pragma unroll
        for (int q = 0; q < RS_::BATCH; ++q) {
          const int n = n0 + 4 * (b0 + q);
          rv[q] = load4(RS + i * SP + n);
          kv[q] = load4(KS + i * SP + n);
          cv[q] = load4(C + i * P + n);
          cx[q] = i > 0 ? load4(C + (i - 1) * P + n) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < RS_::BATCH; ++q) {
          const int n = n0 + 4 * (b0 + q);
          const float4 uu = load4(U + n);
#pragma unroll
          for (int z = 0; z < 4; ++z) dg += lane4(rv[q], z) * (lane4(uu, z) * lane4(kv[q], z));
          *reinterpret_cast<float4*>(R + i * P + n) = mul4(rv[q], exp4(cx[q], 1.f));
          *reinterpret_cast<float4*>(K + i * P + n) = mul4(kv[q], exp4(cv[q], -1.f));
        }
      }
    }
#pragma unroll
    for (int off = RS_::TPR / 2; off > 0; off >>= 1) dg += __shfl_xor_sync(0xffffffffu, dg, off);
    if (i < LT && tid % RS_::TPR == 0) DG[i] = dg;
  }
  if (tid < N) WL[tid] = C[(L - 1) * P + tid];
  __syncthreads();  // cum is dead: its rows now hold A

  cp_async_wait<0>();  // v landed
  __syncthreads();
  if constexpr (BF16) widen_rows<N>(V, LT, tid);

  // The products, in two phases of four groups of 64 threads, each thread
  // with an 8 x 8 (or 8 x 4) register tile.  Phase 1: A = strict_lower(r_dec
  // k_dec^T) on its 64 x 64 blocks (i, j <= i), one a group (groups 0-2),
  // and dS_c over s < 64 (group 3).  Phase 2: y_c = A v + diag v, rows 0-63
  // (group 0) and rows 64-127 in two column halves (groups 1, 2), and dS_c
  // over s >= 64 (group 3, the same registers).
  const int g = tid / kGroup, lt = tid % kGroup, ty = lt / 8, tx = lt % 8;
  const int nb = LT / kBlk;
  // dS: thread (tn, tj) owns rows 4 tn + (N / 2) (x / 4) + x % 4 of the
  // increment and the columns alike (x < RM)
  constexpr int RM = cmin(8, N), GN = N / RM;
  const int tn = lt / GN, tj = lt % GN;
  const bool ds_thread = g == 3 && lt < GN * GN;
  float ds[RM][RM] = {};
  auto ds_rows = [&](int s0, int s1) {
#pragma unroll 2
    for (int s = s0; s < s1; ++s) {
      float4 kv[RM / 4], vv[RM / 4];
#pragma unroll
      for (int c = 0; c < RM / 4; ++c) {
        kv[c] = load4(K + s * P + 4 * tn + (N / 2) * c);
        vv[c] = load4(V + s * P + 4 * tj + (N / 2) * c);
      }
#pragma unroll
      for (int x = 0; x < RM; ++x)
#pragma unroll
        for (int z = 0; z < RM; ++z)
          ds[x][z] = fmaf(lane4(kv[x / 4], x % 4), lane4(vv[z / 4], z % 4), ds[x][z]);
    }
  };
  if (g < nb * (nb + 1) / 2) {  // A block (i, j): (0, 0), (1, 0), (1, 1)
    const int i = g == 0 ? 0 : 1, j = g == 2 ? 1 : 0;
    float acc[8][8] = {};
    const float* const rr = R + (i * kBlk + ty) * P;
    const float* const kk = K + (j * kBlk + tx) * P;
#pragma unroll 2
    for (int n = 0; n < N; n += 4) {
      float4 ra[8], kb[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        ra[q] = load4(rr + 8 * q * P + n);
        kb[q] = load4(kk + 8 * q * P + n);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int z = 0; z < 8; ++z)
            acc[x][z] = fmaf(lane4(ra[x], s), lane4(kb[z], s), acc[x][z]);
    }
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int z = 0; z < 8; ++z) {
        const int row = i * kBlk + ty + 8 * x, col = j * kBlk + tx + 8 * z;
        A[row * LT + col] = i > j || col < row ? acc[x][z] : 0.f;
      }
  } else if (ds_thread) {
    ds_rows(0, cmin(kBlk, L));
  }
  __syncthreads();  // A is whole

  float* const yb = y + ((long long)b * a.S + t0) * y_row + h * N;
  if (g == 0) {  // rows 0-63: 8 columns a thread (4 at N = 4)
    if (tx < N / cmin(8, N))
      y_rows<N, cmin(8, N)>(A, V, DG, yb, y_row, LT, 0, 0, ty, tx, kBlk, rows_in);
  } else if (g < 3) {  // rows 64-127, half the columns a group (all of them at N = 4)
    if (nb == 2 && (N >= 8 ? tx < N / 8 : g == 1 && tx == 0))
      y_rows<N, 4>(A, V, DG, yb, y_row, LT, kBlk, N >= 8 ? (g - 1) * (N / 2) : 0, ty, tx, LT,
                   rows_in);
  } else if (ds_thread) {
    ds_rows(kBlk, L);
    float* const out = dS + ((long long)bh * a.n_chunks + c) * N * N;
#pragma unroll
    for (int x = 0; x < RM; ++x) {
      const int n = 4 * tn + (N / 2) * (x / 4) + x % 4;
      const float e = expf(WL[n]);
#pragma unroll
      for (int c4 = 0; c4 < RM / 4; ++c4)
        *reinterpret_cast<float4*>(out + n * N + 4 * tj + (N / 2) * c4) =
            make_float4(e * ds[x][4 * c4], e * ds[x][4 * c4 + 1], e * ds[x][4 * c4 + 2],
                        e * ds[x][4 * c4 + 3]);
    }
  }
  if (tid < N) decay[((long long)bh * a.n_chunks + c) * N + tid] = expf(WL[tid]);
  // r_dec for pass 2
  float* const rdb = rd + ((long long)b * a.S + t0) * y_row + h * N;
  for (int e = tid; e < rows_in * (N / 4); e += kThreads) {
    const int i = e / (N / 4), n = 4 * (e % (N / 4));
    *reinterpret_cast<float4*>(rdb + i * y_row + n) = load4(R + i * P + n);
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
