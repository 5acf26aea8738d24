// RWKV-6 chunked scan for Hopper (sm_90a): the Finch time-mix recurrence
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
// over r, k, v (B, S, H, N) (f32 or bf16), log-decay logw (B, S, H, N) f32 <= 0,
// bonus u (H, N) f32, and an optional carried state s0 (B, H, N, N) f32.
// Writes y (B, S, H, N) f32 and the final state (B, H, N, N) f32.
//
// Replaces: repro/kernels/rwkv6_scan.py::_rwkv_kernel (launched by
// `rwkv6_chunk_scan`), the Pallas TPU kernel.  It computes the same function
// chunk by chunk, not the same block structure:
//   * one CTA per (b, h) stream; a loop over chunks inside the CTA takes the
//     place of the TPU's sequential chunk grid axis, and the (N, N) f32 state
//     stays in shared memory from the first chunk to the last.  With no s0
//     the state starts at zero, as the TPU kernel's does;
//   * r, k, v and logw are read through their (b, s, h) strides with the
//     head dim contiguous (the model's (B, S, D) projections viewed as heads:
//     no transposes, no padding copies); positions >= S get r = k = v = 0 and
//     logw = 0, the TPU kernel's state-neutral padding;
//   * per chunk of L tokens, as the TPU kernel: cum = inclusive cumsum of
//     logw (a warp shuffle scan down each column), r_dec = r e^{cum_ex},
//     k_dec = k e^{-cum}, y = r_dec S + strict_lower(r_dec k_dec^T) v
//     + (sum_n r u k) v, and S <- S e^{w_last} + (k e^{w_last - cum})^T v.
//     cum_ex is read as the previous row's cum (the TPU kernel's cum - logw
//     in exact arithmetic); the u-bonus diagonal is taken before r and k are
//     decayed in place; the state update uses k e^{w_last - cum} =
//     k_dec e^{w_last}, so S <- e^{w_last} (S + k_dec^T v) needs no buffer.
//     Everything is f32 from the loads on.
//   * e^{-cum} overflows f32 once a chunk's decay sum passes about -88, in
//     this kernel as in the TPU kernel and the model's chunk loop: a limit of
//     the formulation that ROADMAP.md records, not changed here.
//
// Chunk tile: the requested chunk, clamped to S (as the TPU wrapper clamps
// it) and to kMaxL = 128.  Shared memory per CTA at L = 128, N = 64: r_dec,
// k_dec, v and cum as f32 rows padded to N + 1 (4 x 33.3 KB), the L x L
// attention tile padded to L + 1 (66 KB), the state (16.6 KB) and three
// short vectors: 216,832 bytes of the 232,448 a block may have, so one CTA
// per SM (dynamic shared memory, after cudaFuncSetAttribute).
//
// Bound on this card: max(bytes / 3.35 TB/s, operations / FP32 peak).  At the
// model's prefill (B 4, S 1024, H 64, N 64, L 128, bf16 r/k/v, with s0) the
// bytes are 243 MB in and out, ~73 us.  The operations counted are the least
// any form of the recurrence does: per token one read-out r_t S (2N^2) and
// one rank-1 state update k_t^T v_t (2N^2), 4.3 GFLOP, ~64 us at the
// 67 TFLOP/s FP32 non-tensor rate; so the bound is the bytes.  The chunked
// form at L = 128 needs 4LN^2 + 2L(L-1)N a chunk and stream (the strictly
// lower triangles of r_dec k_dec^T and A v), 8.6 GFLOP.  This kernel computes
// more than that: the masked upper half of the L x L tile is computed and
// zeroed.  It is SIMT f32 FMAs from shared memory with register micro-tiles
// (8 x 8 for the attention tile, 8 x 4 for y, 4 x 4 for the state at
// N = 64), 256 threads and one CTA per SM: bound by FP32 issue and
// shared-memory loads well above that bound.  No mma/wgmma, TMA or cp.async
// pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;                  // chunk tile
constexpr int kAttLanes = 16;               // attention tile: 16 x 16 threads
constexpr int kAttTile = kMaxL / kAttLanes; // 8 rows and 8 columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// floats of dynamic shared memory for a chunk tile of L and head dim N
constexpr size_t smem_floats(int L, int N) {
  return (size_t)4 * L * (N + 1) + (size_t)L * (L + 1) + (size_t)N * (N + 1) + 2 * N + L;
}

struct Args {
  int S, H, L, n_chunks;
  long long rsb, rss, rsh;  // element strides (b, s, h); the head dim is contiguous
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long wsb, wss, wsh;
  int has_s0;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_scan_fwd(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, float* __restrict__ y,
               float* __restrict__ s_out, const Args a) {
  constexpr int NP = N + 1;
  // y and state products: kCols threads along the N columns, kRows along rows
  constexpr int kCols = N < 16 ? N : 16;
  constexpr int kRows = kThreads / kCols;
  constexpr int CP = N / kCols;                    // columns per thread
  constexpr int YR = (kMaxL + kRows - 1) / kRows;  // y rows per thread
  constexpr int SR = (N + kRows - 1) / kRows;      // state rows per thread

  extern __shared__ float smem[];
  const int L = a.L, LP = L + 1;
  float* R = smem;          // [L][NP]  r, then r_dec
  float* K = R + L * NP;    // [L][NP]  k, then k_dec
  float* V = K + L * NP;    // [L][NP]
  float* C = V + L * NP;    // [L][NP]  logw, then cum
  float* A = C + L * NP;    // [L][LP]  strictly lower r_dec k_dec^T
  float* Ss = A + L * LP;   // [N][NP]  carried state
  float* U = Ss + N * NP;   // [N]
  float* WL = U + N;        // [N]      cum of the chunk's last row
  float* DG = WL + N;       // [L]      u-bonus diagonal

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % kCols, ty = tid / kCols;
  const int ax = tid % kAttLanes, ay = tid / kAttLanes;

  const T* rb = r + b * a.rsb + h * a.rsh;
  const T* kb = k + b * a.ksb + h * a.ksh;
  const T* vb = v + b * a.vsb + h * a.vsh;
  const float* wb = w + b * a.wsb + h * a.wsh;
  float* yb = y + ((long long)b * a.S * a.H + h) * N;  // row t at yb + t * H * N
  const long long y_row = (long long)a.H * N;

  for (int e = tid; e < N * N; e += kThreads)
    Ss[(e / N) * NP + e % N] = a.has_s0 ? s0[(long long)bh * N * N + e] : 0.f;
  for (int e = tid; e < N; e += kThreads) U[e] = u[h * N + e];

  for (int c = 0; c < a.n_chunks; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int e = tid; e < L * N; e += kThreads) {
      const int i = e / N, n = e % N, t = t0 + i;
      const bool in = t < a.S;
      R[i * NP + n] = in ? to_f(rb[t * a.rss + n]) : 0.f;
      K[i * NP + n] = in ? to_f(kb[t * a.kss + n]) : 0.f;
      V[i * NP + n] = in ? to_f(vb[t * a.vss + n]) : 0.f;
      C[i * NP + n] = in ? wb[t * a.wss + n] : 0.f;
    }
    __syncthreads();

    // cum: inclusive cumsum of logw down each column, 32 rows per warp scan
    for (int n = warp; n < N; n += kWarps) {
      float carry = 0.f;
      for (int i0 = 0; i0 < L; i0 += 32) {
        const int i = i0 + lane;
        float x = i < L ? C[i * NP + n] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, x, off);
          if (lane >= off) x += up;
        }
        x += carry;
        if (i < L) C[i * NP + n] = x;
        carry = __shfl_sync(0xffffffffu, x, 31);
      }
    }
    // the u-bonus diagonal sum_n r u k, before r and k are decayed
    for (int i = warp; i < L; i += kWarps) {
      float part = 0.f;
      for (int n = lane; n < N; n += 32) part += R[i * NP + n] * (U[n] * K[i * NP + n]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) DG[i] = part;
    }
    __syncthreads();

    // decay in place: r_dec = r e^{cum_ex}, k_dec = k e^{-cum}
    for (int e = tid; e < L * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const float cum_ex = i > 0 ? C[(i - 1) * NP + n] : 0.f;
      R[i * NP + n] *= expf(cum_ex);
      K[i * NP + n] *= expf(-C[i * NP + n]);
    }
    if (tid < N) WL[tid] = C[(L - 1) * NP + tid];
    __syncthreads();

    // A = strictly lower (r_dec k_dec^T): thread (ay, ax) owns rows ay + 16 i
    // and columns ax + 16 j
    {
      float acc[kAttTile][kAttTile];
#pragma unroll
      for (int i = 0; i < kAttTile; ++i)
#pragma unroll
        for (int j = 0; j < kAttTile; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float ra[kAttTile], ka[kAttTile];
#pragma unroll
        for (int i = 0; i < kAttTile; ++i) {
          const int row = ay + i * kAttLanes;
          ra[i] = row < L ? R[row * NP + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kAttTile; ++j) {
          const int col = ax + j * kAttLanes;
          ka[j] = col < L ? K[col * NP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kAttTile; ++i)
#pragma unroll
          for (int j = 0; j < kAttTile; ++j) acc[i][j] = fmaf(ra[i], ka[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kAttTile; ++i) {
        const int row = ay + i * kAttLanes;
#pragma unroll
        for (int j = 0; j < kAttTile; ++j) {
          const int col = ax + j * kAttLanes;
          if (row < L && col < L) A[row * LP + col] = col < row ? acc[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = r_dec S + A v + diag v: thread (ty, tx) owns rows ty + kRows i and
    // columns tx + kCols j
    {
      float acc[YR][CP];
#pragma unroll
      for (int i = 0; i < YR; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float sv[CP];
#pragma unroll
        for (int j = 0; j < CP; ++j) sv[j] = Ss[n * NP + tx + j * kCols];
#pragma unroll
        for (int i = 0; i < YR; ++i) {
          const int row = ty + i * kRows;
          const float rv = row < L ? R[row * NP + n] : 0.f;
#pragma unroll
          for (int j = 0; j < CP; ++j) acc[i][j] = fmaf(rv, sv[j], acc[i][j]);
        }
      }
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        float vv[CP];
#pragma unroll
        for (int j = 0; j < CP; ++j) vv[j] = V[s * NP + tx + j * kCols];
#pragma unroll
        for (int i = 0; i < YR; ++i) {
          const int row = ty + i * kRows;
          const float av = row < L ? A[row * LP + s] : 0.f;
#pragma unroll
          for (int j = 0; j < CP; ++j) acc[i][j] = fmaf(av, vv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < YR; ++i) {
        const int row = ty + i * kRows;
        if (row >= L || t0 + row >= a.S) continue;
        const float dg = DG[row];
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          const int m = tx + j * kCols;
          float out = acc[i][j];
          out = fmaf(dg, V[row * NP + m], out);  // the u-bonus term
          yb[(t0 + row) * y_row + m] = out;
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S <- e^{w_last} (S + k_dec^T v): thread (ty, tx) owns state rows
    // ty + kRows i and columns tx + kCols j
    {
      float acc[SR][CP];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        float vv[CP];
#pragma unroll
        for (int j = 0; j < CP; ++j) vv[j] = V[s * NP + tx + j * kCols];
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          const int n = ty + i * kRows;
          const float kv = n < N ? K[s * NP + n] : 0.f;
#pragma unroll
          for (int j = 0; j < CP; ++j) acc[i][j] = fmaf(kv, vv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int n = ty + i * kRows;
        if (n >= N) continue;
        const float decay = expf(WL[n]);
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          const int m = tx + j * kCols;
          Ss[n * NP + m] = decay * (Ss[n * NP + m] + acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += kThreads)
    s_out[(long long)bh * N * N + e] = Ss[(e / N) * NP + e % N];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, float* y, float* s_out, int B, const Args& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_fwd<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(kMaxL, N) * sizeof(float)));
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_floats(a.L, N) * sizeof(float);
  rwkv6_scan_fwd<T, N><<<B * a.H, kThreads, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      s0, y, s_out, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int N, const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* y, float* s_out, int B, const Args& a,
             cudaStream_t s) {
  switch (N) {
    case 4: return launch<T, 4>(r, k, v, w, u, s0, y, s_out, B, a, s);
    case 8: return launch<T, 8>(r, k, v, w, u, s0, y, s_out, B, a, s);
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, s_out, B, a, s);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, a, s);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).  r, k, v: (B, S, H, N), all f32 or all
// bf16 (bf16 = 1), and logw (B, S, H, N) f32, through element strides
// (b, s, h) with the head dim contiguous; u: (H, N) f32 contiguous; s0:
// (B, H, N, N) f32 contiguous, or null for a zero start; y: (B, S, H, N) f32
// and s_out: (B, H, N, N) f32, contiguous.  N in {4, 8, 16, 32, 64}; L, the
// chunk tile, in [1, min(S, 128)].
int looptune_rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_out, int B, int S,
                        int H, int N, int L, long long rsb, long long rss, long long rsh,
                        long long ksb, long long kss, long long ksh, long long vsb,
                        long long vss, long long vsh, long long wsb, long long wss,
                        long long wsh, int bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || L < 1 || L > kMaxL || L > S)
    return (int)cudaErrorInvalidValue;
  const Args a{S, H, L, (S + L - 1) / L, rsb, rss, rsh, ksb, kss, ksh,
               vsb, vss, vsh, wsb, wss, wsh, s0 != nullptr};
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_n<__nv_bfloat16>(N, r, k, v, wf, uf, s0f, yf, sf, B, a, st);
  return launch_n<float>(N, r, k, v, wf, uf, s0f, yf, sf, B, a, st);
}

}  // extern "C"
