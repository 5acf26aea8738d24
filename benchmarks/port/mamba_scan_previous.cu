// The previous design of csrc/mamba_scan.cu (one thread per channel, tiles
// staged synchronously), kept unchanged as the baseline of
// benchmarks/port/mamba_scan_plans.py and mamba_scan_phases.py.  It exports
// the same C entry point and is loaded through the same wrapper.
//
// Mamba selective scan for Hopper (sm_90a): the discretised SSM recurrence
//     h_t = e^{dt_t a} h_{t-1} + (dt_t x_t) B_t,   y_t = C_t . h_t
// over x, dt (B, S, C), B_t and C_t (B, S, N) (all f32 or all bf16), a (C, N)
// f32 (a = -exp(a_log) <= 0) and an optional carried state h0 (B, C, N) f32.
// Writes y (B, S, C) f32 and the final state h (B, C, N) f32.
//
// Replaces: repro/kernels/mamba_scan.py::_mamba_kernel (launched by
// `mamba_scan`), the Pallas TPU kernel.  It computes the same function, not
// the same block structure:
//   * the TPU kernel takes dtx = dt x (B, S, C) and da = dt a (B, S, C, N) as
//     operands and scans each chunk in the exp(-cum) form, two MXU products
//     and a masked combine, with the (bd, N) state in VMEM scratch.  This
//     kernel takes the model's x, dt and a and forms dtx and da in registers:
//     the (B, S, C, N) da operand never reaches memory (2.1 GB of f32 a layer
//     at jamba's prefill);
//   * one thread per (b, channel) walks the tokens in order, its N states in
//     registers: h_n <- e^{dt a_n} h_n + dtx B_n, y += C_n h_n.  That is the
//     recurrence itself, exact in real arithmetic like the chunked form, and
//     it has no e^{-cum} to overflow (the TPU form's limit, ROADMAP.md).
//     Everything is f32 from the loads on; e^{dt a} is exp2f(dt (a log2 e))
//     with a log2 e formed once a channel;
//   * a CTA holds CC consecutive channels of one batch row (CC threads) and
//     stages L tokens at a time in shared memory: the (L, CC) tiles of x and
//     dt, loaded coalesced through their (b, s) strides, and the (L, N) rows
//     of B and C, which every channel of the row shares and reads as a
//     broadcast.  y is stored coalesced across the CTA's channels.  Channels
//     >= C idle (C need not be a multiple of CC); the last tile is ragged;
//   * with no h0 the state starts at zero, as the TPU kernel's does.
//
// Block mapping: the "mamba" registry block {l, c} (workload (S, C)), as
// the TPU wrapper clamps it to (S, C): L = clamp(min(l, S), 1, kMaxL = 64)
// tokens a tile and CC = 32 * clamp(cdiv(min(c, C), 32), 1, 8) channels
// (threads) a CTA; the grid is (cdiv(C, CC), B).  The wrapper computes the
// same plan (kernels/mamba_scan.py launch_plan).  Shared memory at L = 64,
// CC = 256, f32: 139,264 bytes (dynamic, after cudaFuncSetAttribute).
//
// Bound on this card: at jamba's prefill (B 4, S 1024, C 8192, N 16, bf16
// x/dt/B/C, with h0) the bytes (x and dt read, y written in f32, B, C, a,
// h0 and h) are 273 MB, ~82 us at 3.35 TB/s; the FP32 operations (~5 per
// (t, c, n)) ~40 us at 67 TFLOP/s; the 5.4e8 exponentials one per (t, c, n)
// at the SFU rate of 16 a clock per SM, ~128 us at 1.98 GHz.  So the
// exponentials bind: each thread keeps N = 16 independent exp/FMA chains in
// flight.  The layout gives B * C = 32,768 threads at that shape (~8 warps
// per SM), low occupancy, so each thread keeps kBatch = 16 loads of a tile
// in flight (one at a time left a warp a single HBM round trip in flight);
// the load phase of a tile is still not overlapped with the previous tile's
// compute (no cp.async or TMA pipelining yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 64;      // tokens staged per tile
constexpr int kMaxCC = 256;    // channels (threads) per CTA
constexpr int kBatch = 16;     // global loads in flight a thread while staging
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int N>
constexpr size_t smem_bytes(int L, int CC) {
  return sizeof(float) * (size_t)2 * L * N + sizeof(T) * (size_t)2 * L * CC;
}

struct Args {
  int S, C, L, CC;
  long long xsb, xss;  // element strides (b, s); channels contiguous
  long long dsb, dss;
  long long bsb, bss;  // B_t: (b, s); states contiguous
  long long csb, css;  // C_t
  int has_h0;
};

template <typename T, int N>
__global__ void __launch_bounds__(kMaxCC)
mamba_scan_fwd(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_out, const Args p) {
  extern __shared__ float smem[];
  const int L = p.L, CC = p.CC;
  float* Bs = smem;                             // [L][N]
  float* Cs = Bs + L * N;                       // [L][N]
  T* Xs = reinterpret_cast<T*>(Cs + L * N);     // [L][CC]
  T* Ds = Xs + L * CC;                          // [L][CC]

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CC;
  const int ch = c0 + tid;
  const bool live = ch < p.C;

  float h[N], a2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? a[(long long)ch * N + n] * kLog2e : 0.f;
    h[n] = live && p.has_h0 ? h0[((long long)b * p.C + ch) * N + n] : 0.f;
  }

  const T* xb = x + b * p.xsb + c0;
  const T* db = dt + b * p.dsb + c0;
  const T* bb = bm + b * p.bsb;
  const T* cb = cm + b * p.csb;
  float* yb = y + (long long)b * p.S * p.C + ch;

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int len = min(L, p.S - t0);
    __syncthreads();  // the previous tile is read
    // kBatch global loads in flight a thread before their shared stores: a
    // store after each load would leave one HBM round trip in flight a warp
    if (live) {  // x and dt: this thread's channel, token by token
      for (int i0 = 0; i0 < len; i0 += kBatch) {
        T xv[kBatch], dv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (i0 + u < len) {
            xv[u] = xb[(t0 + i0 + u) * p.xss + tid];
            dv[u] = db[(t0 + i0 + u) * p.dss + tid];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (i0 + u < len) {
            Xs[(i0 + u) * CC + tid] = xv[u];
            Ds[(i0 + u) * CC + tid] = dv[u];
          }
        }
      }
    }
    for (int e0 = tid; e0 < len * N; e0 += kBatch * CC) {  // B and C rows
      float bv[kBatch], cv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * CC, i = e / N, n = e - i * N;
        if (e < len * N) {
          bv[u] = to_f(bb[(t0 + i) * p.bss + n]);
          cv[u] = to_f(cb[(t0 + i) * p.css + n]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * CC;
        if (e < len * N) {
          Bs[e] = bv[u];
          Cs[e] = cv[u];
        }
      }
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < len; ++i) {
        const float dtv = to_f(Ds[i * CC + tid]);
        const float dtx = dtv * to_f(Xs[i * CC + tid]);
        const float* Bi = Bs + i * N;
        const float* Ci = Cs + i * N;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float decay = exp2f(dtv * a2[n]);  // e^{dt a_n}
          h[n] = fmaf(decay, h[n], dtx * Bi[n]);
          acc = fmaf(Ci[n], h[n], acc);
        }
        yb[(long long)(t0 + i) * p.C] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[((long long)b * p.C + ch) * N + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, const float* a, const void* bm, const void* cm,
           const float* h0, float* y, float* h_out, int B, const Args& p,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_fwd<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<T, N>(kMaxL, kMaxCC));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.C + p.CC - 1) / p.CC, B);
  mamba_scan_fwd<T, N><<<grid, p.CC, smem_bytes<T, N>(p.L, p.CC), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), h0, y, h_out, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int N, const void* x, const void* dt, const float* a, const void* bm,
             const void* cm, const float* h0, float* y, float* h_out, int B,
             const Args& p, cudaStream_t s) {
  switch (N) {
    case 4: return launch<T, 4>(x, dt, a, bm, cm, h0, y, h_out, B, p, s);
    case 8: return launch<T, 8>(x, dt, a, bm, cm, h0, y, h_out, B, p, s);
    case 16: return launch<T, 16>(x, dt, a, bm, cm, h0, y, h_out, B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).  x, dt: (B, S, C) and bm, cm: (B, S, N),
// all f32 or all bf16 (bf16 = 1), through element strides (b, s) with the
// last dim contiguous; a: (C, N) f32 contiguous; h0: (B, C, N) f32
// contiguous, or null for a zero start; y: (B, S, C) f32 and h_out:
// (B, C, N) f32, contiguous.  N in {4, 8, 16}; L, the token tile, in
// [1, min(S, 64)]; CC, the channels a CTA, a multiple of 32 in [32, 256].
int looptune_mamba_scan(const void* x, const void* dt, const void* a, const void* bm,
                        const void* cm, const void* h0, void* y, void* h_out, int B,
                        int S, int C, int N, int L, int CC, long long xsb, long long xss,
                        long long dsb, long long dss, long long bsb, long long bss,
                        long long csb, long long css, int bf16, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || C < 1 || L < 1 || L > kMaxL || L > S || CC < 32 ||
      CC > kMaxCC || CC % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const Args p{S, C, L, CC, xsb, xss, dsb, dss, bsb, bss, csb, css, h0 != nullptr};
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_n<__nv_bfloat16>(N, x, dt, af, bm, cm, h0f, yf, hf, B, p, st);
  return launch_n<float>(N, x, dt, af, bm, cm, h0f, yf, hf, B, p, st);
}

}  // extern "C"
