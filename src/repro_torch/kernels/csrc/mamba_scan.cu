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
//   * it walks the tokens in order: h_n <- e^{dt a_n} h_n + dtx B_n, y +=
//     C_n h_n.  That is the recurrence itself, exact in real arithmetic like
//     the chunked form, with no e^{-cum} to overflow (the TPU form's limit,
//     ROADMAP.md) and one exponential a (t, c, n).  A chunked form would
//     also apply each chunk's starting state through e^{a cumdt} at every
//     (t, c, n): twice the exponentials that bind this kernel (below).
//     Everything is f32 from the loads on.  One launch a call;
//   * with no h0 the state starts at zero, as the TPU kernel's does.
//
// Bound on this card: at jamba's prefill (B 4, S 1024, C 8192, N 16, bf16
// x/dt/B/C, with h0) the bytes (x and dt read, y written in f32, B, C, a,
// h0 and h) are 273 MB, ~82 us at 3.35 TB/s; the FP32 operations (~5 a
// (t, c, n)) ~40 us at 67 TFLOP/s; the 5.4e8 exponentials at the SFU rate
// of 16 a clock per SM, ~128 us at 1.98 GHz.  The exponentials bind, so the
// design keeps the SFU fed and spends as few other issue slots a term as it
// can:
//   * kLanes = 2 lanes a channel, each holding N / 2 of its states in
//     registers; the lanes' partial y_t are summed by one xor-shuffle a
//     token and the even lane writes it to its warp's y block in shared
//     memory (8 tokens x 16 channels), which the warp stores every 8 tokens
//     as float4 rows.  That is twice the warps of one thread a channel
//     (B * C * 2 threads: 16 warps an SM at jamba's shape), and a term costs
//     about 6.6 issue slots a warp against the SFU's 8 cycles (an
//     exponential, the dt * a log2 e product, dtx * B_n, the h FMA and the
//     y FMA, with dt, x, B and C loads and the shuffle shared by the lane's
//     N / 2 terms).  Four lanes a channel would double the warps again but
//     cost ~8.3 slots a term (benchmarks/port/mamba_scan_plans.py compares
//     both on the card);
//   * e^{dt a_n} is one ex2.approx.ftz.f32 (hopper.cuh) on dt (a_n log2 e),
//     with a_n log2 e formed once a lane: the argument is <= 0 (dt >= 0 from
//     the softplus, a <= 0), so flushing to zero changes nothing above 1e-38;
//   * a CTA holds CC consecutive channels of one batch row (CC * kLanes
//     threads) and stages L tokens a tile in a two-stage ring: tile j+1's
//     copies are issued right after the barrier that opens tile j and land
//     during its recurrence.  The (L, CC) tiles of x and dt come through
//     their (b, s) strides by 16-byte cp.async (8 bf16 or 4 f32 channels a
//     copy) where the base and strides are 16-byte multiples, by 4-byte
//     cp.async where they are 4-byte multiples, and otherwise by loads
//     through registers (an operand off a 4-byte boundary is slower, not
//     refused); the (L, N) rows of B and C
//     the same way (jamba's B and C views, rows of 288 bf16 at offsets of 512
//     and 544 bytes, take the 16-byte copies).  x and dt stay in their dtype
//     in shared memory and widen at the read; bf16 B and C are widened once
//     a tile into an f32 copy, so the recurrence reads each lane's N / 2
//     values of B_t and of C_t as float4 broadcasts;
//   * channels >= C run on zero-filled x and dt (their state stays 0) and
//     store nothing, so every lane of a warp reaches every shuffle; the last
//     tile is ragged; the token loop is unrolled by 4, so that the
//     exponentials and y chains of successive tokens overlap.
//
// Block mapping: the "mamba" registry block {l, c} (workload (S, C)), as
// the TPU wrapper clamps it to (S, C): L = clamp(min(l, S), 1, kMaxL = 64)
// tokens a tile and CC = 32 * clamp(cdiv(min(c, C), 32), 1, 4) channels a
// CTA, CC * kLanes threads; the grid is (cdiv(C, CC), B).  The wrapper
// computes the same plan (kernels/mamba_scan.py launch_plan), and
// looptune_mamba_scan_plan exports this one.  Shared memory at L = 64,
// CC = 128, N = 16: 86,016 bytes in bf16 (two stages, the widened B and C
// and the y blocks: two CTAs an SM), 151,552 in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kMaxL = 64;                     // tokens staged a tile
constexpr int kMaxCC = 128;                   // channels a CTA
constexpr int kLanes = 2;                     // lanes a channel, N / kLanes states each
constexpr int kMaxThreads = kMaxCC * kLanes;  // threads a CTA
constexpr int kCPW = 32 / kLanes;             // channels a warp
constexpr float kLog2e = 1.4426950408889634f;
enum { kCopyRegs = 0, kCopy4 = 4, kCopy16 = 16 };  // how a tile reaches shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

inline int cdiv(int x, int y) { return (x + y - 1) / y; }
inline int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

// one ring stage: the (L, CC) tiles of x and dt, then the (L, N) rows of B
// and C, in T, each with round8(L) rows (so every part is 16-byte aligned)
template <typename T>
__host__ __device__ constexpr size_t stage_bytes(int L, int CC, int N) {
  return sizeof(T) * (size_t)round8(L) * (2 * CC + 2 * N);
}
// f32 floats after the two stages: for bf16 the f32 copy of B and C that the
// recurrence reads; then each warp's y block of 8 tokens x kCPW channels
template <typename T>
__host__ __device__ constexpr int f32_floats(int L, int N) {
  return sizeof(T) == 2 ? round8(L) * 2 * N : 0;
}
template <typename T>
constexpr size_t smem_bytes(int L, int CC, int N) {
  return 2 * stage_bytes<T>(L, CC, N) + sizeof(float) * (size_t)f32_floats<T>(L, N) +
         sizeof(float) * 8 * (size_t)CC;
}

struct Args {
  int S, C, L, CC;
  long long xsb, xss;  // element strides (b, s); channels contiguous
  long long dsb, dss;
  long long bsb, bss;  // B_t: (b, s); states contiguous
  long long csb, css;  // C_t
  int has_h0;
  int mode_x, mode_d, mode_b, mode_c;  // kCopy16, kCopy4 or kCopyRegs
  int vec_y;                           // y rows start on 16-byte boundaries (C % 4 == 0)
};

// rows [0, rows) x elements [0, width) of a T matrix with row stride gs
// (elements) into dst [rows][width] in shared memory; elements >= valid of a
// row are zero.  kCopy16 / kCopy4: cp.async of 16 / 4 bytes (a piece that
// straddles `valid` copies its valid bytes and zero-fills the rest); the
// caller commits.  kCopyRegs: plain loads, stored as they arrive.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long gs, int rows,
                                           int width, int valid, int mode, int tid,
                                           int nthr) {
  using namespace hopper;
  if (mode == kCopyRegs) {
    for (int e = tid; e < rows * width; e += nthr) {
      const int r = e / width, k = e - r * width;
      dst[e] = k < valid ? src[r * gs + k] : zero<T>();
    }
    return;
  }
  const int per = mode / (int)sizeof(T);  // elements a copy
  const int pieces = width / per;
  for (int e = tid; e < rows * pieces; e += nthr) {
    const int r = e / pieces, k = (e - r * pieces) * per;
    const int n = min(per, max(0, valid - k));
    const T* s = n > 0 ? src + r * gs + k : src;
    const uint32_t d = smem_u32(dst + r * width + k);
    if (mode == kCopy16)
      cp_async16(d, s, n * (int)sizeof(T));
    else
      cp_async4(d, s, n * (int)sizeof(T));
  }
}

// NS consecutive f32 from shared memory, as float4 (or float2) reads
template <int NS>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[NS]) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NS / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else if constexpr (NS == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
#pragma unroll
    for (int q = 0; q < NS; ++q) v[q] = p[q];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads, 2)
mamba_scan_fwd(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_out, const Args p) {
  using namespace hopper;
  constexpr int NS = N / kLanes;  // states a lane
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(smem4);
  const int L = p.L, CC = p.CC, LP = round8(L);
  const size_t stage = stage_bytes<T>(L, CC, N);
  float* const BCf = reinterpret_cast<float*>(smem + 2 * stage);  // bf16: [B, C][LP][N]

  const int nthr = CC * kLanes;
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = tid % kLanes, cl = tid / kLanes;  // lane of the channel, channel of the CTA
  const int b = blockIdx.y, c0 = blockIdx.x * CC, ch = c0 + cl;
  const bool live = ch < p.C;
  const int n0 = g * NS;  // this lane's first state
  // this warp's y block: [8 tokens][kCPW channels, from cw]
  float* const Yw = BCf + f32_floats<T>(L, N) + (tid / 32) * 8 * kCPW;
  const int cw = c0 + (tid / 32) * kCPW;

  float h[NS], a2[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a2[n] = live ? a[(long long)ch * N + n0 + n] * kLog2e : 0.f;
    h[n] = live && p.has_h0 ? h0[((long long)b * p.C + ch) * N + n0 + n] : 0.f;
  }

  const T* const xb = x + b * p.xsb + c0;
  const T* const db = dt + b * p.dsb + c0;
  const T* const bb = bm + b * p.bsb;
  const T* const cb = cm + b * p.csb;
  float* const yb = y + (long long)b * p.S * p.C;
  const int valid_c = min(CC, p.C - c0);
  const int n_tiles = (p.S + L - 1) / L;

  // rows [r0, r1) of tile j into ring stage j % 2 (the caller commits)
  auto stage_rows_of = [&](int j, int r0, int r1) {
    T* const X = reinterpret_cast<T*>(smem + (j & 1) * stage);
    T* const Dt = X + LP * CC;
    T* const Bs = Dt + LP * CC;
    T* const Cs = Bs + LP * N;
    const int t = j * L + r0, rows = r1 - r0, half = (tid + nthr / 2) % nthr;
    stage_rows(X + r0 * CC, xb + t * p.xss, p.xss, rows, CC, valid_c, p.mode_x, tid, nthr);
    stage_rows(Dt + r0 * CC, db + t * p.dss, p.dss, rows, CC, valid_c, p.mode_d, half, nthr);
    stage_rows(Bs + r0 * N, bb + t * p.bss, p.bss, rows, N, N, p.mode_b, tid, nthr);
    stage_rows(Cs + r0 * N, cb + t * p.css, p.css, rows, N, N, p.mode_c, half, nthr);
  };
  // the warp's y block, rows [0, rows) = tokens t..t+rows-1, to y: a float4
  // of 4 channels a lane where the row allows it
  auto store_y = [&](int t, int rows) {
    __syncwarp();
    const int r = lane / (kCPW / 4), cq = 4 * (lane % (kCPW / 4)), c = cw + cq;
    if (r < rows && c < p.C) {
      const float4 v = *reinterpret_cast<const float4*>(Yw + r * kCPW + cq);
      float* const dst = yb + (long long)(t + r) * p.C + c;
      if (p.vec_y && c + 3 < p.C) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        dst[0] = v.x;
        if (c + 1 < p.C) dst[1] = v.y;
        if (c + 2 < p.C) dst[2] = v.z;
        if (c + 3 < p.C) dst[3] = v.w;
      }
    }
    __syncwarp();
  };

  stage_rows_of(0, 0, min(L, p.S));
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();  // this thread's copies of tile j landed
    // every thread's copies of tile j landed, and every thread is done with
    // tile j - 1, whose stage (and the widened B and C) are refilled next
    __syncthreads();

    const T* const X = reinterpret_cast<const T*>(smem + (j & 1) * stage);
    const T* const Dt = X + LP * CC;
    const int t0 = j * L, len = min(L, p.S - t0);
    if (j + 1 < n_tiles)  // in flight during tile j's recurrence
      stage_rows_of(j + 1, 0, min(L, p.S - t0 - L));
    cp_async_commit();
    const float* Bf;
    const float* Cf;
    if constexpr (BF16) {  // widen this tile's B and C rows once
      const T* const Bs = Dt + LP * CC;
      const T* const Cs = Bs + LP * N;
      for (int e = tid; e < len * N; e += nthr) {
        BCf[e] = to_f(Bs[e]);
        BCf[LP * N + e] = to_f(Cs[e]);
      }
      __syncthreads();
      Bf = BCf;
      Cf = BCf + LP * N;
    } else {
      Bf = reinterpret_cast<const float*>(Dt + LP * CC);
      Cf = Bf + LP * N;
    }

#pragma unroll 4
    for (int i = 0; i < len; ++i) {
      const float dtv = to_f(Dt[i * CC + cl]);
      const float dtx = dtv * to_f(X[i * CC + cl]);
      float bv[NS], cv[NS];
      load_vec<NS>(Bf + i * N + n0, bv);
      load_vec<NS>(Cf + i * N + n0, cv);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float decay = ex2_approx(dtv * a2[n]);  // e^{dt a_n}
        h[n] = fmaf(decay, h[n], dtx * bv[n]);
        acc = fmaf(cv[n], h[n], acc);
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)  // the lanes' partial y_t
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) Yw[(i % 8) * kCPW + cl % kCPW] = acc;
      if (i % 8 == 7) store_y(t0 + i - 7, 8);
    }
    if (len % 8) store_y(t0 + len - len % 8, len % 8);
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int n = 0; n < NS; ++n) h_out[((long long)b * p.C + ch) * N + n0 + n] = h[n];
  }
}

// how a (., width) operand with element strides (sb, ss) at `base` reaches
// shared memory: kCopy16 where the base and every row start are 16-byte
// aligned, kCopy4 where they are 4-byte aligned, else through registers
template <typename T>
int copy_mode(const void* base, int width, long long sb, long long ss, int B, int S) {
  const long long esz = sizeof(T);
  auto aligned = [&](long long n) {
    return (long long)(reinterpret_cast<uintptr_t>(base) % n) == 0 && width * esz % n == 0 &&
           (B == 1 || sb * esz % n == 0) && (S == 1 || ss * esz % n == 0);
  };
  return aligned(16) ? kCopy16 : aligned(4) ? kCopy4 : kCopyRegs;
}

template <typename T, int N>
int launch(const void* x, const void* dt, const float* a, const void* bm, const void* cm,
           const float* h0, float* y, float* h_out, int B, Args p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_fwd<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<T>(kMaxL, kMaxCC, N));
  if (err != cudaSuccess) return (int)err;
  p.mode_x = copy_mode<T>(x, p.CC, p.xsb, p.xss, B, p.S);
  p.mode_d = copy_mode<T>(dt, p.CC, p.dsb, p.dss, B, p.S);
  p.mode_b = copy_mode<T>(bm, N, p.bsb, p.bss, B, p.S);
  p.mode_c = copy_mode<T>(cm, N, p.csb, p.css, B, p.S);
  p.vec_y = p.C % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((p.C + p.CC - 1) / p.CC, B);
  mamba_scan_fwd<T, N><<<grid, p.CC * kLanes, smem_bytes<T>(p.L, p.CC, N), s>>>(
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

// The launch plan, as kernels/mamba_scan.py::launch_plan computes it, for S
// tokens and C channels at the "mamba" block {l: chunk, c: bd}: out[0..4] =
// tokens a tile, channels a CTA, threads a CTA, tiles along S, CTAs along C.
int looptune_mamba_scan_plan(int S, int C, int chunk, int bd, int* out) {
  if (S < 1 || C < 1 || chunk < 1 || bd < 1) return (int)cudaErrorInvalidValue;
  const int L = chunk < S ? (chunk < kMaxL ? chunk : kMaxL) : (S < kMaxL ? S : kMaxL);
  const int cc = 32 * clampi(cdiv(bd < C ? bd : C, 32), 1, kMaxCC / 32);
  out[0] = L;
  out[1] = cc;
  out[2] = cc * kLanes;
  out[3] = cdiv(S, L);
  out[4] = cdiv(C, cc);
  return 0;
}

// Launches on `stream` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).  x, dt: (B, S, C) and bm, cm: (B, S, N),
// all f32 or all bf16 (bf16 = 1), through element strides (b, s) with the
// last dim contiguous; a: (C, N) f32 contiguous; h0: (B, C, N) f32
// contiguous, or null for a zero start; y: (B, S, C) f32 and h_out:
// (B, C, N) f32, contiguous.  N in {4, 8, 16}; L, the token tile, in
// [1, min(S, 64)]; CC, the channels a CTA, a multiple of 32 in [32, 128].
int looptune_mamba_scan(const void* x, const void* dt, const void* a, const void* bm,
                        const void* cm, const void* h0, void* y, void* h_out, int B,
                        int S, int C, int N, int L, int CC, long long xsb, long long xss,
                        long long dsb, long long dss, long long bsb, long long bss,
                        long long csb, long long css, int bf16, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || C < 1 || L < 1 || L > kMaxL || L > S || CC < 32 ||
      CC > kMaxCC || CC % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const Args p{S, C, L, CC, xsb, xss, dsb, dss, bsb, bss, csb, css, h0 != nullptr,
               0, 0, 0, 0, 0};
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
