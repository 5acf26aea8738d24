"""The RWKV-6 scan's two passes at rwkv6-7b's prefill shape, and the pass-2
form they were chosen over, on one CUDA card.

    python3 benchmarks/port/rwkv6_scan_passes.py

Pass 1 (one CTA per stream and chunk) computes each chunk's own products and
leaves r_dec = r e^{cum_ex} for pass 2, which walks the state over the
chunks (one CTA per stream and 32 state columns).  The form compared,
``recompute``, is a copy of ``csrc/rwkv6_scan.cu`` in which pass 1 does not
store r_dec and pass 2 restages r and logw for every chunk and derives
cum and r_dec again (two CTAs an SM instead of three).  Both run through the
same wrapper at (B, S, H, N) = (4, 1024, 64, 64), bf16 r/k/v, chunk 128,
with a carried state, against the plain version (2e-4): each pass's device
time (``torch.profiler``, the mean over 10 calls) and the call's time (CUDA
events, median of 20, each after overwriting 512 MiB).  Prints one JSON line
per form and the card's name and power limit.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

RW = importlib.import_module("repro_torch.kernels.rwkv6_scan")
SHAPE, CHUNK, LIMIT = (4, 1024, 64, 64), 128, 2e-4

STORE = """  // r_dec = r~ e^{GX} against the chunk's start, to scratch for pass 2: a
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
"""
PASS2_FLOATS = """  return tile_rows(L) * (N + 4) + 2 * N * (cmin(N, kSliceCols) + 4) + N +
         tile_rows(L) * (cmin(N, kSliceCols) + 4);"""
LAUNCH = """  rwkv6_state_walk<N><<<B * a.H * (N / cmin(N, kSliceCols)), kThreads,
                        pass2_floats(a.L, N) * 4, s>>>(q.rd, q.s0, q.y, q.s_out, q.dS, q.decay,
                                                       a);"""
# pass 2 deriving r_dec from r and logw (cp.async, widened in place, a
# chunk-wide cumsum and pass 1's decay code), the rest as the shipped pass 2
RECOMPUTE_PASS2 = r"""// cum: inclusive cumsum of logw down each column of rows [0, LT), in place
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

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_state_walk(const T* __restrict__ r, const float* __restrict__ w,
                 const float* __restrict__ s0, float* __restrict__ y,
                 float* __restrict__ s_out, const float* __restrict__ dS,
                 const float* __restrict__ decay, const Args a) {
  using namespace hopper;
  constexpr int P = N + 4, CW = cmin(N, kSliceCols), SP = CW + 4;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int TX = CW / 4, TY = kThreads / TX, RPT = cmax(1, kMaxL / TY);
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int L = a.L, LT = tile_rows(L);
  float* const R = smem;
  float* const C = R + LT * P;
  float* const SS = C + LT * P;
  float* const DS = SS + N * SP;
  float* const DC = DS + N * SP;
  float* const YS = DC + N;
  float* const SEG = YS + LT * SP;
  const int bh = blockIdx.x / (N / CW), j0 = (blockIdx.x % (N / CW)) * CW;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const T* const rb = r + b * a.rsb + h * a.rsh;
  const float* const wb = w + b * a.wsb + h * a.wsh;
  const long long y_row = (long long)a.H * N;
  float* const yb = y + (long long)b * a.S * y_row + h * N + j0;
  const uint32_t r_dst = smem_u32(R) + (BF16 ? 2 * N : 0);
  for (int e = tid; e < N * CW; e += kThreads) {
    const int n = e / CW, j = e % CW;
    SS[n * SP + j] = s0 != nullptr ? s0[((long long)bh * N + n) * N + j0 + j] : 0.f;
  }
  stage<T, N>(r_dst, P * 4, rb, a.rss, LT, cmin(L, a.S), a.vec_r, tid);
  stage<float, N>(smem_u32(C), P * 4, wb, a.wss, LT, cmin(L, a.S), a.vec_w, tid);
  cp_async_commit();
  for (int c = 0; c < a.n_chunks; ++c) {
    const int t0 = c * L, rows_in = cmin(L, a.S - t0);
    const bool next = c + 1 < a.n_chunks;
    const long long at = (long long)bh * a.n_chunks + c;
    cp_async_wait<0>();
    __syncthreads();
    stage<float, CW>(smem_u32(YS), SP * 4, yb + t0 * y_row, y_row, LT, rows_in, 1, tid);
    stage<float, CW>(smem_u32(DS), SP * 4, dS + at * N * N + j0, N, N, N, 1, tid);
    stage<float, N>(smem_u32(DC), N * 4, decay + at * N, N, 1, 1, 1, tid);
    cp_async_commit();
    if constexpr (BF16) widen_rows<N>(R, LT, tid);
    column_cumsum<N>(C, SEG, LT, tid);
    {
      using RS_ = RowSplit<N>;
      const int i = tid / RS_::TPR, n0 = (tid % RS_::TPR) * RS_::NPT;
      if (i > 0 && i < LT) {
#pragma unroll
        for (int b0 = 0; b0 < RS_::STEPS; b0 += RS_::BATCH) {
          float4 rv[RS_::BATCH], cx[RS_::BATCH];
#pragma unroll
          for (int q = 0; q < RS_::BATCH; ++q) {
            rv[q] = load4(R + i * P + n0 + 4 * (b0 + q));
            cx[q] = load4(C + (i - 1) * P + n0 + 4 * (b0 + q));
          }
#pragma unroll
          for (int q = 0; q < RS_::BATCH; ++q)
            *reinterpret_cast<float4*>(R + i * P + n0 + 4 * (b0 + q)) = mul4(rv[q], exp4(cx[q], 1.f));
        }
      }
    }
    __syncthreads();
    if (next)
      stage<float, N>(smem_u32(C), P * 4, wb + (t0 + L) * a.wss, a.wss, LT,
                      cmin(L, a.S - t0 - L), a.vec_w, tid);
    cp_async_commit();
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
    cp_async_wait<1>();
    __syncthreads();
    if (next)
      stage<T, N>(r_dst, P * 4, rb + (t0 + L) * a.rss, a.rss, LT, cmin(L, a.S - t0 - L),
                  a.vec_r, tid);
    cp_async_commit();
#pragma unroll
    for (int x = 0; x < RPT; ++x) {
      const int row = ty + TY * x;
      if (row >= rows_in) continue;
      const float4 yv = load4(YS + row * SP + 4 * tx);
      *reinterpret_cast<float4*>(yb + (t0 + row) * y_row + 4 * tx) =
          make_float4(yv.x + acc[x][0], yv.y + acc[x][1], yv.z + acc[x][2], yv.w + acc[x][3]);
    }
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

"""


def recompute_source(out_dir: Path) -> Path:
    src = (_build.CSRC / "rwkv6_scan.cu").read_text()
    start = src.index("template <int N>\n__global__ void __launch_bounds__(kThreads, 3)\n"
                      "rwkv6_state_walk(")
    end = src.index("// raises a kernel's dynamic shared memory limit")
    for part in (STORE, PASS2_FLOATS, LAUNCH, "allow_smem<rwkv6_state_walk<N>>()"):
        if src.count(part) != 1:
            raise SystemExit(f"rwkv6_scan.cu: {part[:60]!r} is not found once")
    text = (src[:start] + RECOMPUTE_PASS2 + src[end:]).replace(STORE, "").replace(
        PASS2_FLOATS, """  return 2 * tile_rows(L) * (N + 4) + 2 * N * (cmin(N, kSliceCols) + 4) + N +
         tile_rows(L) * (cmin(N, kSliceCols) + 4) + kThreads;""").replace(
        LAUNCH, """  rwkv6_state_walk<T, N><<<B * a.H * (N / cmin(N, kSliceCols)), kThreads,
                           pass2_floats(a.L, N) * 4, s>>>(r, q.w, q.s0, q.y, q.s_out, q.dS,
                                                          q.decay, a);""").replace(
        "allow_smem<rwkv6_state_walk<N>>()", "allow_smem<rwkv6_state_walk<T, N>>()")
    path = out_dir / "recompute" / "rwkv6_scan.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def time_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def pass_ms(fn, reps: int = 10) -> dict:
    """Mean device ms of each pass over ``reps`` calls (profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in ("rwkv6_chunk_intra", "rwkv6_state_walk"):
            if name in ev.key and ev.device_time_total > 0:
                out[name] = ev.device_time_total / ev.count / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv6_scan_passes: no CUDA device", file=sys.stderr)
        return 1
    variant = recompute_source(ROOT / "build" / "rwkv6_passes")
    _build.build_all(["rwkv6_scan", variant])
    b, s, h, n = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = ((0.5 * torch.randn(b, s, h, n, generator=g, device="cuda")).bfloat16()
               for _ in range(3))
    logw = -torch.exp(torch.randn(b, s, h, n, generator=g, device="cuda") - 2.0)
    u = 0.3 * torch.randn(h, n, generator=g, device="cuda")
    s0 = 0.1 * torch.randn(b, h, n, n, generator=g, device="cuda")
    want_y, want_s = RW.rwkv6_chunk_scan_plain_heads(r, k, v, logw, u, chunk=CHUNK, s0=s0)
    flush = torch.empty(512 * 1024 * 1024 // 4, device="cuda")

    def call():
        return RW.rwkv6_chunk_scan(r, k, v, logw, u, chunk=CHUNK, s0=s0)

    for form, path in (("store_rdec", None), ("recompute", variant),
                       ("store_rdec", None), ("recompute", variant)):
        with _build.substitute("rwkv6_scan", path or _build.CSRC / "rwkv6_scan.cu", RW._declare):
            y, st = call()
            torch.cuda.synchronize()
            ratio = max(((x - p).abs() / (LIMIT + LIMIT * p.abs())).max().item()
                        for x, p in ((y, want_y), (st, want_s)))
            if not ratio <= 1.0:
                raise SystemExit(f"{form}: outside the {LIMIT} limit ({ratio})")
            print(json.dumps({"form": form, "bshn": list(SHAPE), "chunk": CHUNK,
                              "ms": time_ms(call, flush), "device_ms_by_pass": pass_ms(call),
                              "ratio_to_limit": ratio}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
