"""Chip smoke test of the PyTorch/CUDA port: its main paths on one card.

    python3 chip_smoke.py

Run from the repository root on a host with one CUDA card (H100), the CUDA
toolkit and PyTorch; it needs nothing else.  Phases, each printing one JSON
line with its seconds:

1. device — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build  — nvcc builds the tiled-matmul, flash-attention, flash backward,
   RWKV-6 scan and Mamba scan kernels from ``src/repro_torch`` and a copy
   of each scan kernel, two of the flash kernel, two of the flash backward
   and two of the matmul with one term dropped (the mutation checks
   below), in parallel, and reports ptxas'
   register lines (for each instance of the Mamba scan, of flash's SIMT
   kernel and of the flash backward: registers and spills) and the number
   of HGMMA (wgmma) instructions in the flash, flash backward and matmul
   libraries' SASS;
3. kernel — the matmul kernel against its plain torch version on the card
   over a sweep of shapes, blocks, grid orders, dtypes and transposed B,
   then its tensor-core route's bf16 cases (musicgen-large's six shapes at
   the thin blocks an f32-timed search picked for the model and at 128^3,
   every (m tile, n tile) pair, ragged M,
   N and K off multiples of 64, both B layouts, f32 and bf16 out), each case
   with its route and the kernel's own launch plan held equal to
   ``launch_plan``; then two mutation checks: the matmul with its last
   64-value k chunk dropped must put every tensor-core case with K > 64
   outside its limit, and with the SIMT ring's last k stage dropped every
   SIMT case with K over one stage;
   attention — the flash-attention kernel against its plain version over
   the JAX kernel tests' shapes, windows, softcaps, bf16, head dim 128 with
   GQA groups of 4, the tensor-core route's bf16 cases at head dims 64 and
   128 (ragged S != T, GQA 4, blind rows, softcaps, every kv tile, a
   strided q view) and at the zoo's 96 and 256 (GQA 5 and 8 as well), the
   same cases in f32 on the SIMT route, and the models' own shapes (with
   llama-3.2-vision's 1024 x 1600 cross-attention), each case with its
   route and the kernel's own launch
   plan held equal to ``launch_plan``; then two mutation checks: the kernel
   with the accumulator's alpha rescale dropped, on each route, must put
   more than half of that route's multi-tile cases outside their limit;
   rwkv_scan — the RWKV-6 chunked-scan kernel (two passes: the chunks' own
   products in parallel, then the state's walk over the chunks) against its
   plain version over
   the JAX kernel tests' ranges (S 1-70, N 4/8/16, chunks 4/16/64, 1-4
   streams), N = 64 at chunks 64 and 128, a carried state, bf16 r/k/v and
   rwkv6-7b's prefill shape;
   mamba_scan — the Mamba selective-scan kernel against its plain version
   over the JAX kernel test's ranges (S 1-40, C 8/20/32, N 4/8, chunks
   4/8/32, blocks 8/16/128), jamba's prefill shapes, f32 and bf16, with and
   without a carried state, through strided B/C views, ragged S and C, each
   case with the kernel's own launch plan held equal to ``launch_plan``;
4. tune   — ``LoopTuner(policy="search", backend="torch")`` tunes the six
   dense contractions of musicgen-large (d_model 2048, d_ff 8192, vocab
   2048) at decode (M=4) and prefill (M=1024); every reward is a timed
   launch of the kernel;
5. serve  — one layer's worth of ``tuned_einsum`` calls (wq/wk/wv, gate,
   up, down, logits) under ``serving(registry)``, decode and prefill,
   checked against ``matmul_ref``;
   policy — the policy path: APEX-DQN with the paper's network (flat state
   320, dueling head, hidden (256, 256), 8 actors on the ε ladder, the
   card executor's 10 actions) trains on a seeded subsample of the paper's
   matmul train split (dims 64-256), every reward a timed launch of the
   tiled-matmul kernel (f32, the SIMT route); its greedy policy is
   evaluated on 8 held-out matmuls of the test split; DQN trains briefly
   with the graph encoder (the message passing on the card); the APEX
   checkpoint is reloaded through ``LoopTuner.from_checkpoint`` (its
   calibration must be ``recorded``; its greedy actions must equal the
   trained policy's on 64 states, and a CPU load's on those clear of
   ties), tunes musicgen-large's six f32 contractions by greedy rollout
   (each beside the search's block and seconds), and its records are
   served through ``tuned_einsum`` against ``matmul_plain`` at their
   blocks; last, ``LoopTuner(policy="search", surrogate="auto")`` tunes the
   same six at phase tune's budget, beside the measured-only search;
   actor_critic — the actor-critic trainers on the same contractions: PPO
   (20 iterations), A2C (80) and IMPALA (40), 6,400 env steps each, every
   reward a timed launch of the tiled-matmul kernel (f32, the SIMT route),
   each evaluated on the held-out matmuls beside APEX-DQN's rows; IMPALA's
   actor must differ from its learner after the updates since its last
   sync; the PPO checkpoint is reloaded through
   ``LoopTuner.from_checkpoint`` (calibration ``recorded``, greedy actions
   equal to the trained policy's on 64 states) and tunes musicgen-large's
   six f32 contractions through ``launch/tune``'s ``tune_records`` with a
   journal and a registry file; the records read back from that file are
   served through ``tuned_einsum`` against ``matmul_plain``, and a resumed
   ``tune_records`` must skip all six without a launch;
   fleet — the tuner measuring out of process, in four phases:
   pool: ``LoopTuner(backend=make_backend("torch", measure="pool"))`` tunes
   the six f32 contractions with every reward timed in one spawned worker
   on ``cuda:0`` (the worker built as a spy that counts its own launches and
   writes them under ``chiprun_out/``); the worker must be among the card's
   compute processes, launch the kernel for each contraction while the
   parent launches none, and every measurement come from it; the records
   are served as in phase actor_critic; pool_faults: one spawned worker
   through a faulty spy: a schedule that ends its worker on every attempt
   must resolve as a failed record, one that hangs once past a 5 s budget
   must be killed and re-measured, the others measured on the card;
   kernel_store: two spawned workers with an empty build directory share
   an empty kernel store, and exactly one may run nvcc on matmul.cu (one
   compiles.log event), then a fresh worker with the same store none;
   farm: ``repro_torch.launch.measure_farm --backend torch --measure pool``
   as a subprocess serves ``tune_records_fleet`` with two clients: no
   degradation, tickets balanced, records stamped ``torch`` and the card,
   served as above, and SIGTERM drains it to exit 0.  After the path's
   counts are read, the pool's rewards are set beside in-process timings
   of the same schedules (``pool_against_inproc``, reported);
   model  — the second path: musicgen-large at full width (48 layers,
   d_model 2048, bf16, random weights from a seed) tuned through the entry
   point, ``launch/tune``'s ``tune_model`` at the serving shapes (its
   harvest runs one prefill and one decode step under an empty registry:
   the harvested keys must be the six contractions in bf16 with the counts
   the config implies; the budget splits by FLOP share), into a registry
   file, then served from that file as read back by ``launch/serve.py``'s
   continuous-batching loop: every dense site launches the tiled-matmul
   kernel and every prefill attention (the harvest's one prefill included)
   the flash-attention kernel.  Each bf16 record is then held, through
   ``tuned_einsum`` at the
   model's shapes, against ``matmul_plain`` at the record's block; the last
   logits and first decode logits against the same steps with
   ``registry=None`` (dense on ``torch.matmul``), and one prefill wave and
   one decode step are traced with ``torch.profiler``.  Every launch of
   that path, the bf16 tune's rewards and every serving call, must take the
   tensor-core route;
   model_rwkv — the third path: rwkv6-7b at full width (32 layers, d_model
   4096, bf16, random weights from a seed) served by ``serve_once``: every
   prefill time-mix launches the scan kernel.  Then the prefill of a
   384-token prompt (kernel) against the same prompt fed token by token
   through ``decode_step`` (the plain recurrence, no kernel): last logits
   and every layer's state and carries; the same check on the same weights
   widened to f32 (the witness that the bf16 error is the dense products'
   rounding); and a mutation check: the scan kernel with its u-bonus term
   dropped, through the same wrapper, must fail both the bf16 check and the
   rwkv_scan cases;
   model_jamba — the fourth path: jamba-v0.1-52b at its published widths
   cut to two periods (16 layers: d_model 4096, GQA 32/8 at head dim 128,
   16 experts top-2, bf16, random weights from a seed) served by
   ``serve_once``: every prefill Mamba mixer launches the selective-scan
   kernel and every prefill attention the flash kernel.  Then one
   full-width Mamba layer in f32, prefill (kernel) against the plain
   token-by-token decode (the sharp check); the 16-layer model, prefill of a
   384-token prompt against the same prompt through ``decode_step`` (last
   logits, every Mamba layer's h and conv, the attention k/v), with every
   token routed to all 16 experts and at MoE capacity 8, where the two
   paths' expert choices are recorded and compared; and a mutation check:
   the scan kernel with the decay of each staged tile's first token
   dropped must fail the sharp check and the mamba_scan cases;
   zoo — the fifth path: the other seven architectures at their published
   widths, bf16, random weights from a seed, one at a time (llama4-scout
   cut to two whole 4-layer periods): 4 requests of a 1024-token prompt +
   16, one wave, ``registry=None``, through ``serve_once`` (through its
   loop with a seeded (4, 1600, 4096) encoder added to the prefill inputs
   for llama-3.2-vision, which ``serve_once`` refuses): every
   prefill attention, cross-attention included, launches the flash kernel,
   and no other kernel runs.  Per model: its parameter count, one traced
   prefill wave and decode step, decode of token 1025 against ``forward``
   over the 1025 tokens (the MoE models with every token routed to all
   experts and at a capacity where nothing drops: llama4 in bf16, olmoe with
   its weights widened to f32), finite logits and peak memory under 80 GB;
   train  — the sixth path, training: flash_bwd holds the flash backward
   kernel (``csrc/flash_attention_bwd.cu``) against its plain version on
   the same q, k, v, out, dout and lse, and the forward kernel's lse against
   the plain forward's, in f32 and bf16 at every backward head dim (causal,
   a window, softcap 50, GQA 1/4/8, S and T off any tile, rows that see no
   key, jamba's (4, 1024, 32/8, 128) and musicgen-large's (4, 1024, 32,
   64)), each bf16 D = 64/96/128 case on the tensor-core route with the
   kernel's plan equal to ``bwd_launch_plan``, refuses D = 256, and each
   route's kernel without its ``- delta`` must fail more than half of that
   route's multi-tile cases; scan_grads holds both scans' autograd functions (the
   kernel forward, the plain-recompute backward) against plain autograd;
   train_model trains musicgen-large at its published widths (48 layers,
   bf16 with an f32 master copy and f32 moments, remat "block",
   ``registry=None``) for four AdamW steps on one repeated 4 x 1024 batch of
   the data pipeline: the loss falls, peak memory stays under 80 GB, and
   each step launches flash forward 96 times (48 layers and their
   recompute) and the backward 48 times, no other kernel; then one traced
   step, and one step's gradients at the same widths cut to 2 layers with
   the kernels against the plain flash forward and backward; last,
   train_launcher runs ``repro_torch.launch.train`` as subprocesses:
   olmoe's smoke config through an injected failure and a resume,
   phi3-mini's with int8 gradient compression, rwkv6-7b's and jamba's
   launching their scans, every loss falling;
   dist   — the seventh path, the distributed runtime: one nccl rank on
   cuda:0 through a FileStore under ``chiprun_out/``, a (1, 1) mesh over
   ("data", "model"); dist_train trains musicgen-large as train_model does
   (the same seed, batch and lr) with its parameters DTensors placed by the
   FSDP specs and AdamW's moments and master by the ZeRO specs, each
   step's loss held against train_model's for that step, flash forward 96
   and backward 48 launches a step, no other kernel, peak memory under 80
   GB, its step p50 beside train_model's; dist_serve serves olmoe-1b-7b at
   its published widths (4 x 1024 prompt, 4 decode steps, bf16,
   registry=None) without a mesh and then placed on it (flash 16 a wave),
   holding the logits and greedy tokens with every token routed to all
   experts; dist_roofline prints the training cell's model FLOPs,
   ``train_mfu`` of both training runs on ``analysis/roofline.py``'s H100
   constants, the step's roofline terms from an analytic record, and the
   card's memory against ``HBM_GIB``; dist_two_rank, with two cards or
   more, trains on a (2, 1) mesh of two spawned ranks against the 1-rank
   loss, and otherwise prints that it did not run;
6. timing — per contraction, in f32 on the SIMT route: the kernel at its
   tuned block and at 128^3 (each with its TFLOP/s), the plain version,
   ``torch.matmul`` (the library yardstick only), and the bound (bytes over
   3.35 TB/s vs FP32 operations over the FP32 peak);
   then the six contractions in bf16 at the model's tuned records, on the
   tensor-core route, with the profiler's device time (CUDA events around
   the call where three traces come back without the kernel's rows; each
   row names its ``device_ms_source``), TFLOP/s and the bf16
   bound (bytes vs operations at 989 TFLOP/s);
   then flash attention at the models' prefill shapes, bf16 and f32 (the
   SIMT route), and at phi3-mini's (D = 96) and gemma3-12b's (D = 256) in
   bf16, against its plain version, ``scaled_dot_product_attention``
   (yardstick only) and its bound, each with a block sweep;
   then the scan kernel at rwkv6-7b's prefill shape against its plain
   version and its bound (bytes vs the 4N^2 FLOP a token that any form of
   the recurrence does; no single PyTorch call computes the recurrence),
   with each pass's device time and the chunked form's FP32 floor;
   then the Mamba scan at jamba's prefill shape against its plain version
   and its bound (bytes, FP32 operations, or the exponentials at the SFU
   rate and the card's top SM clock, whichever is largest), with its device
   time and a block sweep; then the flash backward at musicgen-large's
   training shape against its plain version, autograd's backward of one
   SDPA call (yardstick only) and its bound, and the forward with and
   without its lse output; dist_roofline_ceiling holds the six bf16
   contractions' TFLOP/s, the kernel's and cuBLAS's, under
   ``PEAK_FLOPS``.

All five kernels' launch counts are set to 0 before phase 4 and read after
phase 5, set to 0 again before the policy phase and read after it, and
before the actor-critic phase and read after it, before the fleet path and
read after its farm phase (its workers' launches, counted by their spies,
added to the parent's), set to 0 before the
model's ``tune_model`` and read right after its serve run, and set to 0
before rwkv6-7b's and jamba's serve runs and each zoo model's and read
right after each (path zoo sums its seven), and set to 0 before path
train's four training steps and read after them, and set to 0 before
dist_train's steps and dist_serve's run under the mesh and read after each
(path dist sums the two); each path must launch its own kernels and no
other.
Launches made to
compare, trace, check or time do not count.  Per-case detail goes to
``chiprun_out/chip_smoke_cases.jsonl``.  Any failure exits non-zero before
the last line, which is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.backend import register_backend  # noqa: E402

D_MODEL, D_FF, VOCAB = 2048, 8192, 2048  # musicgen-large (configs/musicgen_large.py)
DECODE_M, PREFILL_M = 4, 4 * 256
HBM_BYTES_PER_S = 3.35e12
F32_PEAK = {"pcie": 51e12, "sxm": 67e12}  # FP32 non-tensor FLOP/s
BF16_PEAK = {"pcie": 756e12, "sxm": 989e12}  # dense bf16 tensor FLOP/s
SEED = 0
TUNE_MAX_EVALS = 150    # per search (greedy, then beam), per contraction
TUNE_BUDGET_S = 30.0    # per search, per contraction
ATTN_LIMIT = {torch.float32: 3e-5, torch.bfloat16: 3e-2}  # tests/test_kernels.py's
# the model phase: 8 requests of 256 prompt frames (~5 s of audio at 50 Hz)
SERVE = dict(requests=8, batch=4, prompt_len=256, gen_len=16, max_len=512)
MODEL_LIMIT = 5e-2  # tuned vs registry=None logits, bf16 through 48 layers
FA_SHAPE = (4, 256, 32, 64)  # (B, S, H, D) of the model's prefill attention
RWKV_LIMIT = 2e-4  # allclose rtol = atol, tests/test_kernels.py's for the scan
# rwkv6-7b: 8 requests of 1024 prompt tokens, 2 prefill waves of 8 chunks
RWKV_SERVE = dict(requests=8, batch=4, prompt_len=1024, gen_len=32, max_len=1056)
RWKV_SHAPE = (4, 1024, 64, 64)  # (B, S, H, N) of its prefill scan
RWKV_CHUNK = 128  # models/rwkv6.py time_mix_chunked's
RECURRENCE_LEN = 384  # prompt of the prefill-vs-recurrence check: 3 chunks
# max abs diff / max abs over the last logits and every layer's s, xt and xc:
# about twice the 6.7e-2 read with the correct kernel in bf16 (the mutant
# reads 0.41).  The error grows with depth (layer 0's state agrees to 2e-6,
# layer 29's to 4e-2); the same check with the weights widened to f32 (the
# witness below) tells bf16 rounding of the dense products from the scan
RECURRENCE_LIMIT = 0.15
F32_WITNESS_LIMIT = RECURRENCE_LIMIT / 10  # the f32 run must sit far below it
MUTANT_LINE = "const float dg = DG[row];  // the u-bonus term"
# jamba-v0.1-52b at two periods: the published widths, 16 of its 32 layers
# (the 32 need ~103 GB of bf16 weights; 16 hold 52.1 GB on one 80 GB card)
JAMBA_LAYERS = 16
JAMBA_SERVE = dict(requests=8, batch=4, prompt_len=1024, gen_len=32, max_len=1056)
FA_JAMBA_SHAPE = (4, 1024, 32, 8, 128)  # (B, S, H, HKV, D) of its prefill attention
MAMBA_LIMIT = 2e-4  # allclose rtol = atol, tests/test_kernels.py's for the scan
MAMBA_SHAPE = (4, 1024, 8192, 16)  # (B, S, C, N) of its prefill scan
MAMBA_CHUNK, MAMBA_BD = 64, 128  # models/mamba.py mamba_apply's chunk, the ops' bd
MAMBA_SWEEP = [(64, 32), (64, 64), (64, 256), (16, 128), (32, 128)]  # other "mamba" blocks
MAMBA_LAYER_LIMIT = 2e-3  # one f32 layer, prefill vs recurrence: tests/test_moe.py's
# max abs diff / max abs over the last logits, every Mamba layer's h and conv
# and the attention k/v, bf16 through 16 layers, with every token routed to
# all 16 experts: about twice the 5.5e-2 read with the correct kernel (the
# limit started at 0.15, PR 13's; the mutant reads 6.7e-2, so the one-layer
# f32 check is the sharp one).  At capacity 8 (top-2) bf16 noise flips the
# experts of 0.5-13 % of the tokens between the two paths, and the caches
# then differ by up to 1.08 whatever the kernel: only the last logits
# (2.3e-2) are held to the limit there
JAMBA_RECURRENCE_LIMIT = 0.11
MAMBA_MUTANT_LINE = "const float decay = ex2_approx(dtv * a2[n]);  // e^{dt a_n}"
SFU_EXP_PER_CLOCK = 16  # exponentials a clock per SM (sm_90's MUFU rate)
# path zoo: the other seven architectures at their published widths, bf16,
# random weights from a seed, one at a time; llama4-scout cut to two whole
# 4-layer periods (its 48 layers need 215.5 GB).  Per model: (layers run or
# None for all, the parameters at that depth, flash launches a prefill wave,
# the MoE capacity factor at which nothing drops for the decode check)
ZOO = {
    "olmoe-1b-7b": (None, 6_919_100_416, 16, 8.0),        # 64 experts / top-8
    "gemma2-27b": (None, 27_227_128_320, 46, None),
    "command-r-35b": (None, 30_283_538_432, 40, None),
    "llama4-scout-17b-a16e": (8, 19_685_790_720, 8, 16.0),  # 16 experts / top-1
    "phi3-mini-3.8b": (None, 3_821_079_552, 32, None),    # D = 96
    "gemma3-12b": (None, 11_765_788_416, 48, None),       # D = 256
    "llama-3.2-vision-11b": (None, 10_110_734_336, 48, None),  # 40 self + 8 cross
}
# one wave of 4 requests: a 1024-token prompt + 16 generated each; gemma3's
# 1024-token window sits below max_len, so its decode writes the ring past it
ZOO_SERVE = dict(requests=4, batch=4, prompt_len=1024, gen_len=16, max_len=1040)
# decode of token 1025 against forward over the 1025 tokens, max abs diff /
# max abs of the logits, bf16 at full width: about twice the first reading
# with the correct kernel (in brackets, on an H100 SXM at 700 W).  The MoE
# models run it with every token routed to all experts ("dense_routing": no
# discrete choice for bf16 noise to flip) and at the capacity above
# ("capacity_*").  olmoe's top-8 of 64 flips so many routings in bf16 (its
# combine adds eight bf16 terms a token in atomic order, so the flips vary
# run to run) that its bf16 capacity reading decorrelated the logits (0.57
# to 1.15 over three runs) and could hold nothing: its capacity check runs
# on the same weights widened to f32 ("f32_capacity_8" [1.9e-5, 1.35e-5]).
# Each model runs exactly the checks its limits name, in this order
ZOO_LIMIT = {"olmoe-1b-7b": {"dense_routing": 0.21,                        # [0.107, 0.116]
                             "f32_capacity_8": 4e-5},
             "gemma2-27b": {"served": 0.13},                              # [0.0626]
             "command-r-35b": {"served": 0.011},                          # [0.0055]
             "llama4-scout-17b-a16e": {"capacity_16": 0.028,              # [0.0140]
                                       "dense_routing": 0.067},           # [0.0336]
             "phi3-mini-3.8b": {"served": 0.04},                          # [0.0203]
             "gemma3-12b": {"served": 0.001},                             # [0.000507]
             "llama-3.2-vision-11b": {"served": 0.042}}                   # [0.0212]
CARD_BYTES = 80e9  # one H100's device memory
FA_PHI3_SHAPE = (4, 1024, 32, 32, 96)   # (B, S, H, HKV, D) of phi3-mini's prefill attention
FA_GEMMA3_SHAPE = (4, 1024, 16, 8, 256)  # gemma3-12b's
# the other prefill attentions of path zoo, (B, S, H, HKV, D), window and
# softcap as the models' layers pass them to the kernel
FA_ZOO_PREFILL = [((4, 1024, 16, 16, 128), None, None),  # olmoe-1b-7b
                  ((4, 1024, 32, 16, 128), None, 50.0),  # gemma2-27b, global layers
                  ((4, 1024, 32, 16, 128), 4096, 50.0),  # gemma2-27b, local layers
                  ((4, 1024, 64, 8, 128), None, None),   # command-r-35b, GQA 8
                  ((4, 1024, 40, 8, 128), 8192, None),   # llama4-scout, local layers, GQA 5
                  ((4, 1024, 16, 8, 256), 1024, None)]   # gemma3-12b, local layers
FLASH_SWEEP = [(64, 64), (128, 64), (64, 32), (128, 32), (64, 16), (128, 16)]  # other "fa" blocks, timed
FLASH_MUTANT_LINE = "acc[c][i] *= (i & 2) ? alpha1 : alpha0;  // the accumulator's alpha rescale"
SIMT_FLASH_MUTANT_LINE = "acc[i][c] *= alpha;  // the SIMT accumulator's alpha rescale"
MATMUL_MUTANT_LINE = "const int kchunks = (a.K + kChunk - 1) / kChunk;  // 64-value chunks of K"
SIMT_MUTANT_LINE = "return (K + kd - 1) / kd;  // k stages of the SIMT ring"
# the tensor-core route's f32-out limit: the products of bf16 values are
# exact in f32, but the tensor cores add them into the f32 accumulator with
# truncation rather than round to nearest, so the error grows with K: the
# route read up to 3.7e-6 at K = 2048 and 1.17e-5 at K = 8192 against the
# plain version (the SIMT route 3.7e-6 there; PERF.md §2).  This limit is
# about 2.5 times the K = 8192 reading.  The SIMT route keeps 1e-5, and bf16
# out is 1e-2 on both
TC_F32_LIMIT = 3e-5
# the policy path: APEX-DQN (the paper's network: flat state 320, dueling
# head, hidden (256, 256), 8 actors) trained on card-timed rewards over a
# seeded subsample of the paper's matmul train split, evaluated on held-out
# matmuls of its test split, then tuning musicgen-large's six contractions
POLICY_TRAIN = 96          # train-split contractions the actors draw from
POLICY_EVAL = 8            # held-out test-split contractions
APEX_ITERATIONS = 300      # one episode of 10 actions per actor each
DQN_ITERATIONS = 8         # the graph-encoder DQN: the trunk on the card
POLICY_PROBE = 64          # states on which reloaded policies must act alike
TIE_GAP = 1e-3             # 100x the f32 score tolerance (1e-5 relative)


# path train: the flash backward kernel against its plain version (allclose
# rtol = atol: f32 the JAX package's own flash-gradient tolerance,
# tests/test_attention.py:106; bf16 the forward's 3e-2), the forward's lse
# against the plain forward's; the scans' autograd against plain autograd
FLASH_BWD_LIMIT = {torch.float32: 5e-4, torch.bfloat16: 3e-2}
LSE_LIMIT = 1e-5
FLASH_BWD_MUTANT_LINE = "const float ds = pv * (dp[i][j] - dl_s[r]) * fac;  // ds = p (dP - delta)"
# the same term on the tensor-core route (its dk/dv kernel)
TC_FLASH_BWD_MUTANT_LINE = ("const float ds = s[i] * (dp[i] - dl);  "
                            "// dS^T = P^T (dP^T - delta), by fragment")
SCAN_GRAD_RWKV = (2, 256, 4, 64)      # (B, S, H, N)
SCAN_GRAD_MAMBA = (2, 256, 256, 16)   # (B, S, C, N)
SCAN_LIMIT_GRAD = 2e-4
# musicgen-large trained at its published widths: 48 layers, bf16 params
# with an f32 master copy and f32 moments, remat "block", registry=None,
# one repeated batch of 4 x 1024 frames from the data pipeline
MUSICGEN_PARAMS = 3_229_812_736
TRAIN_BATCH = (4, 1024)
TRAIN_STEPS = 4
# constant; at this init (logits at scale ~45, loss ~159) 3e-4 and 1e-4
# rise again by the third step, 2e-5 falls 159 -> 123 -> 85 -> 61 -> 35
# (an H100 SXM at 700 W, six steps each)
TRAIN_LR = 2e-5
TRAIN_FA_SHAPE = (4, 1024, 32, 64)  # (B, S, H, D) of its attention
TRAIN_CHECK_LAYERS = 2  # the kernel-vs-plain gradient check's depth
# per leaf, max |kernel grad - plain grad| / max |plain grad|, bf16 at the
# published widths cut to 2 layers: about twice the first reading with the
# correct kernels, 0.0636 at lm_head (median leaf 0.033; an H100 SXM at
# 700 W).  The kernels' forward rounds p to bf16 where the plain one keeps
# f32, and at this init's logit scale (~45, loss ~150) the head's gradient
# moves with the hidden states' last bits
TRAIN_CHECK_LIMIT = 0.13


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
    from repro_torch.kernels.matmul import matmul

    matmul.route_launches = {"wgmma": 0, "simt": 0}


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by name; a wrapper adds one to its ``launches``
    where it launches its kernel and nowhere else."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.rwkv6_scan import rwkv6_chunk_scan

    return {"tiled_matmul": matmul, "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "rwkv6_scan": rwkv6_chunk_scan, "mamba_scan": mamba_scan}


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def check_path_launches(path: str, launches: dict, used: tuple) -> None:
    """Every kernel of ``used`` launched on this path, no other kernel did."""
    bad = {k: n for k, n in launches.items() if (n > 0) != (k in used)}
    if bad:
        raise SystemExit(f"{path}: launches {launches}, expected > 0 only for {used}")


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **kw}), flush=True)


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_by_function(log: str, keep: str) -> dict:
    """ptxas -v output per kernel whose demangled name holds ``keep``: its
    registers and its spill stores and loads (bytes)."""
    import re
    import shutil

    out, name = {}, None
    filt = shutil.which("cu++filt") or str(Path(shutil.which("nvcc") or
                                                "/usr/local/cuda/bin/nvcc").parent / "cu++filt")
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            try:
                name = subprocess.run([filt, name], capture_output=True, text=True,
                                      check=True).stdout.strip()
                name = name[:name.find(">(") + 1] if ">(" in name else name
            except (OSError, subprocess.CalledProcessError):
                pass
            for noise in ("(anonymous namespace)::", "<unnamed>::", "void ", "(int)"):
                name = name.replace(noise, "")
            continue
        if name is None or keep not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(name, {})["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return ((out.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def limit_for(out_dtype, route: str = "simt") -> float:
    # both accumulate in f32, only the order of summation differs; a bf16
    # output rounds to 8 bits of mantissa (tests/test_kernels.py's 1e-2);
    # the tensor cores' truncating f32 accumulation has its own f32 limit
    if out_dtype != torch.float32:
        return 1e-2
    return TC_F32_LIMIT if route == "wgmma" else 1e-5


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

SHAPES = [(1, 1, 1), (4, 33, 96), (33, 200, 4), (96, 96, 96), (200, 1024, 33),
          (1024, 200, 1024), (4, 8192, 2048), (1024, 1024, 200), (1, 1024, 200),
          (33, 4, 1024)]
BLOCKS = [(4, 64, 64), (32, 32, 32), (96, 64, 96), (128, 128, 128), (64, 8192, 256)]
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)]


# the tensor-core route's bf16 cases: musicgen-large's six contractions at
# the thin blocks an f32-timed search picked for the model (one output
# element a block) and at 128^3, then ragged M with N and K multiples of 8
# but not of 64 at blocks that reach every (m tile, n tile) pair
MODEL_BLOCKS = [(1, 2048, 1), (4, 2048, 1), (1, 8192, 1), (128, 128, 128)]
TC_BLOCKS = [(64, 64, 64), (64, 128, 128), (32, 256, 256), (128, 64, 64), (128, 128, 128),
             (128, 256, 256)]


def matmul_cases() -> list:
    """(m, k, n, (bm, bk, bn), grid order, in dtype, out dtype, trans_b):
    the sweep of both routes, then the tensor-core route's bf16 cases."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(m, k, n, blk, order, dt, odt, trans_b)
             for (m, k, n) in SHAPES for blk in BLOCKS for order in ("mn", "nm")
             for dt, odt in DTYPES for trans_b in (False, True)]
    cases += [(m, k, n, blk, "mn", bf16, odt, trans_b)
              for (m, k, n) in CONTRACTIONS for blk in MODEL_BLOCKS
              for odt in (bf16, f32) for trans_b in (False, True)]
    cases += [(m, k, n, blk, ("mn", "nm")[i % 2], bf16, odt, trans_b)
              for m in (1, 4, 33, 200) for (k, n) in ((200, 1000), (1000, 200), (8, 72))
              for i, blk in enumerate(TC_BLOCKS) for odt in (bf16, f32)
              for trans_b in (False, True)]
    return cases


def matmul_case_check(case, g) -> dict:
    """One case: the kernel against its plain version on the same inputs,
    its route, and the kernel's own plan against ``launch_plan``."""
    from repro_torch.kernels.matmul import kernel_plan, launch_plan, matmul, matmul_plain

    m, k, n, (bm, bk, bn), order, dt, odt, trans_b = case
    a = torch.randn(m, k, generator=g, device="cuda").to(dt)
    b = torch.randn(*((n, k) if trans_b else (k, n)), generator=g, device="cuda").to(dt)
    kw = dict(bm=bm, bk=bk, bn=bn, grid_order=order, out_dtype=odt, trans_b=trans_b)
    out = matmul(a, b, **kw)
    plain = matmul_plain(a, b, **kw)
    torch.cuda.synchronize()
    plan = launch_plan(m, k, n, bm, bk, bn, order, dtype=dt)
    want = "wgmma" if dt == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 else "simt"
    return {"mkn": [m, k, n], "block": [bm, bk, bn], "order": order, "in": str(dt),
            "out": str(odt), "trans_b": trans_b, "route": plan["route"], "want_route": want,
            "plan": plan,
            "plan_is_kernels": plan == kernel_plan(m, k, n, bm, bk, bn, order, dtype=dt),
            "rel_err": rel_err(out, plain), "limit": limit_for(odt, plan["route"])}


def phase_kernel(cases_f) -> None:
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows, worst, failures, routes = [], {}, [], {}
    for case in matmul_cases():
        row = matmul_case_check(case, g)
        cases_f.write(json.dumps(row) + "\n")
        rows.append(row)
        key = f"{row['in']}->{row['out']} {row['route']}".replace("torch.", "")
        worst[key] = max(worst.get(key, 0.0), row["rel_err"])
        routes[row["route"]] = routes.get(row["route"], 0) + 1
        if not (row["rel_err"] <= row["limit"] and row["route"] == row["want_route"]
                and row["plan_is_kernels"]):
            failures.append(row)
    tc_f32 = [r["rel_err"] for r in rows
              if r["route"] == "wgmma" and r["out"] == "torch.float32"]
    emit("kernel", t0, cases=len(rows), routes=routes, worst_rel_err=worst,
         limits={"float32_out_simt": 1e-5, "float32_out_wgmma": TC_F32_LIMIT,
                 "bfloat16_out": 1e-2},
         wgmma_f32_out_worst_at_k8192=max(
             r["rel_err"] for r in rows if r["route"] == "wgmma"
             and r["out"] == "torch.float32" and r["mkn"][1] == 8192),
         wgmma_f32_out_over_1e5=sum(e > 1e-5 for e in tc_f32),
         wgmma_f32_out_cases=len(tc_f32), failures=failures[:5])
    if failures:
        raise SystemExit(f"{len(failures)} kernel cases outside their limit, route or plan")


def phase_matmul_mutant(cases_f, mutant: Path, route: str, dropped: str) -> None:
    """The matmul with the last k step of ``route`` dropped (a 64-value chunk
    on "wgmma", a ring stage of the plan's k depth on "simt"), through the
    same wrapper: every case of that route with K over one step must fall
    outside its limit."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul import _declare, launch_plan

    def over_one_step(case) -> bool:
        plan = launch_plan(case[0], case[1], case[2], *case[3], case[4], dtype=case[5])
        return plan["route"] == route and case[1] > plan.get("k_depth", 64)

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    picked = [c for c in matmul_cases() if over_one_step(c)]
    with _build.substitute("matmul", mutant, _declare):
        mut = [matmul_case_check(case, g) for case in picked]
    for row in mut:
        cases_f.write(json.dumps({f"matmul_{route}_mutant": row}) + "\n")
    outside = sum(not r["rel_err"] <= r["limit"] for r in mut)
    emit("mutation", t0, kernel="tiled_matmul", route=route, dropped=dropped,
         cases_k_over_one_step=len(mut), outside_limit=outside,
         min_ratio_to_limit=min(r["rel_err"] / r["limit"] for r in mut))
    if outside != len(mut):
        raise SystemExit(f"matmul {route} mutant: only {outside} of {len(mut)} cases with K "
                         f"over one step outside their limit")


def attention_cases() -> list:
    """(B, S, T, H, HKV, D, causal, window, softcap, bq, bk, dtype, q_view);
    ``q_view``: q is a strided view into a fused (B, S, 3, H, D) buffer."""
    cases, blocks = [], [(16, 16), (64, 128), (128, 128), (128, 16)]
    i = 0
    for s in (2, 17, 64, 130):          # the JAX sweep: S 2-130, D 8/16/32,
        for d in (8, 16, 32):           # H 1-4, GQA groups 1-2, causal or not
            for hq in (1, 2, 4):
                for g in (1, 2):
                    hkv = max(1, hq // g)
                    for causal in (False, True):
                        bq, bk = blocks[i % len(blocks)]
                        i += 1
                        cases.append((2, s, s, hkv * g, hkv, d, causal, None, None,
                                      bq, bk, torch.float32, False))
    for dt in (torch.float32, torch.bfloat16):
        for window, softcap in ((None, None), (8, None), (None, 20.0), (16, 50.0)):
            cases.append((1, 48, 48, 4, 2, 16, True, window, softcap, 128, 128, dt, False))
        cases += [(2, 20, 45, 2, 2, 8, False, None, None, 128, 128, dt, False),
                  (1, 45, 20, 2, 1, 32, True, None, None, 128, 128, dt, False),
                  (1, 40, 24, 2, 2, 16, True, 8, None, 128, 16, dt, False),  # rows see no key
                  (1, 70, 70, 2, 2, 64, False, None, 20.0, 8, 64, dt, False)]
    for dt in (torch.float32, torch.bfloat16):  # jamba's head dim and GQA group
        cases += [(1, 70, 70, 8, 2, 128, True, None, None, 128, 128, dt, False),
                  (2, 45, 45, 4, 1, 128, True, None, None, 64, 32, dt, False),
                  (1, 33, 50, 4, 1, 128, False, None, None, 16, 16, dt, False)]
    cases += TC_CASES + ZOO_CASES
    cases += [case[:11] + (torch.float32,) + case[12:]
              for case in TC_CASES + ZOO_CASES]  # on route simt
    b, s, h, d = FA_SHAPE
    cases.append((b, s, s, h, h, d, True, None, None, 128, 128, torch.bfloat16, False))
    for b, s, h, hkv, d in (FA_JAMBA_SHAPE, FA_PHI3_SHAPE, FA_GEMMA3_SHAPE):
        cases.append((b, s, s, h, hkv, d, True, None, None, 128, 128, torch.bfloat16, False))
    for (b, s, h, hkv, d), window, softcap in FA_ZOO_PREFILL:
        cases.append((b, s, s, h, hkv, d, True, window, softcap, 128, 128, torch.bfloat16,
                      False))
    # llama-3.2-vision's cross-attention: 1024 queries over 1600 encoder
    # tokens, non-causal, T off any kv tile
    cases.append((4, 1024, 1600, 32, 8, 128, False, None, None, 128, 128, torch.bfloat16,
                  False))
    return cases


# bf16 at D = 64 and 128, the tensor-core route: S and T off multiples of 64
# and S != T, GQA 4, 5 and 8, a window with rows that see no key, softcaps, a block
# for each kv tile (bk 16, 32, 48 -> 64, 128 -> 128 at D = 128 and 64 at
# D = 64) and q tile (64, 128), and q as a strided view, as a fused
# projection would pass it
TC_CASES = [(b, s, t, h, hkv, d, causal, window, softcap, bq, bk, torch.bfloat16, q_view)
            for d in (64, 128)
            for (b, s, t, h, hkv, causal, window, softcap, bq, bk, q_view) in (
                (2, 100, 100, 4, 4, True, None, None, 128, 128, False),
                (1, 70, 150, 8, 2, False, None, None, 64, 64, False),
                (1, 150, 70, 8, 2, True, None, None, 128, 32, False),
                (1, 120, 90, 4, 1, True, 24, None, 128, 16, False),    # rows 113-119 see no key
                (2, 130, 130, 4, 2, True, None, 30.0, 64, 128, False),
                (1, 200, 200, 4, 4, False, 40, 20.0, 16, 16, False),
                (2, 96, 96, 8, 2, True, None, None, 128, 48, False),
                (2, 77, 77, 8, 2, True, None, None, 128, 128, True),
                (1, 150, 150, 10, 2, True, None, 50.0, 128, 64, False),  # GQA 5
                (2, 90, 130, 16, 2, False, None, None, 64, 128, False))]  # GQA 8


# bf16 at the zoo's head dims 96 (phi3-mini) and 256 (gemma3-12b), the
# tensor-core route: GQA groups 5 (llama4-scout) and 8 (command-r), ragged
# S != T, a window with rows that see no key, a softcap (gemma2's 50), a
# block for each kv tile, non-causal with T off any tile (the cross form),
# and a strided q view
ZOO_CASES = [(b, s, t, h, hkv, d, causal, window, softcap, bq, bk, torch.bfloat16, q_view)
             for d in (96, 256)
             for (b, s, t, h, hkv, causal, window, softcap, bq, bk, q_view) in (
                 (2, 100, 100, 5, 1, True, None, None, 128, 128, False),
                 (1, 70, 150, 8, 1, False, None, None, 64, 64, False),
                 (1, 150, 70, 10, 2, True, None, None, 128, 32, False),
                 (1, 120, 90, 4, 1, True, 24, None, 128, 16, False),    # rows 113-119 see no key
                 (2, 130, 130, 5, 1, True, None, 50.0, 64, 128, False),
                 (2, 64, 100, 8, 1, False, None, None, 128, 128, False),
                 (2, 77, 77, 8, 1, True, None, None, 128, 128, True))]


def attention_case_check(case, g) -> dict:
    """One case: the kernel against its plain version on the same inputs."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     kernel_plan, launch_plan)

    (b, s, t, h, hkv, d, causal, window, softcap, bq, bk, dt, q_view) = case
    if q_view:
        q = torch.randn(b, s, 3, h, d, generator=g, device="cuda").to(dt)[:, :, 0]
    else:
        q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
    k = torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt)
    v = torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap, bq=bq, bk=bk)
    out = flash_attention(q, k, v, **kw)
    plain = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    lim = ATTN_LIMIT[dt]
    diff = (out.float() - plain.float()).abs()
    plan = launch_plan(s, t, bq, bk, d=d, dtype=dt)
    if plan != kernel_plan(s, t, bq, bk, d=d, dtype=dt):
        raise SystemExit(f"attention {case}: launch_plan {plan} is not the kernel's "
                         f"{kernel_plan(s, t, bq, bk, d=d, dtype=dt)}")
    # allclose(rtol=lim, atol=lim), as the JAX kernel tests hold it
    return {"bsthd": [b, s, t, h, hkv, d], "causal": causal, "window": window,
            "softcap": softcap, "block": [bq, bk], "dtype": str(dt), "q_view": q_view,
            "plan": plan, "max_abs_err": diff.max().item(), "limit": lim,
            "ratio_to_limit": (diff / (lim + lim * plain.float().abs())).max().item()}


def phase_attention(cases_f) -> None:
    from repro_torch.kernels.flash_attention import TC_HEAD_DIMS

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst, failures, routes, by_d = {}, [], {}, {}  # by_d: worst ratio to the limit
    cases = attention_cases()
    for case in cases:
        c = attention_case_check(case, g)
        cases_f.write(json.dumps({"attention": c}) + "\n")
        key = c["dtype"].replace("torch.", "")
        worst[key] = max(worst.get(key, 0.0), c["max_abs_err"])
        route = c["plan"]["route"]
        dkey = f"{key} D={case[5]} {route}"
        by_d[dkey] = max(by_d.get(dkey, 0.0), c["ratio_to_limit"])
        routes[route] = routes.get(route, 0) + 1
        want = "wgmma" if case[11] == torch.bfloat16 and case[5] in TC_HEAD_DIMS else "simt"
        if not c["ratio_to_limit"] <= 1.0 or route != want:
            failures.append(c)
    emit("attention", t0, cases=len(cases), routes=routes, worst_max_abs_err=worst,
         worst_by_head_dim=by_d, limits={"float32": 3e-5, "bfloat16": 3e-2},
         failures=failures[:5])
    if failures:
        raise SystemExit(f"{len(failures)} attention cases outside their limit or route")


def phase_attention_mutant(cases_f, mutant: Path, route: str, dropped: str) -> None:
    """The flash kernel with the accumulator's alpha rescale of ``route``
    dropped, through the same wrapper, over every multi-tile case of that
    route: more than half must fall outside their limit."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import _declare, launch_plan

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    picked = []
    for case in attention_cases():
        (b, s, t, h, hkv, d, causal, window, softcap, bq, bk, dt, q_view) = case
        plan = launch_plan(s, t, bq, bk, d=d, dtype=dt)
        if plan["route"] == route and t > plan["kv_tile"]:
            picked.append(case)
    with _build.substitute("flash_attention", mutant, _declare):
        mut = [attention_case_check(case, g) for case in picked]
    for c in mut:
        cases_f.write(json.dumps({f"attention_{route}_mutant": c}) + "\n")
    outside = sum(not c["ratio_to_limit"] <= 1.0 for c in mut)
    emit("mutation", t0, kernel="flash_attention", route=route, dropped=dropped,
         multi_tile_cases=len(mut), outside_limit=outside,
         min_ratio_to_limit=min(c["ratio_to_limit"] for c in mut))
    if not outside > len(mut) / 2:
        raise SystemExit(f"flash {route} mutant: only {outside} of {len(mut)} multi-tile "
                         f"cases outside their limit")


def rwkv_cases() -> list:
    """(B, S, H, N, chunk, dtype, with s0)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases, bhs, i = [], [(1, 1), (2, 1), (1, 3), (2, 2)], 0
    for s in (1, 5, 17, 64, 70):         # the JAX sweep: S 1-70, N 4/8/16,
        for n in (4, 8, 16):             # chunks 4/16/64, BH 1-4
            for chunk in (4, 16, 64):
                b, h = bhs[i % len(bhs)]
                i += 1
                cases.append((b, s, h, n, chunk, f32, False))
    cases += [(2, s, 2, 64, chunk, f32, False)
              for s in (70, 128, 200, 300) for chunk in (64, 128)]
    for dt in (f32, bf16):
        cases += [(2, 200, 2, 64, 128, dt, True), (1, 37, 3, 16, 16, dt, True),
                  (2, 300, 2, 64, 64, dt, False)]
    b, s, h, n = RWKV_SHAPE
    cases += [(b, s, h, n, RWKV_CHUNK, bf16, False), (b, s, h, n, RWKV_CHUNK, bf16, True)]
    return cases


def rwkv_inputs(case, seed: int) -> tuple:
    """r, k, v, logw, u, s0 as the JAX kernel test draws them: r/k/v
    0.5 N(0, 1), logw = -exp(N(0, 1) - 2), u 0.3 N(0, 1); s0 0.1 N(0, 1)."""
    b, s, h, n, _, dt, with_s0 = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    r, k, v = ((0.5 * rand(b, s, h, n)).to(dt) for _ in range(3))
    logw = -torch.exp(rand(b, s, h, n) - 2.0)
    u = 0.3 * rand(h, n)
    return r, k, v, logw, u, (0.1 * rand(b, h, n, n) if with_s0 else None)


def rwkv_plain(r, k, v, logw, u, s0, chunk) -> tuple:
    """The plain version on the kernel's inputs, at the kernel's tile."""
    from repro_torch.kernels.rwkv6_scan import launch_plan, rwkv6_chunk_scan_plain_heads

    tile = launch_plan(r.shape[1], chunk)["chunk"]
    return rwkv6_chunk_scan_plain_heads(r, k, v, logw, u, chunk=tile, s0=s0)


def rwkv_case_check(i: int, case) -> dict:
    """Case ``i``: the kernel against its plain version on the same inputs,
    as allclose(rtol=RWKV_LIMIT, atol=RWKV_LIMIT) on y and the state."""
    from repro_torch.kernels.rwkv6_scan import launch_plan, rwkv6_chunk_scan

    b, s, h, n, chunk, dt, with_s0 = case
    r, k, v, logw, u, s0 = rwkv_inputs(case, SEED + i)
    y, st = rwkv6_chunk_scan(r, k, v, logw, u, chunk=chunk, s0=s0)
    yp, sp = rwkv_plain(r, k, v, logw, u, s0, chunk)
    torch.cuda.synchronize()
    ratio = max(((a - p).abs() / (RWKV_LIMIT + RWKV_LIMIT * p.abs())).max().item()
                for a, p in ((y, yp), (st, sp)))
    return {"bshn": [b, s, h, n], "chunk": chunk,
            "plan": launch_plan(s, chunk, b=b, h=h, n=n, dtype=dt),
            "dtype": str(dt), "s0": with_s0,
            "max_abs_err": max((y - yp).abs().max().item(), (st - sp).abs().max().item()),
            "limit": RWKV_LIMIT, "ratio_to_limit": ratio}


def phase_rwkv_scan(cases_f) -> None:
    t0 = time.perf_counter()
    worst, worst_ratio, failures = {}, 0.0, []
    cases = rwkv_cases()
    for i, case in enumerate(cases):
        row = rwkv_case_check(i, case)
        cases_f.write(json.dumps({"rwkv_scan": row}) + "\n")
        key = row["dtype"].replace("torch.", "")
        worst[key] = max(worst.get(key, 0.0), row["max_abs_err"])
        worst_ratio = max(worst_ratio, row["ratio_to_limit"])
        if not row["ratio_to_limit"] <= 1.0:
            failures.append(row)
    emit("rwkv_scan", t0, cases=len(cases), worst_max_abs_err=worst,
         worst_ratio_to_limit=worst_ratio, limit=RWKV_LIMIT, failures=failures[:5])
    if failures:
        raise SystemExit(f"{len(failures)} rwkv scan cases outside their limit")


def mamba_cases() -> list:
    """(B, S, C, N, chunk, bd, dtype, with h0)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases, blocks, i = [], [(4, 8), (8, 16), (32, 128)], 0
    for s in (1, 5, 17, 40):            # the JAX sweep: S 1-40, C 8/20/32,
        for c in (8, 20, 32):           # N 4/8, chunks 4/8/32, bd 8/16/128
            for n in (4, 8):
                chunk, bd = blocks[i % len(blocks)]
                i += 1
                cases.append((2, s, c, n, chunk, bd, f32, False))
    for dt in (f32, bf16):              # ragged S, C not a multiple of the CTA
        cases += [(2, 300, 1000, 16, 64, 256, dt, True), (3, 130, 520, 16, 32, 128, dt, False),
                  (1, 77, 100, 8, 16, 8, dt, True)]
    b, s, c, n = MAMBA_SHAPE            # jamba's prefill, and the 384-token check's
    cases += [(b, s, c, n, MAMBA_CHUNK, MAMBA_BD, bf16, True),
              (b, s, c, n, MAMBA_CHUNK, MAMBA_BD, bf16, False),
              (1, RECURRENCE_LEN, c, n, MAMBA_CHUNK, MAMBA_BD, f32, False),
              (1, RECURRENCE_LEN, c, n, MAMBA_CHUNK, MAMBA_BD, bf16, True)]
    return cases


def mamba_inputs(case, seed: int) -> tuple:
    """x, dt, a, b, c, h0 in the model's layout: x N(0, 1); dt a small
    positive step, exp(0.5 N(0, 1) - 3.5) (softplus near the init's 0.01);
    a = -(1..N) e^{0.1 N(0, 1)} per channel; b and c strided views of one
    (B, S, 4 + 2N) projection of 0.5 N(0, 1), as ``_ssm_inputs`` makes
    them; h0 0.1 N(0, 1)."""
    b, s, c, n, _, _, dt_, with_h0 = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    x = rand(b, s, c).to(dt_)
    dt = torch.exp(0.5 * rand(b, s, c) - 3.5).to(dt_)
    a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda") * torch.exp(0.1 * rand(c, n))
    proj = (0.5 * rand(b, s, 4 + 2 * n)).to(dt_)
    h0 = 0.1 * rand(b, c, n) if with_h0 else None
    return x, dt, a, proj[..., 4:4 + n], proj[..., 4 + n:], h0


def mamba_case_check(i: int, case) -> dict:
    """Case ``i``: the kernel against its plain version on the same inputs
    at the kernel's token tile, as allclose(rtol=MAMBA_LIMIT,
    atol=MAMBA_LIMIT) on y and the state."""
    from repro_torch.kernels.mamba_scan import (kernel_plan, launch_plan, mamba_scan,
                                                mamba_scan_plain_model)

    b, s, c, n, chunk, bd, dt_, with_h0 = case
    x, dt, a, bm, cm, h0 = mamba_inputs(case, SEED + i)
    plan = launch_plan(s, c, chunk, bd)
    if plan != kernel_plan(s, c, chunk, bd):
        raise SystemExit(f"mamba {case}: launch_plan {plan} is not the kernel's "
                         f"{kernel_plan(s, c, chunk, bd)}")
    y, h = mamba_scan(x, dt, a, bm, cm, chunk=chunk, bd=bd, h0=h0)
    yp, hp = mamba_scan_plain_model(x, dt, a, bm, cm, chunk=plan["l"], h0=h0)
    torch.cuda.synchronize()
    ratio = max(((o - p).abs() / (MAMBA_LIMIT + MAMBA_LIMIT * p.abs())).max().item()
                for o, p in ((y, yp), (h, hp)))
    return {"bscn": [b, s, c, n], "block": [chunk, bd], "plan": plan, "dtype": str(dt_),
            "h0": with_h0,
            "max_abs_err": max((y - yp).abs().max().item(), (h - hp).abs().max().item()),
            "limit": MAMBA_LIMIT, "ratio_to_limit": ratio}


def phase_mamba_scan(cases_f) -> None:
    t0 = time.perf_counter()
    worst, worst_ratio, failures = {}, 0.0, []
    cases = mamba_cases()
    for i, case in enumerate(cases):
        row = mamba_case_check(i, case)
        cases_f.write(json.dumps({"mamba_scan": row}) + "\n")
        key = row["dtype"].replace("torch.", "")
        worst[key] = max(worst.get(key, 0.0), row["max_abs_err"])
        worst_ratio = max(worst_ratio, row["ratio_to_limit"])
        if not row["ratio_to_limit"] <= 1.0:
            failures.append(row)
    emit("mamba_scan", t0, cases=len(cases), worst_max_abs_err=worst,
         worst_ratio_to_limit=worst_ratio, limit=MAMBA_LIMIT, failures=failures[:5])
    if failures:
        raise SystemExit(f"{len(failures)} mamba scan cases outside their limit")


# ---------------------------------------------------------------------------
# phases 4-5: tune, then serve
# ---------------------------------------------------------------------------

CONTRACTIONS = [(m, k, n) for m in (DECODE_M, PREFILL_M)
                for (k, n) in ((D_MODEL, D_MODEL), (D_MODEL, D_FF), (D_FF, D_MODEL))]


def phase_tune(launches) -> tuple:
    from repro_torch.core import LoopTuner, matmul_benchmark

    t0 = time.perf_counter()
    tuner = LoopTuner(policy="search", backend="torch", surrogate="off")
    benches = [matmul_benchmark(*mkn) for mkn in CONTRACTIONS]
    rows = []
    mark = [launches(), time.perf_counter(), tuner.cache.misses]

    def on_entry(i: int, entry: dict) -> None:
        now = [launches(), time.perf_counter(), tuner.cache.misses]
        m, k, n = CONTRACTIONS[i]
        row = {"mkn": [m, k, n], "base_gflops": entry["base_gflops"],
               "tuned_gflops": entry["gflops"], "actions": entry["actions"],
               "block": entry.get("block"), "grid_order": entry.get("grid_order"),
               "evals": now[2] - mark[2], "tune_s": round(now[1] - mark[1], 3),
               "kernel_launches": now[0] - mark[0]}
        mark[:] = now
        rows.append(row)
        print(json.dumps({"phase": "tune_entry", **row}), flush=True)

    n = len(benches)
    tuner.tune_many(benches, weights=[1.0] * n, budget_s=TUNE_BUDGET_S * n,
                    eval_budget=TUNE_MAX_EVALS * n, on_entry=on_entry)
    stats = tuner.stats()
    emit("tune", t0, contractions=n, evals_cached=stats["cache"]["misses"],
         measurements=stats["measurement"]["measurements"],
         noisy=stats["measurement"]["noisy"], peak_gflops=tuner.backend.peak(),
         registry_size=len(tuner.registry))
    for row in rows:
        if not (row["kernel_launches"] > 0 and row["tuned_gflops"] > 0
                and row["tuned_gflops"] >= row["base_gflops"] and row["block"]):
            raise SystemExit(f"tuning did not run through the kernel: {row}")
    return tuner.registry, rows


def layer_weights(g) -> dict:
    def w(*shape):
        return torch.randn(*shape, generator=g, device="cuda") / shape[0] ** 0.5

    return {"wq": w(D_MODEL, D_MODEL), "wk": w(D_MODEL, D_MODEL),
            "wv": w(D_MODEL, D_MODEL), "w_gate": w(D_MODEL, D_FF),
            "w_up": w(D_MODEL, D_FF), "w_down": w(D_FF, D_MODEL),
            "table": w(VOCAB, D_MODEL)}


def layer_calls(x, wts, tuned_einsum):
    """One layer's dense contractions, as models/layers.py sends them."""
    out = {}
    for name in ("wq", "wk", "wv"):
        out[name] = tuned_einsum("bsk,kn->bsn", x, wts[name])
    gate = tuned_einsum("bsk,kn->bsn", x, wts["w_gate"])
    up = tuned_einsum("bsk,kn->bsn", x, wts["w_up"])
    out["w_gate"], out["w_up"] = gate, up
    h = torch.nn.functional.gelu(gate) * up
    out["w_down"] = tuned_einsum("bsk,kn->bsn", h, wts["w_down"])
    out["logits"] = tuned_einsum("bsd,vd->bsv", x, wts["table"])
    return out, h


def phase_serve(registry, wts, g) -> int:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref

    t0 = time.perf_counter()
    ops.reset_serving_stats()
    n_calls, worst = 0, 0.0
    for batch, seq in ((4, 1), (4, 256)):
        x = torch.randn(batch, seq, D_MODEL, generator=g, device="cuda")
        with ops.serving(registry):
            outs, h = layer_calls(x, wts, ops.tuned_einsum)
        n_calls += len(outs)
        x2 = x.reshape(-1, D_MODEL)
        refs = {name: matmul_ref(x2, wts[name]) for name in
                ("wq", "wk", "wv", "w_gate", "w_up")}
        refs["w_down"] = matmul_ref(h.reshape(-1, D_FF), wts["w_down"])
        refs["logits"] = matmul_ref(x2, wts["table"].t())
        torch.cuda.synchronize()
        for name, out in outs.items():
            ref = refs[name]
            if out.shape[:-1] != x.shape[:-1] or not torch.isfinite(out).all():
                raise SystemExit(f"serve {name}: bad output {tuple(out.shape)}")
            err = rel_err(out.reshape(ref.shape), ref)
            worst = max(worst, err)
            if not err <= 1e-5:
                raise SystemExit(f"serve {name} (batch {batch}, seq {seq}): "
                                 f"rel err {err} > 1e-5")
    stats = ops.serving_stats()
    emit("serve", t0, calls=n_calls, hits=stats["hits"], misses=stats["misses"],
         routed=stats["routed"], worst_rel_err=worst, limit=1e-5)
    if stats["routed"] != n_calls:
        raise SystemExit(f"routed {stats['routed']} of {n_calls} tuned_einsum calls")
    return n_calls


# ---------------------------------------------------------------------------
# the policy path: train on card-timed rewards, tune and serve from the
# checkpoint, and the surrogate-guided search
# ---------------------------------------------------------------------------


def kernel_spy(backend) -> dict:
    """Count the tiled-matmul launches of each contraction's rewards on
    ``backend``: its ``run_once`` is wrapped to read the wrapper's count
    around each timed call."""
    from repro_torch.kernels.matmul import matmul

    per: dict = {}
    run_once = backend.run_once

    def counted(nest):
        before = matmul.launches
        run_once(nest)
        name = nest.contraction.name
        per[name] = per.get(name, 0) + matmul.launches - before

    backend.run_once = counted
    return per


def probe_states(benches, actions, n: int) -> tuple:
    """Observations and legal masks of ``n`` states reached by seeded random
    walks (features depend on the nest only, so the analytical backend
    walks them)."""
    from repro_torch.core import VecLoopTuneEnv

    venv = VecLoopTuneEnv(benches, "tpu", 8, actions=actions, seed=SEED)
    rng = np.random.default_rng(SEED)
    obs, masks = [venv.reset()], [venv.action_mask()]
    while sum(len(o) for o in obs) < n:
        a = [int(rng.choice(np.flatnonzero(m))) for m in masks[-1]]
        o, _, d, _ = venv.step(a)
        obs.append(venv.reset() if d.all() else o)
        masks.append(venv.action_mask())
    return np.concatenate(obs)[:n], np.concatenate(masks)[:n]


def policy_data() -> tuple:
    """The policy phases' contractions and actions: ``POLICY_TRAIN`` drawn
    (seed ``SEED``) from the paper's matmul train split, ``POLICY_EVAL``
    held out from its test split, the card executor's action space."""
    from repro_torch.core import CPU_SPLITS, build_action_space
    from repro_torch.core.dataset import matmul_dataset, train_test_split

    train, test = train_test_split(matmul_dataset(), seed=SEED)
    rng = np.random.default_rng(SEED)
    train = [train[i] for i in rng.choice(len(train), POLICY_TRAIN, replace=False)]
    held = [test[i] for i in rng.choice(len(test), POLICY_EVAL, replace=False)]
    return train, held, build_action_space(CPU_SPLITS)


def phase_policy(out_dir: Path, tune_rows: list, g) -> dict:
    from repro_torch.core import (ApexConfig, DQNConfig, EncoderConfig, LoopTuneEnv,
                                  LoopTuner, evaluate_policy, make_act_from_checkpoint,
                                  make_backend, matmul_benchmark, train_apex, train_dqn)
    from repro_torch.kernels.matmul import matmul

    t0 = time.perf_counter()
    train, held, actions = policy_data()
    backend = make_backend("torch")
    per = kernel_spy(backend)
    env = LoopTuneEnv(train, backend, actions=actions, seed=SEED)

    # 1. APEX-DQN on rewards timed on the card (f32, the SIMT route)
    t1, l1 = time.perf_counter(), matmul.launches
    res = train_apex(lambda i: env, APEX_ITERATIONS, ApexConfig(n_actors=8, seed=SEED))
    ms = backend.measure_stats()
    train_row = {
        "iterations": APEX_ITERATIONS, "updates": res.extra["updates"],
        "episode_reward_mean_first": res.rewards[0], "episode_reward_mean_last": res.rewards[-1],
        "episode_reward_mean_first30": float(np.mean(res.rewards[:30])),
        "episode_reward_mean_last30": float(np.mean(res.rewards[-30:])),
        "rewards": res.rewards[::10], "seconds": time.perf_counter() - t1,
        "reward_launches": matmul.launches - l1, "measurements": ms["measurements"],
        "noisy": ms["noisy"], "contractions_measured": len(per),
        "peak_gflops": env.peak, "state_dim": res.meta["state_dim"],
        "n_actions": res.meta["n_actions"]}
    print(json.dumps({"phase": "policy_train", **train_row}), flush=True)
    unlaunched = sorted(k for k, v in per.items() if v == 0)

    # 2. the greedy policy on held-out matmuls
    t1 = time.perf_counter()
    ev = evaluate_policy(LoopTuneEnv(held, backend, actions=actions), res.act,
                         list(range(len(held))))
    eval_row = {"contractions": [list(c.iter_sizes.values()) for c in held],
                "speedup_geomean": ev["speedup_geomean"], "speedups": ev["speedups"],
                "time_mean_s": ev["time_mean_s"], "seconds": time.perf_counter() - t1}
    print(json.dumps({"phase": "policy_eval", **eval_row}), flush=True)

    # 3. a second encoder: the graph trunk's message passing on the card
    t1 = time.perf_counter()
    dqn = train_dqn(LoopTuneEnv(train, backend, actions=actions, seed=SEED), DQN_ITERATIONS,
                    DQNConfig(encoder=EncoderConfig(kind="graph"), seed=SEED))
    dqn_row = {"iterations": DQN_ITERATIONS, "updates": dqn.extra["updates"],
               "rewards": dqn.rewards, "state_dim": dqn.meta["state_dim"],
               "seconds": time.perf_counter() - t1}
    print(json.dumps({"phase": "policy_dqn_graph", **dqn_row}), flush=True)

    # 4. the checkpoint: reload it, act alike, tune and serve from it
    path = out_dir / "policy_apex.pkl"
    res.save(str(path))
    tuner = LoopTuner.from_checkpoint(str(path), backend="torch")
    tune_per = kernel_spy(tuner.backend)
    obs, mask = probe_states(train[:8], actions, POLICY_PROBE)
    trained = np.asarray(res.act(obs, mask))
    reloaded = np.asarray(tuner.act(obs, mask))
    with torch.no_grad():
        dev = next(res.params.parameters()).device
        scores = res.params(torch.as_tensor(obs, device=dev)).cpu().numpy()
    top2 = np.sort(np.where(mask, scores, -np.inf), axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TIE_GAP * np.abs(scores).max(axis=1)
    on_cpu = np.asarray(make_act_from_checkpoint(str(path), device="cpu")(obs, mask))
    benches = [matmul_benchmark(*mkn) for mkn in CONTRACTIONS]
    search = {tuple(r["mkn"]): r for r in tune_rows}
    rows = []
    t1, l1 = time.perf_counter(), matmul.launches
    for i, e in enumerate(tuner.tune_many(benches)):
        mkn = CONTRACTIONS[i]
        rows.append({"mkn": list(mkn), "block": e.get("block"), "grid_order": e.get("grid_order"),
                     "actions": e["actions"], "base_gflops": e["base_gflops"],
                     "tuned_gflops": e["gflops"], "tune_s": e["tune_time_s"],
                     "kernel_launches": tune_per.get(benches[i].name, 0),
                     "search_block": search[mkn]["block"], "search_gflops": search[mkn]["tuned_gflops"],
                     "search_tune_s": search[mkn]["tune_s"]})
        print(json.dumps({"phase": "policy_tune_entry", **rows[-1]}), flush=True)
    tune_s, tune_launches = time.perf_counter() - t1, matmul.launches - l1
    records = record_checks(tuner.registry, g, torch.float32)

    # 5. surrogate-guided search at phase tune's budget, beside measured-only
    t1 = time.perf_counter()
    guided = LoopTuner(policy="search", surrogate="auto", backend="torch")
    guided_per = kernel_spy(guided.backend)
    n = len(benches)
    guided_rows, mark = [], [guided.cache.misses, 0]

    def on_entry(i: int, entry: dict) -> None:
        sc = guided.stats()["surrogate"]
        mkn = CONTRACTIONS[i]
        guided_rows.append({"mkn": list(mkn), "best_gflops": entry["gflops"],
                            "evals": guided.cache.misses - mark[0],
                            "skipped": sc.get("skipped", 0) - mark[1],
                            "block": entry.get("block"),
                            "kernel_launches": guided_per.get(benches[i].name, 0),
                            "search_gflops": search[mkn]["tuned_gflops"],
                            "search_evals": search[mkn]["evals"]})
        mark[:] = [guided.cache.misses, sc.get("skipped", 0)]

    guided.tune_many(benches, weights=[1.0] * n, budget_s=TUNE_BUDGET_S * n,
                     eval_budget=TUNE_MAX_EVALS * n, on_entry=on_entry)
    sur = guided.stats()["surrogate"]
    row = {"train": train_row, "eval": eval_row, "dqn_graph": dqn_row,
           "calibration": tuner.calibration, "probe_states": len(obs),
           "probe_clear_of_ties": int(clear.sum()),
           "reload_differs": int((trained != reloaded).sum()),
           "cpu_differs_clear": int((on_cpu != trained)[clear].sum()),
           "tune": rows, "tune_s": tune_s, "tune_launches": tune_launches,
           "tune_s_per_contraction": tune_s / n,
           "search_tune_s_per_contraction": sum(r["tune_s"] for r in tune_rows) / n,
           "records": records, "surrogate_search": guided_rows,
           "surrogate": sur, "surrogate_search_s": time.perf_counter() - t1}
    emit("policy", t0, **{k: v for k, v in row.items() if k not in ("train", "eval",
                                                                      "dqn_graph", "tune")})
    checks = {
        "every measured training contraction launched the kernel":
            not unlaunched and train_row["reward_launches"] > 0,
        "rewards finite": bool(np.isfinite(res.rewards).all()),
        "the graph DQN trained": dqn_row["updates"] > 0,
        "calibration recorded": tuner.calibration["mode"] == "recorded",
        "reloaded policy acts as trained": row["reload_differs"] == 0,
        "cpu load acts alike clear of ties": row["cpu_differs_clear"] == 0,
        "every contraction's tune launched the kernel":
            all(r["kernel_launches"] > 0 for r in rows + guided_rows),
        "tuned >= base": all(r["tuned_gflops"] >= r["base_gflops"] > 0 and r["block"]
                             for r in rows),
        "every record served, routed, within its limit": all(
            r["rel_err"] <= r["limit"] and r["routed"] == 1 and r["misses"] == 0
            for r in records),
        "the surrogate fitted and skipped candidates":
            sur.get("n_fits", 0) > 0 and sur.get("skipped", 0) > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"policy phase failed: {bad} (unlaunched: {unlaunched[:8]})")
    return row


# ---------------------------------------------------------------------------
# the actor-critic path: PPO, A2C and IMPALA on card-timed rewards, then
# the PPO checkpoint tunes through launch/tune's journaled tune_records
# ---------------------------------------------------------------------------

AC_TRAINERS = (("ppo", 20), ("a2c", 80), ("impala", 40))  # iterations: 6,400 env steps each


def phase_actor_critic(out_dir: Path, apex: dict, g) -> dict:
    from repro_torch.core import (A2CConfig, ImpalaConfig, LoopTuneEnv, LoopTuner, PPOConfig,
                                  evaluate_policy, make_backend, matmul_benchmark, train_a2c,
                                  train_impala, train_ppo)
    from repro_torch.core.registry import ScheduleRegistry
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.tune import TuneJournal, tune_records

    t0 = time.perf_counter()
    train, held, actions = policy_data()
    backend = make_backend("torch")
    per = kernel_spy(backend)
    trainers = {"ppo": (train_ppo, PPOConfig), "a2c": (train_a2c, A2CConfig),
                "impala": (train_impala, ImpalaConfig)}
    rows, results = {}, {}
    for algo, iterations in AC_TRAINERS:
        fn, cfg_cls = trainers[algo]
        cfg = cfg_cls(seed=SEED)
        env = LoopTuneEnv(train, backend, actions=actions, seed=SEED)  # its own cache
        ms0 = backend.measure_stats()
        t1, l1 = time.perf_counter(), matmul.launches
        res = results[algo] = fn(lambda i: env, iterations, cfg)
        seconds, ms = time.perf_counter() - t1, backend.measure_stats()
        t1 = time.perf_counter()
        ev = evaluate_policy(LoopTuneEnv(held, backend, actions=actions), res.act,
                             list(range(len(held))))
        tenth = max(1, iterations // 10)
        rows[algo] = {
            "algo": algo, "iterations": iterations,
            "env_steps": iterations * cfg.n_envs * cfg.rollout_len,
            "updates": res.extra["updates"], "seconds": seconds,
            "s_per_iteration": seconds / iterations,
            "episode_reward_mean_first": res.rewards[0],
            "episode_reward_mean_last": res.rewards[-1],
            "episode_reward_mean_first_tenth": float(np.mean(res.rewards[:tenth])),
            "episode_reward_mean_last_tenth": float(np.mean(res.rewards[-tenth:])),
            "rewards": res.rewards[::tenth], "reward_launches": matmul.launches - l1,
            "measurements": ms["measurements"] - ms0["measurements"],
            "noisy": ms["noisy"] - ms0["noisy"], "noisy_frac": res.extra["noisy_frac"],
            "held_speedup_geomean": ev["speedup_geomean"], "held_speedups": ev["speedups"],
            "eval_s": time.perf_counter() - t1}
        print(json.dumps({"phase": "actor_critic_train", **rows[algo]}), flush=True)
    unlaunched = sorted(k for k, v in per.items() if v == 0)
    impala = results["impala"]
    actor_differs = any(not torch.equal(a, p) for a, p in
                        zip(impala.extra["actor"].parameters(), impala.params.parameters()))

    # the PPO checkpoint tunes musicgen-large's six f32 contractions through
    # launch/tune's journaled tune_records, into a registry file
    ppo = results["ppo"]
    path = out_dir / "actor_critic_ppo.pkl"
    ppo.save(str(path))
    reg_path = out_dir / "actor_critic_registry.json"
    jpath = Path(f"{reg_path}.journal.jsonl")
    for f in (reg_path, jpath):
        f.unlink(missing_ok=True)
    tuner = LoopTuner.from_checkpoint(str(path), backend="torch",
                                      registry=ScheduleRegistry(str(reg_path)))
    tune_per = kernel_spy(tuner.backend)
    obs, mask = probe_states(train[:8], actions, POLICY_PROBE)
    reload_differs = int((np.asarray(ppo.act(obs, mask)) != np.asarray(tuner.act(obs, mask))).sum())
    flops = [2.0 * m * k * n for m, k, n in CONTRACTIONS]
    records = [{"m": m, "k": k, "n": n, "dtype": "float32", "flop_share": f / sum(flops)}
               for (m, k, n), f in zip(CONTRACTIONS, flops)]
    journal = TuneJournal(str(jpath))
    t1, l1 = time.perf_counter(), matmul.launches
    entries, n_skipped = tune_records(records, tuner=tuner, registry=tuner.registry,
                                      registry_path=str(reg_path),
                                      budget_s=TUNE_BUDGET_S * len(records), journal=journal)
    tune_s, tune_launches = time.perf_counter() - t1, matmul.launches - l1
    tune_rows = [{"mkn": [r["m"], r["k"], r["n"]], "block": e.get("block"),
                  "grid_order": e.get("grid_order"), "actions": e["actions"],
                  "base_gflops": e["base_gflops"], "tuned_gflops": e["gflops"],
                  "kernel_launches": tune_per.get(matmul_benchmark(r["m"], r["k"], r["n"]).name, 0)}
                 for r, e in zip(records, entries)]
    journal_lines = len(jpath.read_text().splitlines())
    served = record_checks(ScheduleRegistry(str(reg_path)), g, torch.float32)  # read back
    l1 = matmul.launches
    resumed, n_resumed = tune_records(records, tuner=tuner, registry=tuner.registry,
                                      registry_path=str(reg_path),
                                      budget_s=TUNE_BUDGET_S * len(records), journal=journal,
                                      resume=True)
    resume_launches = matmul.launches - l1
    apex_row = {"seconds": apex["train"]["seconds"],
                "episode_reward_mean_first": apex["train"]["episode_reward_mean_first"],
                "episode_reward_mean_last": apex["train"]["episode_reward_mean_last"],
                "held_speedup_geomean": apex["eval"]["speedup_geomean"],
                "noisy_frac": apex["train"]["noisy"] / max(apex["train"]["measurements"], 1)}
    row = {"trainers": {a: {k: rows[a][k] for k in (
               "seconds", "episode_reward_mean_first", "episode_reward_mean_last",
               "held_speedup_geomean", "noisy_frac", "updates", "reward_launches")}
               for a in rows}, "apex_dqn": apex_row,
           "impala_actor_differs": actor_differs, "calibration": tuner.calibration,
           "probe_states": len(obs), "reload_differs": reload_differs,
           "tune": tune_rows, "tune_s": tune_s, "tune_launches": tune_launches,
           "n_skipped": n_skipped, "journal_lines": journal_lines, "records": served,
           "resume_skipped": n_resumed, "resume_launches": resume_launches,
           "contractions_measured": len(per)}
    emit("actor_critic", t0, **row)
    checks = {
        "every measured training contraction launched the kernel":
            not unlaunched and all(r["reward_launches"] > 0 for r in rows.values()),
        "rewards finite": all(np.isfinite(res.rewards).all() for res in results.values()),
        "every trainer updated": all(r["updates"] > 0 for r in rows.values()),
        "impala's actor differs from its learner after updates between syncs": actor_differs,
        "calibration recorded": tuner.calibration["mode"] == "recorded",
        "reloaded policy acts as trained": reload_differs == 0,
        "every contraction's tune launched the kernel, tuned >= base":
            all(r["kernel_launches"] > 0 and r["tuned_gflops"] >= r["base_gflops"] > 0
                and r["block"] for r in tune_rows),
        "one journal line a contraction": journal_lines == len(records) and n_skipped == 0,
        "every record read back served, routed, on simt, within its limit": all(
            r["rel_err"] <= r["limit"] and r["routed"] == 1 and r["misses"] == 0
            and r["route"] == "simt" for r in served),
        "resume skips all, launching nothing":
            n_resumed == len(records) and resume_launches == 0
            and all(e.get("resumed") for e in resumed),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"actor_critic phase failed: {bad} (unlaunched: {unlaunched[:8]})")
    return row


# ---------------------------------------------------------------------------
# the fleet path: the tuner measuring out of process, through the worker
# pool (one spawned worker a card), then through a farm with two clients
# ---------------------------------------------------------------------------

FAULT_TASK_TIMEOUT_S = 5.0  # pool_faults' hung-kill budget (start-up excluded)
FARM_START_S = 300.0        # the farm's first line: torch, the card, its port


def _spy_backend(spy_dir: str, **kw):
    """The card executor, counting the tiled-matmul launches of each
    contraction's measurements in this (worker) process, and the seconds
    spent measuring.  The counts go to ``spy_dir/worker-<pid>.json`` at
    most once a second and when the worker exits, outside the timed runs."""
    from multiprocessing import util

    from repro_torch.core.torch_backend import TorchBackend
    from repro_torch.kernels.matmul import matmul

    backend = TorchBackend(**kw)
    per: dict = {}
    state = {"measure_s": 0.0, "write_s": 0.0, "written": 0.0}
    measure = backend.measure
    out = Path(spy_dir) / f"worker-{os.getpid()}.json"

    def dump() -> None:
        t0 = time.perf_counter()
        tmp = out.with_suffix(".tmp")
        tmp.write_text(json.dumps({"pid": os.getpid(), "device": str(backend.device),
                                   "launches": per, "measure_s": state["measure_s"],
                                   "write_s": state["write_s"]}))
        os.replace(tmp, out)
        state["written"] = time.perf_counter()
        state["write_s"] += state["written"] - t0

    def counted(nest, worker=-1):
        before, t0 = matmul.launches, time.perf_counter()
        m = measure(nest, worker)
        state["measure_s"] += time.perf_counter() - t0
        name = nest.contraction.name
        per[name] = per.get(name, 0) + matmul.launches - before
        if time.perf_counter() - state["written"] > 1.0:
            dump()
        return m

    backend.measure = counted
    util.Finalize(backend, dump, exitpriority=10)  # the last counts, at a clean exit
    return backend


def _faulty_backend(spy_dir: str, poison: str, hang: str, token: str, **kw):
    """The spy, with two faults: the schedule whose structure key reads
    ``poison`` ends its worker (``os._exit``) on every attempt, the one
    reading ``hang`` sleeps past the hung budget once (while ``token``
    exists)."""
    backend = _spy_backend(spy_dir, **kw)
    measure = backend.measure

    def faulty(nest, worker=-1):
        key = repr(nest.structure_key())
        if key == poison:
            os._exit(3)
        if key == hang and os.path.exists(token):
            os.unlink(token)
            time.sleep(3600)
        return measure(nest, worker)

    backend.measure = faulty
    return backend


# registered at the top level: a spawned pool worker re-imports this file
# (as __mp_main__) and so finds them in its own registry
register_backend("smoke_spy", _spy_backend)
register_backend("smoke_faulty", _faulty_backend)


def spy_launches(spy_dir: Path) -> dict:
    """The spies' counts: per worker process, and summed per contraction."""
    workers = [json.loads(p.read_text()) for p in sorted(spy_dir.glob("worker-*.json"))]
    per: dict = {}
    for w in workers:
        for name, n in w["launches"].items():
            per[name] = per.get(name, 0) + n
    return {"workers": workers, "per_contraction": per, "total": sum(per.values()),
            "measure_s": sum(w["measure_s"] for w in workers),
            "write_s": sum(w["write_s"] for w in workers)}


def fresh_dir(path: Path) -> Path:
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def compute_pids() -> list:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return sorted(int(x) for x in out.split())


def replay(bench, names: list, actions: list):
    """The schedule a record's action names build from the untuned nest."""
    from repro_torch.core import LoopNest, apply_action

    by_name = {a.name: a for a in actions}
    nest = LoopNest(bench)
    for name in names:
        apply_action(nest, by_name[name])
    return nest


def phase_pool(out_dir: Path, g) -> dict:
    """The tune -> serve path with every reward measured in one spawned
    worker on the card: ``LoopTuner(backend=make_backend("torch",
    measure="pool"))``, the worker built as the spy (its launches counted in
    the worker), the parent launching nothing while it tunes."""
    from repro_torch.core import LoopNest, LoopTuner, make_backend, matmul_benchmark
    from repro_torch.kernels.matmul import matmul

    t0 = time.perf_counter()
    spy_dir = fresh_dir(out_dir / "fleet_spy" / "pool")
    backend = make_backend("torch", measure="pool")
    spec, kw, method = backend.pool_spec()
    backend.pool_spec = lambda: ("smoke_spy", {**kw, "spy_dir": str(spy_dir)}, method)
    workers: list = []
    record = backend._record

    def noted(nest, m):
        workers.append(m.worker)
        return record(nest, m)

    backend._record = noted
    pool_s = [0.0]
    measure_batch = backend.measure_batch

    def timed(nests):
        t = time.perf_counter()
        try:
            return measure_batch(nests)
        finally:
            pool_s[0] += time.perf_counter() - t

    backend.measure_batch = timed
    tuner = LoopTuner(backend=backend, policy="search", surrogate="off")
    benches = [matmul_benchmark(*mkn) for mkn in CONTRACTIONS]
    n = len(benches)
    entries: list = []
    apps_before = compute_pids()
    # the pool starts at its first measurement: start it here, so the tune
    # below is timed with a ready worker (its start-up is reported apart)
    t1 = time.perf_counter()
    backend.measure(LoopNest(benches[0]))
    first_measure_s = time.perf_counter() - t1
    l0, t1 = matmul.launches, time.perf_counter()
    tuner.tune_many(benches, weights=[1.0] * n, budget_s=TUNE_BUDGET_S * n,
                    eval_budget=TUNE_MAX_EVALS * n,
                    on_entry=lambda i, e: entries.append((i, e)))
    tune_s, parent_launches = time.perf_counter() - t1, matmul.launches - l0
    pool = backend.measure_stats()["pool"]
    apps = compute_pids()
    rows = [{"mkn": list(CONTRACTIONS[i]), "block": e.get("block"),
             "grid_order": e.get("grid_order"), "base_gflops": e["base_gflops"],
             "tuned_gflops": e["gflops"], "actions": e["actions"]}
            for i, e in sorted(entries, key=lambda t: t[0])]
    served = record_checks(tuner.registry, g, torch.float32)
    # the pool's recorded rewards beside in-process timings of the same
    # schedules (the untuned and the tuned nest of each contraction)
    nests = [nest for i, b in enumerate(benches)
             for nest in (replay(b, [], tuner.actions), replay(b, rows[i]["actions"], tuner.actions))]
    pooled = [backend.measurement_for(nest) for nest in nests]
    backend.close()  # the worker exits cleanly: its spy writes its last counts
    spy = spy_launches(spy_dir)
    for r, b in zip(rows, benches):
        r["worker_launches"] = spy["per_contraction"].get(b.name, 0)
    info = pool["worker_info"][0]
    row = {"first_measure_s": first_measure_s, "tune_s": tune_s, "pool_s": pool_s[0],
           "worker_measure_s": spy["measure_s"],
           "spy_write_s": spy["write_s"], "parent_launches": parent_launches,
           "worker": {k: info.get(k) for k in ("pid", "device", "startup_s", "executor_s",
                                               "builds")},
           "compute_pids_before": apps_before, "compute_pids": apps,
           "pool": {k: v for k, v in pool.items() if k != "worker_info"},
           "measurements": len(workers), "measurement_workers": sorted(set(workers)),
           "worker_launches": spy["total"], "spy": spy["workers"], "tune": rows,
           "records": served}
    emit("pool", t0, **row)
    checks = {
        "one worker, on cuda:0": pool["workers"] == 1 and info.get("device") == "cuda:0",
        # nvidia-smi reads pids in the host's namespace, which a container's
        # need not match (they can all read 1): the worker is the one
        # compute process the pool added to the card
        "the worker is one more compute process on the card":
            len(apps) == len(apps_before) + 1,
        "every contraction's rewards launched the kernel in the worker":
            all(r["worker_launches"] > 0 for r in rows),
        "the parent launched nothing while tuning": parent_launches == 0,
        "every measurement came from worker 0": bool(workers) and set(workers) == {0},
        "tuned >= base": all(r["tuned_gflops"] >= r["base_gflops"] > 0 and r["block"]
                             for r in rows),
        "every record served, routed, on simt, within its limit": all(
            r["rel_err"] <= r["limit"] and r["routed"] == 1 and r["misses"] == 0
            and r["route"] == "simt" for r in served),
        "no worker died or hung": pool["respawns"] == 0 and pool["hung_killed"] == 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"pool phase failed: {bad}")
    row["compare"] = (benches, nests, pooled)
    return row


def pool_against_inproc(benches, nests, pooled) -> list:
    """In-process timings of the schedules the pool measured (after the
    fleet path's counts are read: these launches compare, they do not
    count)."""
    from repro_torch.core import make_backend

    inproc = make_backend("torch")
    out = []
    for i, b in enumerate(benches):
        for kind, nest, m in (("base", nests[2 * i], pooled[2 * i]),
                              ("tuned", nests[2 * i + 1], pooled[2 * i + 1])):
            local = inproc.measure(nest)
            out.append({"mkn": list(CONTRACTIONS[i]), "schedule": kind,
                        "pool_gflops": m.gflops if m is not None else None,
                        "inproc_gflops": local.gflops,
                        "ratio": (m.gflops / local.gflops) if m is not None else None})
    return out


def phase_pool_faults(out_dir: Path) -> dict:
    """One spawned worker on the card through the faulty spy: a schedule
    that ends its worker on every attempt resolves as a failed record, one
    that hangs once past the hung budget is killed and re-measured, and the
    batch's other schedules are measured on the card."""
    from repro_torch.core import (CPU_SPLITS, LoopNest, WorkerPool, apply_action,
                                  build_action_space, is_legal, make_backend,
                                  matmul_benchmark)

    t0 = time.perf_counter()
    spy_dir = fresh_dir(out_dir / "fleet_spy" / "pool_faults")
    token = spy_dir / "hang-once"
    token.write_text("once")
    bench = matmul_benchmark(DECODE_M, D_MODEL, D_MODEL)
    actions = build_action_space(CPU_SPLITS)
    rng = np.random.default_rng(SEED)
    nests, seen = [], set()
    while len(nests) < 4:
        nest = LoopNest(bench)
        for _ in range(3):
            legal = [a for a in actions if is_legal(nest, a)]
            apply_action(nest, legal[int(rng.integers(len(legal)))])
        if nest.structure_key() not in seen:
            seen.add(nest.structure_key())
            nests.append(nest)
    kw = make_backend("torch").pool_spec()[1]
    pool = WorkerPool("smoke_faulty", {**kw, "spy_dir": str(spy_dir),
                                       "poison": repr(nests[0].structure_key()),
                                       "hang": repr(nests[1].structure_key()),
                                       "token": str(token)},
                      n_workers=1, start_method="spawn", max_task_retries=1,
                      task_timeout_s=FAULT_TASK_TIMEOUT_S)
    try:
        ms = pool.measure_batch(nests)
        stats = pool.stats()
    finally:
        pool.close()
    spy = spy_launches(spy_dir)
    row = {"task_timeout_s": FAULT_TASK_TIMEOUT_S, "max_task_retries": 1,
           "measurements": [{"role": role, "gflops": m.gflops, "noisy": m.noisy,
                             "remeasured": m.remeasured, "worker": m.worker,
                             "repeats": m.repeats}
                            for role, m in zip(("poison", "hang_once", "ok", "ok"), ms)],
           "stats": {k: v for k, v in stats.items() if k != "worker_info"},
           "startup_s": [w["startup_s"] for w in stats["worker_info"] if w],
           "worker_launches": spy["total"], "spy": spy["workers"]}
    emit("pool_faults", t0, **row)
    checks = {
        "the poison schedule is a failed record": ms[0].gflops == 0.0 and ms[0].noisy
            and ms[0].remeasured and stats["failed_tasks"] == 1,
        "the hung worker was killed and the schedule re-measured":
            stats["hung_killed"] >= 1 and ms[1].gflops > 0,
        "dead workers respawned": stats["respawns"] >= 2,
        "the other schedules measured on the card":
            all(m.gflops > 0 and m.worker == 0 for m in ms[1:]) and spy["total"] > 0
            and all(w["device"] == "cuda:0" for w in spy["workers"]),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"pool_faults phase failed: {bad}")
    return row


def phase_kernel_store(out_dir: Path) -> dict:
    """Two spawned workers with an empty build directory share an empty
    kernel store: exactly one runs nvcc on matmul.cu (one compiles.log
    event) and the other loads the library from the store; then a fresh
    worker with another empty build directory and the same store runs no
    nvcc."""
    from repro_torch.core import (LoopNest, WorkerPool, make_backend, matmul_benchmark,
                                  open_store)
    from repro_torch.core.kernel_store import key_digest
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    root = fresh_dir(out_dir / "fleet_store")
    cache = root / "store"
    src = _build.CSRC / "matmul.cu"
    digest = key_digest(_build.store_key(src, _build._lib_path(src)))
    kw = {**make_backend("torch").pool_spec()[1], "cache_dir": str(cache)}
    nests = [LoopNest(matmul_benchmark(DECODE_M, D_MODEL, D_MODEL))]
    rounds = {}
    saved = os.environ.get(_build.BUILD_DIR_ENV)
    try:
        for name, n_workers in (("two_workers", 2), ("fresh_process", 1)):
            # the workers inherit the build directory from the environment
            os.environ[_build.BUILD_DIR_ENV] = str(fresh_dir(root / f"build_{name}"))
            t1 = time.perf_counter()
            with WorkerPool("torch", kw, n_workers=n_workers, start_method="spawn") as pool:
                if not pool.wait_ready(timeout_s=900.0):
                    raise SystemExit(f"kernel_store: the {name} workers never started")
                ms = pool.measure_batch(nests * n_workers)
                stats = pool.stats()
            events = open_store(str(cache), _build.fingerprint()).compile_events()
            rounds[name] = {
                "seconds": time.perf_counter() - t1,
                "matmul_sources": sorted(w["builds"]["matmul"]["source"]
                                         for w in stats["worker_info"]),
                "nvcc_s": [w["builds"]["matmul"]["seconds"] for w in stats["worker_info"]],
                "startup_s": [w["startup_s"] for w in stats["worker_info"]],
                "compile_events": sum(e["key"] == digest for e in events),
                "gflops": [m.gflops for m in ms]}
    finally:
        if saved is None:
            os.environ.pop(_build.BUILD_DIR_ENV, None)
        else:
            os.environ[_build.BUILD_DIR_ENV] = saved
    row = {"rounds": rounds, "nvcc_runs_per_source": {
        "matmul": rounds["fresh_process"]["compile_events"]}}
    emit("kernel_store", t0, **row)
    two, fresh = rounds["two_workers"], rounds["fresh_process"]
    checks = {
        "one nvcc across two workers, the other loaded the library":
            two["matmul_sources"] == ["nvcc", "store"] and two["compile_events"] == 1,
        "a fresh process runs no nvcc": fresh["matmul_sources"] == ["store"]
            and fresh["compile_events"] == 1,
        "every worker measured on the card":
            all(g > 0 for r in rounds.values() for g in r["gflops"]),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"kernel_store phase failed: {bad}")
    return row


def _read_lines(stream, lines: "queue.Queue") -> None:
    for line in stream:
        lines.put(line)
    lines.put(None)


def phase_farm(out_dir: Path, g, inproc_tune_s: float) -> dict:
    """A farm subprocess (``repro_torch.launch.measure_farm --backend torch
    --measure pool``) serves ``tune_records_fleet`` with two clients tuning
    the six contractions; its records are served here, and SIGTERM drains
    it."""
    from repro_torch.core import LoopNest, make_backend, matmul_benchmark
    from repro_torch.core.registry import ScheduleRegistry, current_hardware
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.measure_farm import farm_status
    from repro_torch.launch.tune import TuneJournal, tune_records_fleet

    t0 = time.perf_counter()
    farm_dir = fresh_dir(out_dir / "fleet_farm")
    reg_path = farm_dir / "registry.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.measure_farm", "--addr", "127.0.0.1:0",
         "--backend", "torch", "--measure", "pool"],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=_read_lines, args=(proc.stdout, lines), daemon=True).start()
    out: list = []
    try:
        first = lines.get(timeout=FARM_START_S)
        if not first or not first.startswith("[farm] listening on"):
            raise SystemExit(f"farm did not start: {first!r}")
        out.append(first)
        addr = first.split()[3]
        # the farm's pool starts at its first request: one request first, so
        # the fleet's tune is timed with a ready worker
        warm = make_backend("remote", addr=addr, fallback="torch", client_id="warm-up")
        t1 = time.perf_counter()
        warm.measure(LoopNest(matmul_benchmark(*CONTRACTIONS[0])))
        first_request_s, warm_farm = time.perf_counter() - t1, warm.farm_stats()
        warm.close()
        records = [{"m": m, "k": k, "n": n, "dtype": "float32",
                    "flop_share": 1.0 / len(CONTRACTIONS)} for m, k, n in CONTRACTIONS]
        l0, t1 = matmul.launches, time.perf_counter()
        entries, n_skipped, clients = tune_records_fleet(
            records, n_clients=2, farm=addr, backend="torch", registry_path=str(reg_path),
            budget_s=TUNE_BUDGET_S * len(records),
            eval_budget=TUNE_MAX_EVALS * len(records),
            journal=TuneJournal(str(reg_path) + ".journal.jsonl"))
        tune_s, parent_launches = time.perf_counter() - t1, matmul.launches - l0
        status = farm_status(addr)
        registry = ScheduleRegistry(str(reg_path))
        stamped = [registry.get("mm", (m, k, n), "float32", exact=True)
                   for m, k, n in CONTRACTIONS]
        served = record_checks(registry, g, torch.float32)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        while (line := lines.get(timeout=30)) is not None:
            out.append(line)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    (out_dir / "fleet_farm" / "farm_stdout.txt").write_text("".join(out))
    farms = [c["farm"] for c in clients]
    row = {"addr": addr, "first_request_s": first_request_s, "tune_s": tune_s,
           "inproc_tune_s": inproc_tune_s,
           "tune_s_over_inproc": tune_s / inproc_tune_s, "parent_launches": parent_launches,
           "clients": [{k: c["farm"][k] for k in (
               "client_id", "requests", "retries", "degradations", "degraded_batches",
               "tickets_submitted", "tickets_collected", "tickets_resubmitted",
               "inflight_tickets_peak", "overlap_ratio", "farm_rtt_s",
               "remote_backend", "remote_hardware")} | {"wall_s": c["wall_s"],
                                                        "n_tuned": c["n_tuned"]}
                       for c in clients],
           "farm": {k: status.get(k) for k in (
               "requests", "served_nests", "pool_batches", "coalesced_batches",
               "tickets_submitted", "tickets_collected", "tickets_acked", "errors",
               "backend", "hardware", "service_s_per_nest")},
           "stamps": [[e.get("backend"), e.get("hardware")] if e else None for e in stamped],
           "tune": [{"mkn": list(mkn), "block": e.get("block"), "base_gflops":
                     e.get("base_gflops"), "tuned_gflops": e.get("gflops")}
                    for mkn, e in zip(CONTRACTIONS, entries)],
           "records": served, "farm_rc": rc,
           "farm_drained": any("SIGTERM: draining" in ln for ln in out)
           and any(ln.startswith("[farm] stopped") for ln in out)}
    emit("farm", t0, **row)
    card = current_hardware()
    checks = {
        "the farm served requests, no client degraded": status["requests"] > 0
            and all(f["degradations"] == 0 and f["degraded_batches"] == 0
                    for f in farms + [warm_farm]),
        "tickets balanced": sum(f["tickets_submitted"] for f in farms)
            == sum(f["tickets_collected"] for f in farms) > 0,
        "every measurement came from the farm's card executor":
            all(f["remote_backend"] == "torch" and f["remote_hardware"] == card for f in farms),
        "records stamped torch and the card": all(
            e is not None and e["backend"] == "torch" and e["hardware"] == card
            for e in stamped) and n_skipped == 0 and len(entries) == len(records),
        "tuned >= base": all(e["gflops"] >= e["base_gflops"] > 0 for e in entries),
        "the parent launched nothing while the farm tuned": parent_launches == 0,
        "every record served, routed, on simt, within its limit": all(
            r["rel_err"] <= r["limit"] and r["routed"] == 1 and r["misses"] == 0
            and r["route"] == "simt" for r in served),
        "SIGTERM drained the farm, exit 0": rc == 0 and row["farm_drained"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"farm phase failed: {bad}")
    return row


def phase_fleet(out_dir: Path, g, inproc_tune_s: float) -> dict:
    """The fleet path's four phases.  Returns their rows and the path's
    launches: the parent's (serving the tuned records) and the workers'
    (every reward of the pool phases), which their spies counted."""
    pool = phase_pool(out_dir, g)
    compare = pool.pop("compare")
    faults = phase_pool_faults(out_dir)
    store = phase_kernel_store(out_dir)
    farm = phase_farm(out_dir, g, inproc_tune_s)
    parent = read_launches()
    workers = pool["worker_launches"] + faults["worker_launches"]
    launches = {**parent, "tiled_matmul": parent["tiled_matmul"] + workers}
    return {"pool": pool, "pool_faults": faults, "kernel_store": store, "farm": farm,
            "parent_launches": parent, "worker_launches": workers, "launches": launches,
            "compare": compare}


# ---------------------------------------------------------------------------
# the model path: musicgen-large at full width, served through both kernels
# ---------------------------------------------------------------------------


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device rows of a chrome trace


def device_times(prof, wall_s: float, path: Path) -> dict:
    """Device ms by kernel from a profiler trace, and the idle share of the
    traced window: 1 - (union of the device's busy intervals) / wall.  The
    union counts overlapping device work once.  The value is not clamped:
    host and device clocks are aligned by the tracer, so a fully busy window
    can read slightly below 0.  ``key_averages_device_ms`` is the sum of
    self device time over the profiler's table rows, kept to compare."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    by = {"flash_attention": 0.0, "flash_attention_bwd": 0.0, "tiled_matmul": 0.0,
          "rwkv6_scan": 0.0, "mamba_scan": 0.0, "other": 0.0}
    spans = []
    for e in events:
        if e.get("ph") != "X" or str(e.get("cat", "")).lower() not in DEVICE_CATS:
            continue
        start, dur = float(e["ts"]), float(e["dur"])
        spans.append((start, start + dur))
        name = e.get("name", "")
        key = ("flash_attention" if "flash_fwd" in name else
               "flash_attention_bwd" if "flash_bwd" in name else
               "tiled_matmul" if "simt_matmul" in name or "tc_matmul" in name else
               "rwkv6_scan" if "rwkv6_chunk_intra" in name or "rwkv6_state_walk" in name else
               "mamba_scan" if "mamba_scan" in name else "other")
        by[key] += dur / 1e3
    table_ms = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()) / 1e3
    out = {"wall_ms": wall_s * 1e3, "key_averages_device_ms": table_ms}
    if not spans:
        return {**out, "device_ms": None}
    spans.sort()
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_us, lo, hi = busy_us + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy_ms = (busy_us + hi - lo) / 1e3
    return {**out, "device_ms": sum(by.values()), "busy_ms": busy_ms,
            **{f"{k}_ms": v for k, v in by.items()},
            "idle_share": 1.0 - busy_ms / (wall_s * 1e3)}


def record_checks(registry, g, dt=torch.bfloat16) -> list:
    """Each record of type ``dt`` the model serves (bf16 unless told
    otherwise), through ``tuned_einsum`` at the model's shapes and forms
    (the logits form with f32 out), against ``matmul_plain`` on the same
    operands at the record's block."""
    from repro_torch.core.registry import current_hardware
    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul import launch_plan, matmul_plain

    rows = []
    for m, seq in ((DECODE_M, 1), (PREFILL_M, PREFILL_M // DECODE_M)):
        for spec, (k, n), odt in (("bsk,kn->bsn", (D_MODEL, D_MODEL), None),
                                  ("bsk,kn->bsn", (D_MODEL, D_FF), None),
                                  ("bsk,kn->bsn", (D_FF, D_MODEL), None),
                                  ("bsd,vd->bsv", (D_MODEL, VOCAB), torch.float32)):
            x = torch.randn(DECODE_M, seq, k, generator=g, device="cuda").to(dt)
            trans_b = spec.endswith("vd->bsv")
            w = torch.randn(*((n, k) if trans_b else (k, n)), generator=g,
                            device="cuda").to(dt)
            ops.reset_serving_stats()
            with ops.serving(registry):
                out = ops.tuned_einsum(spec, x, w, out_dtype=odt)
            stats = ops.serving_stats(reset=True)
            block, order = ops._entry_schedule(registry.get(
                "mm", (m, k, n), str(dt).removeprefix("torch."),
                hardware=current_hardware(), exact=True))
            plain = matmul_plain(x.reshape(m, k), w, bm=block["m"], bk=block["k"],
                                 bn=block["n"], grid_order=order,
                                 out_dtype=odt or dt, trans_b=trans_b)
            torch.cuda.synchronize()
            odt = odt or dt
            route = launch_plan(m, k, n, block["m"], block["k"], block["n"], order,
                                dtype=dt)["route"]
            rows.append({"spec": spec, "mkn": [m, k, n], "out": str(odt),
                         "block": [block["m"], block["k"], block["n"]], "order": order,
                         "route": route, "routed": stats["routed"],
                         "misses": stats["misses"], "limit": limit_for(odt, route),
                         "rel_err": rel_err(out.reshape(m, n), plain)})
    return rows


def traced_steps(cfg, params, prompts, max_len: int, registry, out_dir: Path,
                 tok=None, encoder=None) -> tuple:
    """One prefill wave of ``prompts`` (with ``encoder`` states, for a model
    with cross layers) and one decode step of ``tok`` (its own greedy tokens
    when None), each under ``torch.profiler``.  Returns (last logits, decode
    logits, the tokens decoded, {"prefill": device times, "decode": device
    times})."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve as SV
    from repro_torch.models import steps as S

    make_inputs = SV.input_fn(cfg, "cuda")
    prefill = S.make_prefill_step(cfg, max_len, registry=registry)
    decode = S.make_decode_step(cfg, registry=registry)
    inputs = make_inputs(prompts)
    if encoder is not None:
        inputs["encoder"] = encoder
    traces = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        last, caches, n = prefill(params, inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    traces["prefill"] = device_times(prof, wall, out_dir / "trace.json")
    if tok is None:
        tok = torch.argmax(last, -1).cpu().numpy()
    step_in = make_inputs(tok[:, None])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, step, caches = decode(params, step_in, caches, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    traces["decode"] = device_times(prof, wall, out_dir / "trace.json")
    return last, step, tok, traces


def model_agreement(cfg, registry, out_dir: Path) -> dict:
    """The first wave's prefill last logits and first decode logits, tuned
    against ``registry=None``; every step traced by the profiler."""
    from repro_torch.launch import serve as SV

    params = SV.init_model(cfg, SEED, "cuda")
    wave = SV.request_pool(cfg, SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"], SEED)
    prompts = np.stack([r.prompt for r in wave])
    outs, traces, tok = {}, {}, None
    for name, reg in (("tuned", registry), ("plain", None)):
        last, step, tok, tr = traced_steps(cfg, params, prompts, SERVE["max_len"], reg,
                                           out_dir, tok)
        traces[f"{name}_prefill"], traces[f"{name}_decode"] = tr["prefill"], tr["decode"]
        outs[name] = (last, step)
    return {"prefill_last_logits_rel_err": rel_err(outs["tuned"][0], outs["plain"][0]),
            "decode_logits_rel_err": rel_err(outs["tuned"][1], outs["plain"][1]),
            "finite": all(bool(torch.isfinite(x).all())
                          for pair in outs.values() for x in pair),
            "traces": traces}


def expected_harvest(cfg) -> dict:
    """The dense sites' ``(m, k, n, dtype)`` keys and counts that one
    prefill and one decode step of ``cfg`` (every layer attention + dense
    MLP) look up at phase model's shapes, from the config: per layer q, k,
    v and o, gate and up, down; once the logits against the (vocab, d)
    head."""
    if any(spec.mixer != "attn" or spec.ffn != "dense" for spec in cfg.period):
        raise SystemExit(f"{cfg.name}: expected attention + dense MLP layers")
    d, layers = cfg.d_model, cfg.n_layers
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    sites = (((d, q), layers), ((d, kv), 2 * layers), ((q, d), layers),
             ((d, cfg.d_ff), 2 * layers), ((cfg.d_ff, d), layers), ((d, cfg.vocab), 1))
    out: dict = {}
    for m in (SERVE["batch"], SERVE["batch"] * SERVE["prompt_len"]):
        for (k, n), count in sites:
            key = (m, k, n, str(cfg.dtype))
            out[key] = out.get(key, 0) + count
    return out


def phase_model(out_dir: Path) -> tuple:
    from repro_torch.configs import get_config
    from repro_torch.core.registry import ScheduleRegistry, current_hardware
    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul import launch_plan, matmul
    from repro_torch.launch import serve as SV
    from repro_torch.launch.tune import tune_model

    t0 = time.perf_counter()
    cfg = get_config("musicgen-large")
    n = len(CONTRACTIONS)
    reg_path = out_dir / "model_registry.json"
    jpath = Path(f"{reg_path}.journal.jsonl")
    for f in (reg_path, jpath):
        f.unlink(missing_ok=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # this path starts here: the entry point harvests and tunes
    report = tune_model(cfg, smoke=False, registry_path=str(reg_path),
                        journal_path=str(jpath), batch=SERVE["batch"],
                        prompt_len=SERVE["prompt_len"], max_len=SERVE["max_len"],
                        budget_s=TUNE_BUDGET_S * n, eval_budget=TUNE_MAX_EVALS * n)
    tune_s, at_tune = time.perf_counter() - t0, read_launches()
    tune_launches = at_tune["tiled_matmul"]
    tune_routes = dict(matmul.route_launches)
    registry = ScheduleRegistry(str(reg_path))  # the table as read back from disk
    summary = SV.serve_once(cfg, seed=SEED, registry=registry, device="cuda", **SERVE)
    launches = read_launches()  # ... and ends here
    harvested = {(c["m"], c["k"], c["n"], c["dtype"]): c["count"]
                 for c in report["contractions"]}
    expected = expected_harvest(cfg)
    # the FLOP-share split of the eval budget (tune_records, then tune_many)
    share_evals = {"x".join(map(str, (c["m"], c["k"], c["n"]))):
                   max(2, int(round(TUNE_MAX_EVALS * n * c["flop_share"])))
                   for c in report["contractions"]}
    serve_routes = {r: matmul.route_launches[r] - tune_routes[r] for r in tune_routes}
    peak_bytes = torch.cuda.max_memory_allocated()
    stats = summary["registry"]["serving"]
    waves = summary["prefill_waves"]
    records = record_checks(registry, torch.Generator(device="cuda").manual_seed(SEED))
    tuned = {}
    for mkn in CONTRACTIONS:
        block, order = ops._entry_schedule(registry.get(
            "mm", mkn, "bfloat16", hardware=current_hardware(), exact=True))
        blk = (block["m"], block["k"], block["n"])
        tuned["x".join(map(str, mkn))] = {
            "block": list(blk), "grid_order": order,
            "plan": launch_plan(*mkn, *blk, order, dtype=torch.bfloat16)}
    agree = model_agreement(cfg, registry, out_dir)
    worst = max(agree["prefill_last_logits_rel_err"], agree["decode_logits_rel_err"])
    row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab, "dtype": cfg.dtype, "params": cfg.param_count(),
           **SERVE, "tune_s": tune_s, "tune_launches": tune_launches,
           "harvest": report["contractions"], "n_harvested": report["n_harvested"],
           "flop_share_covered": report["flop_share_covered"],
           "max_evals_by_flop_share": share_evals,
           "harvest_flash_launches": at_tune["flash_attention"],
           "launches": launches, "prefill_waves": waves,
           "prefill_ms_per_wave": summary["prefill_ms"],
           "decode_steps": summary["decode_steps"],
           "decode_tokens": summary["decode_tokens"],
           "decode_step_p50_ms": summary["decode_step_p50_ms"],
           "decode_tokens_per_s": summary["decode_tokens_per_s"],
           "tokens_per_s": summary["tokens_per_s"],
           "max_memory_allocated": peak_bytes,
           "hits": stats["hits"], "misses": stats["misses"], "routed": stats["routed"],
           "tune_route_launches": tune_routes, "serve_route_launches": serve_routes,
           "tuned_blocks": tuned,
           "logits_finite": summary["logits_finite"] and agree["finite"],
           "records": records,
           "worst_rel_err_vs_registry_none": worst, "limit": MODEL_LIMIT,
           **{k: agree[k] for k in ("prefill_last_logits_rel_err",
                                    "decode_logits_rel_err", "traces")}}
    emit("model", t0, **row)
    checks = {
        "every record: kernel vs plain within limit_for, routed once, on wgmma":
            all(r["rel_err"] <= r["limit"] and r["routed"] == 1 and r["route"] == "wgmma"
                for r in records),
        "misses == 0": stats["misses"] == 0,
        "routed == hits > 0": stats["routed"] == stats["hits"] > 0,
        "harvested keys and counts == the six contractions' from the config":
            harvested == expected
            and set(expected) == {(*mkn, "bfloat16") for mkn in CONTRACTIONS},
        "flop_share_covered == 1": abs(report["flop_share_covered"] - 1.0) <= 1e-12,
        "flash launches while serving == layers x waves":
            launches["flash_attention"] - at_tune["flash_attention"] == cfg.n_layers * waves > 0,
        "flash launches in the harvest == layers (one prefill)":
            at_tune["flash_attention"] == cfg.n_layers,
        "matmul launches while serving == routed":
            launches["tiled_matmul"] - tune_launches == stats["routed"],
        "every reward launch of the bf16 tune on wgmma":
            tune_routes == {"wgmma": tune_launches, "simt": 0} and tune_launches > 0,
        "every serving launch on wgmma":
            serve_routes == {"wgmma": stats["routed"], "simt": 0},
        "no scan launches": launches["rwkv6_scan"] == 0,
        "every logit finite": row["logits_finite"],
        f"tuned vs registry=None <= {MODEL_LIMIT}": worst <= MODEL_LIMIT,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"model phase failed: {bad} (harvested {harvested}, "
                         f"expected {expected})")
    return row, registry


# ---------------------------------------------------------------------------
# the rwkv6-7b path: served at full width through the scan kernel
# ---------------------------------------------------------------------------


def recurrence_errors(cfg, params, prompts, want) -> dict:
    """The prefill of ``prompts`` (the kernels) against ``want``, the same
    prompt fed token by token through ``decode_step``: last logits, and for
    every cache leaf (rwkv6-7b: the state ``s`` and the carries ``xt``/
    ``xc``; jamba: Mamba ``h`` and ``conv``, attention ``k``/``v``) its
    worst layer and its error layer by layer."""
    from repro_torch.launch import serve as SV
    from repro_torch.models import steps as S

    make_inputs = SV.input_fn(cfg, "cuda")
    last, caches, _ = S.make_prefill_step(cfg, RECURRENCE_LEN)(params, make_inputs(prompts))
    torch.cuda.synchronize()
    errs = {"logits": rel_err(last, want["logits"])}
    per_leaf, n = {}, len(cfg.period)
    for pos, leaves in enumerate(caches):
        for name, t in leaves.items():
            for per in range(cfg.n_periods):
                per_leaf.setdefault(name, []).append(
                    (per * n + pos, rel_err(t[per], want["caches"][pos][name][per])))
    for name, rows in per_leaf.items():
        errs[f"{name}_worst_layer"] = max(e for _, e in rows)
        errs[f"{name}_per_layer"] = [e for _, e in sorted(rows)]
    errs["worst"] = max([errs["logits"]] + [errs[f"{k}_worst_layer"] for k in per_leaf])
    errs["finite"] = bool(torch.isfinite(last).all())
    return errs


def decode_recurrence(cfg, params, prompts) -> dict:
    """``prompts`` fed one token at a time through ``decode_step`` from a
    zero cache: the plain single-token recurrence, no scan kernel (and no
    flash kernel: decode attention is plain)."""
    from repro_torch.launch import serve as SV
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T

    make_inputs = SV.input_fn(cfg, "cuda")
    decode = S.make_decode_step(cfg)
    caches = T.init_cache(cfg, prompts.shape[0], RECURRENCE_LEN, device="cuda")
    for t in range(prompts.shape[1]):
        _, logits, caches = decode(params, make_inputs(prompts[:, t:t + 1]), caches, t)
    torch.cuda.synchronize()
    return {"logits": logits[:, -1], "caches": caches}


def phase_model_rwkv(out_dir: Path, mutant: Path) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_scan as RW
    from repro_torch.launch import serve as SV

    t0 = time.perf_counter()
    cfg = get_config("rwkv6-7b")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # this path starts here
    summary = SV.serve_once(cfg, seed=SEED, device="cuda", **RWKV_SERVE)
    launches = read_launches()  # ... and ends here
    peak_bytes = torch.cuda.max_memory_allocated()
    waves = summary["prefill_waves"]
    serve_s = time.perf_counter() - t0

    params = SV.init_model(cfg, SEED, "cuda")
    wave = SV.request_pool(cfg, RWKV_SERVE["batch"], RWKV_SERVE["prompt_len"], 1, SEED)
    *_, traces = traced_steps(cfg, params, np.stack([r.prompt for r in wave]),
                              RWKV_SERVE["max_len"], None, out_dir)
    t1 = time.perf_counter()
    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (RWKV_SERVE["batch"], RECURRENCE_LEN))
    want = decode_recurrence(cfg, params, prompts)
    recurrence_s = time.perf_counter() - t1
    want_finite = bool(torch.isfinite(want["logits"]).all())
    errs = recurrence_errors(cfg, params, prompts, want)

    # mutation check: the scan kernel without its u-bonus term, through the
    # same wrapper, against the same two checks
    with _build.substitute("rwkv6_scan", mutant, RW._declare):
        mut = recurrence_errors(cfg, params, prompts, want)
        mut_cases = [rwkv_case_check(i, c) for i, c in enumerate(rwkv_cases())]
    del want

    # the witness: the same check on the same weights widened to f32, so the
    # dense products no longer round to bf16; the scan kernel is unchanged
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = params.float()  # nn.Module.float: leaf by leaf, in place
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    f32 = recurrence_errors(cfg32, params, prompts, decode_recurrence(cfg32, params, prompts))
    f32["seconds"] = time.perf_counter() - t1
    del params
    mut_outside = sum(not c["ratio_to_limit"] <= 1.0 for c in mut_cases)
    mutation = {"kernel": "rwkv6_scan", "dropped": MUTANT_LINE, "worst_err": mut["worst"],
                "logits_err": mut["logits"],
                **{f"{k}_worst_layer_err": mut[f"{k}_worst_layer"] for k in ("s", "xt", "xc")},
                "rwkv_scan_cases_outside_limit": mut_outside,
                "rwkv_scan_cases": len(mut_cases),
                "rwkv_scan_min_ratio_to_limit": min(c["ratio_to_limit"] for c in mut_cases)}
    worst = errs["worst"]
    row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.d_model // cfg.rwkv_head_dim, "head_dim": cfg.rwkv_head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
           "params": cfg.param_count(), **RWKV_SERVE, "chunk": RWKV_CHUNK,
           "serve_s": serve_s, "launches": launches, "prefill_waves": waves,
           "prefill_ms_per_wave": summary["prefill_ms"],
           "decode_steps": summary["decode_steps"],
           "decode_tokens": summary["decode_tokens"],
           "decode_step_p50_ms": summary["decode_step_p50_ms"],
           "decode_tokens_per_s": summary["decode_tokens_per_s"],
           "tokens_per_s": summary["tokens_per_s"],
           "max_memory_allocated": peak_bytes,
           "logits_finite": summary["logits_finite"] and errs["finite"] and want_finite,
           "recurrence": {"prompt_len": RECURRENCE_LEN, "decode_s": recurrence_s,
                          **{k: v for k, v in errs.items() if k != "finite"}},
           "recurrence_limit": RECURRENCE_LIMIT,
           "recurrence_f32": {k: v for k, v in f32.items() if k != "finite"},
           "f32_witness_limit": F32_WITNESS_LIMIT, "traces": traces}
    emit("model_rwkv", t0, **row)
    emit("mutation", t0, **mutation)
    checks = {
        "scan launches == layers x waves": launches["rwkv6_scan"] == cfg.n_layers * waves > 0,
        "no matmul or flash launches":
            launches["tiled_matmul"] == launches["flash_attention"] == 0,
        "every logit finite": row["logits_finite"] and f32["finite"],
        f"prefill vs recurrence <= {RECURRENCE_LIMIT}": worst <= RECURRENCE_LIMIT,
        f"f32 witness <= {F32_WITNESS_LIMIT}": f32["worst"] <= F32_WITNESS_LIMIT,
        "mutant outside the recurrence limit": mut["worst"] > RECURRENCE_LIMIT,
        "mutant outside the rwkv_scan limit": mut_outside > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"model_rwkv phase failed: {bad}")
    return row


# ---------------------------------------------------------------------------
# the jamba-v0.1-52b path: two periods at full width, through the Mamba scan
# ---------------------------------------------------------------------------


def mamba_layer_check(cfg) -> dict:
    """One full-width Mamba layer with f32 weights (seeded), a 384-token
    prompt of N(0, 1) activations run two ways: ``mamba_apply`` (the scan
    kernel) and ``mamba_reference`` (the plain token-by-token decode)."""
    from repro_torch.models import mamba as M

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    p = M.mamba_params(g, cfg.d_model, cfg.ssm_d_state, cfg.ssm_d_conv, cfg.ssm_expand,
                       torch.float32, "cuda")
    x = torch.randn(JAMBA_SERVE["batch"], RECURRENCE_LEN, cfg.d_model, generator=g,
                    device="cuda")
    with torch.no_grad():
        out, st = M.mamba_apply(p, x)
        ref, st_r = M.mamba_reference(p, x)
    torch.cuda.synchronize()
    errs = {"out": rel_err(out, ref), "h": rel_err(st.h, st_r.h),
            "conv": rel_err(st.conv, st_r.conv)}
    errs["worst"] = max(errs["out"], errs["h"])
    errs["finite"] = bool(torch.isfinite(out).all())
    return errs


def recorded_routes(fn) -> tuple:
    """Run ``fn()`` recording the expert choices ``(N, top_k)`` of every MoE
    router call, in call order.  Returns (the choices, fn's result)."""
    from repro_torch.models import moe as X

    calls, route = [], X._route

    def recording(p, xt, moe_cfg):
        out = route(p, xt, moe_cfg)
        calls.append(out[3])
        return out

    X._route = recording
    try:
        return calls, fn()
    finally:
        X._route = route


def routing_differs(prefill_calls, decode_calls, n_moe: int, batch: int) -> list:
    """Per MoE layer, the share of tokens whose set of experts differs
    between the prefill (one router call a layer over B*S tokens) and the
    token-by-token decode (one call a layer and step over B tokens)."""
    out = []
    for layer in range(n_moe):
        pre = prefill_calls[layer].sort(dim=-1).values                  # (B*S, K)
        dec = torch.stack(decode_calls[layer::n_moe])                    # (S, B, K)
        dec = dec.transpose(0, 1).reshape(-1, pre.shape[-1]).sort(dim=-1).values
        out.append((pre != dec).any(-1).float().mean().item())
    return out


def phase_model_jamba(out_dir: Path, mutant: Path) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import _declare as mamba_declare
    from repro_torch.launch import serve as SV

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=JAMBA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # this path starts here
    summary = SV.serve_once(cfg, seed=SEED, device="cuda", **JAMBA_SERVE)
    launches = read_launches()  # ... and ends here
    peak_bytes = torch.cuda.max_memory_allocated()
    waves = summary["prefill_waves"]
    serve_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    params = SV.init_model(cfg, SEED, "cuda")
    wave = SV.request_pool(cfg, JAMBA_SERVE["batch"], JAMBA_SERVE["prompt_len"], 1, SEED)
    *_, traces = traced_steps(cfg, params, np.stack([r.prompt for r in wave]),
                              JAMBA_SERVE["max_len"], None, out_dir)
    layer = mamba_layer_check(cfg)

    # the whole model, prefill vs the token-by-token decode, at MoE capacity
    # 8 (= n_experts / top_k: no token drops at prefill or at decode), and
    # with every token routed to all 16 experts at its full softmax weights
    # (top-k = 16, capacity 1: no drops and no discrete routing choice, so
    # that bf16 noise cannot flip a token's experts); same weights
    moe = cfg.moe
    variants = {
        "capacity_8": dataclasses.replace(cfg, moe=dataclasses.replace(
            moe, capacity_factor=8.0)),
        "dense_routing": dataclasses.replace(cfg, moe=dataclasses.replace(
            moe, top_k=moe.n_experts, capacity_factor=1.0)),
    }
    n_moe = sum(spec.ffn == "moe" for spec in cfg.period) * cfg.n_periods
    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (JAMBA_SERVE["batch"], RECURRENCE_LEN))
    wants, recurrence, finite = {}, {}, layer["finite"]
    for name, vcfg in variants.items():
        t1 = time.perf_counter()
        dec_calls, wants[name] = recorded_routes(lambda: decode_recurrence(vcfg, params, prompts))
        decode_s = time.perf_counter() - t1
        pre_calls, errs = recorded_routes(
            lambda: recurrence_errors(vcfg, params, prompts, wants[name]))
        finite = finite and errs.pop("finite") and bool(torch.isfinite(
            wants[name]["logits"]).all())
        recurrence[name] = {"decode_s": decode_s, **errs,
                            "routing_differs_per_moe_layer": routing_differs(
                                pre_calls, dec_calls, n_moe, JAMBA_SERVE["batch"])}

    # mutation check: the scan kernel with each staged tile's first token
    # left undecayed, through the same wrapper, against the same checks
    with _build.substitute("mamba_scan", mutant, mamba_declare):
        mut_layer = mamba_layer_check(cfg)
        mut = {name: recurrence_errors(vcfg, params, prompts, wants[name])
               for name, vcfg in variants.items()}
        mut_cases = [mamba_case_check(i, c) for i, c in enumerate(mamba_cases())]
    del wants, params
    mut_outside = sum(not c["ratio_to_limit"] <= 1.0 for c in mut_cases)
    mutation = {"kernel": "mamba_scan", "dropped": MAMBA_MUTANT_LINE,
                "layer_worst_err": mut_layer["worst"], "layer_out_err": mut_layer["out"],
                "layer_h_err": mut_layer["h"],
                **{f"{name}_{k}": m[k] for name, m in mut.items()
                   for k in ("worst", "logits", "h_worst_layer")},
                "mamba_scan_cases_outside_limit": mut_outside,
                "mamba_scan_cases": len(mut_cases),
                "mamba_scan_min_ratio_to_limit": min(c["ratio_to_limit"] for c in mut_cases)}
    row = {"arch": cfg.name, "layers": cfg.n_layers, "published_layers": 32,
           "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "experts": moe.n_experts, "top_k": moe.top_k,
           "capacity_factor": moe.capacity_factor, "d_state": cfg.ssm_d_state,
           "dtype": cfg.dtype, "params": cfg.param_count(), **JAMBA_SERVE,
           "serve_s": serve_s, "launches": launches, "prefill_waves": waves,
           "prefill_ms_per_wave": summary["prefill_ms"],
           "decode_steps": summary["decode_steps"],
           "decode_tokens": summary["decode_tokens"],
           "decode_step_p50_ms": summary["decode_step_p50_ms"],
           "decode_tokens_per_s": summary["decode_tokens_per_s"],
           "tokens_per_s": summary["tokens_per_s"],
           "max_memory_allocated": peak_bytes,
           "logits_finite": summary["logits_finite"] and finite,
           "mamba_layer": {k: v for k, v in layer.items() if k != "finite"},
           "mamba_layer_limit": MAMBA_LAYER_LIMIT,
           "recurrence_prompt_len": RECURRENCE_LEN, "recurrence": recurrence,
           "recurrence_limit": JAMBA_RECURRENCE_LIMIT, "traces": traces}
    emit("model_jamba", t0, **row)
    emit("mutation", t0, **mutation)
    n_mamba = sum(spec.mixer == "mamba" for spec in cfg.period) * cfg.n_periods
    n_attn = sum(spec.mixer == "attn" for spec in cfg.period) * cfg.n_periods
    dense, cap8 = recurrence["dense_routing"], recurrence["capacity_8"]
    checks = {
        "params == 26,053,595,136": row["params"] == 26_053_595_136,
        "scan launches == Mamba layers x waves":
            launches["mamba_scan"] == n_mamba * waves == 14 * waves > 0,
        "flash launches == attention layers x waves":
            launches["flash_attention"] == n_attn * waves == 2 * waves,
        "no matmul or rwkv scan launches":
            launches["tiled_matmul"] == launches["rwkv6_scan"] == 0,
        "every logit finite": row["logits_finite"],
        f"one Mamba layer <= {MAMBA_LAYER_LIMIT}": layer["worst"] <= MAMBA_LAYER_LIMIT,
        f"dense routing: prefill vs recurrence <= {JAMBA_RECURRENCE_LIMIT}":
            dense["worst"] <= JAMBA_RECURRENCE_LIMIT,
        f"capacity 8: last logits <= {JAMBA_RECURRENCE_LIMIT}":
            cap8["logits"] <= JAMBA_RECURRENCE_LIMIT,
        "mutant outside the one-layer limit": mut_layer["worst"] > MAMBA_LAYER_LIMIT,
        "mutant outside the mamba_scan limit": mut_outside > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"model_jamba phase failed: {bad}")
    return row


def zoo_encoder(cfg):
    """The vision stub's encoder states: seeded (batch, 1600, 4096) in the
    model's dtype; None for a model without cross layers."""
    if not cfg.n_cross_tokens:
        return None
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    return torch.randn(ZOO_SERVE["batch"], cfg.n_cross_tokens, cfg.d_cross, generator=g,
                       device="cuda").to(getattr(torch, cfg.dtype))


def decode_vs_forward(cfg, params, prompts, tok, encoder, out_dir: Path) -> tuple:
    """Prefill ``prompts`` and decode ``tok`` at position S, against
    ``forward`` over the S + 1 tokens: (max abs diff / max abs of the
    logits, all finite)."""
    from repro_torch.launch import serve as SV
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    _, step, _, _ = traced_steps(cfg, params, prompts, ZOO_SERVE["max_len"], None, out_dir,
                                 tok=tok, encoder=encoder)
    batch = SV.input_fn(cfg, "cuda")(np.concatenate([prompts, tok[:, None]], axis=1))
    if encoder is not None:
        batch["encoder"] = encoder
    with torch.no_grad():
        x, _, _ = T.hidden_states(params, cfg, batch)
        want = L.logits_apply(params["embed"], x[:, -1:], params.get("lm_head"),
                              cfg.logit_softcap)
    return rel_err(step, want), bool(torch.isfinite(step).all() and torch.isfinite(want).all())


def phase_zoo_model(arch: str, out_dir: Path) -> dict:
    """One architecture of path zoo: its serve run (launches counted from 0
    just before it and read just after), one traced prefill wave and decode
    step, and decode of token 1025 against ``forward`` over the 1025 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SV

    t0 = time.perf_counter()
    layers, want_params, flash_per_wave, capacity = ZOO[arch]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    encoder = zoo_encoder(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # this model's run starts here
    if encoder is None:
        summary = SV.serve_once(cfg, seed=SEED, device="cuda", **ZOO_SERVE)
    else:  # serve_once refuses a cross model; its loop takes the encoder states
        summary = SV._serve_waves(cfg, seed=SEED, registry=None, device="cuda",
                                  prefill_extra={"encoder": encoder}, **ZOO_SERVE)
    launches = read_launches()  # ... and ends here
    peak_bytes = torch.cuda.max_memory_allocated()
    serve_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    params = SV.init_model(cfg, SEED, "cuda")
    wave = SV.request_pool(cfg, ZOO_SERVE["batch"], ZOO_SERVE["prompt_len"], 1, SEED)
    prompts = np.stack([r.prompt for r in wave])
    _, step, tok, traces = traced_steps(cfg, params, prompts, ZOO_SERVE["max_len"], None,
                                        out_dir, encoder=encoder)
    variants = {"served": cfg}
    if capacity is not None:
        # the decode check where no token drops, and with every token routed
        # to all experts at its full softmax weights (no discrete routing
        # choice, so that bf16 noise cannot flip a token's experts); f32:
        # the same weights widened in place, so it runs last
        routed = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                  capacity_factor=capacity))
        variants = {"dense_routing": dataclasses.replace(cfg, moe=dataclasses.replace(
                        cfg.moe, top_k=cfg.moe.n_experts, capacity_factor=1.0)),
                    f"capacity_{capacity:g}": routed,
                    f"f32_capacity_{capacity:g}": dataclasses.replace(routed, dtype="float32")}
    decode_err, finite = {}, True
    for name in ZOO_LIMIT[arch]:
        vcfg = variants[name]
        if vcfg.dtype == "float32":
            params.float()
        err, ok = decode_vs_forward(vcfg, params, prompts, tok, encoder, out_dir)
        decode_err[name], finite = err, finite and ok
    check_peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pre = traces["prefill"]
    row = {"arch": cfg.name, "layers": cfg.n_layers,
           "published_layers": get_config(arch).n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim_,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
           "params": cfg.param_count(), **ZOO_SERVE, "serve_s": serve_s,
           "launches": launches, "flash_launches_per_wave":
               launches["flash_attention"] / summary["prefill_waves"],
           "prefill_waves": summary["prefill_waves"],
           "prefill_ms_per_wave": summary["prefill_ms"],
           "decode_steps": summary["decode_steps"],
           "decode_step_p50_ms": summary["decode_step_p50_ms"],
           "decode_tokens_per_s": summary["decode_tokens_per_s"],
           "traced_prefill": {k: pre.get(k) for k in (
               "wall_ms", "busy_ms", "device_ms", "flash_attention_ms", "other_ms",
               "idle_share")},
           "traced_decode": {k: traces["decode"].get(k) for k in (
               "wall_ms", "busy_ms", "idle_share")},
           "decode_check_capacity_factor": capacity, "decode_vs_forward": decode_err,
           "decode_vs_forward_limit": ZOO_LIMIT[arch],
           "logits_finite": summary["logits_finite"] and finite,
           "max_memory_allocated": peak_bytes, "check_max_memory_allocated": check_peak}
    emit("zoo_model", t0, **row)
    check_path_launches(f"zoo {arch}", launches, ("flash_attention",))
    checks = {
        f"params == {want_params:,}": row["params"] == want_params,
        f"flash launches == {flash_per_wave} a wave":
            launches["flash_attention"] == flash_per_wave * summary["prefill_waves"] > 0,
        "every logit finite": row["logits_finite"],
        f"decode vs forward <= {ZOO_LIMIT[arch]}": decode_err.keys() == ZOO_LIMIT[arch].keys()
            and all(decode_err[k] <= lim for k, lim in ZOO_LIMIT[arch].items()),
        "peak memory under 80 GB": max(peak_bytes, check_peak) < CARD_BYTES,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"zoo {arch} failed: {bad}")
    return row


def phase_zoo(out_dir: Path) -> dict:
    """Path zoo: each of the seven architectures in turn, freed before the
    next.  Returns the path's launches, summed over the models' serve runs,
    and each model's row."""
    t0 = time.perf_counter()
    rows = [phase_zoo_model(arch, out_dir) for arch in ZOO]
    launches = {k: sum(r["launches"][k] for r in rows) for k in kernel_wrappers()}
    emit("zoo", t0, models=len(rows), launches=launches,
         decode_vs_forward={r["arch"]: r["decode_vs_forward"] for r in rows},
         prefill_ms={r["arch"]: r["prefill_ms_per_wave"][0] for r in rows},
         decode_step_p50_ms={r["arch"]: r["decode_step_p50_ms"] for r in rows},
         max_memory_allocated={r["arch"]: max(r["max_memory_allocated"],
                                              r["check_max_memory_allocated"])
                               for r in rows})
    return {"launches": launches, "rows": rows}


# ---------------------------------------------------------------------------
# path train: musicgen-large trained at full width; the flash backward kernel
# ---------------------------------------------------------------------------


MUSICGEN_BWD_CASE = (4, 1024, 1024, 32, 32, 64, True, None, None, torch.bfloat16)


def flash_bwd_cases() -> list:
    """(B, S, T, H, HKV, D, causal, window, softcap, dtype): every head dim
    with a backward instance in f32 and bf16, causal, a window, softcap 50,
    GQA 1/4/8, S and T off any 64-row tile (S != T too), rows that see no
    key, jamba's (4, 1024, 32/8, 128) and musicgen-large's training shape."""
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for i, d in enumerate(BWD_HEAD_DIMS):
            cases += [(2, 100, 100, 4, 4, d, True, None, None, dt),
                      (1, 130, 130, 8, 2, d, True, 40, None, dt),          # window, GQA 4
                      (1, 77, 77, 8, 1, d, True, None, 50.0, dt),          # softcap 50, GQA 8
                      (2, 70, 150, 4, 1, d, False, None, None, dt),        # S < T, GQA 4
                      (1, 150, 70, 4, 4, d, True, None, 50.0, dt)]         # S > T
            if i % 2 == 0:
                cases.append((1, 120, 90, 4, 1, d, True, 24, None, dt))    # rows 113-119 see no key
        cases.append((1, 40, 24, 2, 2, 16, False, None, None, dt))         # one tile each way
    cases.append((4, 1024, 1024, 32, 8, 128, True, None, None, torch.bfloat16))  # jamba's, GQA 4
    cases.append(MUSICGEN_BWD_CASE)
    return cases


def flash_bwd_case_check(case, g) -> dict:
    """One case: the backward kernel against ``flash_attention_bwd_plain``
    on the same q, k, v, out, dout and lse (the forward kernel's), and the
    forward kernel's lse against the plain forward's; the case's route, and
    whether the kernel's own plan equals ``bwd_launch_plan``."""
    from repro_torch.kernels.flash_attention import (bwd_launch_plan, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain, kernel_bwd_plan)

    b, s, t, h, hkv, d, causal, window, softcap, dt = case
    plan = bwd_launch_plan(s, t, d=d, dtype=dt)
    q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(b, t, hkv, d, generator=g, device="cuda").to(dt) for _ in range(2))
    dout = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    _, plain_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    lim = FLASH_BWD_LIMIT[dt]
    ratios = {name: ((a.float() - r.float()).abs() / (lim + lim * r.float().abs())).max().item()
              for name, a, r in zip(("dq", "dk", "dv"), got, want)}
    lse_ratio = ((lse - plain_lse).abs() / (LSE_LIMIT + LSE_LIMIT * plain_lse.abs())).max().item()
    return {"bsthd": [b, s, t, h, hkv, d], "causal": causal, "window": window,
            "softcap": softcap, "dtype": str(dt).replace("torch.", ""), "limit": lim,
            "route": plan["route"], "plan": plan,
            "plan_equal": kernel_bwd_plan(s, t, d=d, dtype=dt) == plan,
            "ratio_to_limit": ratios, "worst_ratio": max(ratios.values()),
            "max_abs_err": max((a.float() - r.float()).abs().max().item()
                               for a, r in zip(got, want)),
            "lse_ratio_to_limit": lse_ratio}


def phase_flash_bwd(cases_f, mutant: Path, tc_mutant: Path) -> dict:
    """The backward kernel against its plain version over
    :func:`flash_bwd_cases` (and the forward's lse), every bf16 D = 64/96/128
    case on the "wgmma" route with the kernel's plan equal to
    ``bwd_launch_plan``, a head dim without an instance refused, then each
    route's mutant without ``- delta`` through the same wrapper over that
    route's multi-tile cases: more than half must fail."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (BWD_TC_HEAD_DIMS, _declare_bwd,
                                                     flash_attention_bwd)

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = flash_bwd_cases()
    rows, failures = [], []
    for case in cases:
        c = flash_bwd_case_check(case, g)
        cases_f.write(json.dumps({"flash_bwd": c}) + "\n")
        rows.append(c)
        tc = case[9] == torch.bfloat16 and case[5] in BWD_TC_HEAD_DIMS
        if not (c["worst_ratio"] <= 1.0 and c["lse_ratio_to_limit"] <= 1.0
                and c["plan_equal"] and (c["route"] == "wgmma") == tc):
            failures.append(c)
    x = torch.zeros(1, 8, 2, 256, device="cuda")
    lse = torch.zeros(1, 2, 8, device="cuda")
    try:
        flash_attention_bwd(x, x, x, x, x, lse)
        refused = False
    except ValueError:
        refused = True
    mutation = {}
    for route, path, line in (("simt", mutant, FLASH_BWD_MUTANT_LINE),
                              ("wgmma", tc_mutant, TC_FLASH_BWD_MUTANT_LINE)):
        multi = [case for case, c in zip(cases, rows)
                 if max(case[1], case[2]) > 64 and c["route"] == route]
        with _build.substitute("flash_attention_bwd", path, _declare_bwd):
            mut = [flash_bwd_case_check(case, g) for case in multi]
        for c in mut:
            cases_f.write(json.dumps({"flash_bwd_mutant": c}) + "\n")
        mutation[route] = {"dropped": line, "multi_tile_cases": len(mut),
                           "outside_limit": sum(not c["worst_ratio"] <= 1.0 for c in mut),
                           "min_ratio_to_limit": min(c["worst_ratio"] for c in mut)}
    by = {}
    for c in rows:
        key = f"{c['route']} {c['dtype']} D={c['bsthd'][5]}"
        by[key] = max(by.get(key, 0.0), c["worst_ratio"])
    routes = {r: sum(c["route"] == r for c in rows) for r in ("wgmma", "simt")}
    row = {"cases": len(rows), "cases_by_route": routes,
           "limits": {"float32": FLASH_BWD_LIMIT[torch.float32],
                      "bfloat16": FLASH_BWD_LIMIT[torch.bfloat16], "lse": LSE_LIMIT},
           "worst_ratio_by_route_and_head_dim": by,
           "worst_lse_ratio": max(c["lse_ratio_to_limit"] for c in rows),
           "plans_equal": all(c["plan_equal"] for c in rows),
           "musicgen_shape": rows[cases.index(MUSICGEN_BWD_CASE)], "d256_refused": refused,
           "failures": failures[:5]}
    emit("flash_bwd", t0, **row)
    for route, m in mutation.items():
        emit("mutation", t0, kernel="flash_attention_bwd", route=route, **m)
    if failures or not refused:
        raise SystemExit(f"flash_bwd: {len(failures)} cases outside their limits, off their "
                         f"route or with another plan; D = 256 refused: {refused}")
    for route, m in mutation.items():
        if not m["outside_limit"] > m["multi_tile_cases"] / 2:
            raise SystemExit(f"flash_bwd {route} mutant: only {m['outside_limit']} of "
                             f"{m['multi_tile_cases']} multi-tile cases outside their limit")
    return row


def phase_scan_grads() -> dict:
    """Each scan's autograd function (kernel forward, plain-recompute
    backward) against plain autograd through its plain version on the card:
    the gradient of every input within 2e-4."""
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain_model
    from repro_torch.kernels.rwkv6_scan import rwkv6_chunk_scan, rwkv6_chunk_scan_plain_heads

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def grads(fn, inputs, weights):
        leaves = [x.clone().requires_grad_() for x in inputs]
        y, state = fn(leaves)
        ((y * weights[0]).sum() + (state * weights[1]).sum()).backward()
        return [x.grad for x in leaves], type(y.grad_fn).__name__

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    # the inputs as the kernel phases draw them (the JAX kernel tests'
    # decays: a chunk's cumulative log decay stays inside exp's f32 range)
    b, s, h, n = SCAN_GRAD_RWKV
    rw_in = list(rwkv_inputs((b, s, h, n, RWKV_CHUNK, torch.float32, False), SEED)[:5])
    rw_w = (rand(b, s, h, n), rand(b, h, n, n))
    b, s, c, n = SCAN_GRAD_MAMBA
    mb_in = list(mamba_inputs((b, s, c, n, MAMBA_CHUNK, MAMBA_BD, torch.float32, False),
                              SEED)[:5])
    mb_w = (rand(b, s, c), rand(b, c, n))
    out, ok = {}, True
    for name, inputs, weights, kern, plain in (
            ("rwkv6_scan", rw_in, rw_w,
             lambda x: rwkv6_chunk_scan(*x, chunk=RWKV_CHUNK),
             lambda x: rwkv6_chunk_scan_plain_heads(*x, chunk=RWKV_CHUNK)),
            ("mamba_scan", mb_in, mb_w,
             lambda x: mamba_scan(*x, chunk=MAMBA_CHUNK, bd=MAMBA_BD),
             lambda x: mamba_scan_plain_model(*x, chunk=MAMBA_CHUNK))):
        got, fn_name = grads(kern, inputs, weights)
        want, _ = grads(plain, inputs, weights)
        torch.cuda.synchronize()
        ratio = max(((a - w).abs() / (SCAN_LIMIT_GRAD + SCAN_LIMIT_GRAD * w.abs())).max().item()
                    for a, w in zip(got, want))
        out[name] = {"grad_fn": fn_name, "inputs": len(got), "worst_ratio_to_limit": ratio}
        ok = ok and ratio <= 1.0 and fn_name in ("RWKV6ScanBackward", "MambaScanBackward")
    emit("scan_grads", t0, rwkv_bshn=list(SCAN_GRAD_RWKV), mamba_bscn=list(SCAN_GRAD_MAMBA),
         limit=SCAN_LIMIT_GRAD, **out)
    if not ok:
        raise SystemExit(f"scan_grads: {out}")
    return out


class PlainFlash(torch.autograd.Function):
    """Flash attention's plain forward and plain backward on CUDA tensors:
    what a training step is held against."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, bq, bk):
        from repro_torch.kernels.flash_attention import flash_attention_plain

        out, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                         softcap=softcap, bq=bq, bk=bk, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, bk=bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.flash_attention import flash_attention_bwd_plain

        q, k, v, out, lse = ctx.saved_tensors  # read once: the remat unpacks each once
        return (*flash_attention_bwd_plain(q, k, v, out, dout, lse, **ctx.opts),
                None, None, None, None, None)


def train_grads(cfg, batch, plain: bool) -> dict:
    """The gradients of one loss evaluation of ``cfg`` at seeded weights on
    ``batch``, through the flash kernels or (``plain``) their plain versions."""
    import importlib

    from repro_torch.models import steps as S

    # the module (``repro_torch.kernels.flash_attention`` the attribute is
    # the ops function of that name)
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    params, _ = S.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                   "cuda")
    kernel_fn = FA.FlashAttention
    if plain:
        FA.FlashAttention = PlainFlash
    try:
        loss, _ = S.make_loss_fn(cfg)(params, batch)
        loss.backward()
    finally:
        FA.FlashAttention = kernel_fn
    # the embedding table of an embeds frontend gets no gradient (zeros)
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
            for k, p in params.named_parameters()}


def phase_train_model(out_dir: Path) -> dict:
    """Path train's model phase: musicgen-large at its published widths (48
    layers, bf16, f32 master and moments, remat "block", registry=None)
    takes TRAIN_STEPS AdamW steps on one repeated 4 x 1024 batch from the
    data pipeline, launches counted from 0 just before and read just after;
    then one traced step, and a step's gradients with the kernels against
    the plain flash at the same widths cut to 2 layers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset
    from repro_torch.models import steps as S
    from repro_torch.optim.schedules import constant

    t0 = time.perf_counter()
    cfg = get_config("musicgen-large")
    b, s = TRAIN_BATCH
    ds = make_dataset(cfg, None, seed=SEED, global_batch=b, seq_len=s)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in ds.batch(0).items()}
    torch.cuda.reset_peak_memory_stats()
    params, opt = S.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                     "cuda")
    state_bytes = torch.cuda.memory_allocated()
    step = S.make_train_step(cfg, constant(TRAIN_LR), weight_decay=0.1, max_grad_norm=1.0)
    torch.cuda.synchronize()
    reset_launches()  # the path's main drive starts here
    losses, gnorms, times = [], [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = read_launches()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    traced = device_times(prof, wall, out_dir / "trace.json")
    # the step's device time by kernel name, largest first (what "other" is)
    by_name = sorted(((e.key, getattr(e, "self_device_time_total", 0.0) / 1e3)
                      for e in prof.key_averages()), key=lambda kv: -kv[1])
    traced["top_device_ms"] = [[name[:80], ms] for name, ms in by_name[:12]]
    del params, opt, m, step
    gc.collect()
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    kern = train_grads(cut, batch, plain=False)
    plain = train_grads(cut, batch, plain=True)
    per_leaf = {k: ((kern[k] - plain[k]).abs().max()
                    / plain[k].abs().max().clamp_min(1e-30)).item() for k in kern}
    worst = max(per_leaf, key=per_leaf.get)
    del kern, plain
    gc.collect()
    torch.cuda.empty_cache()

    p50 = sorted(times[1:])[len(times[1:]) // 2]
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab, "dtype": cfg.dtype, "params": cfg.param_count(),
           "remat": cfg.remat_policy, "batch": [b, s], "steps": TRAIN_STEPS, "lr": TRAIN_LR,
           "loss": losses, "grad_norm": gnorms, "step_s": times, "step_ms_p50": p50 * 1e3,
           "tokens_per_s": b * s / p50, "state_bytes": state_bytes,
           "max_memory_allocated": peak, "launches": launches, "launches_per_step": per_step,
           "traced_step": {k: traced.get(k) for k in (
               "wall_ms", "busy_ms", "device_ms", "flash_attention_ms",
               "flash_attention_bwd_ms", "other_ms", "idle_share", "top_device_ms")},
           "kernel_vs_plain": {"layers": TRAIN_CHECK_LAYERS, "worst_leaf": worst,
                               "worst": per_leaf[worst], "limit": TRAIN_CHECK_LIMIT,
                               "median": float(np.median(list(per_leaf.values())))}}
    emit("train_model", t0, **row)
    check_path_launches("train", launches, ("flash_attention", "flash_attention_bwd"))
    checks = {
        f"params == {MUSICGEN_PARAMS:,}": row["params"] == MUSICGEN_PARAMS,
        "loss and grad norm finite": all(np.isfinite(losses + gnorms)),
        "loss falls (loss[3] < loss[0])": losses[3] < losses[0],
        "peak memory under 80 GB": peak < CARD_BYTES,
        f"flash forward {2 * cfg.n_layers} a step": launches["flash_attention"]
            == 2 * cfg.n_layers * TRAIN_STEPS,
        f"flash backward {cfg.n_layers} a step": launches["flash_attention_bwd"]
            == cfg.n_layers * TRAIN_STEPS,
        f"kernel vs plain gradients <= {TRAIN_CHECK_LIMIT}": per_leaf[worst] <= TRAIN_CHECK_LIMIT,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"train_model failed: {bad}")
    return row


def start_train_launcher(args: list) -> subprocess.Popen:
    """``repro_torch.launch.train`` in a subprocess with ``args``, which
    prints the kernels' launch counts after it returns (read it with
    :func:`train_launcher_result`)."""

    code = ("import json, sys; sys.path.insert(0, 'src');"
            "from repro_torch.launch import train;"
            "from repro_torch.kernels.flash_attention import flash_attention,"
            " flash_attention_bwd;"
            "from repro_torch.kernels.mamba_scan import mamba_scan;"
            "from repro_torch.kernels.matmul import matmul;"
            "from repro_torch.kernels.rwkv6_scan import rwkv6_chunk_scan;"
            "rc = train.main(sys.argv[1:]);"
            "fns = {'tiled_matmul': matmul, 'flash_attention': flash_attention,"
            " 'flash_attention_bwd': flash_attention_bwd,"
            " 'rwkv6_scan': rwkv6_chunk_scan, 'mamba_scan': mamba_scan};"
            "print('[launches]', json.dumps({k: f.launches for k, f in fns.items()}),"
            " flush=True);"
            "sys.exit(rc)")
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def train_launcher_result(proc: subprocess.Popen) -> tuple:
    """(summary, stdout, launch counts) of a run :func:`start_train_launcher`
    started; a run that fails or outlasts 600 s fails the phase."""
    import re

    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit(f"train launcher {proc.args[3:]} ran past 600 s")
    if proc.returncode != 0:
        raise SystemExit(f"train launcher {proc.args[3:]} failed:\n{err[-3000:]}")
    summary = json.loads(re.search(r"\[train\] done: (\{.*\})", out).group(1))
    counts = json.loads(re.search(r"\[launches\] (\{.*\})", out).group(1))
    return summary, out, counts


def phase_train_launcher() -> dict:
    """The launcher on the card, as subprocesses (four at once, the resume
    after its first run): olmoe's smoke config surviving an injected
    failure and resuming from its checkpoint, phi3-mini's with int8
    gradient compression, rwkv6-7b's and jamba's launching their scans;
    every loss falls."""
    t0 = time.perf_counter()
    ckpt = fresh_dir(ROOT / "build" / "train_ckpt")
    base = ["--batch", "2", "--seq", "32", "--save-every", "8", "--log-every", "8"]
    olmoe = ["--arch", "olmoe-1b-7b", "--ckpt-dir", str(ckpt / "olmoe"), *base]
    procs = {"olmoe_fail": start_train_launcher(olmoe + ["--steps", "24", "--fail-at", "13"]),
             "phi3_compress": start_train_launcher(
                 ["--arch", "phi3-mini-3.8b", "--steps", "10", "--compress-grads",
                  "--ckpt-dir", str(ckpt / "phi3"), *base])}
    # six steps of the warmup (lr = 1e-2 x step / 10) move the loss by about
    # 1-2 at 4 x 128 tokens a batch; at 2 x 32 the batches' spread (~1) hides
    # it (the CPU probes of the same flags, six seeds each)
    for arch in ("rwkv6-7b", "jamba-v0.1-52b"):
        procs[arch] = start_train_launcher(["--arch", arch, "--steps", "6", "--ckpt-dir",
                                            str(ckpt / arch), "--batch", "4", "--seq", "128",
                                            "--lr", "1e-2", "--log-every", "8"])
    try:
        runs = {name: train_launcher_result(proc) for name, proc in procs.items()}
        procs["olmoe_resume"] = start_train_launcher(olmoe + ["--steps", "28"])
        runs["olmoe_resume"] = train_launcher_result(procs["olmoe_resume"])
    finally:  # a failed run stops the others
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    row = {name: {"summary": r[0], "launches": r[2]} for name, r in runs.items()}
    emit("train_launcher", t0, **row)
    s = {name: r[0] for name, r in runs.items()}
    checks = {
        "olmoe: 24 steps, 1 restart": s["olmoe_fail"]["steps"] == 24
            and s["olmoe_fail"]["restarts"] == 1,
        "olmoe: resumed from step 24": "resumed from step 24" in runs["olmoe_resume"][1]
            and s["olmoe_resume"]["steps"] == 28,
        "olmoe: flash forward and backward launched": runs["olmoe_fail"][2]["flash_attention"] > 0
            and runs["olmoe_fail"][2]["flash_attention_bwd"] > 0,
        "rwkv6-7b: the RWKV-6 scan launched": runs["rwkv6-7b"][2]["rwkv6_scan"] > 0,
        "jamba: the Mamba scan launched": runs["jamba-v0.1-52b"][2]["mamba_scan"] > 0,
        "every loss falls": all(s[k]["loss_last"] < s[k]["loss_first"]
                                for k in ("olmoe_fail", "phi3_compress", "rwkv6-7b",
                                          "jamba-v0.1-52b")),
        "no tiled matmul": all(r[2]["tiled_matmul"] == 0 for r in runs.values()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"train_launcher failed: {bad}")
    return row


# path dist (the distributed runtime on one card: a (1, 1) mesh of one nccl
# rank, parameters and optimizer state as DTensors)
DIST_MESH = ((1, 1), ("data", "model"))
# dist_train's loss against train_model's, step by step, relative: on a
# (1, 1) mesh every placement is Replicate and the arithmetic is the same;
# the first reading was 0.0 at all four steps (NVIDIA H100 80GB HBM3, 700
# W), so this allows only the grad norm's sums in another order (~8 f32
# ulps of a loss of ~160)
DIST_LOSS_LIMIT = 1e-6
DIST_SERVE = dict(batch=4, prompt_len=1024, decodes=4, max_len=1040)
# olmoe's logits under the mesh against the same weights without one, f32
# with every token routed to all 64 experts (no discrete choice to flip),
# every step, max abs diff / max abs: about twice the first reading, 9.7e-6
# (8.3e-6 in a second call; NVIDIA H100 80GB HBM3, 700 W).  In bf16 at
# top-8 the plain run reads 0.45 from its own repeat at prefill (the
# combine's index_add_ adds in no fixed order on the card, and routings
# flip), so bf16 is held with PyTorch's deterministic algorithms on, where
# the plain run repeats and the mesh's run equals it bit for bit
DIST_SERVE_LIMIT = 2e-5


def dist_store(out_dir: Path, name: str) -> str:
    """A fresh FileStore path under ``chiprun_out/`` (no sockets)."""
    path = out_dir / "dist" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    return str(path)


def phase_dist_train(mesh, train: dict) -> dict:
    """musicgen-large at its published widths under the mesh: parameters
    placed by the FSDP specs, the AdamW moments and master by the ZeRO
    specs, the same seed, batch and lr as train_model, TRAIN_STEPS steps
    (launches counted from 0 just before and read just after); each step's
    loss against train_model's for the same step; then one traced step."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset
    from repro_torch.models import steps as S
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import sharding as SH

    t0 = time.perf_counter()
    cfg = get_config("musicgen-large")
    b, s = TRAIN_BATCH
    ds = make_dataset(cfg, None, seed=SEED, global_batch=b, seq_len=s)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in ds.batch(0).items()}
    torch.cuda.reset_peak_memory_stats()
    params, opt = S.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                     "cuda", mesh=mesh)
    placed = S.distribute_batch(batch, mesh)
    step = S.make_train_step(cfg, constant(TRAIN_LR), weight_decay=0.1, max_grad_norm=1.0)
    kinds = sorted({type(p).__name__ for p in params.parameters()}
                   | {type(t).__name__ for t in opt.mu.values()})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, times = [], []
    with SH.use_mesh(mesh):
        reset_launches()  # the path's training drive starts here
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            params, opt, m = step(params, opt, placed)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
        launches = read_launches()  # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            params, opt, m = step(params, opt, placed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    traced = device_times(prof, wall, ROOT / "chiprun_out" / "trace.json")
    del params, opt, m, step, placed
    gc.collect()
    torch.cuda.empty_cache()
    p50 = sorted(times[1:])[len(times[1:]) // 2]
    diff = [abs(a - w) / abs(w) for a, w in zip(losses, train["loss"])]
    row = {"arch": cfg.name, "mesh": dict(zip(DIST_MESH[1], DIST_MESH[0])),
           "backend": "nccl", "leaf_types": kinds, "init_s": init_s,
           "loss": losses, "train_model_loss": train["loss"], "loss_rel_diff": diff,
           "loss_limit": DIST_LOSS_LIMIT, "step_s": times, "step_ms_p50": p50 * 1e3,
           "train_model_step_ms_p50": train["step_ms_p50"],
           "dtensor_overhead_ms": p50 * 1e3 - train["step_ms_p50"],
           "tokens_per_s": b * s / p50, "max_memory_allocated": peak, "launches": launches,
           "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items()},
           "traced_step": {k: traced.get(k) for k in (
               "wall_ms", "busy_ms", "flash_attention_ms", "flash_attention_bwd_ms",
               "other_ms", "idle_share")}}
    emit("dist_train", t0, **row)
    check_path_launches("dist_train", launches, ("flash_attention", "flash_attention_bwd"))
    checks = {
        "every leaf a DTensor": kinds == ["DTensor"] or all("DTensor" in k for k in kinds),
        f"flash forward {2 * cfg.n_layers} a step": launches["flash_attention"]
            == 2 * cfg.n_layers * TRAIN_STEPS,
        f"flash backward {cfg.n_layers} a step": launches["flash_attention_bwd"]
            == cfg.n_layers * TRAIN_STEPS,
        f"loss within {DIST_LOSS_LIMIT} of train_model's": max(diff) <= DIST_LOSS_LIMIT,
        "loss falls": losses[-1] < losses[0],
        "peak memory under 80 GB": peak < CARD_BYTES,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"dist_train failed: {bad}")
    return row


def _serve_steps(cfg, params, prompts, decodes: int, max_len: int, mesh=None,
                 feed=None) -> tuple:
    """prefill + ``decodes`` decode steps, under ``mesh`` if given, each step
    fed its own greedy token or, with ``feed`` (decodes, B), those tokens.
    Returns ([last logits, each decode step's logits] as plain f32 CUDA
    tensors, the greedy tokens (decodes, B), prefill ms, decode ms)."""
    from repro_torch.launch import serve as SV
    from repro_torch.models import steps as S
    from repro_torch.runtime import sharding as SH

    make_inputs = SV.input_fn(cfg, "cuda")
    place = (lambda x: S.distribute_batch(x, mesh)) if mesh is not None else (lambda x: x)
    prefill = S.make_prefill_step(cfg, max_len)
    decode = S.make_decode_step(cfg)
    ctx = SH.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    logits, greedy, dec_ms = [], [], []
    with ctx:
        torch.cuda.synchronize()
        t = time.perf_counter()
        last, caches, n = prefill(params, place(make_inputs(prompts)))
        last = SH.to_plain(last)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t) * 1e3
        for i in range(decodes + 1):
            logits.append(last.float())
            greedy.append(torch.argmax(last, -1).cpu().numpy())
            if i == decodes:
                break
            tok = greedy[-1] if feed is None else feed[i]
            t = time.perf_counter()
            _, step_logits, caches = decode(params, place(make_inputs(tok[:, None])), caches,
                                            n + i)
            last = SH.to_plain(step_logits)[:, -1]
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t) * 1e3)
    del caches
    return logits, np.stack(greedy[:decodes]), pre_ms, dec_ms


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms (``index_add_`` on the card adds in
    a fixed order), their warnings for ops that have none silenced."""
    import warnings as warn

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warn.catch_warnings():
            warn.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def _repeat(run, ref) -> dict:
    """One ``_serve_steps`` run against another: each step's max abs diff /
    max abs, whether every step's logits are equal bit for bit, and whether
    the greedy tokens are."""
    rel = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(run[0], ref[0])]
    return {"rel_diff_by_step": rel,
            "bitwise_equal": all(bool(torch.equal(a, b)) for a, b in zip(run[0], ref[0])),
            "tokens_equal": bool(np.array_equal(run[1], ref[1]))}


def _unplace(params) -> None:
    """DTensor parameters back to plain tensors, in place (their whole
    values)."""
    for mod in params.modules():
        for name, p in list(mod._parameters.items()):
            mod._parameters[name] = torch.nn.Parameter(p.full_tensor().detach(),
                                                       requires_grad=False)


def phase_dist_serve(mesh) -> dict:
    """olmoe-1b-7b at its published widths, bf16, registry=None, 4 x 1024
    and 4 greedy decode steps: without a mesh, then the same weights placed
    on the mesh (the TP specs) under it, each a warm-up run and a timed
    one, launches counted from 0 just before the mesh's first run and read
    just after (flash 16 a wave, the zoo path's).  In bf16 each run is
    recorded against its repeat (the combine's ``index_add_`` adds in no
    fixed order on the card).  The checks: with PyTorch's deterministic
    algorithms on (the combine then adds in a fixed order), the bf16 plain
    run against its repeat and the mesh's run fed the same tokens against
    the plain one, bit for bit; and the same weights widened to f32 with
    every token routed to all experts (no discrete routing choice), without
    the mesh and then under it fed the same tokens: every step's logits,
    and the greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import steps as S

    t0 = time.perf_counter()
    cfg = get_config("olmoe-1b-7b")
    bsz, plen, decodes, max_len = (DIST_SERVE[k] for k in ("batch", "prompt_len", "decodes",
                                                           "max_len"))
    torch.cuda.reset_peak_memory_stats()
    params = SV.init_model(cfg, SEED, "cuda")
    wave = SV.request_pool(cfg, bsz, plen, 1, SEED)
    prompts = np.stack([r.prompt for r in wave])
    args = (prompts, decodes, max_len)
    plain = [_serve_steps(cfg, params, *args) for _ in range(2)]
    with _deterministic():
        det_plain = [_serve_steps(cfg, params, *args) for _ in range(2)]
    S.place_params(params, cfg, mesh, "tp")
    reset_launches()  # the path's serving drive starts here
    placed = [_serve_steps(cfg, params, *args, mesh=mesh)]
    launches = read_launches()  # ... and ends here
    placed.append(_serve_steps(cfg, params, *args, mesh=mesh))
    with _deterministic():
        det_mesh = _serve_steps(cfg, params, *args, mesh=mesh, feed=det_plain[0][1])
    served = {"prefill_ms": placed[1][2], "plain_prefill_ms": plain[1][2],
              "decode_ms_p50": float(np.median(placed[1][3])),
              "plain_decode_ms_p50": float(np.median(plain[1][3])),
              "first_run_prefill_ms": [plain[0][2], placed[0][2]],
              "prefill_rel_diff_bf16": ((placed[1][0][0] - plain[1][0][0]).abs().max()
                                        / plain[1][0][0].abs().max()).item(),
              "tokens_equal_bf16": bool(np.array_equal(placed[1][1], plain[1][1])),
              "plain_repeat": _repeat(plain[1], plain[0]),
              "mesh_repeat": _repeat(placed[1], placed[0]),
              "deterministic": {"plain_repeat": _repeat(det_plain[1], det_plain[0]),
                                "mesh_vs_plain": _repeat(det_mesh, det_plain[0])},
              "finite": all(bool(torch.isfinite(x).all()) for x in placed[1][0])}
    del plain, placed, det_plain, det_mesh
    # the check, in f32 with dense routing: on the mesh, then without it
    dense = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.n_experts, capacity_factor=1.0))
    _unplace(params)
    params.float()
    off_mesh = _serve_steps(dense, params, *args)
    S.place_params(params, dense, mesh, "tp")
    on_mesh = _serve_steps(dense, params, *args, mesh=mesh, feed=off_mesh[1])
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(on_mesh[0], off_mesh[0])]
    peak = torch.cuda.max_memory_allocated()
    row = {"arch": cfg.name, "params": sum(p.numel() for p in params.parameters()),
           "mesh": dict(zip(DIST_MESH[1], DIST_MESH[0])), "batch": bsz, "prompt_len": plen,
           "decodes": decodes, "launches": launches, "served_bf16": served,
           "check_f32_dense_routing": {"rel_diff_by_step": errs, "worst": max(errs),
                                       "tokens_equal": bool(np.array_equal(on_mesh[1],
                                                                           off_mesh[1])),
                                       "finite": all(bool(torch.isfinite(x).all())
                                                     for x in on_mesh[0])},
           "limit": DIST_SERVE_LIMIT, "max_memory_allocated": peak}
    del params, on_mesh, off_mesh
    gc.collect()
    torch.cuda.empty_cache()
    emit("dist_serve", t0, **row)
    check_path_launches("dist_serve", launches, ("flash_attention",))
    c = row["check_f32_dense_routing"]
    det = served["deterministic"]
    checks = {
        "flash 16 a wave": launches["flash_attention"] == cfg.n_layers,
        "bf16 deterministic: the plain run repeats bit for bit":
            det["plain_repeat"]["bitwise_equal"],
        "bf16 deterministic: the mesh's run equals the plain one bit for bit":
            det["mesh_vs_plain"]["bitwise_equal"] and det["mesh_vs_plain"]["tokens_equal"],
        f"f32 dense routing within {DIST_SERVE_LIMIT}": c["worst"] <= DIST_SERVE_LIMIT,
        "f32 dense routing: equal greedy tokens": c["tokens_equal"],
        "finite logits": c["finite"] and served["finite"],
        "peak memory under 80 GB": peak < CARD_BYTES,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"dist_serve failed: {bad}")
    return row


def phase_dist_roofline(train: dict, dist_train: dict, card: str, smi: str) -> dict:
    """The training cell's roofline on the H100's constants
    (``analysis/roofline.py``): model FLOPs of a musicgen-large step at 4 x
    1024, ``train_mfu`` = model FLOPs / (p50 x PEAK_FLOPS) for train_model
    and dist_train, and the step's ``RooflineTerms`` from an analytic
    record: executed FLOPs (the model's, with the remat recompute of the
    forward: 4/3) and the parameters' and optimizer's bytes (bf16 weights
    read three times and their gradient written and read, the f32 moments
    and master read and written, the weights written: 38 bytes a parameter;
    activations not counted, so a lower bound)."""
    from repro_torch.analysis import roofline as RF
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell

    t0 = time.perf_counter()
    cfg = get_config("musicgen-large")
    b, s = TRAIN_BATCH
    cell = ShapeCell("train_1k", s, b, "train")
    mf = RF.model_flops(cfg, cell)
    n = cfg.param_count()
    peak_gib = dist_train["max_memory_allocated"] / 2 ** 30
    terms = RF.RooflineTerms(arch=cfg.name, shape=f"train {b}x{s}", mesh="1x1", chips=1,
                             flops=mf * 4 / 3, mem_bytes=38.0 * n, coll_bytes=0.0,
                             model_flops_global=mf, hbm_gib=peak_gib,
                             fits_hbm=peak_gib <= RF.HBM_GIB).finalize()
    total = torch.cuda.get_device_properties(0).total_memory
    row = {"card": card, "nvidia_smi": smi, "peak_flops": RF.PEAK_FLOPS, "hbm_bw": RF.HBM_BW,
           "link_bw": RF.LINK_BW, "total_memory": total, "total_memory_gib": total / 2 ** 30,
           "hbm_gib_constant": RF.HBM_GIB, "cell": {"batch": b, "seq": s, "kind": "train"},
           "model_flops": mf,
           "train_mfu": {"train_model": mf / (train["step_ms_p50"] / 1e3 * RF.PEAK_FLOPS),
                         "dist_train": mf / (dist_train["step_ms_p50"] / 1e3 * RF.PEAK_FLOPS)},
           "terms": {"flops": terms.flops, "mem_bytes": terms.mem_bytes,
                     "t_compute_s": terms.t_compute, "t_memory_s": terms.t_memory,
                     "t_collective_s": terms.t_collective, "dominant": terms.dominant,
                     "t_step_s": terms.t_step, "useful_ratio": terms.useful_ratio,
                     "roofline_fraction_at_bound": terms.roofline_fraction,
                     "peak_gib": terms.hbm_gib, "fits_hbm": terms.fits_hbm}}
    emit("dist_roofline", t0, **row)
    if not abs(total / 2 ** 30 - RF.HBM_GIB) < 0.01:
        raise SystemExit(f"dist_roofline: HBM_GIB {RF.HBM_GIB} is not this card's "
                         f"{total / 2 ** 30:.4f} GiB")
    return row


def _dist_two_rank(rank: int, store: str, out: str) -> None:
    """One rank of the optional 2-rank dist_train (mesh (2, 1))."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import steps as S
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime import sharding as SH

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    mesh = make_mesh((2, 1), ("data", "model"), "cuda")
    cfg = get_config("musicgen-large")
    b, s = TRAIN_BATCH
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             make_dataset(cfg, None, seed=SEED, global_batch=b, seq_len=s).batch(0).items()}
    params, opt = S.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                     "cuda", mesh=mesh)
    step = S.make_train_step(cfg, constant(TRAIN_LR), weight_decay=0.1, max_grad_norm=1.0)
    losses = []
    with SH.use_mesh(mesh):
        for _ in range(TRAIN_STEPS):
            params, opt, m = step(params, opt, S.distribute_batch(batch, mesh))
            losses.append(float(m["loss"]))
    if rank == 0:
        Path(out).write_text(json.dumps(losses))
    dist.destroy_process_group()


def phase_dist(out_dir: Path, train: dict, card: str, smi: str) -> dict:
    """Path dist: one nccl rank on cuda:0 through a FileStore under
    ``chiprun_out/``, a (1, 1) mesh; dist_train, dist_serve, dist_roofline;
    with two cards or more also a 2-rank dist_train (mesh (2, 1)) held
    against the 1-rank loss."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.FileStore(dist_store(out_dir, "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(*DIST_MESH, "cuda")
        dtrain = phase_dist_train(mesh, train)
        gc.collect()
        torch.cuda.empty_cache()
        dserve = phase_dist_serve(mesh)
        roof = phase_dist_roofline(train, dtrain, card, smi)
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    two = {"ran": False, "cards": torch.cuda.device_count()}
    if torch.cuda.device_count() >= 2:
        import torch.multiprocessing as mp

        out = out_dir / "dist" / "two_rank.json"
        mp.spawn(_dist_two_rank, args=(dist_store(out_dir, "store2"), str(out)), nprocs=2)
        two2 = json.loads(out.read_text())
        diff = [abs(a - w) / abs(w) for a, w in zip(two2, dtrain["loss"])]
        two = dict(two, ran=True, loss=two2, loss_rel_diff=diff)
        if max(diff) > DIST_LOSS_LIMIT:
            raise SystemExit(f"dist_two_rank: loss {two2} against {dtrain['loss']}")
    else:
        two["note"] = "one card: the 2-rank dist_train (mesh (2, 1)) did not run"
    emit("dist_two_rank", t0, **two)
    return {"launches": {k: dtrain["launches"][k] + dserve["launches"][k]
                         for k in dtrain["launches"]},
            "dist_train": dtrain, "dist_serve": dserve, "dist_roofline": roof}


def phase_dist_ceiling(rows_bf16: list) -> None:
    """dist_roofline's last check, once the six bf16 contractions are
    timed: neither the tiled matmul's nor cuBLAS's measured TFLOP/s may
    exceed PEAK_FLOPS, or the constant is no ceiling."""
    from repro_torch.analysis.roofline import PEAK_FLOPS

    t0 = time.perf_counter()
    rates = [{"mkn": r["mkn"], "kernel_tflops": r["tflops"],
              "library_tflops": 2 * math.prod(r["mkn"]) / r["library_ms"] / 1e9}
             for r in rows_bf16]
    top = max(max(r["kernel_tflops"], r["library_tflops"]) for r in rates)
    emit("dist_roofline_ceiling", t0, peak_tflops=PEAK_FLOPS / 1e12, top_tflops=top,
         contractions=rates)
    if top * 1e12 > PEAK_FLOPS:
        raise SystemExit(f"a bf16 contraction ran at {top} TFLOP/s, over PEAK_FLOPS")


def phase_flash_bwd_timing(card: str, g) -> dict:
    """The backward kernel at musicgen-large's training shape (bf16, causal)
    against its plain version, autograd's backward of one SDPA call
    (yardstick only) and its bound (the function's five products; the
    design's seven, S and dP in both launches, beside it), with its route
    and plan; and the forward with and without its lse output."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     kernel_bwd_plan)

    t0 = time.perf_counter()
    flush = flush_buffer()
    b, s, h, d = TRAIN_FA_SHAPE
    dt = torch.bfloat16
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
                     for _ in range(4))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal=True)
    want = flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=True)
    torch.cuda.synchronize()
    max_abs = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse, causal=True), flush, 20)
    device_ms = events_device_ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse,
                                                             causal=True))
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=True),
                       flush, 3)
    fwd_ms = time_ms(lambda: flash_attention(q, k, v, causal=True), flush, 20)
    fwd_lse_ms = time_ms(lambda: flash_attention(q, k, v, causal=True, return_lse=True),
                         flush, 20)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do = dout.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do, retain_graph=True),
                         flush, 20)
    pairs = s * (s + 1) // 2
    flops = 10 * b * h * d * pairs  # S recomputed, dP, dv, dk, dq over the visible pairs
    nbytes = 8 * b * s * h * d * q.element_size() + 2 * b * h * s * 4  # q k v out dout dq dk dv; lse, delta
    peak = BF16_PEAK["pcie" if "PCIe" in card else "sxm"]
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    del flush
    design_ops_ms = 14 * b * h * d * pairs / peak * 1e3
    row = {"bshd": list(TRAIN_FA_SHAPE), "dtype": "bfloat16", "causal": True,
           "plan": kernel_bwd_plan(s, s, d=d, dtype=dt), "ms": ms,
           "device_ms": device_ms, "device_ms_source": "cuda_events", "plain_ms": plain_ms,
           "library_ms": library_ms, "library": "SDPA backward (autograd of one call)",
           "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "design_products": 7, "design_ops_ms": design_ops_ms,
           "tflops": flops / ms / 1e9, "max_abs_err": max_abs,
           "forward_ms": fwd_ms, "forward_with_lse_ms": fwd_lse_ms}
    emit("timing_flash_bwd", t0, **row)
    return row


# ---------------------------------------------------------------------------
# phase 6: timing against the bound and the library yardstick
# ---------------------------------------------------------------------------


def flush_buffer() -> torch.Tensor:
    """512 MiB to overwrite between timed launches: ten times L2, and long
    enough on the device (~0.16 ms) that the host's launch overhead (up to
    ~80 us a wrapper call) is hidden behind it and not timed."""
    return torch.empty(512 * 1024 * 1024 // 4, device="cuda")


SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's top SM clock


def events_device_ms(fn, reps: int = 10) -> float:
    """Mean ms that a call of ``fn`` holds the stream: CUDA events around
    ``reps`` back-to-back calls, all queued behind a spin kernel so that the
    host's launch time is hidden and not timed.  Every kernel the call
    launches is in it, with the gaps between them; no flush."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def kernel_device_ms(fn, name: str, reps: int = 10) -> tuple:
    """(mean device ms, its source) of ``reps`` back-to-back calls of ``fn``.
    Source ``"trace"``: the mean over the rows of the kernel whose name holds
    ``name`` in a ``torch.profiler`` chrome trace, the device's own time with
    no host time and no flush in it (the rows can be fewer than ``reps``).
    A trace can come back without its device rows, and once it has, the
    traces after it in the process may too: after three such traces the
    source is ``"cuda_events"``, ``events_device_ms`` of the whole call."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        path = ROOT / "build" / "kernel_trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        durs = [float(e["dur"]) for e in events
                if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATS
                and name in e.get("name", "")]
        if durs:
            return sum(durs) / len(durs) / 1e3, "trace"
    print(f"chip_smoke: three traces hold no {name} kernel; timed with CUDA events",
          file=sys.stderr, flush=True)
    return events_device_ms(fn, reps), "cuda_events"


def time_ms(fn, flush: torch.Tensor, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` launches, each after overwriting a
    buffer larger than L2 (a layer's weights are cold when it runs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def phase_timing(registry, card: str, g) -> list:
    from repro_torch.core.registry import current_hardware
    from repro_torch.kernels.matmul import launch_plan, matmul, matmul_plain

    t0 = time.perf_counter()
    peak = F32_PEAK["pcie" if "PCIe" in card else "sxm"]
    flush = flush_buffer()
    rows = []
    for (m, k, n) in CONTRACTIONS:
        entry = registry.get("mm", (m, k, n), hardware=current_hardware(), exact=True)
        blk = entry["block"]
        order = "nm" if [i for i in entry["grid_order"] if i in "mn"][0] == "n" else "mn"
        tuned = dict(bm=blk["m"], bk=blk["k"], bn=blk["n"], grid_order=order)
        a = torch.randn(m, k, generator=g, device="cuda")
        b = torch.randn(k, n, generator=g, device="cuda")
        out = matmul(a, b, **tuned)
        plain = matmul_plain(a, b, **tuned)
        torch.cuda.synchronize()
        max_abs = (out - plain).abs().max().item()
        err = rel_err(out, plain)
        if not err <= 1e-5:
            raise SystemExit(f"kernel vs plain at {(m, k, n)} block {tuned}: "
                             f"rel err {err} > 1e-5")
        ms = time_ms(lambda: matmul(a, b, **tuned), flush, 20)
        ms_default = time_ms(lambda: matmul(a, b), flush, 20)
        plain_ms = time_ms(lambda: matmul_plain(a, b, **tuned), flush, 3)
        library_ms = time_ms(lambda: torch.matmul(a, b), flush, 20)
        ops_ms = 2 * m * k * n / peak * 1e3
        bytes_ms = (m * k + k * n + m * n) * 4 / HBM_BYTES_PER_S * 1e3
        row = {"mkn": [m, k, n], "block": [blk["m"], blk["k"], blk["n"]],
               "grid_order": order,
               "plan": launch_plan(m, k, n, blk["m"], blk["k"], blk["n"], order),
               "ms": ms, "ms_128cubed": ms_default, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "tflops": 2 * m * k * n / ms / 1e9,
               "tflops_128cubed": 2 * m * k * n / ms_default / 1e9,
               "plan_128cubed": launch_plan(m, k, n), "max_abs_err": max_abs,
               "rel_err": err}
        rows.append(row)
        print(json.dumps({"phase": "timing_entry", **row}), flush=True)
    del flush
    emit("timing", t0, card=card, fp32_peak_flops=peak, hbm_bytes_per_s=HBM_BYTES_PER_S,
         **{k: sum(r[k] for r in rows)
            for k in ("ms", "ms_128cubed", "plain_ms", "library_ms", "bound_ms")})
    return rows


def phase_timing_bf16(registry, card: str, g) -> list:
    """The six contractions in bf16 at the model's tuned records, B (K, N)
    as the model stores the weight and bf16 out, as the model serves them:
    the tensor-core route, against the plain version, ``torch.matmul`` on
    the same bf16 operands (the library yardstick only) and the bf16 bound
    (bytes over 3.35 TB/s vs operations over the bf16 tensor peak)."""
    from repro_torch.core.registry import current_hardware
    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul import launch_plan, matmul, matmul_plain

    t0 = time.perf_counter()
    peak = BF16_PEAK["pcie" if "PCIe" in card else "sxm"]
    flush = flush_buffer()
    rows = []
    for (m, k, n) in CONTRACTIONS:
        block, order = ops._entry_schedule(registry.get(
            "mm", (m, k, n), "bfloat16", hardware=current_hardware(), exact=True))
        blk = (block["m"], block["k"], block["n"])
        kw = dict(bm=blk[0], bk=blk[1], bn=blk[2], grid_order=order)
        a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        b = torch.randn(k, n, generator=g, device="cuda").bfloat16()
        out = matmul(a, b, **kw)
        plain = matmul_plain(a, b, **kw)
        torch.cuda.synchronize()
        max_abs = (out.float() - plain.float()).abs().max().item()
        err = rel_err(out, plain)
        if not err <= limit_for(torch.bfloat16):
            raise SystemExit(f"bf16 kernel vs plain at {(m, k, n)} block {kw}: rel err {err}")
        ms = time_ms(lambda: matmul(a, b, **kw), flush, 20)
        device_ms, device_src = kernel_device_ms(lambda: matmul(a, b, **kw), "tc_matmul")
        plain_ms = time_ms(lambda: matmul_plain(a, b, **kw), flush, 3)
        library_ms = time_ms(lambda: torch.matmul(a, b), flush, 20)
        ops_ms = 2 * m * k * n / peak * 1e3
        bytes_ms = (m * k + k * n + m * n) * 2 / HBM_BYTES_PER_S * 1e3
        plan = launch_plan(m, k, n, *blk, order, dtype=torch.bfloat16)
        row = {"mkn": [m, k, n], "dtype": "bfloat16", "route": plan["route"],
               "block": list(blk), "grid_order": order, "plan": plan, "ms": ms,
               "device_ms": device_ms, "device_ms_source": device_src,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(ops_ms, bytes_ms), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "tflops": 2 * m * k * n / ms / 1e9, "max_abs_err": max_abs, "rel_err": err}
        rows.append(row)
        print(json.dumps({"phase": "timing_bf16_entry", **row}), flush=True)
    del flush
    emit("timing_bf16", t0, card=card, bf16_peak_flops=peak, hbm_bytes_per_s=HBM_BYTES_PER_S,
         ms=sum(r["ms"] for r in rows), device_ms=sum(r["device_ms"] for r in rows),
         bound_ms=sum(r["bound_ms"] for r in rows),
         library_ms=sum(r["library_ms"] for r in rows))
    if any(r["route"] != "wgmma" for r in rows):
        raise SystemExit("a bf16 record of the model is not on the tensor-core route")
    return rows


def flash_timing_row(shape, card: str, g, flush, dt=torch.bfloat16) -> dict:
    """Flash attention at a model's prefill shape (B, S, H, HKV, D), causal:
    the kernel, its plain version, SDPA (yardstick only) and the bound."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain, launch_plan)

    b, s, h, hkv, d = shape
    q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dt) for _ in range(2))
    out = flash_attention(q, k, v, causal=True)
    plain = flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    max_abs = (out.float() - plain.float()).abs().max().item()
    lim = ATTN_LIMIT[dt]
    if not max_abs <= lim + lim * plain.float().abs().max().item():
        raise SystemExit(f"flash attention at {shape} {dt}: max abs err {max_abs}")
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), flush, 20)
    device_ms, device_src = kernel_device_ms(lambda: flash_attention(q, k, v, causal=True),
                                             "flash_fwd")
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True), flush, 5)
    # the same call at other "fa" blocks: what the block mapping moves
    sweep = [{"block": list(blk), "plan": launch_plan(s, s, *blk, d=d, dtype=dt),
              "ms": time_ms(lambda: flash_attention(q, k, v, causal=True, bq=blk[0], bk=blk[1]),
                            flush, 20)}
             for blk in FLASH_SWEEP]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA takes (B, H, S, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=hkv != h),
                         flush, 20)
    size = q.element_size()
    bytes_ms = 2 * b * s * (h + hkv) * d * size / HBM_BYTES_PER_S * 1e3  # q, k, v, o once
    flops = 4 * b * h * d * s * (s + 1) // 2                              # visible pairs only
    peak = (BF16_PEAK if dt == torch.bfloat16 else F32_PEAK)["pcie" if "PCIe" in card else "sxm"]
    ops_ms = flops / peak * 1e3
    plan = launch_plan(s, s, d=d, dtype=dt)
    return {"bshkd": list(shape), "dtype": str(dt).replace("torch.", ""), "causal": True,
            "route": plan["route"], "plan": plan, "ms": ms, "device_ms": device_ms,
            "device_ms_source": device_src, "plain_ms": plain_ms, "block_sweep": sweep,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "peak_flops": peak,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "tflops": flops / ms / 1e9, "max_abs_err": max_abs}


def phase_flash_timing(card: str, g) -> list:
    """Flash attention at musicgen-large's and jamba's prefill shapes in
    bf16 (the tensor-core route, what the models run) and in f32 (the SIMT
    route), then at phi3-mini's (D = 96) and gemma3-12b's (D = 256) in bf16."""
    t0 = time.perf_counter()
    flush = flush_buffer()
    b, s, h, d = FA_SHAPE
    rows = [flash_timing_row(shape, card, g, flush, dt)
            for dt in (torch.bfloat16, torch.float32) for shape in ((b, s, h, h, d),
                                                                    FA_JAMBA_SHAPE)]
    rows += [flash_timing_row(shape, card, g, flush) for shape in (FA_PHI3_SHAPE,
                                                                   FA_GEMMA3_SHAPE)]
    del flush
    emit("timing_flash", t0, shapes=rows)
    return rows


def phase_rwkv_timing(card: str) -> dict:
    """The scan kernel at rwkv6-7b's prefill shape (bf16 r/k/v, f32 logw,
    a carried state, as the model passes it), against its plain version
    and its bound."""
    from repro_torch.kernels.rwkv6_scan import launch_plan, rwkv6_chunk_scan

    t0 = time.perf_counter()
    b, s, h, n = RWKV_SHAPE
    case = (b, s, h, n, RWKV_CHUNK, torch.bfloat16, True)
    r, k, v, logw, u, s0 = rwkv_inputs(case, SEED)
    flush = flush_buffer()
    y, st = rwkv6_chunk_scan(r, k, v, logw, u, chunk=RWKV_CHUNK, s0=s0)
    yp, sp = rwkv_plain(r, k, v, logw, u, s0, RWKV_CHUNK)
    torch.cuda.synchronize()
    max_abs = max((y - yp).abs().max().item(), (st - sp).abs().max().item())
    ms = time_ms(lambda: rwkv6_chunk_scan(r, k, v, logw, u, chunk=RWKV_CHUNK, s0=s0),
                 flush, 20)
    plain_ms = time_ms(lambda: rwkv_plain(r, k, v, logw, u, s0, RWKV_CHUNK), flush, 5)
    del flush
    device_ms = {}
    for name in ("rwkv6_chunk_intra", "rwkv6_state_walk"):
        ms_pass, src = kernel_device_ms(
            lambda: rwkv6_chunk_scan(r, k, v, logw, u, chunk=RWKV_CHUNK, s0=s0), name)
        if src != "trace":  # CUDA events time the whole call, both passes
            device_ms = {"call": ms_pass, "source": src}
            break
        device_ms[name] = ms_pass
    plan = launch_plan(s, RWKV_CHUNK, b=b, h=h, n=n, dtype=torch.bfloat16)
    L = plan["chunk"]
    # bytes: r, k, v (bf16), logw, u, s0 read once; y and the state written once
    nbytes = b * s * h * n * (3 * 2 + 4 + 4) + h * n * 4 + 2 * b * h * n * n * 4
    # operations, the least any form of the recurrence does: per token one
    # read-out r_t S (2N^2) and one rank-1 state update k_t^T v_t (2N^2);
    # decays, the u-bonus and the intra-chunk products counted as free
    flops = 4 * b * s * h * n * n
    # the chunked form at the kernel's tile, with only the strictly lower
    # triangle of r_dec k_dec^T and of A v: 4LN^2 + 2L(L-1)N a chunk and stream
    flops_chunked = b * h * plan["n_chunks"] * (4 * L * n * n + 2 * L * (L - 1) * n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_PEAK["pcie" if "PCIe" in card else "sxm"] * 1e3
    row = {"bshn": list(RWKV_SHAPE), "dtype": "bfloat16", "chunk": RWKV_CHUNK, "plan": plan,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bytes": nbytes, "flops": flops,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "flops_chunked": flops_chunked,
           "chunked_fp32_floor_ms": flops_chunked / F32_PEAK[
               "pcie" if "PCIe" in card else "sxm"] * 1e3,
           "chunked_gflops_per_s": flops_chunked / ms / 1e6, "device_ms_by_pass": device_ms,
           "max_abs_err": max_abs}
    emit("timing_rwkv", t0, **row)
    return row


def phase_mamba_timing(card: str) -> dict:
    """The Mamba scan at jamba's prefill shape (bf16 x, dt, b, c as strided
    views, f32 a, a carried state, the model's chunk and block), against
    its plain version and its bound."""
    from repro_torch.kernels.mamba_scan import launch_plan, mamba_scan, mamba_scan_plain_model

    t0 = time.perf_counter()
    b, s, c, n = MAMBA_SHAPE
    case = (b, s, c, n, MAMBA_CHUNK, MAMBA_BD, torch.bfloat16, True)
    x, dt, a, bm, cm, h0 = mamba_inputs(case, SEED)
    plan = launch_plan(s, c, MAMBA_CHUNK, MAMBA_BD)
    flush = flush_buffer()
    y, h = mamba_scan(x, dt, a, bm, cm, chunk=MAMBA_CHUNK, bd=MAMBA_BD, h0=h0)
    yp, hp = mamba_scan_plain_model(x, dt, a, bm, cm, chunk=plan["l"], h0=h0)
    torch.cuda.synchronize()
    max_abs = max((y - yp).abs().max().item(), (h - hp).abs().max().item())
    del yp, hp
    ms = time_ms(lambda: mamba_scan(x, dt, a, bm, cm, chunk=MAMBA_CHUNK, bd=MAMBA_BD, h0=h0),
                 flush, 20)
    plain_ms = time_ms(lambda: mamba_scan_plain_model(x, dt, a, bm, cm, chunk=plan["l"],
                                                      h0=h0), flush, 5)
    device_ms, device_src = kernel_device_ms(
        lambda: mamba_scan(x, dt, a, bm, cm, chunk=MAMBA_CHUNK, bd=MAMBA_BD, h0=h0), "mamba_scan")
    # the same call at other registry blocks: what a tuned "mamba" block
    # could move (tokens a tile, channels a CTA)
    sweep = []
    for chunk, bd in MAMBA_SWEEP:
        sweep.append({"block": [chunk, bd], "plan": launch_plan(s, c, chunk, bd),
                      "ms": time_ms(lambda: mamba_scan(x, dt, a, bm, cm, chunk=chunk, bd=bd,
                                                       h0=h0), flush, 20)})
    del flush
    # bytes: x and dt (bf16) read once, y (f32) written once; b and c (bf16),
    # a, h0 read once, the state written once
    nbytes = b * s * c * (2 * 2 + 4) + 2 * b * s * n * 2 + c * n * 4 + 2 * b * c * n * 4
    # operations per (t, c, n): one exponential e^{dt a} and five FP32 ones
    # (h <- e h + dtx B: two products and a sum; y += C h: a product and a sum)
    terms = b * s * c * n
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi_line("clocks.max.sm").split()[0])
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fp32_ms = 5 * terms / F32_PEAK["pcie" if "PCIe" in card else "sxm"] * 1e3
    exp_ms = terms / (SFU_EXP_PER_CLOCK * sms * clock_mhz * 1e6) * 1e3
    bound_ms = max(bytes_ms, fp32_ms, exp_ms)
    row = {"bscn": list(MAMBA_SHAPE), "dtype": "bfloat16", "block": [MAMBA_CHUNK, MAMBA_BD],
           "plan": plan, "ms": ms, "device_ms": device_ms, "device_ms_source": device_src,
           "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes" if bound_ms == bytes_ms else "operations",
           "bound_kind": ("bytes" if bound_ms == bytes_ms else
                          "exponentials" if bound_ms == exp_ms else "fp32"),
           "bytes_ms": bytes_ms, "fp32_ms": fp32_ms, "exp_ms": exp_ms, "bytes": nbytes,
           "exponentials": terms, "fp32_ops": 5 * terms, "sms": sms,
           "max_sm_clock_mhz": clock_mhz, "max_abs_err": max_abs, "block_sweep": sweep}
    emit("timing_mamba", t0, **row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    emit("device", t0, nvidia_smi=smi, name=card, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # the mutation checks' copies of four kernels: the RWKV-6 scan with its
    # u-bonus term dropped, the Mamba scan with the decay of each staged
    # tile's first token dropped, the flash kernel with the accumulator's
    # alpha rescale dropped on each route, the matmul with the last k step
    # of each route dropped
    mutants = {}
    for key, name, line, repl in (
            ("rwkv6_scan", "rwkv6_scan", MUTANT_LINE,
             "const float dg = 0.f;  // mutation: u-bonus dropped"),
            ("mamba_scan", "mamba_scan", MAMBA_MUTANT_LINE,
             "const float decay = i == 0 ? 1.f : ex2_approx(dtv * a2[n]);  // mutation"),
            ("flash_attention", "flash_attention", FLASH_MUTANT_LINE,
             "(void)0;  // mutation: no alpha rescale"),
            ("flash_simt", "flash_attention", SIMT_FLASH_MUTANT_LINE,
             "(void)alpha;  // mutation: no alpha rescale"),
            ("matmul", "matmul", MATMUL_MUTANT_LINE,
             "const int kchunks = (a.K + kChunk - 1) / kChunk - 1;  // mutation"),
            ("matmul_simt", "matmul", SIMT_MUTANT_LINE,
             "return (K + kd - 1) / kd - 1;  // mutation: the last k stage dropped"),
            ("flash_attention_bwd", "flash_attention_bwd", FLASH_BWD_MUTANT_LINE,
             "const float ds = pv * dp[i][j] * fac;  // mutation: - delta dropped"),
            ("flash_bwd_tc", "flash_attention_bwd", TC_FLASH_BWD_MUTANT_LINE,
             "const float ds = s[i] * dp[i];  // mutation: - delta dropped")):
        mutants[key] = ROOT / "build" / "mutant" / f"{key}_mutant.cu"
        mutants[key].parent.mkdir(parents=True, exist_ok=True)
        src = (_build.CSRC / f"{name}.cu").read_text()
        if src.count(line) != 1:
            raise SystemExit(f"mutation: {line!r} not found once in {name}.cu")
        mutants[key].write_text(src.replace(line, repl))

    t0 = time.perf_counter()
    names = ["matmul", "flash_attention", "flash_attention_bwd", "rwkv6_scan", "mamba_scan"]
    _build.build_all(names + list(mutants.values()))  # one nvcc per source, all at once
    hgmma = {}
    for name in ("flash_attention", "matmul", "flash_attention_bwd"):
        sass = subprocess.run(
            [str(Path(_build.nvcc()).parent / "cuobjdump"), "--dump-sass",
             str(_build.build(name))], capture_output=True, text=True, check=True).stdout
        hgmma[name] = sum("HGMMA" in ln for ln in sass.splitlines())

    def warnings(name: str) -> list:  # wgmma serialisation (C7520) and the like
        return [ln.strip() for ln in str(_build.BUILD_INFO[name]["log"]).splitlines()
                if "wgmma" in ln.lower() or "C7520" in ln]

    flash_kernels = ptxas_by_function(str(_build.BUILD_INFO["flash_attention"]["log"]),
                                      "flash_fwd")
    emit("build", t0, kernels=names,
         nvcc_s={n: round(float(_build.BUILD_INFO[n]["seconds"]), 3) for n in names},
         ptxas={n: sorted({ln.split(":")[-1].strip()
                           for ln in str(_build.BUILD_INFO[n]["log"]).splitlines()
                           if "Used" in ln and "registers" in ln or "spill" in ln})
                for n in names},
         flash_hgmma_in_sass=hgmma["flash_attention"],
         flash_wgmma_warnings=warnings("flash_attention"),
         matmul_hgmma_in_sass=hgmma["matmul"], matmul_wgmma_warnings=warnings("matmul"),
         flash_bwd_hgmma_in_sass=hgmma["flash_attention_bwd"],
         flash_bwd_wgmma_warnings=warnings("flash_attention_bwd"),
         matmul_c7519_arrive_injected=sum(
             "C7519" in ln for ln in str(_build.BUILD_INFO["matmul"]["log"]).splitlines()),
         # the two kernels redesigned last, kernel by kernel
         mamba_scan_kernels=ptxas_by_function(str(_build.BUILD_INFO["mamba_scan"]["log"]),
                                              "mamba_scan_fwd"),
         flash_simt_kernels={k: v for k, v in flash_kernels.items() if "simt" in k},
         flash_bwd_kernels=ptxas_by_function(
             str(_build.BUILD_INFO["flash_attention_bwd"]["log"]), "flash_bwd"),
         flash_tc_kernels={k: v for k, v in flash_kernels.items() if "_tc<" in k})
    for name, count in hgmma.items():
        if count == 0:
            raise SystemExit(f"the {name} library's SASS holds no HGMMA instruction")
    flash_kernels.update(ptxas_by_function(
        str(_build.BUILD_INFO["flash_attention_bwd"]["log"]), "flash_bwd"))
    spilled = {k: v for k, v in flash_kernels.items() if any(v.get("spill_bytes", [0]))}
    if spilled or not flash_kernels:
        raise SystemExit(f"flash instances that spill: {spilled} (of {len(flash_kernels)})")

    with open(out_dir / "chip_smoke_cases.jsonl", "w") as cases_f:
        phase_kernel(cases_f)
        phase_matmul_mutant(cases_f, mutants["matmul"], "wgmma", MATMUL_MUTANT_LINE)
        phase_matmul_mutant(cases_f, mutants["matmul_simt"], "simt", SIMT_MUTANT_LINE)
        phase_attention(cases_f)
        phase_attention_mutant(cases_f, mutants["flash_attention"], "wgmma", FLASH_MUTANT_LINE)
        phase_attention_mutant(cases_f, mutants["flash_simt"], "simt", SIMT_FLASH_MUTANT_LINE)
        phase_rwkv_scan(cases_f)
        phase_mamba_scan(cases_f)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    wts = layer_weights(g)
    reset_launches()  # the first path starts here
    registry, tune_rows = phase_tune(lambda: read_launches()["tiled_matmul"])
    phase_serve(registry, wts, g)
    by_path = {"tune_serve": read_launches()}  # ... and ends here
    check_path_launches("tune_serve", by_path["tune_serve"], ("tiled_matmul",))
    del wts
    reset_launches()  # the policy path starts here
    policy = phase_policy(out_dir, tune_rows, g)
    by_path["policy"] = read_launches()  # ... and ends here
    check_path_launches("policy", by_path["policy"], ("tiled_matmul",))
    gc.collect()
    reset_launches()  # the actor-critic path starts here
    phase_actor_critic(out_dir, policy, g)
    by_path["actor_critic"] = read_launches()  # ... and ends here
    check_path_launches("actor_critic", by_path["actor_critic"], ("tiled_matmul",))
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()  # the fleet path starts here (its workers count their own)
    fleet = phase_fleet(out_dir, g, sum(r["tune_s"] for r in tune_rows))
    by_path["fleet"] = fleet["launches"]  # ... and ends here
    check_path_launches("fleet", by_path["fleet"], ("tiled_matmul",))
    t0 = time.perf_counter()
    compare = pool_against_inproc(*fleet["compare"])
    emit("pool_against_inproc", t0, schedules=compare,
         ratio_min=min(r["ratio"] for r in compare if r["ratio"] is not None),
         ratio_max=max(r["ratio"] for r in compare if r["ratio"] is not None))
    # the policy paths' executors and their operands on the card sit in
    # reference cycles (the launch spies): free them before the model path
    gc.collect()
    torch.cuda.empty_cache()

    model, model_registry = phase_model(out_dir)  # the second path (counts set to 0 and read inside)
    gc.collect()
    torch.cuda.empty_cache()  # musicgen's tensors are gone before rwkv6-7b's
    model_rwkv = phase_model_rwkv(out_dir, mutants["rwkv6_scan"])  # the third path, likewise
    gc.collect()
    torch.cuda.empty_cache()  # rwkv6-7b's tensors are gone before jamba's
    model_jamba = phase_model_jamba(out_dir, mutants["mamba_scan"])  # the fourth path
    gc.collect()
    torch.cuda.empty_cache()
    zoo = phase_zoo(out_dir)  # the fifth path: seven models, each counted from 0 and read
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(model=model["launches"], model_rwkv=model_rwkv["launches"],
                   model_jamba=model_jamba["launches"], zoo=zoo["launches"])
    check_path_launches("model", model["launches"], ("tiled_matmul", "flash_attention"))
    check_path_launches("model_rwkv", model_rwkv["launches"], ("rwkv6_scan",))
    check_path_launches("model_jamba", model_jamba["launches"],
                        ("mamba_scan", "flash_attention"))
    check_path_launches("zoo", zoo["launches"], ("flash_attention",))

    # path train: the backward kernel against its plain version, the scans'
    # gradients, then musicgen-large trained at full width (counts set to 0
    # and read inside) and the launcher's runs (each in its own process)
    with open(out_dir / "chip_smoke_cases.jsonl", "a") as cases_f:
        phase_flash_bwd(cases_f, mutants["flash_attention_bwd"], mutants["flash_bwd_tc"])
    phase_scan_grads()
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train_model(out_dir)
    by_path["train"] = train["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_launcher()
    gc.collect()
    torch.cuda.empty_cache()

    # path dist: the distributed runtime on a (1, 1) mesh (counts set to 0
    # and read inside, around dist_train's steps and dist_serve's mesh run)
    dist = phase_dist(out_dir, train, card, smi)
    by_path["dist"] = dist["launches"]
    check_path_launches("dist", dist["launches"], ("flash_attention", "flash_attention_bwd"))
    gc.collect()
    torch.cuda.empty_cache()

    def launches(name: str) -> dict:
        per = {path: counts[name] for path, counts in by_path.items()}
        return {"launches": sum(per.values()), "launches_by_path": per}

    rows = phase_timing(registry, card, g)
    rows_bf16 = phase_timing_bf16(model_registry, card, g)
    phase_dist_ceiling(rows_bf16)
    fa = phase_flash_timing(card, g)
    # the headline sums musicgen-large's and jamba's bf16 shapes, as in
    # earlier slices; the zoo's D = 96 and 256 rows are in "by_head_dim"
    headline = [[FA_SHAPE[0], FA_SHAPE[1], FA_SHAPE[2], FA_SHAPE[2], FA_SHAPE[3]],
                list(FA_JAMBA_SHAPE)]
    fa_main = [r for r in fa if r["dtype"] == "bfloat16" and r["bshkd"] in headline]
    fa_bwd = phase_flash_bwd_timing(card, g)
    rw = phase_rwkv_timing(card)
    mb = phase_mamba_timing(card)
    def route_sums(rs: list) -> dict:
        return {k: sum(r[k] for r in rs) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    kernels = [{
        "name": "tiled_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:24",
        **launches("tiled_matmul"),
        "route_launches_model": {"tune": model["tune_route_launches"],
                                 "serve": model["serve_route_launches"]},
        # one pass over the six musicgen-large contractions in bf16 at the
        # model's tuned records, on the tensor-core route the model serves;
        # the f32 rows (the SIMT route, the tune -> serve path) beside them
        "max_abs_err": max(r["max_abs_err"] for r in rows_bf16),
        **route_sums(rows_bf16),
        "bound_by": ("operations" if sum(r["ops_ms"] for r in rows_bf16)
                     >= sum(r["bytes_ms"] for r in rows_bf16) else "bytes"),
        "device_ms": sum(r["device_ms"] for r in rows_bf16),
        "by_route": {"wgmma": route_sums(rows_bf16), "simt": route_sums(rows)},
        "shapes_bf16": rows_bf16,
        "shapes": rows,
        "tune": tune_rows,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        **launches("flash_attention"),
        # one pass over musicgen-large's and jamba's prefill shapes in bf16
        # (the tensor-core route the models run); every row, f32 and the
        # zoo's head dims included, is in "shapes"
        "max_abs_err": max(r["max_abs_err"] for r in fa_main),
        **{k: sum(r[k] for r in fa_main) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "by_head_dim": {f"D={r['bshkd'][4]}": {k: r[k] for k in (
                            "bshkd", "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                            "bound_by", "max_abs_err")}
                        for r in fa if r["dtype"] == "bfloat16" and r["bshkd"] not in headline},
        "bound_by": ("operations" if sum(r["ops_ms"] for r in fa_main)
                     >= sum(r["bytes_ms"] for r in fa_main) else "bytes"),
        "routes": sorted({r["route"] for r in fa_main}),
        "by_route": {route: {k: sum(r[k] for r in fa if r["route"] == route)
                             for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}
                     for route in ("wgmma", "simt")},
        "shapes": fa,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:190",
        "replaces_note": "_flash_bwd, the JAX model attention's hand-written backward (a jnp "
                         "custom_vjp): the JAX package has no Pallas backward kernel",
        **launches("flash_attention_bwd"),
        **{k: fa_bwd[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "library", "bshd", "dtype", "plan",
                                  "design_ops_ms", "forward_ms", "forward_with_lse_ms")},
    }, {
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:27",
        **launches("rwkv6_scan"),
        **{k: rw[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                              "bshn", "dtype", "chunk", "plan")},
        "library_ms": None,
        "library_note": "no single PyTorch call computes the chunked Finch recurrence",
    }, {
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:25",
        **launches("mamba_scan"),
        **{k: mb[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                              "bound_kind", "bytes_ms", "fp32_ms", "exp_ms", "bscn",
                              "dtype", "block", "plan")},
        "library_ms": None,
        "library_note": "no single PyTorch call computes the selective scan",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
