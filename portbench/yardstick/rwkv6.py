"""RWKV-6 "Finch" in the benchmark: what ``kinds/prefill_rwkv6.py`` and the
``*.prefill_rwkv6`` metrics need beside the decoder's modules.

- :func:`model_config`: the configuration's model as the program's
  ``ModelConfig`` (every layer an RWKV-6 time-mix and channel-mix, Finch's
  two LoRA ranks);
- :func:`make`, :func:`port_params`: the weights, one stacked tensor a
  kind over the layers, each drawn by its own generator from the run's
  seed and the kind (parts ``(7000, kind)``, apart from
  ``weights.KINDS``'), and the program's parameter tree of views of them;
- :func:`dense_sites`, :func:`dense_keys`, :func:`model_flops`,
  :func:`scan_work`, :func:`mix_work`: what a prefill of ``tokens`` rows
  computes and moves, counted from the configuration's shapes and nothing
  of the program;
- :func:`scan_checked`: every scan the program launches held, while it is
  open, to the reference's recurrence on the same inputs (``scan_rel``);
- :func:`control`: the cell's controls, the plain reference with fp8
  products (``control.py``'s, with this model's reference and comparisons)
  or with logw and the WKV state in bf16;
- :func:`dropped`: a fault planted in the program, ddlerp's LoRA term or
  the decay's LoRA left out of the time-mix while it is open.
"""
from __future__ import annotations

import contextlib
import math
import random
from typing import Dict, List, Optional, Tuple

import torch

from . import compare as C
from . import counting as N
from . import weights as W

#: H100 SXM float32 outside the tensor cores (data sheet, 700 W): the scan's
#: products are f32 FMAs
PEAK_F32_FLOPS = 67e12

#: (kind, draw): the order names each kind's generator
KINDS = ("embed", "lm_head", "final_norm", "norm_attn", "norm_ffn",
         "mu_x", "mu_w", "mu_k", "mu_v", "mu_r", "mu_g", "mix_lora_a", "mix_lora_b",
         "w0", "decay_lora_a", "decay_lora_b", "u", "ln_w", "ln_b",
         "w_r", "w_k", "w_v", "w_g", "w_o",
         "cmix_mu_k", "cmix_mu_r", "cmix_w_k", "cmix_w_v", "cmix_w_r")
_GEN = 7000
#: the lowered precisions of :func:`control`: products in fp8, or logw and
#: the WKV state in bf16
CONTROLS = ("fp8", "bf16_scan")


def model_config(model: Dict):
    """The program's ``ModelConfig``.  A program without Finch's ranks (no
    ``rwkv_mix_lora`` field) raises here, before anything is drawn."""
    from repro_torch.configs.base import DENSE, RWKV6, LayerSpec, ModelConfig

    heads = model["d_model"] // model["head_dim"]
    return ModelConfig(
        name=model["name"], n_layers=model["n_layers"], d_model=model["d_model"],
        n_heads=heads, n_kv_heads=heads, d_ff=model["d_ff"], vocab=model["vocab"],
        period=(LayerSpec(RWKV6, DENSE),), rwkv_head_dim=model["head_dim"],
        rwkv_mix_lora=model["mix_lora"], rwkv_decay_lora=model["decay_lora"],
        frontend=model["frontend"], tie_embeddings=False, dtype=model["dtype"],
        supports_long_context=True)


def shapes(model: Dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """Each kind's stacked shape, its type (``"model"`` or ``"float32"``) and
    how it is drawn: a positive scale s is normal(0, s); ``"gain"`` 1 +
    normal(0, 0.1); ``"unit"`` uniform(0, 1); ``"w0"`` Finch's decay ramp,
    as published.

    Every factor of ddlerp and of the decay is drawn non-zero (the
    published init zeroes the LoRAs' second factors), at scales at which
    the mechanisms move the output."""
    d, n_l, vocab, ff = model["d_model"], model["n_layers"], model["vocab"], model["d_ff"]
    hd, rm, rd = model["head_dim"], model["mix_lora"], model["decay_lora"]
    vec = ((n_l, d), "float32", "unit")
    mat = ((n_l, d, d), "model", d ** -0.5)
    return {
        "embed": ((vocab, d), "model", 1.0), "lm_head": ((vocab, d), "model", d ** -0.5),
        "final_norm": ((d,), "model", "gain"), "norm_attn": ((n_l, d), "model", "gain"),
        "norm_ffn": ((n_l, d), "model", "gain"),
        "mu_x": vec, "mu_w": vec, "mu_k": vec, "mu_v": vec, "mu_r": vec, "mu_g": vec,
        "mix_lora_a": ((n_l, d, 5 * rm), "model", d ** -0.5),
        "mix_lora_b": ((n_l, 5, rm, d), "model", 0.5 * rm ** -0.5),
        "w0": ((n_l, d), "float32", "w0"),
        "decay_lora_a": ((n_l, d, rd), "float32", d ** -0.5),
        "decay_lora_b": ((n_l, rd, d), "float32", rd ** -0.5),
        "u": ((n_l, d // hd, hd), "float32", 0.5),
        "ln_w": ((n_l, d), "float32", "gain"), "ln_b": ((n_l, d), "float32", 0.1),
        "w_r": mat, "w_k": mat, "w_v": mat, "w_g": mat, "w_o": mat,
        "cmix_mu_k": vec, "cmix_mu_r": vec,
        "cmix_w_k": ((n_l, d, ff), "model", d ** -0.5),
        "cmix_w_v": ((n_l, ff, d), "model", ff ** -0.5), "cmix_w_r": mat}


def draw(model: Dict, seed: int, kind: str, device: torch.device) -> torch.Tensor:
    shape, typ, how = shapes(model)[kind]
    dt = getattr(torch, model["dtype"] if typ == "model" else typ)
    g = W.generator(device, seed, _GEN, KINDS.index(kind))
    if how == "w0":
        # RWKV_Tmix_x060's decay_speed ramp -6 + 5 (n / (d - 1))^(0.7 + 1.3 l / (L - 1))
        n_l, d = shape
        n = torch.arange(d, device=device, dtype=torch.float64) / (d - 1)
        ratio = torch.arange(n_l, device=device, dtype=torch.float64) / max(n_l - 1, 1)
        return (-6.0 + 5.0 * n[None] ** (0.7 + 1.3 * ratio[:, None])).to(dt)
    if how == "unit":
        return torch.rand(shape, generator=g, device=device, dtype=dt)
    t = torch.randn(shape, generator=g, device=device, dtype=dt)
    if how == "gain":
        return t.mul_(0.1).add_(1.0)
    return t.mul_(how)


def make(model: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    return {kind: draw(model, seed, kind, device) for kind in KINDS}


#: the program's time-mix leaf of each kind that is not named alike
_TIME_MIX = {"decay_lora_a": "w_lora_a", "decay_lora_b": "w_lora_b"}
_TIME_MIX_KINDS = ("mu_x", "mu_w", "mu_k", "mu_v", "mu_r", "mu_g", "mix_lora_a",
                   "mix_lora_b", "w0", "decay_lora_a", "decay_lora_b", "u", "ln_w", "ln_b",
                   "w_r", "w_k", "w_v", "w_g", "w_o")


def port_params(w: Dict[str, torch.Tensor], model: Dict):
    """The program's parameter tree (``models.transformer.make_params``)
    whose leaves are views of the stacked tensors ``w``."""
    from repro_torch.models import transformer as T

    top = {"embed": {"table": w["embed"]}, "final_norm": w["final_norm"],
           "lm_head": w["lm_head"]}
    blocks = [{"norm_attn": w["norm_attn"][l], "norm_ffn": w["norm_ffn"][l],
               "rwkv": {_TIME_MIX.get(k, k): w[k][l] for k in _TIME_MIX_KINDS},
               "cmix": {k[len("cmix_"):]: w[k][l]
                        for k in ("cmix_mu_k", "cmix_mu_r", "cmix_w_k", "cmix_w_v",
                                  "cmix_w_r")}}
              for l in range(model["n_layers"])]
    return T.make_params(top, blocks, trainable=False)


def dense_sites(model: Dict, tokens: int) -> List[N.DenseSite]:
    """The full-width products of a prefill over ``tokens`` rows: the
    time-mix's r, k, v, g and o and the channel-mix's k, v and r a layer,
    and the head (f32 out) once.  The LoRAs are not dense sites."""
    d, ff, dt, n_l = model["d_model"], model["d_ff"], model["dtype"], model["n_layers"]
    per_layer = [("w_r", d, d), ("w_k", d, d), ("w_v", d, d), ("w_g", d, d), ("w_o", d, d),
                 ("cmix_w_k", d, ff), ("cmix_w_v", ff, d), ("cmix_w_r", d, d)]
    sites = [N.DenseSite(name, tokens, k, n, dt, dt, n_l) for name, k, n in per_layer]
    sites.append(N.DenseSite("lm_head", tokens, d, model["vocab"], dt, "float32", 1))
    return sites


def dense_keys(model: Dict, tokens: int) -> Dict[Tuple[int, int, int, str], int]:
    """Launches a prefill of each registry key (m, k, n, dtype)."""
    out: Dict[Tuple[int, int, int, str], int] = {}
    for s in dense_sites(model, tokens):
        out[s.key] = out.get(s.key, 0) + s.count
    return out


def lora_flops_per_token(model: Dict) -> float:
    """ddlerp's LoRA (d x 5r, then five r x d) and the decay's (d x rd, rd x
    d), 2 FLOPs a multiply-add."""
    d, rm, rd = model["d_model"], model["mix_lora"], model["decay_lora"]
    return 2.0 * (d * 5 * rm + 5 * rm * d) + 2.0 * (d * rd + rd * d)


def scan_flops_per_token(model: Dict) -> float:
    """The least any form of the recurrence does a token and layer: the
    read-out r_t S and the rank-1 update k_t^T v_t, 2 N^2 each a head
    (``analysis/roofline.py``'s 4 H N^2)."""
    n = model["head_dim"]
    return 4.0 * (model["d_model"] // n) * n * n


def model_flops(model: Dict, batch: int, seq: int) -> float:
    """Useful FLOPs of one prefill: the eight products a layer and the
    head (2 per multiply-add, no embedding gather), the two LoRAs and the
    scan's 4 H N^2 a token and layer."""
    d, ff = model["d_model"], model["d_ff"]
    per_token_layer = (2.0 * (6 * d * d + 2 * d * ff) + lora_flops_per_token(model)
                       + scan_flops_per_token(model))
    tokens = batch * seq
    return tokens * (model["n_layers"] * per_token_layer + 2.0 * d * model["vocab"])


def scan_work(model: Dict, batch: int, seq: int) -> Tuple[float, float]:
    """(operations, bytes) of one layer's scan over (batch, seq): r, k, v
    read at the model's type, logw at f32, u and the carried state read,
    y (f32) and the final state written, each once."""
    d, n = model["d_model"], model["head_dim"]
    h = d // n
    elem = N.DTYPE_BYTES[model["dtype"]]
    streams = batch * seq * d * (3 * elem + 4 + 4)
    state = 2 * batch * h * n * n * 4
    return batch * seq * scan_flops_per_token(model), float(streams + state + d * 4)


def mix_work(model: Dict, batch: int, seq: int) -> Tuple[float, float]:
    """(operations, bytes) of one layer's token shift, ddlerp and decay:
    the LoRAs' products; x and the carry x_prev read at the model's type,
    the LoRAs and the six mu and w0 read, the five mixed streams written at
    the model's type and logw at f32, each once."""
    d, rm, rd = model["d_model"], model["mix_lora"], model["decay_lora"]
    elem = N.DTYPE_BYTES[model["dtype"]]
    tokens = batch * seq
    acts = tokens * d * (elem + 5 * elem + 4) + batch * d * elem
    params = 10 * rm * d * elem + 2 * rd * d * 4 + 7 * d * 4
    return tokens * lora_flops_per_token(model), float(acts + params)


def sampled_waves(traffic: Dict, seed: int) -> List[int]:
    rng = random.Random(W.sub_seed(seed, 3000))
    return sorted(rng.sample(range(traffic["sample_from"]), traffic["sampled_waves"]))


def worst(*values: float) -> float:
    """The largest reading, NaN where any is NaN (a value that could not be
    read must fail, where ``max`` would pass over it)."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def state_errors(caches, l: int, s, xt, xc) -> float:
    """The worst of layer ``l``'s final WKV state and two carries in the
    program's cache against the reference's."""
    c = caches[0]
    return worst(C.rel_err(c["s"][l], s), C.rel_err(c["xt"][l], xt),
                 C.rel_err(c["xc"][l], xc))


@contextlib.contextmanager
def scan_checked(ref, out: Dict[str, float], each: Optional[List[float]] = None):
    """While open, every scan the program's time-mix launches is held to
    the reference's recurrence (``ref.wkv``, f32) on the same inputs: the
    worst of the output's and the final state's relative errors over the
    scans goes to ``out["scan_rel"]``, and each scan's to ``each`` when
    given.  A scan from a carried state other than zero raises: the
    reference starts from zero."""
    from repro_torch.kernels import ops as K

    real = K.rwkv6_chunk_scan

    def checked(r, k, v, logw, u, **kw):
        y, state = real(r, k, v, logw, u, **kw)
        s0 = kw.get("s0")
        if s0 is not None and bool(s0.any()):
            raise ValueError("scan_checked: the reference's recurrence starts from zero")
        want_y, want_s = ref.wkv(r.float(), k.float(), v.float(), logw.float(), u.float())
        err = worst(C.rel_err(y, want_y), C.rel_err(state, want_s))
        out["scan_rel"] = worst(out.get("scan_rel", 0.0), err)
        if each is not None:
            each.append(err)
        return y, state

    K.rwkv6_chunk_scan = checked
    try:
        yield
    finally:
        K.rwkv6_chunk_scan = real


def control(cell, seed: int, device: torch.device, lowered: str = "fp8"
            ) -> Dict[str, float]:
    """The plain reference with a lower precision in the program's place,
    over the waves a run of the seed would check, against the f32
    reference: the last logits, every layer's state and carries, the
    reference logit gap of its argmax at every position, and each layer's
    recurrence against the f32 one on the same inputs (``scan_rel``).
    ``lowered``: ``"fp8"``, the products in fp8 (the recurrence f32, so
    ``scan_rel`` reads 0); ``"bf16_scan"``, logw and the WKV state in bf16
    (``ref.wkv``'s ``state_dtype``), the products f32."""
    if lowered not in CONTROLS:
        raise ValueError(f"control: {lowered!r} is one of {CONTROLS}")
    model, traffic = cell.model, cell.traffic
    B, L = traffic["clients"], traffic["prompt_len"]
    ref = cell.reference()
    ref.no_tf32()
    w = make(model, seed, device)
    out = {"logits_rel": 0.0, "state_rel": 0.0, "token_gap": 0.0, "scan_rel": 0.0}
    matmul = C.fp8_matmul if lowered == "fp8" else ref.f32_matmul

    def bf16_scan(r, k, v, logw, u):
        want_y, want_s = ref.wkv(r, k, v, logw, u)
        y, state = ref.wkv(r, k, v, logw, u, state_dtype=torch.bfloat16)
        out["scan_rel"] = worst(out["scan_rel"], C.rel_err(y, want_y),
                                C.rel_err(state, want_s))
        return y, state

    for i in sampled_waves(traffic, seed):
        inputs = W.prompt(model, seed, i, B, L, device)
        states = {}
        want = ref.prefill(model, w, inputs, all_positions=True,
                           on_state=lambda l, *t: states.__setitem__(l, t))

        def on_state(l, s, xt, xc):
            out["state_rel"] = worst(out["state_rel"], *(
                C.rel_err(a, b) for a, b in zip((s, xt, xc), states[l])))

        got = ref.prefill(model, w, inputs, matmul=matmul, all_positions=True,
                          on_state=on_state, scan=ref.wkv if lowered == "fp8" else bf16_scan)
        out["logits_rel"] = worst(out["logits_rel"], *(C.rel_err(got[r, -1], want[r, -1])
                                                       for r in range(B)))
        out["token_gap"] = worst(out["token_gap"], C.served_gap(want, got.argmax(dim=-1)))
        del states, want, got
    return out


@contextlib.contextmanager
def dropped(term: str):
    """While open, the program's time-mix leaves out ``"ddlerp"`` (its
    LoRA term: a static mu a stream) or ``"decay_lora"`` (logw = -exp(w0))."""
    from repro_torch.models import rwkv6 as PR

    if term not in ("ddlerp", "decay_lora"):
        raise ValueError(f"dropped: {term!r} is ddlerp or decay_lora")
    real = PR._mixed

    def broken(p, x, x_shift):
        q = dict(p.named_parameters())
        if term == "ddlerp":
            for k in ("mu_x", "mix_lora_a", "mix_lora_b"):
                q.pop(k)
        else:
            q["w_lora_b"] = torch.zeros_like(q["w_lora_b"])
        return real(q, x, x_shift)

    PR._mixed = broken
    try:
        yield
    finally:
        PR._mixed = real
