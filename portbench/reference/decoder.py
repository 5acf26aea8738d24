"""A plain decoder-only transformer in PyTorch, float32, TF32 off.

Written from the layer equations the configurations state, and from
nothing of the program: it imports no module of the port and takes none of
its state.  It reads the weights the benchmark made (stacked over layers,
``(L, in, out)``, the head ``(V, d)``) and the inputs the benchmark made,
widens each to f32 where it is used, and computes, for each layer ``l``::

    h   = rms(x) * g_attn[l]                  rms(x) = x / sqrt(mean(x^2) + 1e-6)
    q   = rope(h Wq[l]), k = rope(h Wk[l]), v = h Wv[l]     (heads of d / H)
    x   = x + softmax(q k^T / sqrt(D) + causal) v Wo[l]
    h   = rms(x) * g_ffn[l]
    x   = x + (act(h Wgate[l]) * (h Wup[l])) Wdown[l]

then ``logits = (rms(x) * g_final) Whead^T``.  ``rope`` rotates the two
halves of each head by ``pos * theta^(-2i / D)``.  The training loss is
the mean next-token cross-entropy plus ``z_loss`` times the mean squared
log-normaliser, and AdamW (decoupled weight decay on every leaf, global
gradient-norm clipping, bias-corrected moments) updates f32 parameters.

``matmul`` is where a lower precision is put for the control
(``yardstick.compare.fp8`` on both operands); the default multiplies in
f32.  Everything is computed a layer at a time, and attention one batch
row at a time, so that a prefill of the timed size fits beside nothing.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

ACTS = {"gelu_tanh": lambda x: F.gelu(x, approximate="tanh"), "silu": F.silu}


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) f32, positions 0..S-1."""
    d = x.shape[-1]
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    inv = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = pos[:, None] * inv[None]                       # (S, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     matmul: Matmul) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, S, HKV, D) f32 -> (B, S, H, D)."""
    b, s, h, d = q.shape
    groups = h // k.shape[2]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for i in range(b):
        qi = q[i].transpose(0, 1)                                      # (H, S, D)
        ki = k[i].repeat_interleave(groups, dim=1).transpose(0, 1)
        vi = v[i].repeat_interleave(groups, dim=1).transpose(0, 1)
        scores = matmul(qi, ki.transpose(-1, -2)) / math.sqrt(d)
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out[i] = matmul(p, vi).transpose(0, 1)
    return out


def layer(model: Dict, w: Dict[str, torch.Tensor], l: int, x: torch.Tensor,
          matmul: Matmul, act: Callable, on_kv: Optional[Callable] = None) -> torch.Tensor:
    b, s, _ = x.shape
    hd = model["d_model"] // model["n_heads"]
    h = rms(x, w["norm_attn"][l])
    q = matmul(h, w["wq"][l]).view(b, s, model["n_heads"], hd)
    k = matmul(h, w["wk"][l]).view(b, s, model["n_kv_heads"], hd)
    v = matmul(h, w["wv"][l]).view(b, s, model["n_kv_heads"], hd)
    q, k = rope(q, model["rope_theta"]), rope(k, model["rope_theta"])
    if on_kv is not None:
        on_kv(l, k, v)
    o = causal_attention(q, k, v, matmul).reshape(b, s, -1)
    x = x + matmul(o, w["wo"][l])
    h = rms(x, w["norm_ffn"][l])
    return x + matmul(act(matmul(h, w["w_gate"][l])) * matmul(h, w["w_up"][l]),
                      w["w_down"][l])


def embed(model: Dict, w: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor]
          ) -> torch.Tensor:
    if "embeds" in inputs:
        return inputs["embeds"].float()
    return w["embed"].float()[inputs["tokens"].long()]


def hidden(model: Dict, w: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
           act: Callable, matmul: Matmul = f32_matmul,
           on_kv: Optional[Callable] = None) -> torch.Tensor:
    """The final-normed hidden states (B, S, d) f32."""
    x = embed(model, w, inputs)
    for l in range(model["n_layers"]):
        x = layer(model, w, l, x, matmul, act, on_kv)
    return rms(x, w["final_norm"])


def logits(w: Dict[str, torch.Tensor], h: torch.Tensor, matmul: Matmul = f32_matmul
           ) -> torch.Tensor:
    return matmul(h, w["lm_head"].transpose(0, 1))


def prefill(model: Dict, w: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
            act: Callable, matmul: Matmul = f32_matmul, on_kv: Optional[Callable] = None,
            all_positions: bool = False) -> torch.Tensor:
    """The last position's logits (B, V) f32, or every position's (B, S, V)
    with ``all_positions``; ``on_kv(l, k, v)`` sees each layer's k (after
    rope) and v, (B, S, HKV, D) f32."""
    with torch.no_grad():
        h = hidden(model, w, inputs, act, matmul, on_kv)
        return logits(w, h if all_positions else h[:, -1], matmul)


def loss(model: Dict, w: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
         labels: torch.Tensor, act: Callable, z_loss: float,
         matmul: Matmul = f32_matmul) -> torch.Tensor:
    """Mean next-token CE + z_loss * mean(lse^2), each layer recomputed in
    the backward (``torch.utils.checkpoint``) so that it fits."""
    x = embed(model, w, inputs)
    for l in range(model["n_layers"]):
        x = torch.utils.checkpoint.checkpoint(
            lambda x_, l_=l: layer(model, w, l_, x_, matmul, act), x,
            use_reentrant=False)
    h = rms(x, w["final_norm"])
    ce_sum = z_sum = torch.zeros((), device=x.device)
    for i in range(h.shape[0]):   # one row's logits at a time
        def row(h_, lab_):
            lg = logits(w, h_, matmul)
            lse = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, lab_.long()[:, None])[:, 0]
            return (lse - gold).sum(), lse.square().sum()

        c, z = torch.utils.checkpoint.checkpoint(row, h[i], labels[i], use_reentrant=False)
        ce_sum, z_sum = ce_sum + c, z_sum + z
    n = labels.numel()
    return ce_sum / n + z_loss * z_sum / n


def adamw(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor], step: int, lr: float,
          opt: Dict) -> float:
    """One AdamW step in place on f32 ``params``; returns the gradient norm
    before clipping."""
    gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    scale = min(1.0, opt["max_grad_norm"] / (gnorm + 1e-9))
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name] * scale
            mu[name].mul_(b1).add_(g, alpha=1 - b1)
            nu[name].mul_(b2).add_(g * g, alpha=1 - b2)
            u = (mu[name] / c1) / ((nu[name] / c2).sqrt() + eps)
            p.sub_(lr * (u + wd * p))
    return gnorm
