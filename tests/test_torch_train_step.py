"""The port's optimizer step, remat, loss chunking and kernel gradients on
the CPU, against the JAX package's where it has the same function.

* One ``make_train_step`` (AdamW with clipping, a warmup schedule) and one
  with two microbatches on musicgen-large's smoke config against the
  reference's: loss, ce, grad norm and lr within 1e-5 relative, and the
  parameters after the update within 1e-5 relative per leaf (Adam's first
  step moves each parameter by about lr whatever the gradient's size, so
  the two packages' gradient rounding shows only where a gradient is near
  0).
* The three remat policies giving equal gradients (the recomputation is
  the same arithmetic on the CPU).
* The seq-chunked loss (two chunks of 512) against the whole-logits
  cross-entropy and the reference's chunked loss, within 1e-5 relative
  (sums in another order), and the fallback where the chunk does not
  divide S equal to the whole-logits loss.
* ``flash_attention_bwd_plain`` (through the autograd ``FlashAttention``
  that ``layers.attention`` takes under grad) against ``jax.vjp`` of the
  JAX model's ``layers.attention`` (its hand-written backward) at causal,
  window, softcap, GQA, ragged S != T and rows that see no key:
  allclose(rtol=atol=5e-4), the JAX package's own flash-gradient tolerance
  (tests/test_attention.py); the lse of the forward against
  ``_flash_fwd_impl``'s within 1e-5.
* Both scans' autograd functions (kernel forward, plain-recompute backward)
  against autograd through their plain versions, every input's gradient
  within 2e-4 (the scans' limit, tests/test_kernels.py), and a ``grad_fn``
  on every wrapper's result under grad.
* The tiled matmul's grad guard: ``matmul`` and a registry hit of
  ``tuned_einsum`` routed to the kernel raise under grad, naming ROADMAP
  §C 6; the CPU fallback stays differentiable.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.data import make_dataset
from repro.models import layers as RL
from repro.models import steps as RS
from repro.models import transformer as RT
from repro.optim import adamw_init as r_adamw_init
from repro.optim.schedules import cosine_with_warmup as r_cosine
from repro_torch.configs import get_config
from repro_torch.core.registry import ScheduleRegistry
from repro_torch.kernels import ops as K
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain_model
from repro_torch.kernels.rwkv6_scan import rwkv6_chunk_scan, rwkv6_chunk_scan_plain_heads
from repro_torch.kernels.matmul import matmul
from repro_torch.models import layers as TL
from repro_torch.models import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.optim import adamw_init
from repro_torch.optim.schedules import cosine_with_warmup

FLASH_GRAD_LIMIT = 5e-4
SCAN_LIMIT = 2e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _setup(arch, seed=0, seq=16, batch=2):
    r_cfg, t_cfg = r_get_config(arch).smoke(), get_config(arch).smoke()
    params = RT.init_params(r_cfg, jax.random.PRNGKey(seed))
    batch_np = make_dataset(r_cfg, None, seed=seed, global_batch=batch, seq_len=seq).batch(1)
    tp = params_from_jax(jax.tree.map(np.asarray, params), t_cfg, "cpu", trainable=True)
    return r_cfg, t_cfg, params, batch_np, tp, {k: torch.from_numpy(v)
                                                for k, v in batch_np.items()}


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(n_micro):
    r_cfg, t_cfg, params, batch_np, tp, batch = _setup("musicgen-large", seed=1, batch=4)
    r_step = RS.make_train_step(r_cfg, r_cosine(3e-3, 2, 20), n_microbatches=n_micro)
    r_params, r_opt, r_m = r_step(params, r_adamw_init(params),
                                  {k: jnp.asarray(v) for k, v in batch_np.items()})
    t_step = TS.make_train_step(t_cfg, cosine_with_warmup(3e-3, 2, 20), n_microbatches=n_micro)
    tp, t_opt, t_m = t_step(tp, adamw_init(dict(tp.named_parameters())), batch)
    assert int(t_opt.step) == int(r_opt.step) == 1
    for key in ("loss", "ce", "grad_norm", "lr"):
        assert abs(float(t_m[key]) - float(r_m[key])) <= 1e-5 * abs(float(r_m[key])), key
    want, got = _leaves(r_params), _leaves(params_to_jax(tp, t_cfg))
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, k
    assert all(p.grad is None for p in tp.parameters())  # freed after the update


def test_remat_policies_equal():
    _, t_cfg, params, batch_np, _, batch = _setup("jamba-v0.1-52b", seed=2)
    grads = {}
    for policy in ("block", "period", "none"):
        cfg = dataclasses.replace(t_cfg, remat_policy=policy)
        tp = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu", trainable=True)
        loss, _ = TS.make_loss_fn(cfg)(tp, batch)
        loss.backward()
        grads[policy] = {k: p.grad for k, p in tp.named_parameters()}
    for policy in ("period", "none"):
        for k, g in grads["block"].items():
            assert torch.equal(grads[policy][k], g), f"{policy} {k}"


def test_chunked_cross_entropy_matches_whole():
    r_cfg, t_cfg, params, batch_np, tp, batch = _setup("phi3-mini-3.8b", seq=1024, batch=1)
    with torch.no_grad():
        hidden, _, _ = TT.hidden_states(tp, t_cfg, batch)
        whole = TS.cross_entropy(TL.logits_apply(tp["embed"], hidden, tp.get("lm_head"),
                                                 t_cfg.logit_softcap), batch["labels"])
        chunked = TS.chunked_cross_entropy(t_cfg, tp, hidden, batch["labels"], chunk=512)
        ragged = TS.chunked_cross_entropy(t_cfg, tp, hidden, batch["labels"], chunk=300)
    for a, b in zip(chunked, whole):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    assert [float(x) for x in ragged] == [float(x) for x in whole]  # 300 does not divide 1024
    r_loss, r_ce = RS.chunked_cross_entropy(r_cfg, params, jnp.asarray(hidden.numpy()),
                                            jnp.asarray(batch_np["labels"]), chunk=512)
    assert abs(float(chunked[0]) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    assert abs(float(chunked[1]) - float(r_ce)) <= 1e-5 * abs(float(r_ce))


# (B, S, T, HQ, HKV, D, causal, window, softcap)
FLASH_CASES = [
    (2, 24, 24, 4, 4, 16, True, None, None),      # causal
    (1, 40, 40, 4, 2, 16, True, 8, None),         # window, GQA 2
    (2, 33, 33, 4, 1, 8, True, None, 20.0),       # softcap, GQA 4
    (1, 20, 45, 2, 2, 32, False, None, None),     # ragged, S < T
    (1, 45, 20, 4, 1, 16, True, None, 30.0),      # ragged, S > T
    (1, 40, 24, 2, 2, 16, True, 8, None),         # rows 31-39 see no key
    # gemma3-12b's head dim
    (1, 24, 24, 4, 2, 256, True, None, None),     # D = 256, causal, GQA 2
    (1, 40, 40, 4, 2, 256, True, 8, None),        # D = 256, window, GQA 2
    (2, 33, 33, 2, 2, 256, True, None, 50.0),     # D = 256, softcap 50
    (1, 40, 24, 2, 2, 256, True, 8, None),        # D = 256, rows 31-39 see no key
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_matches_jax_vjp(case):
    b, s, t, hq, hkv, d, causal, window, softcap = case
    rng = np.random.default_rng(abs(hash(case)) % 2**32)
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32) for shape in
                     ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, hq, d)))
    out_r, vjp = jax.vjp(lambda q, k, v: RL.attention(q, k, v, causal=causal, window=window,
                                                      softcap=softcap), q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TL.attention(tq, tk, tv, causal=causal, window=window, softcap=softcap)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_r), rtol=3e-5, atol=3e-5)
    out.backward(torch.from_numpy(dout))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=FLASH_GRAD_LIMIT,
                                   atol=FLASH_GRAD_LIMIT)
    # the forward's lse against the reference's (1e-5)
    scale = 1.0 / math.sqrt(d)
    rep = lambda x: np.repeat(x, hq // hkv, axis=2).transpose(0, 2, 1, 3)[None]  # noqa: E731
    static = (causal, window, softcap, scale, s, t, 1, 1, s, t)
    _, lse_r = RL._flash_fwd_impl(static, jnp.asarray((q * scale).transpose(0, 2, 1, 3)[None]),
                                  jnp.asarray(rep(k)), jnp.asarray(rep(v)), jnp.asarray(0),
                                  jnp.asarray(t))
    _, lse = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                      window=window, softcap=softcap, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r)[0], rtol=1e-5, atol=1e-5)


def test_flash_function_matches_plain_autograd():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 50, h, 16, generator=g) for h in (4, 2, 2))
    dout = torch.randn(2, 50, 4, 16, generator=g)
    grads = []
    for fn in (K.flash_attention, flash_attention_plain):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves, causal=True, window=20, softcap=30.0).backward(dout)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _scan_grads(fn, inputs, weights):
    leaves = [None if x is None else x.clone().requires_grad_() for x in inputs]
    y, state = fn(leaves)
    assert y.grad_fn is not None and state.grad_fn is not None
    ((y * weights[0]).sum() + (state * weights[1]).sum()).backward()
    return [None if x is None else x.grad for x in leaves], type(y.grad_fn).__name__


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_scan_grads_match_plain(with_state):
    g = torch.Generator().manual_seed(4)
    b, s, h, n, chunk = 2, 40, 2, 8, 16
    r, k, v = (torch.randn(b, s, h, n, generator=g) for _ in range(3))
    logw = -torch.exp(torch.randn(b, s, h, n, generator=g) * 0.5)
    u = torch.randn(h, n, generator=g) * 0.5
    s0 = torch.randn(b, h, n, n, generator=g) if with_state else None
    weights = (torch.randn(b, s, h, n, generator=g), torch.randn(b, h, n, n, generator=g))
    inputs = (r, k, v, logw, u, s0)
    kern, name = _scan_grads(lambda x: rwkv6_chunk_scan(*x[:5], chunk=chunk, s0=x[5]),
                             inputs, weights)
    assert name == "RWKV6ScanBackward"
    plain, _ = _scan_grads(lambda x: rwkv6_chunk_scan_plain_heads(*x[:5], chunk=chunk,
                                                                     s0=x[5]),
                           inputs, weights)
    for a, b_ in zip(kern, plain):
        if a is not None:
            torch.testing.assert_close(a, b_, rtol=SCAN_LIMIT, atol=SCAN_LIMIT)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_scan_grads_match_plain(with_state):
    g = torch.Generator().manual_seed(5)
    b, s, c, n, chunk = 2, 40, 24, 8, 16
    x = torch.randn(b, s, c, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, c, generator=g))
    a = -torch.exp(torch.randn(c, n, generator=g) * 0.5)
    bm, cm = (torch.randn(b, s, n, generator=g) for _ in range(2))
    h0 = torch.randn(b, c, n, generator=g) if with_state else None
    weights = (torch.randn(b, s, c, generator=g), torch.randn(b, c, n, generator=g))
    inputs = (x, dt, a, bm, cm, h0)
    kern, name = _scan_grads(lambda t: mamba_scan(*t[:5], chunk=chunk, h0=t[5]),
                             inputs, weights)
    assert name == "MambaScanBackward"
    plain, _ = _scan_grads(lambda t: mamba_scan_plain_model(*t[:5], chunk=chunk, h0=t[5]),
                           inputs, weights)
    for a_, b_ in zip(kern, plain):
        if a_ is not None:
            torch.testing.assert_close(a_, b_, rtol=SCAN_LIMIT, atol=SCAN_LIMIT)


def test_tiled_matmul_raises_under_grad():
    a = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4)
    with pytest.raises(RuntimeError, match="§C 6"):
        matmul(a, w)
    with torch.no_grad():
        assert matmul(a, w).shape == (8, 4)
    assert matmul(a.detach(), w).grad_fn is None
    reg = ScheduleRegistry()
    reg.put("mm", (8, 16, 4), 1.0, [], dtype="float32")
    reg.get("mm", (8, 16, 4), dtype="float32")["block"] = {"m": 8, "k": 16, "n": 4}
    with pytest.raises(RuntimeError, match="§C 6"):
        K.tuned_einsum("mk,kn->mn", a, w, registry=reg, kernel="on")
    out = K.tuned_einsum("mk,kn->mn", a, w, registry=reg)  # CPU: the plain einsum
    assert out.grad_fn is not None
    out.sum().backward()
    torch.testing.assert_close(a.grad, w.sum(1).expand(8, 16))
