"""The port's jamba-v0.1-52b on the CPU against the JAX package's.

The smoke config (one period of [M, M*, M, A*, M, M*, M, M*] at d_model 64,
4 experts top-2) built in JAX and carried across with ``params_from_jax``:
prefill logits, 4 decode steps, every cache leaf (Mamba ``h`` and ``conv``,
attention ``k``/``v``) and the MoE aux loss against the JAX steps at 1e-4
in f32, with equal greedy tokens, at the smoke config's capacity factor 8.0
and at the published 1.25, where tokens drop; the converter's per-leaf
dtypes and ``init_params``' against JAX's; the parameter count at 8, 16 and
32 layers; and the serve loop on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import steps as RS
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.launch import serve as SV
from repro_torch.models import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax

ARCH = "jamba-v0.1-52b"
MODEL_TOL = 1e-4  # max abs diff / max abs, f32 through the model
B, PROMPT, DECODES = 2, 12, 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _cfgs(factor=None, **kw):
    """(JAX config, port config) of jamba's smoke model, at MoE capacity
    ``factor`` when given."""
    cfgs = []
    for cfg in (r_get_config(ARCH).smoke(), get_config(ARCH).smoke()):
        if factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                   capacity_factor=factor))
        cfgs.append(dataclasses.replace(cfg, **kw))
    return tuple(cfgs)


@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_prefill_and_decode_match_jax(factor):
    """Last logits, aux loss and every cache leaf after prefill, then the
    logits and caches after each of 4 decode steps (1e-4, f32); equal greedy
    tokens.  At 1.25 the MoE layers drop tokens at prefill and at decode
    (capacity 2 for 2 tokens), in both packages alike."""
    r_cfg, t_cfg = _cfgs(factor)
    max_len = PROMPT + DECODES
    params = RT.init_params(r_cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), t_cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, t_cfg.vocab, (B, PROMPT))

    r_caches = RT.init_cache(r_cfg, B, max_len)
    r_logits, r_caches, r_aux = jax.jit(
        lambda p, b, c: RT.forward(p, r_cfg, b, c))(
            params, {"tokens": jnp.asarray(tokens, jnp.int32)}, r_caches)
    t_caches = TT.init_cache(t_cfg, B, max_len, device="cpu")
    with torch.no_grad():
        t_logits, t_caches, t_aux = TT.forward(tparams, t_cfg, {"tokens": torch.tensor(tokens)},
                                               t_caches)
    assert _rel(t_logits.numpy(), r_logits) <= MODEL_TOL
    np.testing.assert_allclose(t_aux.item(), float(r_aux), rtol=1e-5)
    assert t_aux.item() > 0  # four MoE layers' aux + z losses

    def compare(t_out, r_out):
        assert _rel(t_out.numpy(), r_out) <= MODEL_TOL
        for pos, spec in enumerate(t_cfg.period):
            names = ("h", "conv") if spec.mixer == "mamba" else ("k", "v")
            assert set(t_caches[pos]) == set(names)
            for name in names:
                got, want = t_caches[pos][name], r_caches[pos][name]
                assert tuple(got.shape) == want.shape
                assert str(got.dtype) == f"torch.{want.dtype}"
                assert _rel(got.numpy(), want) <= MODEL_TOL, (pos, name)

    compare(t_logits[:, -1], r_logits[:, -1])
    tok = np.asarray(r_logits[:, -1]).argmax(-1)
    np.testing.assert_array_equal(t_logits[:, -1].argmax(-1).numpy(), tok)
    r_step, t_step = jax.jit(RS.make_decode_step(r_cfg)), TS.make_decode_step(t_cfg)
    for i in range(DECODES):
        r_nxt, r_out, r_caches = r_step(params, {"tokens": jnp.asarray(tok[:, None])},
                                        r_caches, jnp.int32(PROMPT + i))
        t_nxt, t_out, t_caches = t_step(tparams, {"tokens": torch.tensor(tok[:, None])},
                                        t_caches, PROMPT + i)
        assert t_out.shape == (B, 1, t_cfg.vocab)
        compare(t_out, r_out)
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(r_nxt))
        tok = np.asarray(r_nxt)


def test_prefill_matches_the_token_by_token_recurrence():
    """The check chip_smoke.py makes on the card, here in f32: the prefill
    (the scan, the flash plain version) against the same prompt fed through
    decode_step from a zero cache, at the smoke config's capacity factor 8,
    where no token drops at either."""
    _, cfg = _cfgs()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = 20
    tokens = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab, (B, n)))
    last, caches, _ = TS.make_prefill_step(cfg, n)(params, {"tokens": tokens})
    step = TS.make_decode_step(cfg)
    rec = TT.init_cache(cfg, B, n, device="cpu")
    for t in range(n):
        _, logits, rec = step(params, {"tokens": tokens[:, t:t + 1]}, rec, t)
    assert _rel(last.numpy(), logits[:, -1].numpy()) <= MODEL_TOL
    for pos in range(len(cfg.period)):
        for name, got in caches[pos].items():
            assert _rel(got.numpy(), rec[pos][name].numpy()) <= MODEL_TOL, (pos, name)


F32_LEAVES = {"dt_proj", "dt_bias", "a_log", "d", "router"}


def test_params_from_jax_keeps_each_leaf_dtype():
    """A bf16 jamba pytree keeps Mamba's dt_proj, dt_bias, a_log and d and
    the MoE router in f32, every other leaf in bf16, with the same values."""
    r_cfg, t_cfg = _cfgs(dtype="bfloat16")
    params = RT.init_params(r_cfg, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), t_cfg, "cpu")
    n = len(t_cfg.period)
    for i, blk in enumerate(tparams["blocks"]):
        for name, t in blk.named_parameters():
            want = params["blocks"][i % n]
            for part in name.split("."):
                want = want[part]
            want = np.asarray(want[i // n])
            f32 = name.split(".")[-1] in F32_LEAVES
            assert want.dtype == (np.float32 if f32 else ml_dtypes.bfloat16), name
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
            np.testing.assert_array_equal(t.float().numpy(), want.astype(np.float32))


def test_init_params_makes_each_leaf_as_jax_does():
    """Names, shapes and dtypes of the port's initialiser against JAX's,
    for a bf16 jamba at two periods (JAX stacks each block leaf over
    n_periods)."""
    r_cfg, t_cfg = _cfgs(dtype="bfloat16", n_layers=16)
    shapes = jax.eval_shape(lambda key: RT.init_params(r_cfg, key),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [str(k.key) if isinstance(k, jax.tree_util.DictKey) else str(k.idx)
                for k in path]
        want[".".join(keys)] = leaf
    got = dict(TT.init_params(t_cfg, None, "meta").named_parameters())
    n = len(t_cfg.period)
    names = set()
    for name, t in got.items():
        parts = name.split(".")
        if parts[0] == "blocks":  # blocks.<layer> -> blocks.<period position>
            key = ".".join(["blocks", str(int(parts[1]) % n)] + parts[2:])
            assert tuple(t.shape) == want[key].shape[1:], name
            assert want[key].shape[0] == t_cfg.n_periods
        else:
            key = name
            assert tuple(t.shape) == want[key].shape, name
        assert str(t.dtype) == f"torch.{want[key].dtype}", name
        names.add(key)
    assert names == set(want)


@pytest.mark.parametrize("layers,count", [(8, 13_295_235_072), (16, 26_053_595_136),
                                          (32, 51_570_315_264)])
def test_param_count_matches_jax(layers, count):
    r_cfg = dataclasses.replace(r_get_config(ARCH), n_layers=layers)
    t_cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
    assert t_cfg.param_count() == r_cfg.param_count() == count


def test_serve_once_jamba_on_cpu():
    cfg = get_config(ARCH).smoke()
    before = (mamba_scan.launches, flash_attention.launches)
    s = SV.serve_once(cfg, requests=3, batch=2, prompt_len=6, gen_len=3, max_len=12,
                      device="cpu")
    assert s["arch"] == "jamba-v0.1-52b-smoke" and s["logits_finite"]
    assert s["requests"] == 3 and s["tokens"] == 9 and s["prefill_waves"] == 2
    assert s["decode_steps"] == 4
    # CPU tensors run the plain versions
    assert (mamba_scan.launches, flash_attention.launches) == before


def test_serve_main_jamba_on_cpu(capsys):
    assert SV.main(["--arch", ARCH, "--requests", "2", "--batch", "2", "--prompt-len", "5",
                    "--gen-len", "2", "--max-len", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"arch": "jamba-v0.1-52b-smoke"' in out and '"logits_finite": true' in out
