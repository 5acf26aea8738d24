"""The port's model on the CPU against the JAX package's.

musicgen-large's smoke config at two layers (and variants: GQA, a sliding
window, every block option of the schema, a token frontend): JAX
``init_params`` weights carried across with ``params_from_jax``, then JAX
``make_prefill_step`` + 4 x ``make_decode_step`` against the port's on the
same inputs, in f32: last logits and caches within 1e-4 (max abs diff /
max abs), equal greedy tokens.  A sliding-window layer's cache is a ring in
the port (position p in slot p % window), so its prefill cache is compared
slot by position, and its decode past the window is held against the JAX
package's ``forward`` over the same tokens (the JAX decode clamps its
writes to the last slot there and masks slots by index).  Then the port's
serve loop alone, on the CPU, with a tuned registry.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import steps as RS
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN_LOCAL, DENSE, LayerSpec
from repro_torch.core import LoopTuner, matmul_benchmark
from repro_torch.launch import serve as SV
from repro_torch.models import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax

B, PROMPT, MAX_LEN, DECODES = 2, 12, 24, 4


def _cfgs(variant):
    """(JAX config, port config) of the same smoke model."""
    kw = {"n_layers": 2}
    if variant == "gqa":
        kw["n_kv_heads"] = 2
    if variant == "options":  # every block option of the schema at once
        kw.update(qk_norm=True, attn_bias=True, post_norm=True, parallel_block=True,
                  attn_softcap=30.0, logit_softcap=20.0, act="silu")
    if variant == "tokens":
        kw.update(frontend="tokens", embed_scale=True, tie_embeddings=True)
    if variant == "window":
        kw["period"] = (LayerSpec(ATTN_LOCAL, DENSE, window=5),)
    r_cfg = r_get_config("musicgen-large").smoke()
    if "period" in kw:  # the JAX package's own LayerSpec type
        from repro.configs.base import LayerSpec as RLayerSpec
        r_kw = dict(kw, period=(RLayerSpec("attn_local", "dense", window=5),))
    else:
        r_kw = kw
    return (dataclasses.replace(r_cfg, **r_kw),
            dataclasses.replace(get_config("musicgen-large").smoke(), **kw))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _batches(cfg, tokens):
    """The same model inputs for both packages: tokens, or frame embeds
    looked up in a fixed table (the audio stub)."""
    if cfg.frontend == "tokens":
        return ({"tokens": jax.numpy.asarray(tokens, jax.numpy.int32)},
                {"tokens": torch.tensor(tokens, dtype=torch.long)})
    table = np.random.default_rng(1).standard_normal((cfg.vocab, cfg.d_model),
                                                     dtype=np.float32)
    return ({"embeds": jax.numpy.asarray(table[tokens])},
            {"embeds": torch.from_numpy(table[tokens])})


@pytest.mark.parametrize("variant", ["mha", "gqa", "window", "options", "tokens"])
def test_prefill_and_decode_match_jax(variant):
    r_cfg, t_cfg = _cfgs(variant)
    params = RT.init_params(r_cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), t_cfg, "cpu")
    prompts = np.random.default_rng(0).integers(0, t_cfg.vocab, (B, PROMPT))

    r_in, t_in = _batches(t_cfg, prompts)
    r_last, r_caches, r_len = RS.make_prefill_step(r_cfg, MAX_LEN)(params, r_in)
    t_last, t_caches, t_len = TS.make_prefill_step(t_cfg, MAX_LEN)(tparams, t_in)
    assert int(r_len) == t_len == PROMPT
    assert _rel(t_last.numpy(), r_last) <= 1e-4
    np.testing.assert_array_equal(t_last.argmax(-1).numpy(), np.asarray(r_last).argmax(-1))
    window = t_cfg.period[0].window
    for got, r_cache in zip(t_caches, r_caches):
        for name in ("k", "v"):
            want = np.asarray(r_cache[name])
            buf = want.shape[2]
            if window is not None and PROMPT > buf:
                # JAX keeps positions PROMPT-buf.. in slots 0..; the port's
                # ring keeps position p in slot p % buf
                want = np.roll(want, PROMPT % buf, axis=2)
            assert _rel(got[name].numpy(), want) <= 1e-4

    tok = np.asarray(r_last).argmax(-1)
    seq = prompts
    r_step, t_step = RS.make_decode_step(r_cfg), TS.make_decode_step(t_cfg)
    for i in range(DECODES):
        seq = np.concatenate([seq, tok[:, None]], axis=1)
        r_in, t_in = _batches(t_cfg, tok[:, None])
        r_nxt, r_logits, r_caches = r_step(params, r_in, r_caches,
                                           jax.numpy.int32(PROMPT + i))
        if window is not None and PROMPT + i >= window:
            # past the window the reference is the full forward over every
            # token so far (the JAX decode masks the wrong keys there)
            r_logits = RT.forward(params, r_cfg, _batches(t_cfg, seq)[0])[0][:, -1:]
            r_nxt = np.asarray(r_logits)[:, -1].argmax(-1)
        t_nxt, t_logits, t_caches = t_step(tparams, t_in, t_caches, PROMPT + i)
        assert t_logits.shape == (B, 1, t_cfg.vocab) and t_logits.dtype == torch.float32
        assert _rel(t_logits.numpy(), r_logits) <= 1e-4
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(r_nxt))
        tok = np.asarray(r_nxt)


@pytest.mark.parametrize("prompt_len", [1, 4, 6])
def test_sliding_window_decode_matches_own_forward_past_the_window(prompt_len):
    """One windowed layer (window 4, max_len 16): the port's prefill of
    ``prompt_len`` tokens, then decode up to position 9, each step against
    the port's own ``forward`` over every token so far."""
    cfg = dataclasses.replace(get_config("musicgen-large").smoke(), n_layers=1,
                              period=(LayerSpec(ATTN_LOCAL, DENSE, window=4),),
                              dtype="float32")
    params = SV.init_model(cfg, 0, "cpu")
    make_inputs = SV.input_fn(cfg, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, 10))
    _, caches, n = TS.make_prefill_step(cfg, 16)(params, make_inputs(toks[:, :prompt_len]))
    assert caches[0]["k"].shape[2] == 4
    step = TS.make_decode_step(cfg)
    for pos in range(prompt_len, 10):
        _, logits, caches = step(params, make_inputs(toks[:, pos:pos + 1]), caches, pos)
        with torch.no_grad():
            want = TT.forward(params, cfg, make_inputs(toks[:, :pos + 1]))[0][:, -1:]
        assert _rel(logits.numpy(), want.numpy()) <= 1e-4, pos


def test_converted_weights_keep_every_name_and_value():
    r_cfg, t_cfg = _cfgs("gqa")
    params = RT.init_params(r_cfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), t_cfg, "cpu")
    assert len(tparams["blocks"]) == t_cfg.n_layers
    for i, blk in enumerate(tparams["blocks"]):
        want = params["blocks"][0]
        for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("w_gate", "w_up", "w_down"))):
            for name in names:
                np.testing.assert_array_equal(blk[group][name].numpy(),
                                              np.asarray(want[group][name][i]))
        for name in ("norm_attn", "norm_ffn"):
            np.testing.assert_array_equal(blk[name].numpy(), np.asarray(want[name][i]))
    for name in ("final_norm", "lm_head"):
        np.testing.assert_array_equal(tparams[name].numpy(), np.asarray(params[name]))
    np.testing.assert_array_equal(tparams["embed"]["table"].numpy(),
                                  np.asarray(params["embed"]["table"]))
    assert not any(p.requires_grad for p in tparams.parameters())


@pytest.mark.parametrize("arch_cfg", ["smoke", "full"])
def test_param_count_matches_jax(arch_cfg):
    r_cfg, t_cfg = r_get_config("musicgen-large"), get_config("musicgen-large")
    if arch_cfg == "smoke":
        r_cfg, t_cfg = r_cfg.smoke(), t_cfg.smoke()
    assert t_cfg.param_count() == r_cfg.param_count()


def test_every_reference_arch_resolves_with_equal_fields():
    from repro.configs import ARCHS as R_ARCHS
    from repro_torch.configs import ARCHS

    assert sorted(ARCHS) == sorted(R_ARCHS) and len(ARCHS) == 10
    for name, r_cfg in R_ARCHS.items():
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(r_cfg), name
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
    with pytest.raises(ValueError, match="unknown layer kind"):
        TT.init_params(dataclasses.replace(get_config("musicgen-large").smoke(),
                                           period=(LayerSpec("conv", DENSE),)),
                       None, "meta")


def _serving_registry(cfg, batch, prompt_len):
    """Every dense contraction of one prefill and one decode step, tuned on
    the analytical backend and labelled with the model's dtype."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    tuner = LoopTuner(policy="search", backend="tpu", surrogate="off")
    shapes = [(m, k, n) for m in (batch, batch * prompt_len)
              for (k, n) in ((d, d), (d, f), (f, d), (d, v))]
    tuner.tune_many([matmul_benchmark(*s) for s in shapes], dtypes=[cfg.dtype] * len(shapes),
                    weights=[1.0] * len(shapes), budget_s=60.0, eval_budget=8 * len(shapes))
    return tuner.registry


def test_serve_once_on_cpu_hits_every_contraction(tmp_path):
    cfg = dataclasses.replace(get_config("musicgen-large").smoke(), n_layers=2)
    reg = _serving_registry(cfg, batch=2, prompt_len=6)
    path = str(tmp_path / "reg.json")
    reg.save(path)
    tuned = SV.serve_once(cfg, requests=3, batch=2, prompt_len=6, gen_len=3, max_len=12,
                          registry=path, device="cpu")
    plain = SV.serve_once(cfg, requests=3, batch=2, prompt_len=6, gen_len=3, max_len=12,
                          device="cpu")
    stats = tuned["registry"]["serving"]
    assert stats["hits"] > 0 and stats["misses"] == 0
    assert stats["routed"] == 0  # CPU tensors keep torch.einsum
    assert len(stats["per_key"]) == 8
    for s in (tuned, plain):
        assert s["requests"] == 3 and s["tokens"] == 9 and s["prefill_waves"] == 2
        assert s["decode_steps"] == 4 and s["logits_finite"]
    assert "registry" not in plain


def test_bf16_logits_fallback_accumulates_in_f32():
    """A registry miss on bf16 operands computes f32 logits from the exact
    products, as jnp.einsum's preferred_element_type does (not a bf16
    einsum cast up afterwards)."""
    import jax.numpy as jnp
    import ml_dtypes
    from repro.core import ScheduleRegistry as RRegistry
    from repro.kernels import ops as rops
    from repro_torch.core import ScheduleRegistry as TRegistry
    from repro_torch.kernels import ops as tops

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 64), dtype=np.float32).astype(ml_dtypes.bfloat16)
    w = rng.standard_normal((256, 64), dtype=np.float32).astype(ml_dtypes.bfloat16)
    with tops.serving(TRegistry()):
        got = tops.tuned_einsum("bsd,vd->bsv",
                                torch.from_numpy(x.astype(np.float32)).bfloat16(),
                                torch.from_numpy(w.astype(np.float32)).bfloat16(),
                                out_dtype=torch.float32)
    with rops.serving(RRegistry()):
        want = rops.tuned_einsum("bsd,vd->bsv", jnp.asarray(x), jnp.asarray(w),
                                 preferred_element_type=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_serve_main_on_cpu(capsys):
    assert SV.main(["--requests", "2", "--batch", "2", "--prompt-len", "4",
                    "--gen-len", "2", "--max-len", "8", "--device", "cpu"]) == 0
    assert '"requests": 2' in capsys.readouterr().out
    with pytest.raises(SystemExit):  # --tune needs a registry to tune into
        SV.main(["--tune", "--device", "cpu"])
    assert "--tune requires --registry" in capsys.readouterr().err


def test_model_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys, repro_torch.launch.serve, repro_torch.models.convert, "
            "repro_torch.configs, repro_torch.models.moe, repro_torch.models.mamba, "
            "repro_torch.models.rwkv6, repro_torch.kernels.flash_attention\n"
            "from repro_torch.configs import ARCHS\n"
            "from repro_torch.models.transformer import init_params\n"
            "[init_params(c, None, 'meta') for c in ARCHS.values()]\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == "[]"
