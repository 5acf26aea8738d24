"""The rest of the model zoo on the CPU against the JAX package's.

The seven architectures beyond musicgen-large, rwkv6-7b and jamba (olmoe-1b-7b,
gemma2-27b, command-r-35b, llama4-scout-17b-a16e, phi3-mini-3.8b,
gemma3-12b, llama-3.2-vision-11b): their configs resolve with the JAX
package's fields and parameter counts (active counts for the MoE models);
each smoke config (one whole period at d_model 64) is built in JAX, carried
across with ``params_from_jax`` and run through the port's
``make_prefill_step`` + 4 x ``make_decode_step`` against the JAX package's
on the same inputs, in f32: last logits, every decode step's logits and
every cache leaf within 1e-4 (max abs diff / max abs), equal greedy
tokens.  llama-3.2-vision's cross layers read the same seeded numpy encoder
states (8 tokens of width 32 at smoke size) in both, and its ``ck``/``cv``
caches are compared too.  phi3-mini and gemma3 also run at their published
head dims (96 and 256), so that the model path reaches the plain flash
version at those D.  Then the entry points: ``serve_once`` refuses the
cross-attention model, ``launch/serve`` serves each other new smoke config
on the CPU, and phi3-mini's harvest equals the reference's dense records.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.launch import tune as RTUNE
from repro.models import steps as RS
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.launch import serve as SV
from repro_torch.launch import tune as TTUNE
from repro_torch.models import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from test_torch_model import PORT_ONLY_FIELDS

B, PROMPT, MAX_LEN, DECODES = 2, 12, 24, 4

# the reference's param_count() at the published widths (and bf16 GB)
FULL_PARAMS = {
    "olmoe-1b-7b": 6_919_100_416,             # 13.8
    "gemma2-27b": 27_227_128_320,             # 54.5
    "command-r-35b": 30_283_538_432,          # 60.6
    "llama4-scout-17b-a16e": 107_769_861_120,  # 215.5
    "phi3-mini-3.8b": 3_821_079_552,          # 7.6
    "gemma3-12b": 11_765_788_416,             # 23.5
    "llama-3.2-vision-11b": 10_110_734_336,   # 20.2
}
ACTIVE_PARAMS = {"olmoe-1b-7b": 1_281_955_840, "llama4-scout-17b-a16e": 17_172_894_720}
NEW_ARCHS = sorted(FULL_PARAMS)
# (arch, head_dim override): the smoke configs, and phi3-mini and gemma3 at
# their published head dims
PARITY = [(a, None) for a in NEW_ARCHS] + [("phi3-mini-3.8b", 96), ("gemma3-12b", 256)]


def _cfgs(arch, head_dim=None):
    r_cfg, t_cfg = r_get_config(arch).smoke(), get_config(arch).smoke()
    if head_dim is not None:
        r_cfg = dataclasses.replace(r_cfg, head_dim=head_dim)
        t_cfg = dataclasses.replace(t_cfg, head_dim=head_dim)
    return r_cfg, t_cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _batches(cfg, tokens, encoder=None):
    r = {"tokens": jax.numpy.asarray(tokens, jax.numpy.int32)}
    t = {"tokens": torch.tensor(tokens, dtype=torch.long)}
    if encoder is not None:
        r["encoder"] = jax.numpy.asarray(encoder)
        t["encoder"] = torch.from_numpy(encoder)
    return r, t


def _encoder(cfg):
    if not cfg.n_cross_tokens:
        return None
    return np.random.default_rng(3).standard_normal((B, cfg.n_cross_tokens, cfg.d_cross),
                                                    dtype=np.float32)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_fields_equal_the_reference(arch):
    # the port's own fields (Finch's LoRA ranks) at the defaults that keep
    # the JAX package's block
    assert dataclasses.asdict(get_config(arch)) == {
        **dataclasses.asdict(r_get_config(arch)), **PORT_ONLY_FIELDS}
    assert dataclasses.asdict(get_config(arch).smoke()) == {
        **dataclasses.asdict(r_get_config(arch).smoke()), **PORT_ONLY_FIELDS}


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_count_matches_jax(arch, size):
    r_cfg, t_cfg = r_get_config(arch), get_config(arch)
    if size == "smoke":
        r_cfg, t_cfg = r_cfg.smoke(), t_cfg.smoke()
    else:
        assert t_cfg.param_count() == FULL_PARAMS[arch]
    assert t_cfg.param_count() == r_cfg.param_count()


@pytest.mark.parametrize("arch", sorted(ACTIVE_PARAMS))
def test_active_param_count_matches_jax(arch):
    t_cfg, r_cfg = get_config(arch), r_get_config(arch)
    assert t_cfg.active_param_count() == r_cfg.active_param_count() == ACTIVE_PARAMS[arch]
    assert t_cfg.smoke().active_param_count() == r_cfg.smoke().active_param_count()
    assert t_cfg.active_param_count() < t_cfg.param_count()


def test_dense_active_param_count_is_the_total():
    for arch in ("phi3-mini-3.8b", "llama-3.2-vision-11b"):
        cfg = get_config(arch).smoke()
        assert cfg.active_param_count() == cfg.param_count() == r_get_config(
            arch).smoke().active_param_count()


@pytest.mark.parametrize("arch,head_dim", PARITY,
                         ids=[a if d is None else f"{a}-d{d}" for a, d in PARITY])
def test_prefill_and_decode_match_jax(arch, head_dim):
    r_cfg, t_cfg = _cfgs(arch, head_dim)
    params = RT.init_params(r_cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), t_cfg, "cpu")
    prompts = np.random.default_rng(0).integers(0, t_cfg.vocab, (B, PROMPT))
    encoder = _encoder(t_cfg)

    r_in, t_in = _batches(t_cfg, prompts, encoder)
    r_last, r_caches, r_len = RS.make_prefill_step(r_cfg, MAX_LEN)(params, r_in)
    t_last, t_caches, t_len = TS.make_prefill_step(t_cfg, MAX_LEN)(tparams, t_in)
    assert int(r_len) == t_len == PROMPT
    assert _rel(t_last.numpy(), r_last) <= 1e-4
    np.testing.assert_array_equal(t_last.argmax(-1).numpy(), np.asarray(r_last).argmax(-1))

    def same_caches():
        for got, want in zip(t_caches, r_caches):
            assert set(got) == set(want)
            for name in want:
                assert got[name].shape == want[name].shape, name
                assert _rel(got[name].numpy(), want[name]) <= 1e-4, name

    same_caches()
    if encoder is not None:
        assert {"ck", "cv"} <= set(t_caches[-1])
    tok = np.asarray(r_last).argmax(-1)
    r_step, t_step = RS.make_decode_step(r_cfg), TS.make_decode_step(t_cfg)
    for i in range(DECODES):
        r_in, t_in = _batches(t_cfg, tok[:, None])
        r_nxt, r_logits, r_caches = r_step(params, r_in, r_caches,
                                           jax.numpy.int32(PROMPT + i))
        t_nxt, t_logits, t_caches = t_step(tparams, t_in, t_caches, PROMPT + i)
        assert t_logits.shape == (B, 1, t_cfg.vocab) and t_logits.dtype == torch.float32
        assert _rel(t_logits.numpy(), r_logits) <= 1e-4
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(r_nxt))
        tok = np.asarray(r_nxt)
    same_caches()


def test_cross_layer_without_an_encoder_raises():
    cfg = get_config("llama-3.2-vision-11b").smoke()
    params = SV.init_model(cfg, 0, "cpu")
    tokens = {"tokens": torch.zeros(B, 4, dtype=torch.long)}
    with pytest.raises(ValueError, match="encoder"):
        TS.make_prefill_step(cfg, 8)(params, tokens)
    with pytest.raises(ValueError, match="encoder"):
        TT.forward(params, cfg, dict(tokens, encoder=torch.zeros(B, 3, cfg.d_cross)))


def test_serve_once_refuses_the_cross_attention_model():
    with pytest.raises(ValueError, match="needs an encoder"):
        SV.serve_once(get_config("llama-3.2-vision-11b").smoke(), requests=2, batch=2,
                      prompt_len=4, gen_len=2, max_len=8, device="cpu")


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS if a != "llama-3.2-vision-11b"])
def test_serve_main_serves_each_new_smoke_config_on_cpu(arch, capsys):
    assert SV.main(["--arch", arch, "--requests", "2", "--batch", "2", "--prompt-len", "4",
                    "--gen-len", "2", "--max-len", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f'"arch": "{arch}-smoke"' in out and '"logits_finite": true' in out


def test_phi3_harvest_matches_the_reference_on_the_dense_sites():
    shapes = dict(batch=2, prompt_len=8, max_len=16)
    ref = RTUNE.harvest_model(r_get_config("phi3-mini-3.8b").smoke(), **shapes)
    cfg = get_config("phi3-mini-3.8b").smoke()
    got = TTUNE.harvest_model(cfg, device="cpu", **shapes)
    dense = {tuple(p.shape[-2:]) for p in TT.init_params(cfg, None, "meta").parameters()
             if p.ndim >= 2}
    dense |= {(n, k) for k, n in dense}
    ref_dense = [r for r in ref if (r["k"], r["n"]) in dense]
    assert len(ref_dense) < len(ref)  # the reference also holds attention's dots

    def by_key(recs):
        return {(r["m"], r["k"], r["n"], r["dtype"]): r for r in recs}

    want, have = by_key(ref_dense), by_key(got)
    assert set(have) == set(want)
    assert {k: r["count"] for k, r in have.items()} == {k: r["count"] for k, r in want.items()}
    total = sum(r["flop_share"] for r in ref_dense)
    for k, r in have.items():
        assert abs(r["flop_share"] - want[k]["flop_share"] / total) <= 1e-9, k


def test_serve_loop_takes_the_encoder_states_of_a_cross_model():
    # serve_once's loop with the encoder added to every prefill's inputs, as
    # the card's smoke serves llama-3.2-vision; without it the cross layers raise
    cfg = get_config("llama-3.2-vision-11b").smoke()
    enc = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, cfg.n_cross_tokens, cfg.d_cross)), dtype=torch.float32)
    shapes = dict(requests=4, batch=2, prompt_len=4, gen_len=3, max_len=8, seed=0,
                  registry=None, device="cpu")
    s = SV._serve_waves(cfg, prefill_extra={"encoder": enc}, **shapes)
    assert (s["requests"], s["prefill_waves"], s["decode_steps"], s["tokens"]) == (4, 2, 4, 12)
    assert s["logits_finite"]
    with pytest.raises(ValueError, match="encoder"):
        SV._serve_waves(cfg, **shapes)
