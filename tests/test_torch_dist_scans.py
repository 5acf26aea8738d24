"""The RWKV-6 and Mamba models under a (2, 2) mesh of ``gloo`` ranks.

``tests/torch_dist_ranks.py scans`` runs rwkv6-7b's smoke config with two
heads (head dim 32, so that the model axis shards its heads, its state and
its bonus ``u``) and jamba's on 4 ranks, from the reference's weights, each
scan on its (batch, head or channel) shard through ``local_map``.  Held
against the JAX package, unsharded, on the same weights and batch
(``tests/torch_dist_ref.py``), and against the unsharded port: the loss
(1e-5 relative), every gradient (5e-4 relative per leaf,
``tests/test_torch_train.py``'s limit), the prefill's last logits and a
decode step's (1e-4); and the recurrent states' placements (RWKV-6's heads
and Mamba's d_inner over model, the batch over data; ``cache_pspecs``).
"""
import numpy as np
import pytest

from torch_dist_ref import rel, run_ranks, scan_references

LOSS_LIMIT, GRAD_LIMIT, SERVE_LIMIT = 1e-5, 5e-4, 1e-4


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    refs, inputs = scan_references()
    res, js = run_ranks(tmp_path_factory.mktemp("scans"), "scans", 4, inputs, timeout=240)
    return res, js, refs


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_scan_models_on_2x2_match_the_unsharded_port(scans, arch):
    r = scans[1][arch]
    assert abs(r["loss"] - r["want"]) <= LOSS_LIMIT * abs(r["want"])
    assert r["grad_rel"] <= GRAD_LIMIT
    assert r["prefill_rel"] <= SERVE_LIMIT and r["decode_rel"] <= SERVE_LIMIT


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_scan_models_on_2x2_match_jax(scans, arch):
    res, js, refs = scans
    want = refs[arch]
    assert abs(js[arch]["loss"] - want["loss"]) <= LOSS_LIMIT * abs(want["loss"])
    bad = {k: rel(res[f"{arch}/grad/{k}"], w) for k, w in want["grads"].items()
           if np.abs(w).max() > 0 and not rel(res[f"{arch}/grad/{k}"], w) <= GRAD_LIMIT}
    assert not bad, bad
    last, logits = want["serving"]
    assert rel(res[f"{arch}/prefill"], last) <= SERVE_LIMIT
    assert rel(res[f"{arch}/decode"], logits) <= SERVE_LIMIT


def test_recurrent_states_are_placed_by_cache_pspecs(scans):
    js = scans[1]
    # RWKV-6's 2 heads and Mamba's d_inner 128 over model, the batch over data
    assert js["rwkv6-7b"]["state_placements"]["s"] == "(Shard(dim=1), Shard(dim=2))"
    assert js["jamba-v0.1-52b"]["state_placements"]["h"] == "(Shard(dim=1), Shard(dim=2))"
