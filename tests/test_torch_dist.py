"""The port's distributed runtime on CPU process groups (``gloo``).

Each test runs ``tests/torch_dist_ranks.py`` in a subprocess that spawns the
ranks (one process a rank, meeting through a file under the test's
temporary directory, so the test workers' groups never collide), with a
timeout of its own.  The JAX reference runs here, unsharded, on the same
weights and batch:

* olmoe-1b-7b's smoke config under FSDP/ZeRO placements on a (2, 2) mesh
  of 4 ranks and the reference's (4, 2) of 8: the loss and every gradient
  against ``jax.value_and_grad`` (5e-4 relative per leaf, the limit of
  ``tests/test_torch_train.py``), then two AdamW steps against the
  reference's ``make_train_step`` (the first step's loss, grad norm and
  each parameter within 1e-5 relative per leaf, the second's within 5e-4);
  on 4 ranks also prefill and a decode step under the mesh against the
  reference's and the unsharded port's (1e-4, equal greedy tokens), a
  checkpoint of the trained state written by the 4 ranks and restored at
  1 rank and in ``repro.checkpoint``, and ``remesh`` 4 -> 2 -> 1 -> 4 bit
  for bit;
* llama4-scout's smoke config (4 q heads, 2 kv heads) on a (1, 4) mesh,
  where K and V are replicated over the model axis and each rank cuts out
  its q head's kv head: the loss and every gradient against the
  reference's (1e-5, 5e-4) and the unsharded port's; then a prefill and a
  decode step whose caches put their sequence dim on the model axis, each
  rank writing its own slots: the logits against the reference's and the
  unsharded port's, and the whole caches against the port's (1e-4).

The reference's side is ``tests/torch_dist_ref.py``.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.optim import AdamWState as RAdamWState
from repro.optim import adamw_init as r_adamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.train import TrainCheckpoints
from repro_torch.models import steps as TS
from torch_dist_ref import (
    inputs_of,
    jax_training,
    llama4_serving,
    loss_and_grads,
    port_names,
    reference,
    rel,
    run_ranks,
    serving,
)

GRAD_LIMIT = 5e-4
STEP_LIMIT = 1e-5
SERVE_LIMIT = 1e-4
BATCH = 8  # divides the data axis of both meshes


def _check_training(res, js, arch, batch_size):
    loss, grads, steps = jax_training(arch, batch_size)
    assert abs(js["loss0"] - loss) <= STEP_LIMIT * abs(loss)
    bad = {k: rel(res[f"grad/{k}"], w) for k, w in grads.items()
           if np.abs(w).max() > 0 and not rel(res[f"grad/{k}"], w) <= GRAD_LIMIT}
    assert not bad, bad
    # one AdamW step at 1e-5 on the parameters; the second step's Adam
    # ratios amplify the first step's rounding (the unsharded port reads
    # 1.8e-5 on olmoe's w_gate there), so it is held at the gradients' limit
    for i, limit, (m, want) in zip((1, 2), (STEP_LIMIT, GRAD_LIMIT), steps):
        for key in ("loss", "grad_norm"):
            assert abs(js[f"{key}{i}"] - m[key]) <= limit * abs(m[key]), (i, key)
        bad = {k: rel(res[f"step{i}/{k}"], w) for k, w in want.items()
               if not rel(res[f"step{i}/{k}"], w) <= limit}
        assert not bad, (i, bad)


@pytest.fixture(scope="module")
def olmoe4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("olmoe4")
    r_cfg, t_cfg, params, batch = reference("olmoe-1b-7b", BATCH)
    res, js = run_ranks(tmp, "olmoe", 4, inputs_of(params, batch), timeout=240)
    return tmp, res, js, (r_cfg, t_cfg, params, batch)


def test_olmoe_train_steps_on_2x2_match_jax(olmoe4):
    _, res, js, _ = olmoe4
    _check_training(res, js, "olmoe-1b-7b", BATCH)
    # FSDP on the data axis, TP (heads) on the model axis
    assert js["placements"]["blocks.0.attn.wq"] == "(Replicate(), Shard(dim=1))"
    assert js["placements"]["blocks.0.moe.w_gate"] == "(Shard(dim=2), Shard(dim=0))"


def test_olmoe_prefill_and_decode_on_2x2_match_the_unsharded_port(olmoe4):
    _, _, js, _ = olmoe4
    assert js["prefill_rel"] <= SERVE_LIMIT and js["decode_rel"] <= SERVE_LIMIT
    assert js["tokens_equal"]
    # batch over data, the kv heads over model (cache_pspecs)
    assert js["cache_placements"]["k"] == "(Shard(dim=1), Shard(dim=3))"


def test_olmoe_prefill_and_decode_on_2x2_match_jax(olmoe4):
    _, res, _, (r_cfg, _, params, batch) = olmoe4
    tokens = np.asarray(batch["tokens"])
    last, logits = serving(r_cfg, params, tokens, tokens[:, :1], 48)
    assert rel(res["prefill"], last) <= SERVE_LIMIT
    assert rel(res["decode"], logits) <= SERVE_LIMIT


def test_remesh_4_2_1_4_keeps_every_value(olmoe4):
    _, _, js, _ = olmoe4
    assert js["remesh_equal"] == [True, True, True]
    # wq (64, 64) under the ZeRO specs: data on its first dim, heads on its
    # second (an axis of size 1 replicates)
    assert js["remesh_placements"] == ["(Shard(dim=0), Replicate())",
                                       "(Replicate(), Replicate())",
                                       "(Shard(dim=0), Shard(dim=1))"]


def test_checkpoint_of_4_ranks_restores_at_1_rank_and_in_jax(olmoe4):
    tmp, res, _, (r_cfg, t_cfg, params, batch) = olmoe4
    # at one rank: the port's launcher checkpoints over a plain state
    plain = TS.init_train_state(t_cfg, torch.Generator().manual_seed(9), "cpu")
    step, (t_params, t_opt), _ = TrainCheckpoints(
        CheckpointManager(str(tmp / "ckpt")), t_cfg).restore_latest(plain)
    assert step == 2 and int(t_opt.step) == 2
    for k, p in t_params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), res[f"step2/{k}"], err_msg=k)
        np.testing.assert_array_equal(t_opt.mu[k].numpy(), res[f"mu/{k}"], err_msg=k)
    # in the JAX package
    template = (params, r_adamw_init(params))
    step, (j_params, j_opt), _ = RManager(str(tmp / "ckpt")).restore_latest(template)
    assert step == 2 and int(j_opt.step) == 2
    for k, v in port_names(j_params, t_cfg).items():
        np.testing.assert_array_equal(v, res[f"step2/{k}"], err_msg=k)
    assert isinstance(j_opt, RAdamWState)


def test_olmoe_train_steps_on_4x2_match_jax(tmp_path):
    _, _, params, batch = reference("olmoe-1b-7b", BATCH)
    res, js = run_ranks(tmp_path, "olmoe", 8, inputs_of(params, batch), timeout=300)
    _check_training(res, js, "olmoe-1b-7b", BATCH)
    assert js["placements"]["blocks.0.moe.w_gate"] == "(Shard(dim=2), Shard(dim=0))"


@pytest.fixture(scope="module")
def llama4(tmp_path_factory):
    r_cfg, t_cfg, params, batch = reference("llama4-scout-17b-a16e", 2)
    assert (t_cfg.n_heads, t_cfg.n_kv_heads) == (4, 2)
    res, js = run_ranks(tmp_path_factory.mktemp("llama4"), "llama4", 4,
                        inputs_of(params, batch), timeout=240)
    return res, js, (r_cfg, t_cfg, params, batch)


def test_llama4_gqa_on_1x4_cuts_the_replicated_kv_heads(llama4):
    res, js, (r_cfg, t_cfg, params, batch) = llama4
    assert abs(js["loss"] - js["want"]) <= SERVE_LIMIT * abs(js["want"])
    # gradients at the gradient limit: the router's sums its experts' shards
    # in another order (read 1.03e-4; the unsharded port's router is 6.9e-5
    # from the reference's, tests/test_torch_train.py)
    bad = {k: e for k, e in js["grad_rel"].items() if not e <= GRAD_LIMIT}
    assert not bad, bad
    assert js["wq_placements"] == "(Replicate(), Shard(dim=1))"


def test_llama4_gqa_on_1x4_matches_jax(llama4):
    res, js, (r_cfg, t_cfg, params, batch) = llama4
    loss, grads = loss_and_grads(r_cfg, t_cfg, params, batch)
    assert abs(js["loss"] - loss) <= STEP_LIMIT * abs(loss)
    bad = {k: rel(res[f"grad/{k}"], w) for k, w in grads.items()
           if np.abs(w).max() > 0 and not rel(res[f"grad/{k}"], w) <= GRAD_LIMIT}
    assert not bad, bad


def test_llama4_serving_on_1x4_with_the_cache_sequence_on_model(llama4):
    res, js, (r_cfg, t_cfg, params, batch) = llama4
    # 2 kv heads do not divide the model axis of 4: the caches' sequence
    # dim (n_periods, B, T, HKV, D) is on model (cache_pspecs), slots of 8
    assert js["cache_placements"] == "(Replicate(), Shard(dim=2))"
    last, logits = llama4_serving(params, batch)
    assert rel(res["prefill"], last) <= SERVE_LIMIT
    assert rel(res["decode"], logits) <= SERVE_LIMIT
    assert js["prefill_rel"] <= SERVE_LIMIT and js["decode_rel"] <= SERVE_LIMIT
    assert js["cache_rel"] <= SERVE_LIMIT
