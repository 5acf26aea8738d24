"""The port's checkpoints and fault tolerance against the JAX package's.

* A ``(params, AdamWState)`` checkpoint written by ``repro.checkpoint`` (f32
  musicgen-large smoke, and the same model in bf16 with an f32 master copy)
  restores through the port's training launcher (``TrainCheckpoints``: the
  live parameters, moments and master take the saved values, equal), and a
  port-written one restores through ``repro.checkpoint``: same manifest
  keys, dtypes and shapes, equal values (bf16 leaves as the two-byte
  records the JAX package writes, compared through ``ml_dtypes``).
* The atomic ``.tmp`` rename, keep-N, a truncated leaf and a corrupted leaf
  raising.
* ``FaultTolerantRunner`` replaying from the last checkpoint after an
  injected failure to the same state as a run without one, and the
  straggler watchdog flagging a slow host as the JAX package's does.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.configs import get_config as r_get_config
from repro.models import transformer as RT
from repro.optim import AdamWState as RAdamWState
from repro.optim import adamw_init as r_adamw_init
from repro.runtime import ft as RFT
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.launch.train import TrainCheckpoints
from repro_torch.models import steps as TS
from repro_torch.models.convert import opt_state_to_jax, params_to_jax
from repro_torch.runtime import ft as TFT


def _cfgs(dtype):
    kw = {"dtype": dtype}
    return (dataclasses.replace(r_get_config("musicgen-large").smoke(), **kw),
            dataclasses.replace(get_config("musicgen-large").smoke(), **kw))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _f64(x):
    x = np.asarray(x)
    if x.dtype.kind == "V":  # a bf16 leaf as np.load gives it
        x = x.view(ml_dtypes.bfloat16)
    return x.astype(np.float64)


def _jax_state(r_cfg, seed):
    params = RT.init_params(r_cfg, jax.random.PRNGKey(seed))
    opt = r_adamw_init(params, keep_master=r_cfg.dtype != "float32")
    rng = np.random.default_rng(seed)
    noise = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), t)
    return params, RAdamWState(jnp.asarray(7, jnp.int32), noise(opt.mu), noise(opt.nu),
                               opt.master)


def _port_state(t_cfg, seed):
    params, opt = TS.init_train_state(t_cfg, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for d in (opt.mu, opt.nu):
        for t in d.values():
            t.copy_(torch.randn(t.shape, generator=g))
    return params, opt._replace(step=torch.tensor(11, dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_port(tmp_path, dtype):
    r_cfg, t_cfg = _cfgs(dtype)
    state = _jax_state(r_cfg, 0)
    RManager(str(tmp_path)).save(40, state, extras={"arch": r_cfg.name})
    ckpt = TrainCheckpoints(CheckpointManager(str(tmp_path)), t_cfg)
    step, (params, opt), extras = ckpt.restore_latest(_port_state(t_cfg, 5))
    assert step == 40 and extras["arch"] == r_cfg.name and int(opt.step) == 7
    want = _leaves(state)
    got = _leaves((params_to_jax(params, t_cfg), RAdamWState(*opt_state_to_jax(opt, t_cfg))))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(_f64(got[k]), _f64(want[k]), err_msg=k)
    assert (opt.master is None) == (dtype == "float32")
    if dtype == "bfloat16":
        assert params["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    r_cfg, t_cfg = _cfgs(dtype)
    params, opt = _port_state(t_cfg, 1)
    TrainCheckpoints(CheckpointManager(str(tmp_path / "port")), t_cfg).save(
        12, (params, opt), extras={"arch": t_cfg.name})
    template = _jax_state(r_cfg, 3)
    step, restored, extras = RManager(str(tmp_path / "port")).restore_latest(template)
    assert step == 12 and extras == {"arch": t_cfg.name, "step": 12}
    got = _leaves(restored)
    want = _leaves((params_to_jax(params, t_cfg), RAdamWState(*opt_state_to_jax(opt, t_cfg))))
    assert got.keys() == want.keys() == _leaves(template).keys()
    for k in want:
        np.testing.assert_array_equal(_f64(got[k]), _f64(want[k]), err_msg=k)
    # the same manifest as the JAX package writes for this tree
    RManager(str(tmp_path / "jax")).save(12, template)
    manifests = [json.load(open(tmp_path / d / "step_000000012" / "meta.json"))["manifest"]
                 for d in ("port", "jax")]
    assert manifests[0].keys() == manifests[1].keys()
    for k, ent in manifests[1].items():
        assert {f: manifests[0][k][f] for f in ("file", "shape", "dtype")} == \
               {f: ent[f] for f in ("file", "shape", "dtype")}, k
    if dtype == "bfloat16":
        leaf = manifests[0]["[0]['blocks'][0]['attn']['wq']"]
        assert leaf["dtype"] == "bfloat16"
        header = open(tmp_path / "port" / "step_000000012" / leaf["file"], "rb").read(80)
        assert b"'descr': '<V2'" in header


def test_atomic_rename_and_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    os.makedirs(tmp_path / "step_000000009.tmp")  # a save killed midway
    tree = {"w": torch.arange(6.0).reshape(2, 3), "n": (torch.tensor(3), None)}
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": tree["w"] + s, "n": tree["n"]})
    assert mgr.steps() == [3, 4]
    assert not any(n.endswith(".tmp") and n != "step_000000009.tmp"
                   for n in os.listdir(tmp_path))
    step, state, extras = mgr.restore_latest(tree)
    assert step == 4 and extras == {"step": 4} and state["n"][1] is None
    assert torch.equal(state["w"], tree["w"] + 4)
    save_pytree(tree, str(tmp_path / "again"))
    save_pytree({"w": tree["w"] * 2, "n": tree["n"]}, str(tmp_path / "again"))  # overwrite
    assert torch.equal(load_pytree(tree, str(tmp_path / "again"))[0]["w"], tree["w"] * 2)


@pytest.mark.parametrize("damage", ["truncate", "corrupt"])
def test_damaged_leaf_raises(tmp_path, damage):
    tree = {"w": torch.randn(64, 16), "b": torch.randn(16).to(torch.bfloat16)}
    save_pytree(tree, str(tmp_path / "ck"))
    meta = json.load(open(tmp_path / "ck" / "meta.json"))
    path = tmp_path / "ck" / meta["manifest"]["['w']"]["file"]
    data = path.read_bytes()
    if damage == "truncate":
        path.write_bytes(data[: len(data) // 2])
        with pytest.raises((IOError, ValueError)):
            load_pytree(tree, str(tmp_path / "ck"))
    else:
        path.write_bytes(data[:-4] + bytes(4))
        with pytest.raises(IOError, match="checksum"):
            load_pytree(tree, str(tmp_path / "ck"))


def test_runner_replays_after_injected_failure(tmp_path):
    def step_fn(state, batch):
        return {"w": state["w"] * 0.5 + batch}, {"loss": state["w"].sum()}

    def run(fail_at, sub):
        runner = TFT.FaultTolerantRunner(
            step_fn, CheckpointManager(str(tmp_path / sub)), save_every=3,
            injector=TFT.FailureInjector(fail_at) if fail_at else None)
        state, step, log = runner.run({"w": torch.ones(4)}, lambda s: torch.full((4,), float(s)),
                                      0, 10)
        return state, step, log, runner

    clean, _, clean_log, _ = run(None, "clean")
    state, step, log, runner = run([7], "faulty")
    assert step == 10 and runner.restarts == 1 and runner.injector.fired == [7]
    assert runner.restart_log[0][0] == 7
    assert torch.equal(state["w"], clean["w"])
    # steps 6 (after the restore from step 6) onwards ran twice
    assert [m["step"] for m in log] == list(range(7)) + list(range(6, 10))
    assert [m["loss"] for m in log[7:]] == [m["loss"] for m in clean_log[6:]]


def test_watchdog_flags_slow_host():
    times = np.full((12, 4), 1.0) + np.random.default_rng(0).normal(0, 0.01, (12, 4))
    times[4:, 2] = 3.0  # host 2 turns slow at step 4
    events = []
    for wd in (RFT.StragglerWatchdog(n_hosts=4), TFT.StragglerWatchdog(n_hosts=4)):
        flagged = [wd.record(step, t) for step, t in enumerate(times)]
        events.append(wd.events)
        assert any(2 in f for f in flagged) and all(f in ([], [2]) for f in flagged)
    assert events[0] == events[1]
