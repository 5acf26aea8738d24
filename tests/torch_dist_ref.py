"""The JAX side of ``tests/test_torch_dist*.py``: the reference's weights,
batches, loss, gradients, train steps and serving steps, unsharded, for
the rank programs of ``tests/torch_dist_ranks.py`` to be held against;
and the runner that spawns those ranks.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as r_get_config
from repro.data import make_dataset
from repro.models import steps as RS
from repro.models import transformer as RT
from repro.optim import adamw_init as r_adamw_init
from repro.optim.schedules import cosine_with_warmup as r_cosine
from repro_torch.configs import get_config
from repro_torch.models.convert import from_jax_layout
from torch_dist_ranks import LLAMA4_MAX_LEN, LLAMA4_PROMPT, LR, SCAN_ARCHS, scan_config

HERE = os.path.dirname(os.path.abspath(__file__))
SCAN_BATCH, SCAN_SEQ, SCAN_MAX_LEN = 4, 24, 32  # torch_dist_ranks._scans


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def flat(tree, prefix):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}/{key}"))
        elif isinstance(val, tuple):
            out.update(flat({str(i): v for i, v in enumerate(val)}, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(val)
    return out


def run_ranks(tmp_path, scenario, world, inputs, timeout):
    """Run the scenario on ``world`` ranks with the arrays ``inputs``;
    returns (arrays, json)."""
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(HERE, "torch_dist_ranks.py"), scenario,
                           str(world), str(tmp_path)], env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp_path / "result.json") as f:
        return np.load(tmp_path / "result.npz"), json.load(f)


def inputs_of(params, batch, prefix=""):
    """A model's weights and batch as the rank programs read them."""
    head = f"{prefix}/" if prefix else ""
    return {**flat(params, f"{head}params"),
            **{f"{head}{k}": np.asarray(v) for k, v in batch.items()}}


def port_names(tree, cfg):
    """A JAX-layout tree as numpy arrays keyed by the port's names."""
    return {k: np.asarray(v) for k, v in from_jax_layout(jax.tree.map(np.asarray, tree),
                                                         cfg).items()}


def reference(arch, batch_size, seq_len=16, cfgs=None):
    """The reference's smoke weights (key 0) and batch 1 of its pipeline;
    ``cfgs`` a (JAX, port) pair of configs in place of the smoke ones."""
    r_cfg, t_cfg = cfgs or (r_get_config(arch).smoke(), get_config(arch).smoke())
    params = RT.init_params(r_cfg, jax.random.PRNGKey(0))
    batch = make_dataset(r_cfg, None, seed=0, global_batch=batch_size,
                         seq_len=seq_len).batch(1)
    return r_cfg, t_cfg, params, batch


def loss_and_grads(r_cfg, t_cfg, params, batch):
    """The reference's loss and gradients (keyed by the port's names)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(RS.make_loss_fn(r_cfg), has_aux=True))(
        params, jb)
    return float(loss), port_names(grads, t_cfg)


@functools.lru_cache(maxsize=None)
def jax_training(arch, batch_size):
    """The reference's loss and gradients, then its two train steps' metrics
    and parameters (keyed by the port's names), on ``reference``'s inputs."""
    r_cfg, t_cfg, params, batch = reference(arch, batch_size)
    loss, grads = loss_and_grads(r_cfg, t_cfg, params, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(RS.make_train_step(r_cfg, r_cosine(*LR)))
    opt, steps = r_adamw_init(params), []
    for _ in (1, 2):
        params, opt, m = step(params, opt, jb)
        steps.append(({k: float(m[k]) for k in ("loss", "grad_norm")},
                      port_names(params, t_cfg)))
    return loss, grads, steps


def serving(r_cfg, params, prompt, one, max_len):
    """The reference's prefill of ``prompt`` (B, S) and one decode step of
    ``one`` (B, 1): (last logits (B, V), the step's logits (B, 1, V))."""
    last, caches, n = RS.make_prefill_step(r_cfg, max_len)(
        params, {"tokens": jnp.asarray(prompt, jnp.int32)})
    _, logits, _ = RS.make_decode_step(r_cfg)(params, {"tokens": jnp.asarray(one, jnp.int32)},
                                              caches, jnp.int32(n))
    return np.asarray(last), np.asarray(logits)


def llama4_serving(params, batch):
    """``serving`` of llama4-scout's smoke config as ``torch_dist_ranks._llama4``
    prefills and decodes."""
    tokens = np.asarray(batch["tokens"])
    return serving(r_get_config("llama4-scout-17b-a16e").smoke(), params,
                   tokens[:, :LLAMA4_PROMPT], tokens[:, LLAMA4_PROMPT:LLAMA4_PROMPT + 1],
                   LLAMA4_MAX_LEN)


def scan_references():
    """For each of ``torch_dist_ranks.SCAN_ARCHS`` (its scenario's configs):
    the reference's weights and batch, loss and gradients, and serving
    logits; and the rank programs' inputs for all of them."""
    refs, inputs = {}, {}
    for arch in SCAN_ARCHS:
        cfgs = scan_config(r_get_config, arch), scan_config(get_config, arch)
        r_cfg, t_cfg, params, batch = reference(arch, SCAN_BATCH, SCAN_SEQ, cfgs)
        loss, grads = loss_and_grads(r_cfg, t_cfg, params, batch)
        tokens = np.asarray(batch["tokens"])
        refs[arch] = {"loss": loss, "grads": grads,
                      "serving": serving(r_cfg, params, tokens, tokens[:, :1], SCAN_MAX_LEN)}
        inputs.update(inputs_of(params, batch, arch))
    return refs, inputs
