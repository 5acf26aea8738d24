"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

Smoke configs of musicgen-large, rwkv6-7b, jamba and llama-3.2-vision are
traced for train, prefill and decode on the production one-pod mesh (16 x
16, over a fake process group of 256 ranks; 32 sequences of 32 tokens), and
each record's argument bytes are held equal to the local-shard bytes that
the JAX package's spec functions give on ``jax.eval_shape`` shapes
(``param_pspecs``, ``fsdp_pspecs``, ``zero_pspecs``, ``cache_pspecs``,
``batch_pspec``): each leaf's bytes over the product of the mesh axes its
spec names.  The port keeps no f32 master copy of an f32 model's
parameters (``models/steps.py`` ``init_train_state``), where the
reference's dry-run keeps one always, so the reference's state is taken
with ``keep_master`` as the port's.  Then the counters: a known product's
FLOPs per device, a data-parallel mesh's share of the FLOPs, a
redistribute's all-gather bytes; and the records: ``roofline.load_all``,
``main``'s exit codes with an erring cell, and a skipped ``long_500k``.
"""
import dataclasses
import json
import math

import jax
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import input_specs as r_input_specs
from repro.models import transformer as RT
from repro.optim import adamw_init as r_adamw_init
from repro.runtime import sharding as RSH
from repro_torch.analysis import roofline
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs import shapes_for as t_shapes_for
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.runtime.sharding import MeshShape

ARCHS = ("musicgen-large", "rwkv6-7b", "jamba-v0.1-52b", "llama-3.2-vision-11b")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
SINGLE = MeshShape((16, 16), ("data", "model"))


def _cell(name, seq=32, batch=32):
    return dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=batch)


def _spec_bytes(tree, specs):
    """Local bytes of each leaf of ``tree`` under the reference's ``specs``."""
    def factor(spec):
        n = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (() if entry is None else (entry,))):
                n *= SINGLE.shape[a]
        return n

    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, RSH.P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        assert n % factor(spec) == 0
        total += n // factor(spec)
    return total


def reference_argument_bytes(arch, cell):
    """The reference dry-run's per-device argument bytes for the smoke
    config's cell (no master copy for an f32 model, as the port)."""
    cfg = r_get_config(arch).smoke()
    specs = r_input_specs(cfg, cell)
    params = jax.eval_shape(lambda: RT.init_params(cfg, jax.random.PRNGKey(0)))
    tp = RSH.param_pspecs(params, SINGLE, special_kv_heads=cfg.n_kv_heads)
    batch = jax.tree.map(lambda s: RSH.batch_pspec(SINGLE, s.shape[0], len(s.shape)),
                         specs["batch"])
    total = _spec_bytes(specs["batch"], batch)
    if cell.kind == "train":
        total += _spec_bytes(params, RSH.fsdp_pspecs(tp, params, SINGLE))
        opt = jax.eval_shape(lambda p: r_adamw_init(p, keep_master=cfg.dtype != "float32"),
                             params)
        zero = RSH.zero_pspecs(tp, params, SINGLE)
        total += 4 + _spec_bytes(opt.mu, zero) + _spec_bytes(opt.nu, zero)
        if opt.master is not None:
            total += _spec_bytes(opt.master, zero)
        return total
    total += _spec_bytes(params, tp)
    if cell.kind == "decode":
        total += _spec_bytes(specs["caches"], RSH.cache_pspecs(
            specs["caches"], SINGLE, cell.global_batch, cfg.n_kv_heads))
    return total


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_trace_on_the_production_mesh(arch, kind):
    cell = _cell(kind)
    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        rec = D.trace_cell(get_config(arch).smoke(), cell, mesh)
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] == reference_argument_bytes(arch, cell)
    assert ma["argument_size_in_bytes"] == sum(rec["argument_bytes_by_group"].values())
    groups = {"train": {"params", "optimizer", "batch"}, "prefill": {"params", "batch"},
              "decode": {"params", "batch", "cache"}}[cell.kind]
    assert set(rec["argument_bytes_by_group"]) == groups
    assert ma["temp_size_in_bytes"] > 0 and ma["output_size_in_bytes"] > 0
    assert rec["cost_analysis"]["flops"] > 0 and rec["cost_analysis"]["bytes accessed"] > 0
    assert rec["corrected"]["flops"] == rec["cost_analysis"]["flops"]
    assert sum(rec["collective_counts"].values()) > 0
    assert set(rec["collective_bytes"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                            "all-to-all"}


def _traced(fn, *args):
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        made = [f() for f in args]
    with D.StepTrace(fake, made) as trace:
        fn(*made)
    return trace


def test_flops_are_per_device():
    """(4096 x 8192) . (8192 x 8192) bf16 on (16, 16): each rank multiplies
    a (256 x 8192) row block by an (8192 x 512) column block."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        trace = _traced(
            lambda a, b: a @ b,
            lambda: distribute_tensor(torch.empty(4096, 8192, dtype=torch.bfloat16), mesh,
                                      [Shard(0), Replicate()], src_data_rank=None),
            lambda: distribute_tensor(torch.empty(8192, 8192, dtype=torch.bfloat16), mesh,
                                      [Replicate(), Shard(1)], src_data_rank=None))
    assert trace.flops == 2 * 256 * 512 * 8192  # 2.15e9; globally 5.50e11
    assert trace.collective_counts == {}


def test_redistribute_records_its_all_gather():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with D.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        trace = _traced(
            lambda x: x.redistribute(mesh, [Replicate(), Replicate()]),
            lambda: distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Replicate()],
                                      src_data_rank=None))
    assert trace.collective_counts == {"all-gather": 1}
    assert trace.collective_bytes == {"all-gather": 4 * 32 * 4}  # the (4, 32) f32 shard
    assert trace.flops == 0


def test_a_data_parallel_mesh_counts_a_quarter_of_the_flops():
    cfg, cell = get_config("musicgen-large").smoke(), _cell("train_4k", batch=8)
    flops = {}
    for shape in ((1, 1), (4, 1)):
        with D.fake_world(math.prod(shape)):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            flops[shape] = D.trace_cell(cfg, cell, mesh)["cost_analysis"]["flops"]
    assert flops[(4, 1)] == pytest.approx(flops[(1, 1)] / 4, rel=1e-2)


@pytest.fixture
def smoke_sweep(monkeypatch):
    """``run_cell`` and ``main`` on the smoke configs at 32 x 32 cells, with
    the records under the real architecture names."""
    cells = {name: _cell(name, batch=32 if name != "long_500k" else 1) for name in SHAPES}
    monkeypatch.setattr(D, "get_config", lambda arch: get_config(arch).smoke())
    monkeypatch.setattr(D, "SHAPES", cells)
    monkeypatch.setattr(D, "shapes_for", lambda cfg: tuple(
        cells[c.name] for c in t_shapes_for(cfg)))


def test_records_feed_the_roofline(smoke_sweep, tmp_path):
    assert D.main(["--arch", "musicgen-large", "--shape", "decode_32k", "--mesh", "single",
                   "--out", str(tmp_path)]) == 0
    assert D.main(["--arch", "musicgen-large", "--shape", "long_500k", "--mesh", "single",
                   "--out", str(tmp_path)]) == 0
    skipped = json.loads((tmp_path / "musicgen-large__long_500k__single.json").read_text())
    assert skipped["status"] == "skipped"
    rec = json.loads((tmp_path / "musicgen-large__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["mesh_shape"] == {"data": 16, "model": 16}
    for key in ("arch", "shape", "mesh", "kind", "seq_len", "global_batch", "trace_s",
                "memory_analysis", "cost_analysis", "collective_bytes", "collective_counts",
                "corrected", "n_params", "n_params_active", "sharding_fallbacks"):
        assert key in rec
    rows = roofline.load_all(str(tmp_path))
    assert [(r.arch, r.shape) for r in rows] == [("musicgen-large", "decode_32k")]
    assert rows[0].chips == 256 and rows[0].flops == rec["cost_analysis"]["flops"]


def test_main_exits_1_and_records_an_erring_cell(smoke_sweep, tmp_path, monkeypatch):
    def broken(cfg, cell, mesh):
        raise RuntimeError("no step for this cell")

    monkeypatch.setattr(D, "build_step", broken)
    assert D.main(["--arch", "rwkv6-7b", "--shape", "decode_32k", "--mesh", "single",
                   "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "rwkv6-7b__decode_32k__single.json").read_text())
    assert rec["status"] == "error" and "no step for this cell" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert roofline.load_all(str(tmp_path)) == []
