"""The port's sharding rules against the JAX package's, on the CPU.

The spec functions are pure Python in both packages, so their results must
be equal, not close.  For all ten architectures at their published widths
and their smoke widths, on the meshes (1, 1), (4, 2), (16, 16) and
(2, 16, 16) (shape-only meshes: the reference's functions read only
``.shape`` and ``.axis_names``, so the port's ``MeshShape`` serves both):
``param_pspecs`` (with ``special_kv_heads``), ``zero_pspecs``,
``fsdp_pspecs`` and ``cache_pspecs`` at three batch sizes, and ``FALLBACKS``
in content and order.  The JAX side is built from shape-only trees
(``jax.eval_shape`` of ``init_params`` and ``init_cache``), the port's on
the meta device, its parameters named by ``models.convert.to_jax_layout``.
Then ``batch_pspec`` and ``shrink_batch_for``, the port's per-layer rule
(``layer_spec``) against its written statement, and ``placements``.
"""
import functools
import math

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as r_get_config
from repro.models import transformer as RT
from repro.runtime import elastic as RE
from repro.runtime import sharding as RSH
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import transformer as TT
from repro_torch.models.convert import to_jax_layout
from repro_torch.runtime import elastic as TE
from repro_torch.runtime import sharding as SH

MESHES = {"1x1": ((1, 1), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BATCHES = (1, 4, 32)
MAX_LEN = 64


def _jflat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {RSH._path_str(p): tuple(x) for p, x in leaves}


def _tflat(tree, prefix=""):
    if isinstance(tree, SH.PartitionSpec):
        return {prefix: tuple(tree)}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_tflat(v, f"{prefix}.{k}"))
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch, full):
    r_cfg = r_get_config(arch) if full else r_get_config(arch).smoke()
    t_cfg = get_config(arch) if full else get_config(arch).smoke()
    j_params = jax.eval_shape(lambda: RT.init_params(r_cfg, jax.random.PRNGKey(0)))
    named = dict(TT.init_params(t_cfg, None, "meta").named_parameters())
    j_caches = {b: jax.eval_shape(lambda b=b: RT.init_cache(r_cfg, b, MAX_LEN)) for b in BATCHES}
    t_caches = {b: TT.init_cache(t_cfg, b, MAX_LEN, device="meta") for b in BATCHES}
    return r_cfg, t_cfg, j_params, to_jax_layout(named, t_cfg), named, j_caches, t_caches


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_and_fallbacks_equal_the_reference(arch, full, mesh_name):
    r_cfg, t_cfg, j_params, t_params, _, j_caches, t_caches = _trees(arch, full)
    mesh = SH.MeshShape(*MESHES[mesh_name])
    RSH.FALLBACKS.clear()
    SH.FALLBACKS.clear()
    j_tp = RSH.param_pspecs(j_params, mesh, special_kv_heads=r_cfg.n_kv_heads)
    t_tp = SH.param_pspecs(t_params, mesh, special_kv_heads=t_cfg.n_kv_heads)
    assert _tflat(t_tp) == _jflat(j_tp)
    assert _tflat(SH.zero_pspecs(t_tp, t_params, mesh)) == \
        _jflat(RSH.zero_pspecs(j_tp, j_params, mesh))
    assert _tflat(SH.fsdp_pspecs(t_tp, t_params, mesh)) == \
        _jflat(RSH.fsdp_pspecs(j_tp, j_params, mesh))
    for b in BATCHES:
        assert _tflat(SH.cache_pspecs(t_caches[b], mesh, b, t_cfg.n_kv_heads)) == \
            _jflat(RSH.cache_pspecs(j_caches[b], mesh, b, r_cfg.n_kv_heads)), b
        for ndim in (1, 2, 3):
            assert tuple(SH.batch_pspec(mesh, b, ndim)) == tuple(RSH.batch_pspec(mesh, b, ndim))
        assert TE.shrink_batch_for(mesh, b) == RE.shrink_batch_for(mesh, b)
    assert SH.FALLBACKS == RSH.FALLBACKS


def _statement(stacked, layer_shape, sizes):
    """ROADMAP's written rule, from scratch: the period entry dropped; the
    axes it named go to the first unsharded layer dim that their product
    divides (and no larger than it), or nowhere."""
    rest = list(stacked[1:])
    if stacked[0] is None:
        return tuple(rest)
    axes = stacked[0] if isinstance(stacked[0], tuple) else (stacked[0],)
    size = math.prod(sizes[a] for a in axes)
    for i, d in enumerate(layer_shape):
        if rest[i] is None and d % size == 0 and d >= size:
            rest[i] = stacked[0]
            break
    return tuple(rest)


@pytest.mark.parametrize("kind", ["tp", "fsdp", "zero"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_layer_rule_is_the_written_statement(arch, kind):
    _, t_cfg, _, t_params, named, _, _ = _trees(arch, True)
    n = len(t_cfg.period)
    for mesh_name in ("16x16", "2x16x16"):
        mesh = SH.MeshShape(*MESHES[mesh_name])
        stacked = SH.param_pspecs(t_params, mesh, special_kv_heads=t_cfg.n_kv_heads)
        if kind != "tp":
            fn = SH.fsdp_pspecs if kind == "fsdp" else SH.zero_pspecs
            stacked = fn(stacked, t_params, mesh)
        port = SH.port_pspecs(named, t_cfg, mesh, kind)
        assert port.keys() == named.keys()
        for name, spec in port.items():
            parts = name.split(".")
            if parts[0] != "blocks":
                node = stacked
                for p in parts:
                    node = node[p]
                assert spec == node, name
                continue
            node = stacked["blocks"][int(parts[1]) % n]
            for p in parts[2:]:
                node = node[p]
            assert tuple(spec) == _statement(node, named[name].shape, mesh.shape), name
            for entry, d in zip(spec, named[name].shape):  # every sharded dim divides
                axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
                assert d % math.prod(mesh.shape[a] for a in axes) == 0, name


def test_musicgen_period_axis_moves_to_the_layer():
    """The reference shards the stack of 48 periods over data; a layer's wv
    takes data on its own first dim instead."""
    _, t_cfg, _, t_params, named, _, _ = _trees("musicgen-large", True)
    mesh = SH.MeshShape(*MESHES["16x16"])
    stacked = SH.fsdp_pspecs(SH.param_pspecs(t_params, mesh, special_kv_heads=32), t_params,
                             mesh)
    assert tuple(stacked["blocks"][0]["attn"]["wv"]) == ("data", None, "model")
    port = SH.port_pspecs(named, t_cfg, mesh, "fsdp")
    assert tuple(port["blocks.7.attn.wv"]) == ("data", "model")


def test_placements():
    mesh = SH.MeshShape((2, 4, 8), ("pod", "data", "model"))
    assert SH.placements(mesh, SH.P(("pod", "data"), None, "model"), 3) == \
        (Shard(0), Shard(0), Shard(2))
    assert SH.placements(mesh, SH.P(None, "data"), 2) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        SH.placements(mesh, SH.P(("data", "pod")), 1)
    with pytest.raises(ValueError, match="two dims"):
        SH.placements(mesh, SH.P("model", "model"), 2)
    # an axis of size 1 shards nothing
    assert SH.placements(SH.MeshShape((1, 2), ("data", "model")), SH.P("data", "model"), 2) \
        == (Replicate(), Shard(1))
    tree = SH.named(mesh, {"a": SH.P(None, "model"), "b": (SH.P("data"),)})
    assert tree == {"a": (Replicate(), Replicate(), Shard(1)),
                    "b": ((Replicate(), Shard(0), Replicate()),)}


def test_ashard_is_a_noop_outside_a_mesh_and_on_plain_tensors():
    x = torch.ones(4, 8)
    assert SH.ashard(x, ("batch", None)) is x
    with SH.use_mesh(SH.MeshShape((2, 2), ("data", "model"))):
        assert SH.current_mesh() is not None
        assert SH.ashard(x, ("batch", None)) is x
    assert SH.current_mesh() is None
