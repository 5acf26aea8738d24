"""``repro_torch.configs.input_specs`` against the JAX package's, leaf for leaf.

For every architecture and every shape cell, the port's stand-ins (meta
tensors: shape and dtype, no storage) have the reference's structure, and
each leaf the shape and dtype of the reference's ``ShapeDtypeStruct`` (its
decode caches come from ``jax.eval_shape``).  A sliding-window layer's
``k``/``v`` cache has ``min(seq_len, window)`` slots in both packages; the
port uses them as a ring (``models/transformer.py`` ``init_cache``), the
reference clamps its writes to the last slot: a difference of layout, not
of shape.
"""
import pytest
import torch

from repro.configs import ALL_SHAPES
from repro.configs import ARCHS as R_ARCHS
from repro.configs import input_specs as r_input_specs
from repro_torch.configs import get_config, input_specs
from repro_torch.configs.base import ATTN_LOCAL


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}/{i}")
    else:
        yield path, tree


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_structure(x) for x in tree]
    return None


@pytest.mark.parametrize("cell", ALL_SHAPES, ids=lambda c: c.name)
@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_input_specs_match_the_reference(arch, cell):
    port = input_specs(get_config(arch), cell)
    ref = r_input_specs(R_ARCHS[arch], cell)
    assert _structure(port) == _structure(ref)
    for (path, t), (rpath, r) in zip(_leaves(port), _leaves(ref)):
        assert path == rpath
        assert isinstance(t, torch.Tensor) and t.is_meta, path  # no storage
        assert tuple(t.shape) == tuple(r.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), path


@pytest.mark.parametrize("arch,n_local", [("gemma2-27b", 1), ("gemma3-12b", 5)])
def test_sliding_window_caches_hold_the_window(arch, n_local):
    """At 32k tokens a local layer's cache holds its window, not the sequence."""
    cfg = get_config(arch)
    cell = next(c for c in ALL_SHAPES if c.name == "decode_32k")
    caches = input_specs(cfg, cell)["caches"]
    local = [pos for pos, spec in enumerate(cfg.period) if spec.mixer == ATTN_LOCAL]
    assert len(local) == n_local
    for pos, spec in enumerate(cfg.period):
        slots = spec.window if spec.mixer == ATTN_LOCAL else cell.seq_len
        assert caches[pos]["k"].shape[2] == caches[pos]["v"].shape[2] == slots
