"""Elastic scaling: re-place a state across a different mesh.

``remesh(state, new_mesh, spec_tree)`` re-places every leaf under the new
mesh/sharding — the mechanism behind shrinking 2 pods -> 1 pod after a pod
loss, or growing when capacity returns.  DTensor cannot redistribute
between two meshes, so a leaf goes through its whole value: every rank of
its old mesh gathers it (``full_tensor``), and ``distribute_tensor`` cuts
it for the new mesh from the new mesh's first rank, so a rank the old mesh
did not span (a mesh that grows) receives it.  Every rank of the process
group must call :func:`remesh` with the same tree: the gathers and the
scatter are collectives.  A rank outside the new mesh gets a DTensor
without local data, as DTensor gives one.  Across process groups of
different sizes (a restart at another world size) the way through is a
checkpoint (``checkpoint/manager.py`` saves whole leaves).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from .sharding import DEFAULT_RULES, _is_spec, _map_with_path, mesh_sizes, placements


def _whole(leaf) -> Optional[torch.Tensor]:
    """The leaf's whole value on this rank, or None where its mesh does not
    hold this rank."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return leaf.detach()
    if leaf.device_mesh.get_coordinate() is None:
        return None
    return leaf.full_tensor().detach()


def remesh(state: Any, mesh, spec_tree: Any) -> Any:
    """Re-place ``state`` so each leaf has its spec under ``mesh``."""
    from torch.distributed.tensor import distribute_tensor

    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def one(_, spec, leaf):
        whole = _whole(leaf)
        if whole is None:
            whole = torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device=device)
        return distribute_tensor(whole.to(device), mesh,
                                 placements(mesh, spec, whole.ndim), src_data_rank=0)

    # the specs lead the walk: a PartitionSpec is a tuple, but a leaf
    return _map_with_path(one, spec_tree, state, is_leaf=_is_spec)


def shrink_batch_for(mesh, global_batch: int, rules: Optional[Dict] = None) -> int:
    """Largest batch <= global_batch divisible by the mesh's batch axes
    (elastic data parallelism keeps per-device batch constant)."""
    rules = dict(rules or DEFAULT_RULES)
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in rules["batch"] if a in sizes)
    bsize = math.prod(sizes[a] for a in axes) if axes else 1
    return max(bsize, (global_batch // bsize) * bsize)
