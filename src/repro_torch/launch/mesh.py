"""Production mesh construction on ``torch.distributed``.

FUNCTIONS (not module-level constants), so importing this module touches
no distributed state: a mesh exists only once a caller builds one over the
process group it has initialised.

:func:`make_mesh` and :func:`make_production_mesh` build a ``DeviceMesh``
with ``init_device_mesh`` over the current process group, whose world size
must equal the mesh's size.  :func:`init_process_group` starts that group:
under a launcher (``torchrun`` sets ``WORLD_SIZE``, ``RANK`` and
``MASTER_ADDR``) from the environment, otherwise as one rank through a
``FileStore`` (no sockets).
"""
from __future__ import annotations

import math
import os
import tempfile
from typing import Optional, Tuple

PRODUCTION_SINGLE = ((16, 16), ("data", "model"))
PRODUCTION_MULTI = ((2, 16, 16), ("pod", "data", "model"))


def init_process_group(device_type: str = "cuda", store_path: Optional[str] = None) -> int:
    """Initialise the default process group unless one exists, and return
    its world size.  ``nccl`` on the card, ``gloo`` on the CPU.  Under a
    launcher the group comes from the environment (``env://``); without one
    it is a single rank whose store is the file ``store_path`` (a fresh
    temporary file by default).  On the card, rank r takes ``cuda:<local
    rank>``."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return dist.get_world_size()
    if store_path is None:
        fd, store_path = tempfile.mkstemp(prefix="repro_torch_pg_")
        os.close(fd)
        os.unlink(store_path)
    dist.init_process_group(backend, store=dist.FileStore(store_path, 1), rank=0,
                            world_size=1)
    return 1


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the current process group, whose
    world size must be the mesh's size (tests, ``--mesh auto``, remesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {math.prod(shape)} "
                           f"ranks; none is initialised (launch.mesh.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} ranks; "
                         f"the process group has world size {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """One pod (data=16, model=16), 256 cards, or two pods (pod=2, data=16,
    model=16), 512 cards."""
    shape, axes = PRODUCTION_MULTI if multi_pod else PRODUCTION_SINGLE
    return make_mesh(shape, axes, device_type)
