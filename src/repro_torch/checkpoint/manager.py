"""Atomic, keep-N checkpointing in the JAX package's on-disk layout.

Layout (``checkpoint/manager.py`` of the JAX package): ``<dir>/step_<N>/``
holding one ``.npy`` per leaf, ``leaf_<i>.npy`` with i the leaf's rank in
the sorted keys, and ``meta.json`` with the extras and a manifest: for each
leaf key its file, shape, dtype and the CRC32 of its bytes.  A key is the
leaf's ``jax.tree_util.keystr`` path (``[0]['blocks'][1]['attn']['wq']``,
``[1].mu['embed']['table']``, ``[1].step``): :func:`keystr_leaves` walks a
tree of dicts (keys sorted, as JAX flattens them), tuples, lists and
NamedTuples (``.field``) the same way, and ``None`` holds no leaf.  Trees
given in the JAX layout (``models.convert.to_jax_layout``) therefore
write and read the same files as the JAX package: a checkpoint written by
either restores in the other.

bf16 leaves are written as the JAX package writes them, two-byte records
with the ``'<V2'`` descriptor (what ``np.save`` gives an ``ml_dtypes``
bfloat16 array), and ``"dtype": "bfloat16"`` in the manifest; they are
read back as ``uint16`` records and viewed as ``torch.bfloat16`` by the
manifest's dtype, so nothing here needs ``ml_dtypes``.  The CRC covers the
same bytes in both packages.

Writes go to ``step_<N>.tmp`` and are renamed into place, so a job killed
mid-save never corrupts the latest checkpoint; the ``keep_n`` newest are
kept.  :meth:`CheckpointManager.restore_latest` returns (step, state,
extras) with every leaf a CPU tensor, and verifies the checksums: a
truncated leaf fails loudly, not with NaNs.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_BF16_DESCR = "<V2"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def keystr_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in keystr_leaves(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in keystr_leaves(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree) for kv in keystr_leaves(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_with_keys(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """The tree with each leaf replaced by ``fn(keystr path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_keys(fn, getattr(tree, f), f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_keys(fn, x, f"{prefix}[{i}]") for i, x in enumerate(tree))
    return fn(prefix, tree)


def _records(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the leaf as a numpy array of its bytes, its dtype's name); bf16 as
    uint16 records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.ascontiguousarray(np.asarray(leaf))
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save_pytree(tree: Any, path: str, extras: Optional[dict] = None) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for i, (key, leaf) in enumerate(sorted(keystr_leaves(tree), key=lambda kv: kv[0])):
        fname = f"leaf_{i:05d}.npy"
        arr, dtype = _records(leaf)
        _save_leaf(os.path.join(tmp, fname), arr, dtype)
        manifest[key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype,
                         "crc": _crc(arr)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"manifest": manifest, "extras": extras or {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)  # atomic publish


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.frombuffer(arr.tobytes(), np.int16).reshape(arr.shape)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=dtype))


def load_pytree(template: Any, path: str, check: bool = True) -> Tuple[Any, dict]:
    """Restore into the structure of ``template`` (shapes checked): every
    leaf a CPU tensor of the manifest's dtype."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    manifest = meta["manifest"]

    def one(key: str, leaf: Any) -> torch.Tensor:
        if key not in manifest:
            raise KeyError(f"checkpoint missing leaf {key}")
        ent = manifest[key]
        arr = np.load(os.path.join(path, ent["file"]))
        if check:
            if _crc(arr) != ent["crc"]:
                raise IOError(f"checksum mismatch for {key}")
            if list(arr.shape) != list(np.shape(leaf)):
                raise ValueError(f"{key}: shape {arr.shape} != template {tuple(np.shape(leaf))}")
        return _tensor(arr, ent["dtype"])

    return map_with_keys(one, template), meta["extras"]


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def save(self, step: int, state: Any, extras: Optional[dict] = None) -> str:
        path = self._step_dir(step)
        save_pytree(state, path, extras=dict(extras or {}, step=step))
        self._gc()
        return path

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore_latest(self, template: Any) -> Optional[Tuple[int, Any, Dict]]:
        steps = self.steps()
        if not steps:
            return None
        step = steps[-1]
        state, extras = load_pytree(template, self._step_dir(step))
        return step, state, extras

    def restore(self, step: int, template: Any) -> Tuple[Any, dict]:
        return load_pytree(template, self._step_dir(step))
