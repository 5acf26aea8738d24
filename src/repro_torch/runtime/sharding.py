"""Logical-axis sharding rules (MaxText-style) + mesh context, on DTensor.

The JAX package's ``runtime/sharding.py`` with ``torch.distributed``'s
``DeviceMesh`` and DTensor in place of the JAX mesh and GSPMD.

Physical meshes (``launch/mesh.py``):
    single-pod  (data=16, model=16)
    multi-pod   (pod=2, data=16, model=16)

Logical axes used by models / optimizer / caches:

    batch   -> (pod, data)      activations' leading dim
    model   -> model            generic tensor-parallel dim
    heads   -> model            attention Q heads
    kv      -> model            attention KV heads (replicated if indivisible)
    mlp     -> model            FFN hidden
    expert  -> model            MoE expert dim (expert parallelism)
    vocab   -> model            vocab-parallel embedding / logits
    seq     -> data             long-context decode: KV cache sequence dim
    zero    -> data             optimizer-state sharding (ZeRO-1/2)

Every rule applies **only when the dim is divisible** by the mesh-axis
product; otherwise the dim is replicated and the fallback is recorded in
:data:`FALLBACKS` (llama4's 40 Q-heads on model=16, kv_heads=8 on model=16,
...).

The spec functions (:func:`logical_spec`, :func:`param_pspecs`,
:func:`zero_pspecs`, :func:`fsdp_pspecs`, :func:`cache_pspecs`,
:func:`batch_pspec`) are the reference's, on trees of nested dicts, tuples,
lists and NamedTuples whose leaves have a ``.shape`` (tensors, meta tensors,
numpy arrays), walked as JAX walks them (dict keys sorted), so the specs
and the order of :data:`FALLBACKS` are the reference's.  They read only the
mesh's axis names and sizes: a ``DeviceMesh`` (``mesh_dim_names``) or a
:class:`MeshShape`, which resolves the 256- and 512-card production meshes'
specs with no process group.  A spec is a :class:`PartitionSpec` (``P``), a
tuple of entries: ``None``, an axis name, or a tuple of names.

The reference computes parameter specs on its stacked layout, where every
block leaf has a leading ``n_periods`` axis; the port keeps one module a
layer.  :func:`layer_spec` is the rule from one to the other: drop the
period entry, and if it named mesh axes (ZeRO/FSDP put the data axis there)
move them to the first unsharded dim of the layer's own shape they divide,
ZeRO's rule; where none divides, the layer is replicated over them.
:func:`port_pspecs` applies the reference's rules to the port's parameters
through ``models.convert.to_jax_layout``'s names and then this rule.

DTensor: :func:`placements` turns a spec into one placement per mesh dim
(``Shard(d)`` where the spec names that mesh axis for tensor dim ``d``,
else ``Replicate()``), :func:`named` a spec tree into a placements tree,
and :func:`ashard` redistributes a DTensor activation to its logical spec
under the mesh :func:`use_mesh` installed (a no-op outside one, or on a
plain tensor).
"""
from __future__ import annotations

import math
import re
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

_TLS = threading.local()

# logical -> physical mesh axis (tuples allowed)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "model": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
    "seq": ("data",),
    "zero": ("data",),
    # sequence parallelism: residual-stream seq dim between blocks -> model
    "act_seq": ("model",),
    # flattened token dim (MoE dispatch): all mesh axes
    "tokens": ("pod", "data", "model"),
    # token dim sharded over data only (MoE internals keep tokens on
    # (pod, data) so the expert buffers can take (model, data))
    "tokens_dp": ("pod", "data"),
    # expert FFN hidden dim: static 2nd shard axis for expert weights
    # (expert -> model, d_ff_expert -> data)
    "expert_ff": ("data",),
}

FALLBACKS: List[str] = []  # record of replication fallbacks


def _record_fallback(msg: str) -> None:
    if msg not in FALLBACKS:
        FALLBACKS.append(msg)


class PartitionSpec(tuple):
    """A spec: one entry a tensor dim, ``None`` (replicated), an axis name,
    or a tuple of axis names (one dim over several mesh axes, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape:
    """A mesh's axis names and sizes, without devices or a process group:
    what the spec functions read (``.shape`` a mapping, ``.axis_names``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or a mesh with
    a ``.shape`` mapping and ``.axis_names`` (:class:`MeshShape`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


@contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Install the mesh + rules for :func:`ashard` activation constraints."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, dict(rules or DEFAULT_RULES))
    try:
        yield
    finally:
        _TLS.ctx = prev


def current_mesh():
    ctx = getattr(_TLS, "ctx", None)
    return ctx[0] if ctx else None


def current_rules() -> Dict[str, Tuple[str, ...]]:
    ctx = getattr(_TLS, "ctx", None)
    return ctx[1] if ctx else dict(DEFAULT_RULES)


def _resolve(mesh, rules, logical: Optional[str], dim: int):
    """Logical axis -> physical axes for a concrete dim, or None (replicate)."""
    if logical is None:
        return None
    sizes = mesh_sizes(mesh)
    phys = tuple(a for a in rules.get(logical, ()) if a in sizes)
    if not phys:
        return None
    prod = math.prod(sizes[a] for a in phys)
    if dim % prod != 0:
        _record_fallback(f"dim {dim} ({logical}) % {prod} != 0 -> replicated")
        return None
    return phys if len(phys) > 1 else phys[0]


def logical_spec(mesh, rules, axes: Sequence[Optional[str]], shape: Sequence[int]) -> P:
    return P(*(_resolve(mesh, rules, ax, d) for ax, d in zip(axes, shape)))


# ---------------------------------------------------------------------------
# Trees (the JAX package's pytrees: dict keys sorted, None holds no leaf)
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_path(fn: Callable, tree: Any, *rest: Any, path: str = "",
                   is_leaf: Callable = lambda x: False) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over ``tree`` with ``rest`` of the same
    structure; ``path`` as the reference's ``_path_str`` writes it
    (``.blocks.0.attn.wq``, ``.mu.embed.table``)."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        out = {k: _map_with_path(fn, tree[k], *(r[k] for r in rest), path=f"{path}.{k}",
                                 is_leaf=is_leaf) for k in sorted(tree)}
        return out
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                                           path=f"{path}.{f}", is_leaf=is_leaf)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, x, *(r[i] for r in rest), path=f"{path}.{i}",
                                         is_leaf=is_leaf) for i, x in enumerate(tree))
    return fn(path, tree, *rest)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


# ---------------------------------------------------------------------------
# Parameter sharding rules (path + shape -> logical axes)
# ---------------------------------------------------------------------------

# (regex on the flattened path, logical axes for the TRAILING dims).
# Leading dims not covered (e.g. the n_periods stack axis) are replicated.
_PARAM_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    # embeddings / head: vocab-parallel
    (r"embed.*table", ("vocab", None)),
    (r"lm_head", ("vocab", None)),
    # MoE: expert parallelism.  Shared-expert rules must precede the
    # generic expert rules (both match "moe.").
    (r"moe.*router", (None, None)),
    (r"moe.*shared.*w_(gate|up)$", (None, "mlp")),
    (r"moe.*shared.*w_down", ("mlp", None)),
    (r"moe.*w_(gate|up)$", ("expert", None, "expert_ff")),
    (r"moe.*w_down", ("expert", "expert_ff", None)),
    # attention projections (column-parallel in, row-parallel out)
    (r"attn.*w(q)$|cross.*wq$", (None, "heads")),
    (r"attn.*w(k|v)$|cross.*w(k|v)$", (None, "kv")),
    (r"attn.*wo$|cross.*wo$", ("heads", None)),
    (r"b(q)$", ("heads",)),
    (r"b(k|v)$", ("kv",)),
    # dense mlp
    (r"mlp.*w_(gate|up)$", (None, "mlp")),
    (r"mlp.*w_down", ("mlp", None)),
    # rwkv time-mix (heads over model via the flattened d axis)
    (r"rwkv.*w_(r|k|v|g)$", (None, "model")),
    (r"rwkv.*w_o$", ("model", None)),
    (r"rwkv.*u$", ("model", None)),
    (r"rwkv.*w_lora_a", (None, None)),
    (r"rwkv.*w_lora_b", (None, "model")),
    (r"rwkv.*w0", ("model",)),
    # rwkv channel-mix
    (r"cmix.*w_k$", (None, "mlp")),
    (r"cmix.*w_v$", ("mlp", None)),
    (r"cmix.*w_r$", (None, "model")),
    # mamba (d_inner over model)
    (r"mamba.*in_proj", (None, "model")),
    (r"mamba.*conv_w", (None, "model")),
    (r"mamba.*conv_b", ("model",)),
    (r"mamba.*x_proj", ("model", None)),
    (r"mamba.*dt_proj", (None, "model")),
    (r"mamba.*dt_bias", ("model",)),
    (r"mamba.*a_log", ("model", None)),
    (r"mamba.*\bd\b", ("model",)),
    (r"mamba.*out_proj", ("model", None)),
]


def _axes_for(path_str: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path_str):
            if len(axes) > ndim:
                return (None,) * ndim
            return (None,) * (ndim - len(axes)) + tuple(axes)
    return (None,) * ndim  # norms, scalars, mu vectors: replicated


def param_pspecs(params_tree: Any, mesh, rules: Optional[Dict] = None,
                 special_kv_heads: Optional[int] = None) -> Any:
    """PartitionSpec tree matching ``params_tree`` (leaves with a shape).

    ``special_kv_heads``: if given, KV projections are only sharded when the
    *head count* divides the model axis (a flat-dim divisibility check would
    wrongly split single heads across shards)."""
    rules = dict(rules or DEFAULT_RULES)
    sizes = mesh_sizes(mesh)
    model_size = math.prod(sizes[a] for a in rules["kv"] if a in sizes) or 1

    def one(ps, leaf):
        shape = _shape(leaf)
        axes = _axes_for(ps, len(shape))
        if special_kv_heads is not None and "kv" in axes:
            if special_kv_heads % model_size != 0:
                _record_fallback(
                    f"kv_heads={special_kv_heads} % model={model_size} != 0 "
                    f"-> KV projections replicated ({ps})")
                axes = tuple(None if a == "kv" else a for a in axes)
        return logical_spec(mesh, rules, axes, shape)

    return _map_with_path(one, params_tree)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def zero_pspecs(param_specs: Any, shapes: Any, mesh, rules: Optional[Dict] = None,
                min_size: int = 0) -> Any:
    """ZeRO/FSDP sharding: spec + 'data' on the first unsharded dim that
    divides the data axis.  Applied to optimizer state (ZeRO-1/2) and — via
    :func:`fsdp_pspecs` — to the bf16 params themselves (FSDP).
    ``min_size`` skips small leaves (norm scales etc.) where gather latency
    beats memory."""
    rules = dict(rules or DEFAULT_RULES)
    sizes = mesh_sizes(mesh)
    data_axes = tuple(a for a in rules["zero"] if a in sizes)
    if not data_axes:
        return param_specs
    dsize = math.prod(sizes[a] for a in data_axes)

    def _uses_data(parts) -> bool:
        for p in parts:
            for a in (p if isinstance(p, tuple) else (p,)):
                if a in data_axes:
                    return True
        return False

    def one(_, spec: P, leaf) -> P:
        shape = _shape(leaf)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if math.prod(shape) < min_size or _uses_data(parts):
            return P(*parts)  # small, or already data-sharded (2D experts)
        for i, (p, d) in enumerate(zip(parts, shape)):
            if p is None and d % dsize == 0 and d >= dsize:
                parts[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                return P(*parts)
        return P(*parts)

    return _map_with_path(one, param_specs, shapes, is_leaf=_is_spec)


def fsdp_pspecs(param_specs: Any, shapes: Any, mesh, rules: Optional[Dict] = None) -> Any:
    """FSDP param sharding: TP spec + data axis on large leaves (>= 1M
    elements).  Small leaves stay TP-only to avoid gather latency."""
    return zero_pspecs(param_specs, shapes, mesh, rules, min_size=1 << 20)


# ---------------------------------------------------------------------------
# Cache / activation input specs
# ---------------------------------------------------------------------------


def cache_pspecs(cache_tree: Any, mesh, batch: int, kv_heads: int,
                 rules: Optional[Dict] = None) -> Any:
    """Decode-cache specs.  Normal decode: batch over (pod, data), heads over
    model.  batch=1 long-context: sequence dim over data."""
    rules = dict(rules or DEFAULT_RULES)
    sizes = mesh_sizes(mesh)
    batch_axes = tuple(a for a in rules["batch"] if a in sizes)
    bsize = math.prod(sizes[a] for a in batch_axes) if batch_axes else 1
    batch_ok = batch % bsize == 0 and batch >= bsize
    model_size = math.prod(sizes[a] for a in rules["model"] if a in sizes) or 1

    def one(ps, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        b_ax = (batch_axes if len(batch_axes) > 1 else batch_axes[0]) \
            if (batch_ok and batch_axes) else None
        if re.search(r"\.(k|v|ck|cv)$", ps) and nd == 5:
            # (n_periods, B, T, HKV, D).  The model axis takes the KV heads
            # when divisible, else the sequence dim; batch=1 long-context
            # shards T over data as well.
            head_ax = "model" if kv_heads % model_size == 0 else None
            seq_parts = []
            if not batch_ok:
                seq_parts += list(a for a in rules["seq"] if a in sizes)
            if head_ax is None:
                seq_parts += list(a for a in rules["act_seq"] if a in sizes)
            seq_ax = None
            if seq_parts:
                prod = math.prod(sizes[a] for a in seq_parts)
                if shape[2] % prod == 0:
                    seq_ax = tuple(seq_parts) if len(seq_parts) > 1 else seq_parts[0]
                else:
                    _record_fallback(f"cache seq {shape[2]} % {prod} != 0 -> replicated")
            return P(None, b_ax, seq_ax, _resolve(mesh, rules, head_ax, shape[3])
                     if head_ax else None, None)
        if re.search(r"\.(h|conv)$", ps) and nd >= 3:
            # mamba: (n_periods, B, ..., d_inner[, N]) — d_inner over model
            inner_axis = 2 if ps.endswith(".h") else 3
            parts = [None] * nd
            parts[1] = b_ax
            parts[inner_axis] = _resolve(mesh, rules, "model", shape[inner_axis])
            return P(*parts)
        if re.search(r"\.s$", ps) and nd == 5:
            # rwkv state (n_periods, B, H, N, N) — heads over model
            return P(None, b_ax, _resolve(mesh, rules, "model", shape[2]), None, None)
        parts = [None] * nd
        if nd >= 2:
            parts[1] = b_ax
        return P(*parts)

    return _map_with_path(one, cache_tree)


def batch_pspec(mesh, batch: int, ndim: int, rules: Optional[Dict] = None) -> P:
    rules = dict(rules or DEFAULT_RULES)
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in rules["batch"] if a in sizes)
    bsize = math.prod(sizes[a] for a in axes) if axes else 1
    if not axes or batch % bsize != 0:
        return P(*([None] * ndim))
    return P(axes if len(axes) > 1 else axes[0], *([None] * (ndim - 1)))


# ---------------------------------------------------------------------------
# The port's layout: one module a layer
# ---------------------------------------------------------------------------


def layer_spec(stacked: P, layer_shape: Sequence[int], mesh) -> P:
    """A stacked block leaf's spec (leading ``n_periods`` entry) as the spec
    of one layer's leaf of ``layer_shape``: the period entry dropped, and
    the axes it named (ZeRO/FSDP's data axis) moved to the first dim of the
    layer's shape that is unsharded and divisible by their product and no
    smaller (ZeRO's rule); where none is, the layer is replicated over
    them."""
    parts = list(stacked[1:]) + [None] * (len(layer_shape) - len(stacked[1:]))
    moved = stacked[0] if len(stacked) else None
    if moved is None:
        return P(*parts)
    sizes = mesh_sizes(mesh)
    size = math.prod(sizes[a] for a in (moved if isinstance(moved, tuple) else (moved,)))
    for i, (p, d) in enumerate(zip(parts, layer_shape)):
        if p is None and d % size == 0 and d >= size:
            parts[i] = moved
            break
    return P(*parts)


def port_pspecs(named_shapes: Mapping[str, Any], cfg, mesh, kind: str = "fsdp",
                rules: Optional[Dict] = None) -> Dict[str, P]:
    """The reference's specs for the port's parameters (``name -> tensor``,
    as ``named_parameters()`` gives them; meta tensors will do), keyed by
    parameter name: ``kind`` ``"tp"`` (:func:`param_pspecs` with the kv-head
    rule), ``"fsdp"`` (parameters) or ``"zero"`` (AdamW's moments and
    master).  Computed on the stacked layout (``models.convert.to_jax_layout``)
    and brought to each layer by :func:`layer_spec`."""
    from repro_torch.models.convert import to_jax_layout

    if kind not in ("tp", "fsdp", "zero"):
        raise ValueError(f"kind {kind!r}: tp | fsdp | zero")
    meta = {k: torch.empty(_shape(v), device="meta") for k, v in named_shapes.items()}
    stacked = to_jax_layout(meta, cfg)
    specs = param_pspecs(stacked, mesh, rules, special_kv_heads=cfg.n_kv_heads)
    if kind == "fsdp":
        specs = fsdp_pspecs(specs, stacked, mesh, rules)
    elif kind == "zero":
        specs = zero_pspecs(specs, stacked, mesh, rules)
    flat = _flat_stacked(specs, cfg)
    return {name: (layer_spec(flat[name], _shape(meta[name]), mesh)
                   if name.startswith("blocks.") else flat[name]) for name in meta}


def _flat_stacked(spec_tree: Dict[str, Any], cfg) -> Dict[str, P]:
    """A stacked spec tree keyed by the port's parameter names (each layer
    of a period position gets its position's stacked spec)."""
    n = len(cfg.period)
    out: Dict[str, P] = {}

    def walk(tree, prefix, fn):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,), fn)
            else:
                fn(prefix + (k,), v)

    walk({k: v for k, v in spec_tree.items() if k != "blocks"}, (),
         lambda path, s: out.__setitem__(".".join(path), s))
    for pos, block in enumerate(spec_tree["blocks"]):
        for per in range(cfg.n_periods):
            walk(block, ("blocks", str(per * n + pos)),
                 lambda path, s: out.__setitem__(".".join(path), s))
    return out


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec: Sequence, ndim: int) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` where ``spec`` names
    that mesh axis for tensor dim ``d`` (a tuple entry shards dim ``d`` over
    each of its axes, major first, as DTensor nests them in mesh order),
    else ``Replicate()``; an axis of size 1 is always ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    if len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than {ndim} dims")
    names = list(mesh_sizes(mesh))
    by_axis: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for a in axes:
            if a in by_axis:
                raise ValueError(f"axis {a!r} shards two dims in {tuple(spec)}")
            by_axis[a] = d
    sizes = mesh_sizes(mesh)
    # an axis of size 1 shards nothing: Replicate is the same layout, and
    # DTensor's view rules handle it where a size-1 Shard would need moving
    return tuple(Shard(by_axis[a]) if a in by_axis and sizes[a] > 1 else Replicate()
                 for a in names)


def named(mesh, spec_tree: Any) -> Any:
    """The placements tree of a spec tree."""
    return _map_with_path(lambda _, s: placements(mesh, s, len(s)), spec_tree,
                          is_leaf=_is_spec)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def ashard(x, axes: Sequence[Optional[str]]):
    """Activation sharding constraint: redistribute the DTensor ``x`` to its
    logical spec under the current mesh; a no-op outside a mesh context or
    on a plain tensor."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    spec = logical_spec(mesh, rules, axes, x.shape)
    want = placements(mesh, spec, x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# The model under a mesh
# ---------------------------------------------------------------------------


@contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication`` (a plain tensor in an op with
    DTensors is a replicated DTensor: positions, masks, RoPE tables), which
    restores the previous setting on exit, so that nested uses (a remat
    recompute inside the step) keep the outer one."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


@contextmanager
def mesh_scope(ctx):
    """Re-enter a mesh context captured by :func:`capture` (``None``: no
    mesh): the mesh and rules for :func:`ashard`, and implicit replication.
    Remat recomputes a layer inside the backward, perhaps on autograd's own
    thread, so each checkpointed function re-enters the context it was
    built under."""
    if ctx is None:
        yield
        return
    with use_mesh(*ctx), _implicit_replication():
        yield


def capture():
    """The current mesh context (mesh, rules), or None outside one."""
    return getattr(_TLS, "ctx", None)


def local_call(fn: Callable, args: Sequence, in_specs: Sequence, out_specs: Sequence):
    """``fn`` on the local shards of the DTensors ``args`` (a kernel, or an op
    DTensor has no sharding strategy for), through ``local_map``: each arg
    is redistributed to its placements in ``in_specs``, and the local
    results become DTensors with ``out_specs`` (one placements tuple a
    result; a 1-tuple for a single tensor).  Gradients: an arg replicated
    over a mesh dim that another arg is sharded over is read by every
    shard's computation, so its gradient there is ``Partial`` (each rank's
    is one term of the sum); elsewhere it has the arg's placements."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    sharded = {i for spec in in_specs for i, p in enumerate(spec) if p.is_shard()}
    grads = tuple(tuple(Partial() if i in sharded and p.is_replicate() else p
                        for i, p in enumerate(spec)) for spec in in_specs)
    wrapped = local_map(fn, out_placements=tuple(out_specs), in_placements=tuple(in_specs),
                        in_grad_placements=grads, device_mesh=mesh, redistribute_inputs=True)
    return wrapped(*args)


def spec_placements(x, axes: Sequence[Optional[str]]) -> tuple:
    """The placements of the logical ``axes`` for the DTensor ``x`` under the
    current rules (the mesh is ``x``'s)."""
    spec = logical_spec(x.device_mesh, current_rules(), axes, x.shape)
    return placements(x.device_mesh, spec, x.ndim)


def distribute(t: torch.Tensor, mesh, spec: Sequence) -> Any:
    """The tensor ``t``, the same on every rank, as a DTensor with ``spec``'s
    placements (each rank keeps its own shard: no communication)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(mesh, spec, t.ndim), src_data_rank=None)


def zeros(shape: Sequence[int], dtype, mesh, spec: Sequence) -> Any:
    """A zero DTensor of the global ``shape`` with ``spec``'s placements,
    allocated shard by shard."""
    import torch.distributed.tensor as dt

    return dt.zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                    placements=placements(mesh, spec, len(shape)))


def to_plain(x):
    """A DTensor's whole value as a plain tensor (a collective over its
    mesh); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x
