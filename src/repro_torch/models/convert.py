"""Carry weights across from the JAX package's layout to the port's.

The JAX ``init_params`` pytree keeps each period position's parameters
stacked over ``n_periods`` on axis 0 (``params["blocks"][pos][name]`` of
shape ``(n_periods, ...)``).  :func:`params_from_jax` unstacks that axis
into one :class:`~repro_torch.models.transformer.ParamTree` per layer, in
layer order, and keeps every name (``wq``/``wk``/``wv``/``wo``,
``w_gate``/``w_up``/``w_down``, ``rwkv.*``, ``cmix.*``, ``mamba.*``,
``moe.*``, a cross layer's ``cross.*`` and ``norm_cross``, ``norm_attn``,
``norm_ffn``, ``embed.table``, ``lm_head``, ``final_norm``) and every
leaf's dtype: a bf16 model keeps its f32 leaves (RWKV-6's decay, bonus and
group-norm parameters; Mamba's ``dt_proj``, ``dt_bias``, ``a_log`` and
``d``; the MoE ``router``) in f32.  It takes numpy arrays (for example
``jax.tree.map(np.asarray, params)``, where a bf16 leaf is an
``ml_dtypes`` bfloat16 array), so nothing here imports JAX.

The other direction, for training: :func:`to_jax_layout` stacks a dict of
the port's tensors keyed by parameter name (``dict(params.named_parameters())``,
the gradients, AdamW's moments) into the JAX pytree layout, still as
tensors, and :func:`from_jax_layout` undoes it; the checkpoint manager
writes the stacked tree, so its keys are the JAX package's.
:func:`params_to_jax` and :func:`opt_state_to_jax` give numpy arrays (a
bf16 leaf as an ``ml_dtypes`` bfloat16 array, which needs ``ml_dtypes``);
:func:`opt_state_from_jax` carries a JAX ``AdamWState`` across.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.optim import AdamWState

from . import transformer as T


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensors(tree: Dict[str, Any], device, index=None) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, val in tree.items():
        if isinstance(val, dict):
            out[name] = _tensors(val, device, index)
            continue
        arr = np.asarray(val)
        if arr.dtype.name not in _DTYPES:
            raise TypeError(f"leaf {name!r} has dtype {arr.dtype}; the port's "
                            f"parameters are {sorted(_DTYPES)}")
        if index is not None:
            arr = arr[index]
        # via f32: numpy has no bfloat16 of its own (bf16 -> f32 is exact)
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C")
                                     ).to(device=device, dtype=_DTYPES[arr.dtype.name])
    return out


def params_from_jax(params_np: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", trainable: bool = False) -> T.ParamTree:
    """The port's parameters holding the JAX pytree ``params_np``'s values,
    each leaf in its own dtype, on ``device`` (requiring grad when
    ``trainable``)."""
    T.check_supported(cfg)
    stacked = params_np["blocks"]
    n = len(cfg.period)
    if len(stacked) != n:
        raise ValueError(f"{len(stacked)} period positions in the pytree, "
                         f"{n} in {cfg.name}")
    blocks = [_tensors(stacked[i % n], device, index=i // n)
              for i in range(cfg.n_layers)]
    top = _tensors({k: v for k, v in params_np.items() if k != "blocks"}, device)
    return T.make_params(top, blocks, trainable)


def _insert(tree: Dict[str, Any], path, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def to_jax_layout(named: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, Any]:
    """Tensors keyed by the port's parameter names (``blocks.<layer>.attn.wq``,
    ``embed.table``) as the JAX pytree: nested dicts, ``"blocks"`` a tuple
    with one dict a period position whose leaves are stacked over
    ``n_periods`` on axis 0."""
    n = len(cfg.period)
    top: Dict[str, Any] = {}
    layers: Dict[int, Dict[tuple, torch.Tensor]] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            layers.setdefault(int(parts[1]), {})[tuple(parts[2:])] = t
        else:
            _insert(top, parts, t)
    if sorted(layers) != list(range(cfg.n_layers)):
        raise ValueError(f"layers {sorted(layers)} named, {cfg.name} has {cfg.n_layers}")
    blocks = []
    for pos in range(n):
        stack = [layers[per * n + pos] for per in range(cfg.n_periods)]
        d: Dict[str, Any] = {}
        for path in stack[0]:
            _insert(d, path, torch.stack([layer[path] for layer in stack]))
        blocks.append(d)
    top["blocks"] = tuple(blocks)
    return top


def _leaves(tree: Dict[str, Any], prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def from_jax_layout(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of :func:`to_jax_layout`: leaves keyed by the port's
    parameter names, each block leaf unstacked (views of the stacked
    leaf's rows)."""
    n = len(cfg.period)
    out: Dict[str, Any] = {}
    for path, leaf in _leaves({k: v for k, v in tree.items() if k != "blocks"}):
        out[".".join(path)] = leaf
    for pos, block in enumerate(tree["blocks"]):
        for path, leaf in _leaves(block):
            for per in range(cfg.n_periods):
                out[".".join(("blocks", str(per * n + pos)) + path)] = leaf[per]
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # bf16 numpy arrays (installed with JAX)

        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy_tree(v) for v in tree)
    return _numpy(tree)


def params_to_jax(params: T.ParamTree, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameters as the JAX ``init_params`` pytree of numpy
    arrays, block leaves stacked per period, each leaf in its dtype."""
    return _numpy_tree(to_jax_layout(dict(params.named_parameters()), cfg))


def opt_state_to_jax(state: AdamWState, cfg: ModelConfig) -> AdamWState:
    """The port's AdamW state as the JAX package's (numpy leaves, trees in
    the JAX layout; ``repro.optim.AdamWState(*result)`` rebuilds its type)."""
    tree = lambda d: None if d is None else _numpy_tree(to_jax_layout(d, cfg))  # noqa: E731
    return AdamWState(_numpy(state.step), tree(state.mu), tree(state.nu), tree(state.master))


def opt_state_from_jax(state_np, cfg: ModelConfig, device="cuda") -> AdamWState:
    """A JAX ``AdamWState`` (numpy leaves) as the port's: moments and master
    f32 tensors keyed by parameter name, on ``device``."""
    def tree(t) -> Optional[Dict[str, torch.Tensor]]:
        if t is None:
            return None
        flat = from_jax_layout(t, cfg)
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                for k, v in flat.items()}

    step, mu, nu, master = state_np
    return AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                      tree(mu), tree(nu), tree(master))
