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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

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
                    device="cuda") -> T.ParamTree:
    """The port's parameters holding the JAX pytree ``params_np``'s values,
    each leaf in its own dtype, on ``device``."""
    T.check_supported(cfg)
    stacked = params_np["blocks"]
    n = len(cfg.period)
    if len(stacked) != n:
        raise ValueError(f"{len(stacked)} period positions in the pytree, "
                         f"{n} in {cfg.name}")
    blocks = [_tensors(stacked[i % n], device, index=i // n)
              for i in range(cfg.n_layers)]
    top = _tensors({k: v for k, v in params_np.items() if k != "blocks"}, device)
    return T.make_params(top, blocks)
