"""MLP networks for the RL trainers as ``nn.Module``s (paper §III-D uses
fully connected nets over the flattened loop features for every algorithm).

The parameters keep the JAX package's tree: every linear layer is ``w (in,
out)`` and ``b (out,)``, applied as ``x @ w + b`` (not ``nn.Linear``'s
``(out, in)``), an MLP is a list of them, and the heads are dicts of MLPs.
So a module's ``state_dict`` is that tree flattened with dotted keys
(``trunk.0.w``), and :func:`params_from_numpy` / :func:`params_to_numpy`
carry weights between the two packages: a checkpoint is the same pickle in
both.

Initialisation is He-normal, as the JAX ``mlp_init``, from an explicit
``torch.Generator``; it cannot draw ``jax.random``'s numbers, so parity
tests carry weights across instead.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def he_normal(gen: torch.Generator, shape: Sequence[int], fan_in: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=gen) * math.sqrt(2.0 / fan_in))


class Linear(nn.Module):
    """``x @ w + b`` with ``w (in, out)``: the JAX package's layer."""

    def __init__(self, fan_in: int, fan_out: int, gen: torch.Generator):
        super().__init__()
        self.w = he_normal(gen, (fan_in, fan_out), fan_in)
        self.b = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class MLP(nn.ModuleList):
    """Linear layers with ReLU between them (none after the last)."""

    def __init__(self, sizes: Sequence[int], gen: torch.Generator):
        super().__init__(Linear(sizes[i], sizes[i + 1], gen)
                         for i in range(len(sizes) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self):
            x = layer(x)
            if i < len(self) - 1:
                x = torch.relu(x)
        return x


class Dueling(nn.Module):
    """Dueling Q-net: shared trunk + value & advantage heads (APEX's)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], n_actions: int,
                 gen: torch.Generator):
        super().__init__()
        self.trunk = MLP([in_dim, *hidden], gen)
        self.v = MLP([hidden[-1], hidden[-1] // 2, 1], gen)
        self.a = MLP([hidden[-1], hidden[-1] // 2, n_actions], gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.trunk(x))
        a = self.a(h)
        return self.v(h) + a - a.mean(dim=-1, keepdim=True)


class ActorCritic(nn.Module):
    """Policy logits and a scalar value over one shared trunk."""

    def __init__(self, in_dim: int, hidden: Sequence[int], n_actions: int,
                 gen: torch.Generator):
        super().__init__()
        self.trunk = MLP([in_dim, *hidden], gen)
        self.pi = MLP([hidden[-1], n_actions], gen)
        self.v = MLP([hidden[-1], 1], gen)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.relu(self.trunk(x))
        return self.pi(h), self.v(h)[..., 0]


def make_head(head: str, in_dim: int, hidden: Sequence[int], n_actions: int,
              gen: torch.Generator) -> nn.Module:
    if head == "q":
        return MLP([in_dim, *hidden, n_actions], gen)
    if head == "dueling":
        return Dueling(in_dim, hidden, n_actions, gen)
    if head == "actor_critic":
        return ActorCritic(in_dim, hidden, n_actions, gen)
    raise ValueError(f"unknown head {head!r} (want one of "
                     "('q', 'dueling', 'actor_critic'))")


def make_adam(module: nn.Module, lr: float) -> torch.optim.Adam:
    """The JAX package's hand-written Adam (β 0.9 / 0.999, ε 1e-8 added to
    the square root of the bias-corrected second moment) is this update."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


# ---------------------------------------------------------------------------
# Carrying parameters between the packages
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_numpy(tree: Any, device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree (nested dicts and lists of numpy
    arrays, as its checkpoints pickle them) as a ``state_dict`` for the
    port's module of the same head and encoder, on ``device``."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in flat.items()}


def params_to_numpy(module: nn.Module) -> Any:
    """The inverse of :func:`params_from_numpy`: the module's parameters as
    the JAX package's tree of numpy arrays (lists where the keys count)."""
    root: Dict[str, Any] = {}
    for key, t in module.state_dict().items():
        *path, leaf = key.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------

# The one masking sentinel, everywhere.  A finite fill (not -inf) so that a
# fully-masked row degrades to a uniform softmax instead of NaN
# probabilities, while exp(MASK_SENTINEL - max_legal) underflows to exactly
# 0 whenever at least one action is legal — so sampling and argmax are
# unchanged on every reachable state.
MASK_SENTINEL = -1e9


def masked_fill(x, mask):
    """``x`` where ``mask`` else the sentinel (numpy arrays and tensors)."""
    if isinstance(x, torch.Tensor):
        mask = torch.as_tensor(mask, dtype=torch.bool, device=x.device)
        return torch.where(mask, x, torch.full_like(x, MASK_SENTINEL))
    return np.where(mask, x, MASK_SENTINEL)


def masked_argmax(q: np.ndarray, mask: np.ndarray) -> int:
    return int(np.argmax(np.where(mask, q, MASK_SENTINEL)))


def masked_logits(logits, mask):
    return masked_fill(logits, mask)

