"""Pluggable policy-encoder registry (paper §III-C/D, graph representation).

How the state becomes network input sits behind an :class:`EncoderConfig`
and a registry:

* ``flat`` — the MLP families of ``networks.py`` over the flat feature
  vector.  Default.
* ``graph`` — a masked message-passing encoder over the packed graph
  observation (``graph_features.py``): per-node embeddings updated over
  typed adjacency (nest-order / same-iterator / membership edges), masked
  mean-pooled into a fixed embedding, with the usual Q / dueling /
  actor-critic head on top.

``build_network(head, cfg, n_actions, device)`` returns a :class:`Network`
whose ``init`` makes the ``nn.Module`` on its device (trainers call the
module on tensors inside their losses) and ``batch`` runs it on a numpy
batch without gradients; ``cfg.to_dict()`` rides in every checkpoint
(``rl_common.TrainResult.meta``) so ``LoopTuner.from_checkpoint`` rebuilds
the exact network and featurizer without guessing.  The module's
parameters keep the JAX package's tree (``networks.params_from_numpy``), so
checkpoints load in either package.

Register a custom encoder with :func:`register_encoder`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .actions import Action
from .features import FEATS_PER_LOOP, MAX_LOOPS
from .graph_features import (GRAPH_MAX_LOOPS, FlatFeaturizer, GraphFeaturizer,
                             N_EDGE_TYPES, build_adjacency, packed_dim,
                             unpack_graph)
from .networks import Linear, he_normal, make_head
from .torch_backend import resolve_device

HEADS = ("q", "dueling", "actor_critic")
DEFAULT_HIDDEN = (256, 256)


@dataclass(frozen=True)
class EncoderConfig:
    """Serializable spec of the state encoder a policy was built with.

    ``hidden``/``max_loops`` default to None meaning "resolve from the
    trainer's ``hidden`` and the encoder's own default" — call
    :meth:`resolved` (idempotent) before building networks or featurizers.
    """

    kind: str = "flat"
    hidden: Optional[Tuple[int, ...]] = None  # head MLP widths
    max_loops: Optional[int] = None           # featurizer capacity
    embed_dim: int = 64                       # graph: node/pooled embedding
    n_rounds: int = 2                         # graph: message-passing rounds

    def resolved(self, hidden: Sequence[int] = DEFAULT_HIDDEN) -> "EncoderConfig":
        return replace(
            self,
            hidden=tuple(self.hidden) if self.hidden else tuple(hidden),
            max_loops=self.max_loops or get_encoder(self.kind).default_max_loops,
        )

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["hidden"] = list(self.hidden) if self.hidden else None
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EncoderConfig":
        return cls(
            kind=d.get("kind", "flat"),
            hidden=tuple(d["hidden"]) if d.get("hidden") else None,
            max_loops=d.get("max_loops"),
            embed_dim=int(d.get("embed_dim", 64)),
            n_rounds=int(d.get("n_rounds", 2)),
        )


@dataclass(frozen=True)
class Network:
    """One policy network: module factory + appliers, on one device."""

    head: str
    config: EncoderConfig
    device: torch.device
    make: Callable[[torch.Generator], nn.Module]

    def init(self, seed: int = 0) -> nn.Module:
        """The module, He-normal from a generator seeded with ``seed``,
        on the network's device."""
        gen = torch.Generator().manual_seed(int(seed))
        return self.make(gen).to(self.device)

    def batch(self, module: nn.Module, obs) -> Any:
        """Forward on a numpy batch ``(N, D)``, moved to the device in one
        copy; no gradients.  The result stays on the device."""
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            return module(x)


class FlatEncoder:
    """The flat-MLP family over the flat feature vector."""

    kind = "flat"
    default_max_loops = MAX_LOOPS

    def featurizer(self, cfg: EncoderConfig) -> FlatFeaturizer:
        return FlatFeaturizer(cfg.max_loops or self.default_max_loops)

    def state_dim(self, cfg: EncoderConfig) -> int:
        return (cfg.max_loops or self.default_max_loops) * FEATS_PER_LOOP

    def make_network(self, head: str, cfg: EncoderConfig, n_actions: int,
                     device) -> Network:
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r} (want one of {HEADS})")
        d, hid = self.state_dim(cfg), list(cfg.hidden)
        return Network(head, cfg, resolve_device(device),
                       lambda gen: make_head(head, d, hid, n_actions, gen))


class GraphRound(nn.Module):
    """One message-passing round: ``self`` (a linear layer) and ``edge``
    ``(N_EDGE_TYPES, e, e)``, the JAX package's round dict."""

    def __init__(self, e: int, gen: torch.Generator):
        super().__init__()
        self.add_module("self", Linear(e, e, gen))
        self.edge = he_normal(gen, (N_EDGE_TYPES, e, e), N_EDGE_TYPES * e)


class GraphTrunk(nn.Module):
    """Masked message passing over the typed loop-nest graph.

    Per round: ``h_i <- relu(h_i W_self + sum_e (A_e_norm h)_i W_e + b)``,
    with degree-normalized adjacency per edge type and padding nodes zeroed
    after every round; the graph embedding is the masked mean of the final
    node states."""

    def __init__(self, cfg: EncoderConfig, gen: torch.Generator):
        super().__init__()
        self.max_loops = cfg.max_loops or GRAPH_MAX_LOOPS
        self.embed = Linear(FEATS_PER_LOOP, cfg.embed_dim, gen)
        self.rounds = nn.ModuleList(GraphRound(cfg.embed_dim, gen)
                                    for _ in range(cfg.n_rounds))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nodes, mask, section, iter_id, pos = unpack_graph(x, self.max_loops)
        adj = build_adjacency(mask, section, iter_id, pos, torch)
        adj = adj / adj.sum(-1, keepdim=True).clamp_min(1.0)
        keep = mask[..., None]
        h = torch.relu(self.embed(nodes)) * keep
        for layer in self.rounds:
            msg = torch.einsum("...eij,...jd,edk->...ik", adj, h, layer.edge)
            lin = getattr(layer, "self")
            h = torch.relu(h @ lin.w + msg + lin.b) * keep
        denom = mask.sum(-1, keepdim=True).clamp_min(1.0)
        return (h * keep).sum(-2) / denom  # (..., embed_dim) masked mean


class GraphNet(nn.Module):
    """``enc`` (the graph trunk) then ``head`` over its embedding."""

    def __init__(self, cfg: EncoderConfig, head: str, n_actions: int,
                 gen: torch.Generator):
        super().__init__()
        self.enc = GraphTrunk(cfg, gen)
        self.head = make_head(head, cfg.embed_dim, list(cfg.hidden), n_actions, gen)

    def forward(self, x: torch.Tensor) -> Any:
        return self.head(self.enc(x))


class GraphEncoder:
    kind = "graph"
    default_max_loops = GRAPH_MAX_LOOPS

    def featurizer(self, cfg: EncoderConfig) -> GraphFeaturizer:
        return GraphFeaturizer(cfg.max_loops or self.default_max_loops)

    def state_dim(self, cfg: EncoderConfig) -> int:
        return packed_dim(cfg.max_loops or self.default_max_loops)

    def make_network(self, head: str, cfg: EncoderConfig, n_actions: int,
                     device) -> Network:
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r} (want one of {HEADS})")
        return Network(head, cfg, resolve_device(device),
                       lambda gen: GraphNet(cfg, head, n_actions, gen))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ENCODERS: Dict[str, Any] = {}


def register_encoder(encoder) -> Any:
    """Register an encoder instance under its ``.kind``; returns it."""
    _ENCODERS[encoder.kind] = encoder
    return encoder


def get_encoder(kind: str):
    try:
        return _ENCODERS[kind]
    except KeyError:
        raise KeyError(
            f"unknown encoder kind {kind!r}; registered: {sorted(_ENCODERS)}"
        ) from None


register_encoder(FlatEncoder())
register_encoder(GraphEncoder())


def build_network(head: str, cfg: EncoderConfig, n_actions: int,
                  device="cuda") -> Network:
    """Resolve ``cfg`` and build the (head, encoder) network on ``device``
    (``"cuda"`` raises where there is no card)."""
    cfg = cfg.resolved(cfg.hidden or DEFAULT_HIDDEN)
    return get_encoder(cfg.kind).make_network(head, cfg, n_actions, device)


def make_score_fn(net: Network):
    """Batched ``(module, obs (N, D)) -> scores (N, A)`` on the host, for
    masked acting — Q-values for value heads, logits for actor-critic.  One
    copy of the batch to the device, one of the scores back."""
    if net.head == "actor_critic":
        return lambda p, o: net.batch(p, o)[0].cpu().numpy()
    return lambda p, o: net.batch(p, o).cpu().numpy()


def make_policy_act(head: str, cfg: EncoderConfig, n_actions: int = 0,
                    device="cuda"):
    """``make_act(params_ref)`` factory for a (head, encoder) pair — what
    the tuner uses to rebuild greedy acting straight from checkpoint
    metadata."""
    from .rl_common import make_masked_act

    return make_masked_act(make_score_fn(build_network(head, cfg, n_actions, device)))


def checkpoint_meta(head: str, cfg: EncoderConfig,
                    actions: Sequence[Action], state_dim: int,
                    surrogate: str = "auto",
                    backend: Optional[str] = None,
                    peak: Optional[float] = None,
                    measure: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The metadata every trainer embeds in its checkpoints so acting can be
    reconstructed without assuming defaults: network head, encoder config,
    the exact action space (names + split factors), the surrogate policy
    (``"auto"``/``"off"``) the tuner should use for search fallbacks, the
    registry name of the backend that produced the reward signal, the
    ``peak`` GFLOPS that normalized the training rewards (the tuner reuses
    it at load on the same backend), and the measurement settings.  The
    keys are the JAX package's."""
    return {
        "head": head,
        "encoder": cfg.to_dict(),
        "n_actions": len(actions),
        "actions": [a.name for a in actions],
        "splits": [a.param for a in actions if a.kind == "split"],
        "state_dim": int(state_dim),
        "surrogate": surrogate,
        "backend": backend,
        "peak": float(peak) if peak is not None else None,
        "measure": measure,
    }
