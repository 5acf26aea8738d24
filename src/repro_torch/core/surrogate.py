"""Learned cost-model surrogate for two-stage frontier ranking.

Search quality is bounded by how many ``Backend.evaluate_batch`` probes a
budget buys.  Following the learned performance models of Kaufman et al.
(*A Learned Performance Model for TPUs*) and the statistical cost models of
Chen et al. (*Learning to Optimize Tensor Programs*), this module trains a
small PyTorch regressor on ``(featurized nest -> measured GFLOPS)`` pairs
harvested online from the shared :class:`ScheduleCache`, then lets search
spend real evaluations only on the most promising slice of each frontier:

* :class:`SurrogateDataset` — deduplicated ``(obs, gflops)`` training set.
  ``from_cache`` reconstructs nests straight from a :class:`ScheduleCache`'s
  structure keys, so *any* producer of measurements (searches, RL trainers'
  rollouts, the tuner) feeds the model for free.
* :class:`SurrogateModel` — the regressor.  Reuses the policy-encoder
  registry (``encoders.py``): a ``flat`` or ``graph`` :class:`EncoderConfig`
  dictates both the featurizer and the network trunk, and the scalar head is
  simply the registry's Q head with one action.  Targets are ``log1p``
  GFLOPS, z-scored per fit; predictions are always finite.  It lives on a
  device (``"cuda"`` by default, which raises without a card).
* :class:`SurrogateScorer` — the two-stage frontier policy used by
  ``search.py``: cache hits always pass (they are free), and of the cache
  misses only the top ``keep_frac`` by predicted GFLOPS are sent to the
  backend / charged against the budget.  Fresh measurements stream back in
  through :meth:`observe`, which re-fits the model every ``refit_every`` new
  examples.  Until ``min_fit`` examples exist the scorer is inactive and
  search behaves exactly as without it (cold-start safety).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from .encoders import DEFAULT_HIDDEN, EncoderConfig, build_network, get_encoder
from .loop_ir import Contraction, LoopNest
from .networks import make_adam
from .rl_common import sync_device
from .schedule_cache import ScheduleCache


class SurrogateDataset:
    """Deduplicated ``(featurized nest, measured GFLOPS)`` training set.

    Examples are keyed by ``nest.structure_key()`` so repeated observations
    of the same schedule (cache hits, revisits across searches) never skew
    the regression.  Nests the featurizer cannot encode (e.g. deeper than a
    graph featurizer's ``max_loops``) are skipped, not fatal.
    """

    def __init__(self, featurizer):
        self.featurizer = featurizer
        self._X: List[np.ndarray] = []
        self._y: List[float] = []
        self._keys: set = set()

    def __len__(self) -> int:
        return len(self._y)

    def add(self, nest: LoopNest, gflops: float) -> bool:
        """Add one example; returns True iff it was new and featurizable."""
        g = float(gflops)
        if not np.isfinite(g):
            return False
        key = nest.structure_key()
        if key in self._keys:
            return False
        try:
            obs = np.asarray(self.featurizer(nest), np.float32)
        except ValueError:  # featurizer capacity exceeded: skip, don't die
            return False
        self._keys.add(key)
        self._X.append(obs)
        self._y.append(g)
        return True

    def add_batch(self, nests: Sequence[LoopNest],
                  gflops: Sequence[float]) -> int:
        return sum(self.add(n, g) for n, g in zip(nests, gflops))

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(X (N, state_dim) float32, y (N,) float64)``."""
        if not self._y:
            d = getattr(self.featurizer, "state_dim", 0)
            return np.zeros((0, d), np.float32), np.zeros(0, np.float64)
        return np.stack(self._X), np.asarray(self._y, np.float64)

    @classmethod
    def from_cache(
        cls,
        cache: ScheduleCache,
        contractions: Iterable[Contraction],
        featurizer,
    ) -> "SurrogateDataset":
        """Harvest every cached measurement whose contraction is known.

        The cache's structure keys carry the full loop body, so each entry is
        reconstructed into a :class:`LoopNest` and featurized — no extra
        backend calls.  This is how trainers' rollouts (which evaluate
        thousands of schedules through the same shared cache) become
        surrogate training data.
        """
        by_name = {c.key_name: c for c in contractions}
        ds = cls(featurizer)
        for key, gflops in cache.entries():
            contraction = by_name.get(key[0])
            if contraction is None:
                continue
            ds.add(LoopNest.from_structure_key(contraction, key), gflops)
        return ds


class SurrogateModel:
    """Small regressor: featurized nest -> predicted GFLOPS.

    The network is the encoder registry's Q head with a single output unit,
    so every registered encoder (``flat``, ``graph``, custom) works
    unchanged.  ``fit`` is warm-started: repeated re-fits continue from the
    current parameters (and Adam state) with the refreshed dataset.
    """

    def __init__(
        self,
        encoder: Optional[EncoderConfig] = None,
        hidden: Sequence[int] = (64, 64),
        lr: float = 1e-2,
        seed: int = 0,
        device="cuda",
    ):
        cfg = (encoder or EncoderConfig()).resolved(tuple(hidden) or DEFAULT_HIDDEN)
        self.config = cfg
        self.net = build_network("q", cfg, 1, device)
        self.featurizer = get_encoder(cfg.kind).featurizer(cfg)
        self.lr = lr
        self.params = self.net.init(seed)
        self._opt = make_adam(self.params, lr)
        self._rng = np.random.default_rng(seed)
        self._mu, self._sigma = 0.0, 1.0
        self.fitted = False
        self.n_fits = 0

    @classmethod
    def for_featurizer(cls, featurizer, **kw) -> "SurrogateModel":
        """Model whose encoder matches an env's featurizer (kind + capacity),
        so search-time observations and training examples agree."""
        cfg = EncoderConfig(kind=featurizer.kind, max_loops=featurizer.max_loops)
        return cls(encoder=cfg, **kw)

    def _update(self, xb: np.ndarray, tb: np.ndarray) -> None:
        dev = self.net.device
        x = torch.as_tensor(xb, dtype=torch.float32, device=dev)
        t = torch.as_tensor(tb, dtype=torch.float32, device=dev)
        err = self.params(x)[..., 0] - t
        loss = (err * err).mean()
        self._opt.zero_grad(set_to_none=True)
        loss.backward()
        self._opt.step()

    # -- training -----------------------------------------------------------

    def fit(self, dataset: SurrogateDataset, steps: int = 150,
            batch_size: int = 32) -> "SurrogateModel":
        """(Re-)fit on the dataset; a no-op on an empty dataset and safe on a
        singleton (degenerate spread falls back to unit scale).  Leaves
        the device idle (the fit's steps are queued otherwise)."""
        X, y = dataset.arrays()
        if len(y) == 0:
            return self
        t = np.log1p(np.maximum(y, 0.0))
        self._mu = float(t.mean())
        sigma = float(t.std())
        self._sigma = sigma if sigma > 1e-8 else 1.0
        targets = (t - self._mu) / self._sigma
        n = len(y)
        for _ in range(max(1, steps)):
            idx = (self._rng.choice(n, size=min(batch_size, n), replace=False)
                   if n > batch_size else np.arange(n))
            self._update(X[idx], targets[idx])
        sync_device(self.net.device)
        self.fitted = True
        self.n_fits += 1
        return self

    # -- inference ----------------------------------------------------------

    def predict_obs(self, X: np.ndarray) -> np.ndarray:
        """Predicted GFLOPS for pre-featurized observations ``(N, D)``;
        always finite (non-finite network output is clamped to 0)."""
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X[None]
        z = self.net.batch(self.params, X)[..., 0].cpu().numpy()
        z = np.nan_to_num(z * self._sigma + self._mu,
                          nan=0.0, posinf=60.0, neginf=-60.0)
        # log1p-space values are small; clip before expm1 to keep finiteness
        return np.expm1(np.clip(z, -60.0, 60.0))

    def predict(self, nests: Sequence[LoopNest]) -> np.ndarray:
        """Predicted GFLOPS per nest.  A nest the featurizer cannot encode
        predicts ``+inf`` — i.e. "must be measured for real" downstream."""
        out = np.full(len(nests), np.inf, np.float64)
        obs, slots = [], []
        for i, nest in enumerate(nests):
            try:
                obs.append(np.asarray(self.featurizer(nest), np.float32))
                slots.append(i)
            except ValueError:
                pass
        if obs:
            out[slots] = self.predict_obs(np.stack(obs))
        return out


class SurrogateScorer:
    """Two-stage frontier policy: surrogate ranks, the backend verifies.

    ``select`` returns the frontier indices worth a real evaluation; cache
    hits are always included (re-scoring them is free) and, once the model is
    active, only the top ``keep_frac`` of the cache misses (never fewer than
    ``min_keep``) survive.  ``observe`` streams measurements back into the
    dataset and re-fits every ``refit_every`` fresh examples.
    """

    def __init__(
        self,
        model: SurrogateModel,
        keep_frac: float = 0.25,
        min_keep: int = 2,
        min_fit: int = 16,
        refit_every: int = 48,
        fit_steps: int = 200,
        root_keep_frac: Optional[float] = 1.0,
    ):
        if not 0.0 < keep_frac <= 1.0:
            raise ValueError(f"keep_frac must be in (0, 1], got {keep_frac}")
        self.model = model
        self.dataset = SurrogateDataset(model.featurizer)
        self.keep_frac = keep_frac
        self.min_keep = min_keep
        self.min_fit = min_fit
        self.refit_every = refit_every
        self.fit_steps = fit_steps
        # frontiers whose scoring a search *commits* to (greedy's root
        # expansion) get this fraction instead; the default 1.0 keeps the
        # commitment fully measured (a mis-pruned commitment can strand the
        # whole trajectory in a poor local optimum), None = same as keep_frac
        self.root_keep_frac = root_keep_frac
        self._since_fit = 0
        self.n_selected = 0
        self.n_skipped = 0

    @classmethod
    def for_env(cls, env, device=None, **kw) -> "SurrogateScorer":
        """Scorer whose model matches ``env.featurizer`` (kind + capacity).
        ``device=None`` puts the model where the env's backend measures (the
        card executor's device), and on ``"cuda"`` for a host-side backend."""
        if device is None:
            device = getattr(env.backend, "device", "cuda")
        return cls(SurrogateModel.for_featurizer(env.featurizer,
                                                 seed=kw.pop("seed", 0),
                                                 device=device), **kw)

    @property
    def active(self) -> bool:
        return self.model.fitted and len(self.dataset) >= self.min_fit

    def select(self, env, nests: Sequence[LoopNest],
               root: bool = False) -> List[int]:
        """Indices of ``nests`` to really evaluate, cheapest-stage first.
        ``root=True`` applies ``root_keep_frac`` (a search's commitment
        frontier) instead of ``keep_frac``."""
        idx = list(range(len(nests)))
        if not self.active:
            return idx
        frac = (self.root_keep_frac if root and self.root_keep_frac is not None
                else self.keep_frac)
        hits, misses = [], []
        for i in idx:
            (hits if nests[i].structure_key() in env.cache else misses).append(i)
        n_keep = max(self.min_keep, math.ceil(frac * len(misses)))
        if n_keep >= len(misses):
            return idx
        preds = self.model.predict([nests[i] for i in misses])
        ranked = sorted(range(len(misses)), key=lambda j: -preds[j])
        kept = [misses[j] for j in ranked[:n_keep]]
        self.n_selected += len(kept)
        self.n_skipped += len(misses) - len(kept)
        # hits first (they cost nothing and must never be truncated away),
        # then misses best-predicted-first — so when a tight max_evals
        # prefix-truncates the batch, it drops the surrogate's LOWEST-ranked
        # survivors, not an arbitrary index suffix
        return hits + kept

    def observe(self, nests: Sequence[LoopNest],
                gflops: Sequence[float]) -> None:
        """Record fresh measurements; re-fit when enough new data arrived."""
        self._since_fit += self.dataset.add_batch(nests, gflops)
        if len(self.dataset) >= self.min_fit and (
                not self.model.fitted or self._since_fit >= self.refit_every):
            self.model.fit(self.dataset, steps=self.fit_steps)
            self._since_fit = 0

    def harvest(self, cache: ScheduleCache,
                contractions: Iterable[Contraction]) -> int:
        """Bulk-import a cache's measurements (e.g. a trainer's rollout
        cache) and fit if that unlocks the model.  Returns examples added."""
        by_name = {c.key_name: c for c in contractions}
        nests, gs = [], []
        for key, gflops in cache.entries():
            c = by_name.get(key[0])
            if c is not None:
                nests.append(LoopNest.from_structure_key(c, key))
                gs.append(gflops)
        added = self.dataset.add_batch(nests, gs)
        self._since_fit += added
        if len(self.dataset) >= self.min_fit and self._since_fit:
            self.model.fit(self.dataset, steps=self.fit_steps)
            self._since_fit = 0
        return added

    def stats(self) -> Dict[str, float]:
        return {
            "active": self.active,
            "dataset_size": len(self.dataset),
            "n_fits": self.model.n_fits,
            "selected": self.n_selected,
            "skipped": self.n_skipped,
            "keep_frac": self.keep_frac,
        }


def make_surrogate(spec, env) -> Optional[SurrogateScorer]:
    """Resolve a user-facing surrogate spec into a scorer (or None).

    ``spec`` may be ``None``/"off" (disabled), "auto" (scorer matched to the
    env's featurizer, on its backend's device; see
    :meth:`SurrogateScorer.for_env`), or an existing
    :class:`SurrogateScorer` (shared across searches so learning
    accumulates)."""
    if spec is None or spec == "off":
        return None
    if isinstance(spec, SurrogateScorer):
        return spec
    if spec == "auto":
        return SurrogateScorer.for_env(env)
    raise ValueError(
        f"surrogate must be 'auto', 'off', None or a SurrogateScorer; "
        f"got {spec!r}")
