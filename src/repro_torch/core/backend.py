"""Evaluation-backend protocol + registry for LoopTune reward sources.

Every reward source — the analytical TPU cost model, the measured NumPy
interpreter, the card executor — implements :class:`Backend`:

* ``evaluate(nest) -> float``          — GFLOPS of one schedule
* ``evaluate_batch(nests) -> ndarray`` — GFLOPS of many schedules at once
* ``peak() -> float``                  — peak GFLOPS (reward normalizer)

``evaluate_batch`` must agree elementwise with looped ``evaluate`` calls;
the default simply loops.  Backends are selected *by name* through
:func:`make_backend`:

* ``"numpy"`` (alias ``"cpu"``) — the blocked NumPy interpreter
  (:class:`~repro_torch.core.cpu_backend.CPUMeasuredBackend`)
* ``"torch"`` — the card executor
  (:class:`~repro_torch.core.torch_backend.TorchBackend`): matmul nests
  run the hand-written tiled-matmul kernel, other contractions plain torch
  ops.  It runs on the CUDA device unless given ``device="cpu"``, and
  raises where there is no card.
* ``"tpu"`` — the analytical TPU cost model
  (:class:`~repro_torch.core.cost_model.TPUAnalyticalBackend`)
* ``"auto"`` — ``"torch"``.  Unlike the JAX package's ``"auto"``, it never
  drops to the NumPy interpreter: a run that asked for measurement on the
  card fails where there is none.
* ``"remote"`` — a client of a measurement farm
  (:class:`~repro_torch.core.measure_service.RemoteMeasuredBackend`);
  ``"remote:host:port"`` is the same with its address.

The JAX package's ``"jax"`` executor has no counterpart here.  The
factories accept measurement kwargs and pass them through —
``make_backend("torch", measure="pool")`` builds a card executor whose
``evaluate_batch`` measures in a spawned worker a card.
"""
from __future__ import annotations

import abc
from typing import Callable, Dict, Sequence, Union

import numpy as np

from .loop_ir import LoopNest


class Backend(abc.ABC):
    """Schedule -> GFLOPS evaluation protocol."""

    #: registry name of the executor — rides in checkpoint metadata (see
    #: ``encoders.checkpoint_meta``) so ``LoopTuner.from_checkpoint`` can
    #: rebuild the reward source.  Deliberately no default: an unnamed
    #: subclass falls back to its class name in ``backend_name`` (visible
    #: in stats/meta) instead of a bogus resolvable-looking string.
    name: str

    #: whether :meth:`prepare_batch` does anything — callers (searches, the
    #: vectorized env) check this before spending time assembling frontiers
    can_prepare: bool = False

    #: whether :meth:`submit_batch` actually overlaps measurement with
    #: caller work (the remote farm client pipelines ticketed requests) —
    #: callers check this before restructuring their loops around
    #: submit/collect; the default implementations are synchronous
    #: equivalents so the async shape is always *safe* to use
    can_measure_async: bool = False

    @abc.abstractmethod
    def evaluate(self, nest: LoopNest) -> float:
        """GFLOPS of one schedule (higher is better)."""

    def evaluate_batch(self, nests: Sequence[LoopNest]) -> np.ndarray:
        """GFLOPS of each schedule, as a float64 array of ``len(nests)``.

        Must agree elementwise with looped ``evaluate`` calls; the default
        simply loops, so overrides only change *cost*, never values.
        """
        return np.array([self.evaluate(n) for n in nests], dtype=np.float64)

    def prepare_batch(self, nests: Sequence[LoopNest]) -> int:
        """Compile-ahead hint: schedules likely to be evaluated *next*.

        Backends with expensive per-structure preparation (JIT compilation)
        overlap it with the current batch's measurement; the default is a
        no-op returning 0, so hinting is always safe.  Purely advisory —
        evaluation results must be identical with or without preparation.
        """
        return 0

    def submit_batch(self, nests: Sequence[LoopNest]):
        """Measure-ahead (``measure_async``): start evaluating ``nests``
        and return an opaque handle for :meth:`collect_batch`.

        The async sibling of :meth:`prepare_batch`: backends whose
        measurement happens elsewhere (the remote farm) put the batch in
        flight and return immediately, so callers overlap frontier
        generation / surrogate ranking / compile-ahead with it.  The
        default evaluates synchronously and returns the finished result as
        the handle — same values, zero overlap — so the split shape is
        always safe; check :attr:`can_measure_async` before restructuring
        a loop around it.
        """
        return self.evaluate_batch(nests)

    def collect_batch(self, handle) -> np.ndarray:
        """Resolve a :meth:`submit_batch` handle: block until the batch is
        measured and return its GFLOPS (float64, submit order).  Values
        must be identical to a direct :meth:`evaluate_batch` call."""
        return np.asarray(handle, dtype=np.float64)

    @abc.abstractmethod
    def peak(self) -> float:
        """Peak GFLOPS of the target — the paper's reward normalizer."""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Callable[..., Backend]] = {}


def register_backend(name: str, factory: Callable[..., Backend]) -> None:
    """Register ``factory(**kw) -> Backend`` under ``name`` (overwrites).

    For checkpoint round-tripping (config -> meta -> tuner), the backends a
    factory builds should set ``.name`` to a *registered* name — that is
    the string ``checkpoint_meta`` records and ``make_backend`` later
    resolves."""
    _BACKENDS[name] = factory


def registered_backends() -> list:
    return sorted(_BACKENDS)


def backend_name(backend: Backend) -> str:
    """The registry name a backend instance answers to."""
    return getattr(backend, "name", type(backend).__name__)


def _numpy_backend(**kw) -> Backend:
    from .cpu_backend import CPUMeasuredBackend

    # the kernel store belongs to the card executor; tolerated here so one
    # tuner-level ``cache_dir=...`` setting works across backend specs
    kw.pop("cache_dir", None)
    kw.pop("prepare", None)
    return CPUMeasuredBackend(**kw)


def _torch_backend(**kw) -> Backend:
    from .torch_backend import TorchBackend

    # a lowered schedule is a block shape: nothing to compile ahead
    kw.pop("prepare", None)
    return TorchBackend(**kw)


def _tpu_backend(**kw) -> Backend:
    from .cost_model import TPUAnalyticalBackend

    kw.pop("cache_dir", None)
    kw.pop("prepare", None)
    return TPUAnalyticalBackend(**kw)


def _remote_backend(**kw) -> Backend:
    from .measure_service import RemoteMeasuredBackend

    # the kernel store belongs to the farm-side executor, not the RPC
    # client; tolerated for the same tuner-level-setting reason as numpy/tpu
    kw.pop("cache_dir", None)
    kw.pop("prepare", None)
    return RemoteMeasuredBackend(**kw)


register_backend("numpy", _numpy_backend)
register_backend("cpu", _numpy_backend)  # historical alias
register_backend("torch", _torch_backend)
register_backend("tpu", _tpu_backend)
register_backend("auto", _torch_backend)
register_backend("remote", _remote_backend)


def make_backend(spec: Union[str, Backend, None] = "auto", **kw) -> Backend:
    """Resolve a backend *spec* to an instance.

    ``spec`` may be a registry name (``"numpy" | "torch" | "tpu" | "auto"``
    plus anything registered via :func:`register_backend`), an existing
    :class:`Backend` instance (passed through, ``kw`` must be empty), or
    ``None`` (same as ``"auto"``).  ``kw`` reaches the factory — e.g.
    ``device="cpu"`` for the card executor, the measurement settings
    ``measure="inproc"|"pool"`` and ``pool_workers``, or a
    :class:`~repro_torch.core.measure.MeasurementPolicy` as ``policy``.

    ``"remote:host:port"`` is accepted as a self-contained spec for the
    farm client (equivalent to ``make_backend("remote", addr="host:port")``)
    so plain-string configuration points — trainer configs, CLI
    ``--backend`` flags — can target a measurement farm directly.
    """
    if spec is None:
        spec = "auto"
    if isinstance(spec, str) and spec.startswith("remote:"):
        kw.setdefault("addr", spec[len("remote:"):])
        spec = "remote"
    if isinstance(spec, Backend):
        if kw:
            raise ValueError(
                f"backend kwargs {sorted(kw)} cannot apply to an "
                f"already-built {backend_name(spec)!r} backend instance")
        return spec
    try:
        factory = _BACKENDS[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown backend {spec!r}; registered: {registered_backends()}"
        ) from None
    return factory(**kw)
