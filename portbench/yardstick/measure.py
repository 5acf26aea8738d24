"""What a run hands the per-layer metric readers, and the traced window.

With ``--trace 1`` a runner measures its window untraced, then runs a fixed
number of further steps of the same traffic under ``torch.profiler`` inside
one host span, ``portbench.traced_window``; the trace is written inside the
checkout (``build/portbench/``), read back and deleted.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from . import trace as TR
from .spec import ROOT

TRACE_DIR = ROOT / "build" / "portbench"
WINDOW_SPAN = "portbench.traced_window"


@dataclass
class Run:
    """One run's readings: ``steps`` waves, contractions or training steps
    completed in ``window_s``; ``traced_steps`` more under the profiler,
    summarised in ``trace``; the program's counters."""

    kind: str
    model: Dict
    traffic: Dict
    window_s: float
    steps: int
    batch: int = 0
    seq: int = 0
    trace: Optional[TR.TraceSummary] = None
    traced_steps: int = 0
    counters: Dict[str, Any] = field(default_factory=dict)


def span(name: str):
    """A host span in the trace (a no-op cost when nothing profiles)."""
    import torch

    return torch.profiler.record_function(name)


def profile_steps(step: Callable[[int], None], n: int, sync: Callable[[], None],
                  tag: str) -> TR.TraceSummary:
    """Run ``step(i)`` for i < n under the profiler, inside the window span,
    and summarise the device's rows over that span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        with span(WINDOW_SPAN):
            for i in range(n):
                step(i)
            sync()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"trace-{tag}.json"
    try:
        prof.export_chrome_trace(str(path))
        events = TR.read_chrome_trace(path)
    finally:
        with contextlib.suppress(FileNotFoundError):
            path.unlink()
    return TR.summarize(events, TR.window_from_spans(events, WINDOW_SPAN))
