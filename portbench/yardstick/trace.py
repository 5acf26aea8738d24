"""What a profiler trace says: the device's busy time, kernel time by name,
and what the host was doing in the device's idle gaps.

The busy time is the union of the trace's device rows (kernels, copies and
memsets), so overlapping work counts once; the idle share is
``1 - busy / window``.  A trace with no device rows is an error: such a
run has nothing to report a busy share from.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPAN_CATS = ("user_annotation",)
HOST_OP_CATS = ("cpu_op",)
NAME_CHARS = 160

#: kernel classes by a piece of the kernel's name
KERNEL_CLASSES = (("flash_bwd", "flash_bwd"), ("flash_fwd", "flash_fwd"),
                  ("tc_matmul", "tiled_matmul"), ("simt_matmul", "tiled_matmul"))


class NoDeviceRows(RuntimeError):
    """The trace holds no device row: the profiler lost the device, and no
    busy share can be read from it."""


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def kernel_class(name: str) -> str:
    for piece, cls in KERNEL_CLASSES:
        if piece in name:
            return cls
    return "other"


@dataclass
class TraceSummary:
    """One traced window, in seconds."""

    window_s: float
    busy_s: float
    by_class_s: Dict[str, float]
    top_ops: List[List]           # [[kernel name, seconds], ...] longest first
    idle_gaps: List[List]         # [[host span / host op, seconds], ...]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _innermost(spans: List[Tuple[float, float, str]], t: float) -> Optional[str]:
    """The shortest span that covers time ``t``."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def summarize(events: List[dict], window: Tuple[float, float], top: int = 10
              ) -> TraceSummary:
    """Summarise chrome-trace ``events`` (times in microseconds) over the
    host-clock ``window`` (start, end) in microseconds of the same clock."""
    lo, hi = window
    dev, spans, ops = [], [], []
    by_name: Dict[str, float] = {}
    by_class: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            s, t = max(start, lo), min(start + dur, hi)
            if t <= s:
                continue
            dev.append((s, t))
            by_name[name] = by_name.get(name, 0.0) + (t - s)
            cls = kernel_class(name) if cat == "kernel" else "other"
            by_class[cls] = by_class.get(cls, 0.0) + (t - s)
        elif cat in HOST_SPAN_CATS:
            spans.append((start, start + dur, name))
        elif cat in HOST_OP_CATS:
            ops.append((start, start + dur, name))
    if not dev:
        raise NoDeviceRows("the trace holds no kernel, memcpy or memset row in its window")
    busy = union(dev)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        span = _innermost(spans, mid) or "no harness span"
        op = _innermost(ops, mid)
        named.append([f"{span}/{op}" if op else span, (e - s) / 1e6])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # a templated kernel's name runs to hundreds of characters: its head names it
    return TraceSummary(
        window_s=(hi - lo) / 1e6, busy_s=covered(busy) / 1e6,
        by_class_s={k: v / 1e6 for k, v in by_class.items()},
        top_ops=[[n[:NAME_CHARS], v / 1e6] for n, v in top_ops], idle_gaps=named)


def read_chrome_trace(path: Path) -> List[dict]:
    return json.loads(path.read_text())["traceEvents"]


def window_from_spans(events: List[dict], name: str) -> Tuple[float, float]:
    """(start, end) in microseconds of the host span ``name`` in the
    trace: the traced window the harness marked."""
    for e in events:
        if e.get("ph") == "X" and e.get("name") == name and \
                str(e.get("cat", "")).lower() in HOST_SPAN_CATS:
            return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
    raise RuntimeError(f"the trace holds no host span {name!r}")
