"""Spans at the port's layer boundaries, kept only while something records.

    from repro_torch.tracing import span

    with span("search.greedy") as sp:
        ...
        sp.set(evals=n)          # an attribute known only at the end

A span records while a ``torch.profiler`` session records (the benchmark's
traced window) or inside a :func:`recording` block (the operator's and the
tests' switch).  Otherwise :func:`span` returns a shared do-nothing object
after one check: no ``record_function``, no CUDA event, no record.

A record holds the span's name, its host start and end (``time.monotonic_ns``),
its parent (the innermost span open on the same thread when it began) and
its attributes.  Under a profiler each span also enters
``torch.profiler.record_function(name)``, so it lands in the chrome trace as
a ``user_annotation`` on the device rows' clock.  A ``device=True`` span in a
process that has initialised CUDA records a CUDA event on the current stream
as it enters and as it leaves; its ``device_s`` is the stream time between
them: the device time of everything it enqueued, with any idle the host
caused inside it.

Records of one session are kept in memory, at most :data:`CAPACITY` of
them; spans past the cap are counted (:func:`dropped`), not kept.  A session
starts at a :func:`recording` block's entry, or at the first span a
profiler records once the previous session has ended; it ends when its
``recording`` block exits, or when :func:`spans` reads it with nothing
recording.  A new session drops the previous one's records, so a reader
sees only the latest traced window.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

#: records kept a session
CAPACITY = 1 << 16

_profiler_enabled = torch.autograd._profiler_enabled


@dataclass
class SpanRecord:
    """One span: ``index`` in its session, ``parent`` the index of the span
    that was open around it on its thread (None at the top)."""

    name: str
    index: int
    parent: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    device_s: Optional[float] = None

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Session:
    def __init__(self):
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self.pending: List[Tuple[SpanRecord, Any, Any]] = []   # device events to resolve


class _State:
    """The tracer's process-wide state: the open ``recording`` blocks, the
    latest session, whether the next span opens a new one, and each
    thread's stack of open spans."""

    def __init__(self):
        self.depth = 0
        self.session: Optional[_Session] = None
        self.ended = True
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def begin(self) -> None:
        self.session, self.ended = _Session(), False


_STATE = _State()


class _Off:
    """The span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "attrs", "record", "session", "rf", "events")

    def __init__(self, name: str, device: bool, attrs: Dict[str, Any]):
        self.name, self.device, self.attrs = name, device, attrs
        self.record = self.session = self.rf = self.events = None

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        if self.record is not None:
            self.record.attrs.update(attrs)

    def __enter__(self):
        st = _STATE
        stack = st.stack()
        with st.lock:
            if st.ended:
                st.begin()
            session = st.session
            if len(session.records) >= CAPACITY:
                session.dropped += 1
                return self
            top = stack[-1] if stack else None
            parent = top[1].index if top is not None and top[0] is session else None
            rec = SpanRecord(self.name, len(session.records), parent, 0, attrs=self.attrs)
            session.records.append(rec)
        self.record, self.session = rec, session
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append((session, rec))
        rec.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        rec = self.record
        if rec is None:
            return None
        end = time.monotonic_ns()
        if self.events is not None:
            self.events[1].record()
            self.session.pending.append((rec, *self.events))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _STATE.stack()
        if stack and stack[-1][1] is rec:
            stack.pop()
        rec.end_ns = end
        return None


def span(name: str, device: bool = False, **attrs):
    """A context manager for one span of ``name`` with ``attrs``; while
    nothing records, a shared object that does nothing (and is false)."""
    if not (_STATE.depth or _profiler_enabled()):
        return _OFF
    return _Span(name, device, attrs)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record every span inside the block, as a new session, with or
    without a profiler."""
    st = _STATE
    with st.lock:
        st.depth += 1
        if st.depth == 1:
            st.begin()
    try:
        yield
    finally:
        with st.lock:
            st.depth -= 1
            if st.depth == 0:
                st.ended = True


def spans() -> List[SpanRecord]:
    """The closed spans of the latest session, in the order they began,
    their device times resolved (one synchronize).  Read with nothing
    recording, this ends the session."""
    st = _STATE
    with st.lock:
        session = st.session
        if not (st.depth or _profiler_enabled()):
            st.ended = True
    if session is None:
        return []
    if session.pending:
        torch.cuda.synchronize()
        for rec, start, end in session.pending:
            rec.device_s = start.elapsed_time(end) / 1e3
        session.pending.clear()
    return [r for r in session.records if r.end_ns is not None]


def dropped() -> int:
    """Spans of the latest session past :data:`CAPACITY`, counted, not kept."""
    session = _STATE.session
    return session.dropped if session is not None else 0
