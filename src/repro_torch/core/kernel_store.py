"""Persistent kernel store: fleet-wide build-once artifacts.

The card executor's schedules lower to a block shape, not to a traced
program, so what is expensive to produce in the port is the hand-written
kernels' shared libraries: ``nvcc`` takes tens of seconds a source, and
every spawned pool worker, farm worker or tuner process that starts with an
empty ``build/kernels/`` used to run it again.  This module is the disk
layer that makes the build **shared** and **persistent**: artifacts (here
the built ``.so`` files, zlib-compressed) keyed by the source's stem and
its build hash (``kernels._build``) under a directory namespaced by a
runtime *fingerprint* (torch, CUDA and ``nvcc`` versions, the card's
compute capability, the artifact format version), so libraries survive
across runs and are loaded — not rebuilt — by every process that shares
the cache dir.

Fleet-wide build dedup is file-based, so it works identically for pool
workers and independent tuner processes: the first process to need a cold
key takes a lock file (``O_CREAT | O_EXCL``, with the owner's pid and
timestamp) and builds; peers poll for the artifact to appear and load it
instead of building.  A crashed builder leaves a stale lock, which waiters
age out (``stale_lock_s``, on the owner's timestamp, padded by
``skew_tolerance_s``) before building themselves — a measurement can be
*slowed* by the store, never failed by it.

Every actual build is appended to ``compiles.log`` (one JSON line per
build: key digest, pid, seconds), which is what lets tests and the card
run assert the headline invariant — N processes on one store run ``nvcc``
once per source, not N times.

Degradation is deliberate and total: an unwritable root, a corrupt
artifact, a full disk — each warns once, counts, and falls back to a local
build.  The store is an accelerator, not a dependency.  The layout, the
lock rules and the log are the JAX package's, so the same code serves
either kind of artifact.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
import warnings
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, Hashable, List, Optional

#: bump when the artifact layout changes (serialization wrapper, compression)
STORE_FORMAT = 1

# one warning per (root, reason) per process — a degraded store must not
# turn every measurement into a warning storm
_WARNED: set = set()


def _warn_once(root: str, reason: str, detail: str) -> None:
    if (root, reason) in _WARNED:
        return
    _WARNED.add((root, reason))
    warnings.warn(
        f"persistent kernel store at {root!r}: {reason} ({detail}); "
        f"falling back to a local build for affected keys",
        stacklevel=3)


def key_digest(key: Hashable) -> str:
    """Stable digest of a compile key (``repr`` of nested tuples of
    str/int is process-independent)."""
    return hashlib.sha256(repr(key).encode()).hexdigest()[:32]


def fingerprint_digest(fingerprint: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(fingerprint, sort_keys=True).encode()).hexdigest()[:16]


class PersistentKernelStore:
    """Disk-backed artifact map with cross-process build coordination.

    The store holds opaque ``bytes`` (the backend owns serialization
    semantics); compression is handled here.  All methods are safe to call
    after degradation (``disabled``) — they no-op / return None.

    Layout::

        root/
          <fingerprint-digest>/
            fingerprint.json     # what this namespace was built by
            <key-digest>.kbin    # zlib(serialized artifact)
            <key-digest>.lock    # in-progress build marker
            compiles.log         # one JSON line per actual build
    """

    def __init__(
        self,
        root: str,
        fingerprint: Dict[str, Any],
        wait_timeout_s: float = 60.0,
        stale_lock_s: float = 300.0,
        poll_s: float = 0.05,
        skew_tolerance_s: float = 120.0,
    ):
        self.root = str(root)
        self.fingerprint = dict(fingerprint, store_format=STORE_FORMAT)
        self.wait_timeout_s = wait_timeout_s
        self.stale_lock_s = stale_lock_s
        self.poll_s = poll_s
        #: extra margin on stale-lock aging: the lock owner's clock and ours
        #: may disagree (shared cache dir across farm hosts), and aging out a
        #: *live* builder's lock forks the build it was coordinating
        self.skew_tolerance_s = skew_tolerance_s
        self.disabled = False
        # traffic counters (per process)
        self.hits = 0
        self.misses = 0
        self.load_errors = 0
        self.put_errors = 0
        self.locks_taken = 0
        self.waits = 0
        self.wait_timeouts = 0
        self.bytes_written = 0
        self.dir = Path(self.root) / fingerprint_digest(self.fingerprint)
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            # probe writability now, not at first artifact: a read-only dir
            # should degrade at construction, once
            probe = self.dir / f".probe-{os.getpid()}"
            probe.write_bytes(b"")
            probe.unlink()
            fp = self.dir / "fingerprint.json"
            if not fp.exists():
                fp.write_text(json.dumps(self.fingerprint, indent=1,
                                         sort_keys=True, default=str))
        except OSError as e:
            self._degrade("cache dir unusable", str(e))

    # -- degradation ----------------------------------------------------------

    def _degrade(self, reason: str, detail: str) -> None:
        self.disabled = True
        _warn_once(self.root, reason, detail)

    # -- paths ----------------------------------------------------------------

    def _artifact(self, key: Hashable) -> Path:
        return self.dir / f"{key_digest(key)}.kbin"

    def _lock(self, key: Hashable) -> Path:
        return self.dir / f"{key_digest(key)}.lock"

    # -- artifact I/O ---------------------------------------------------------

    def contains(self, key: Hashable) -> bool:
        return not self.disabled and self._artifact(key).exists()

    def load(self, key: Hashable) -> Optional[bytes]:
        """Decompressed artifact bytes, or None (miss / corrupt — corrupt
        files are dropped so the next builder replaces them)."""
        if self.disabled:
            return None
        path = self._artifact(key)
        try:
            raw = path.read_bytes()
        except FileNotFoundError:
            self.misses += 1
            return None
        except OSError as e:
            self.load_errors += 1
            _warn_once(self.root, "artifact unreadable", f"{path.name}: {e}")
            return None
        try:
            data = zlib.decompress(raw)
        except zlib.error as e:
            # torn write from a crashed builder, or foreign junk: drop it
            self.load_errors += 1
            _warn_once(self.root, "corrupt artifact",
                       f"{path.name}: {e}")
            self.discard(key)
            return None
        self.hits += 1
        return data

    def store(self, key: Hashable, data: bytes) -> bool:
        """Atomically persist ``data`` (tmp file + rename, so concurrent
        readers never observe a partial artifact)."""
        if self.disabled:
            return False
        path = self._artifact(key)
        try:
            fd, tmp = tempfile.mkstemp(dir=str(self.dir),
                                       prefix=path.stem, suffix=".tmp")
            try:
                payload = zlib.compress(data, 6)
                with os.fdopen(fd, "wb") as f:
                    f.write(payload)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError as e:
            self.put_errors += 1
            self._degrade("artifact write failed", str(e))
            return False
        self.bytes_written += len(payload)
        return True

    def discard(self, key: Hashable) -> None:
        """Drop an artifact the caller could not use (a truncated file:
        the next builder replaces it)."""
        try:
            self._artifact(key).unlink()
        except OSError:
            pass

    # -- cross-process build coordination -------------------------------------

    def acquire_build_lock(self, key: Hashable) -> bool:
        """True when this process should build ``key`` (it now holds the
        lock); False when another builder holds it.  A disabled store always
        grants the build — degraded mode means everyone compiles locally."""
        if self.disabled:
            return True
        lock = self._lock(key)
        try:
            fd = os.open(str(lock), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps({"pid": os.getpid(), "t": time.time()}))
            self.locks_taken += 1
            return True
        except FileExistsError:
            # stale lock from a crashed builder: age it out and retry once.
            # Age against the timestamp the *owner* wrote into the lock, not
            # the file mtime as seen through a shared filesystem — cross-host
            # clock skew on an NFS cache dir can make a live builder's lock
            # look minutes old — and pad with skew_tolerance_s either way.
            try:
                owner_t: Optional[float] = None
                try:
                    owner_t = float(json.loads(lock.read_text())["t"])
                except (OSError, ValueError, TypeError, KeyError):
                    pass  # pre-upgrade / torn lock: mtime is all we have
                if owner_t is None:
                    owner_t = lock.stat().st_mtime
                if time.time() - owner_t > self.stale_lock_s + self.skew_tolerance_s:
                    lock.unlink()
                    return self.acquire_build_lock(key)
            except OSError:
                pass
            return False
        except OSError as e:
            self._degrade("lock dir unusable", str(e))
            return True

    def release_build_lock(self, key: Hashable) -> None:
        try:
            self._lock(key).unlink()
        except OSError:
            pass

    def wait_for(self, key: Hashable) -> Optional[bytes]:
        """Poll for another builder's artifact.  Returns the bytes, or None
        on timeout / builder crash — the caller then builds locally, so the
        measurement proceeds either way."""
        if self.disabled:
            return None
        self.waits += 1
        deadline = time.monotonic() + self.wait_timeout_s
        while time.monotonic() < deadline:
            data = self.load(key)
            if data is not None:
                return data
            if not self._lock(key).exists():
                # builder finished (artifact should exist) or died without
                # one; re-check once then give up and build locally
                data = self.load(key)
                if data is None:
                    self.wait_timeouts += 1
                return data
            time.sleep(self.poll_s)
        self.wait_timeouts += 1
        return None

    # -- fleet compile accounting ---------------------------------------------

    def log_compile(self, key: Hashable, seconds: float) -> None:
        """Record one actual build (fleet-wide ground truth: the pool-of-N
        `~1x builds per key` invariant is asserted off this log)."""
        if self.disabled:
            return
        line = json.dumps({"key": key_digest(key), "pid": os.getpid(),
                           "s": round(seconds, 4), "t": time.time()})
        try:
            with open(self.dir / "compiles.log", "a") as f:
                f.write(line + "\n")
        except OSError as e:
            self.put_errors += 1
            _warn_once(self.root, "compile log write failed", str(e))

    def compile_events(self) -> List[Dict[str, Any]]:
        if self.disabled:
            return []
        try:
            text = (self.dir / "compiles.log").read_text()
        except OSError:
            return []
        out = []
        for line in text.splitlines():
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn concurrent append: skip the fragment
        return out

    # -- orchestration helper --------------------------------------------------

    def get_or_build(
        self,
        key: Hashable,
        build: Callable[[], Optional[bytes]],
    ) -> Optional[bytes]:
        """Artifact bytes for ``key``: loaded if present, else built by
        exactly one process fleet-wide (``build`` returns the serialized
        bytes, or None for unexportable keys).  Callers that need the live
        library rather than bytes orchestrate the same primitives directly
        (see ``kernels._build.build``)."""
        data = self.load(key)
        if data is not None:
            return data
        if self.acquire_build_lock(key):
            try:
                t0 = time.perf_counter()
                data = build()
                if data is not None:
                    self.log_compile(key, time.perf_counter() - t0)
                    self.store(key, data)
            finally:
                self.release_build_lock(key)
            return data
        data = self.wait_for(key)
        if data is not None:
            return data
        t0 = time.perf_counter()
        data = build()
        if data is not None:
            self.log_compile(key, time.perf_counter() - t0)
        return data

    # -- observability ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        n_events = len(self.compile_events())
        return {
            "root": self.root,
            "disabled": self.disabled,
            "hits": self.hits,
            "misses": self.misses,
            "load_errors": self.load_errors,
            "put_errors": self.put_errors,
            "locks_taken": self.locks_taken,
            "waits": self.waits,
            "wait_timeouts": self.wait_timeouts,
            "bytes_written": self.bytes_written,
            "artifacts": (sum(1 for _ in self.dir.glob("*.kbin"))
                          if not self.disabled else 0),
            "fleet_compiles": n_events,
        }


def open_store(root: Optional[str],
               fingerprint: Dict[str, Any],
               **kw) -> Optional[PersistentKernelStore]:
    """A usable store for ``root``, or None (no dir requested, or the dir
    degraded at construction — either way the caller builds locally)."""
    if not root:
        return None
    store = PersistentKernelStore(root, fingerprint, **kw)
    return None if store.disabled else store
