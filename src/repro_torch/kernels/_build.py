"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the
repository root (a directory ``.gitignore`` lists).  ``<hash>`` covers the
source, every header it includes from ``csrc/`` (``#include "..."``,
followed through headers), and the flags, so an edited source or header
rebuilds and an unchanged one loads the library already built.  Nothing
here runs at import time: the CPU tests import every module on hosts with
no ``nvcc``.

With a kernel store open (:func:`open_library_store`, which the card
executor calls for its ``cache_dir``), a library missing from the build
directory is loaded from the store when another process already built it,
and otherwise built by exactly one process across all that share the
store: the builder holds the store's build lock, the others wait for its
artifact, and each ``nvcc`` run is one line of the store's
``compiles.log``.  N spawned pool workers, or N hosts on one shared
directory, so run ``nvcc`` once per source.  ``REPRO_TORCH_BUILD_DIR``
moves the build directory (a process that must not find the libraries
another process left in ``build/kernels/``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: per source: {"seconds": nvcc's time (0.0 when it did not run), "log": ptxas
#: output, "source": "nvcc", "store" (loaded from the kernel store) or
#: "local" (found in the build directory)}
BUILD_INFO: Dict[str, Dict[str, object]] = {}
#: the kernel store builds go through (None: build locally)
_STORE = None
#: the store's waits are sized to nvcc, which takes up to a minute a source
STORE_WAIT_S = 600.0
STORE_STALE_LOCK_S = 900.0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def build_dir() -> Path:
    """Where libraries are built: ``$REPRO_TORCH_BUILD_DIR``, else
    ``build/kernels/`` at the repository root."""
    moved = os.environ.get(BUILD_DIR_ENV)
    return Path(moved) if moved else BUILD_DIR


_NVCC_VERSION: List[str] = []


def fingerprint() -> Dict[str, str]:
    """What a built library depends on besides its source, headers and
    flags: the torch, CUDA and ``nvcc`` versions and the card's compute
    capability.  It initialises no CUDA on a host without a card."""
    import torch

    if not _NVCC_VERSION:
        try:
            out = subprocess.run([nvcc(), "--version"], capture_output=True,
                                 text=True, check=True).stdout
            _NVCC_VERSION.append(out.strip().splitlines()[-1])
        except (RuntimeError, OSError, subprocess.CalledProcessError, IndexError):
            _NVCC_VERSION.append("none")
    capability = "none"
    if torch.cuda.is_available():
        capability = "sm_{}{}".format(*torch.cuda.get_device_capability(0))
    return {"torch": torch.__version__, "cuda": str(torch.version.cuda),
            "nvcc": _NVCC_VERSION[0], "capability": capability}


def open_library_store(root: Optional[str]):
    """Open the kernel store at ``root`` and build through it from now on
    in this process; returns the store, or None (no root, or a root that
    degraded: builds stay local)."""
    global _STORE
    from ..core.kernel_store import open_store

    if not root:
        return None
    store = open_store(root, fingerprint(), wait_timeout_s=STORE_WAIT_S,
                       stale_lock_s=STORE_STALE_LOCK_S)
    if store is not None:
        _STORE = store
    return store


def _source(item: Union[str, Path]) -> Path:
    return item if isinstance(item, Path) else CSRC / f"{item}.cu"


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _headers(src: Path) -> List[Path]:
    """The quoted headers ``src`` includes, and theirs, in the order first
    met: each found beside the file that includes it, else in ``csrc/``
    (where a mutant copy of a source finds them)."""
    found: List[Path] = []
    todo = [src]
    while todo:
        cur = todo.pop(0)
        for name in _INCLUDE.findall(cur.read_bytes()):
            rel = name.decode()
            path = cur.parent / rel
            if not path.exists():
                path = CSRC / rel
            if not path.exists():
                raise FileNotFoundError(f"{cur.name} includes {rel!r}, found neither "
                                        f"beside it nor in {CSRC}")
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in _headers(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def store_key(src: Path, out: Path) -> tuple:
    """The kernel store's key of a library: the source's stem and the build
    hash of :func:`_lib_path` (sources, headers and flags)."""
    return ("cuda-library", src.stem, out.stem.rsplit("-", 1)[-1])


def _compile(src: Path, out: Path) -> float:
    """Run ``nvcc`` on ``src`` into ``out``; returns its seconds."""
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process loads a whole file
    seconds = time.perf_counter() - t0
    BUILD_INFO[src.stem] = {"seconds": seconds, "log": proc.stderr, "source": "nvcc"}
    return seconds


def _materialise(src: Path, out: Path, data: bytes) -> None:
    """Write a library the store held into the build directory."""
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, out)
    BUILD_INFO[src.stem] = {"seconds": 0.0, "log": "", "source": "store"}


def build(item: Union[str, Path]) -> Path:
    """Compile ``csrc/<item>.cu`` (or the source file ``item``) unless the
    library for this source and these flags exists; returns its path.
    Through an open kernel store, a library another process built is
    loaded from the store instead, and a cold one is built by one process
    only.  ``BUILD_INFO`` is keyed by the source's stem."""
    src = _source(item)
    out = _lib_path(src)
    if out.exists():
        BUILD_INFO.setdefault(src.stem, {"seconds": 0.0, "log": "", "source": "local"})
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    store = _STORE
    if store is None:
        _compile(src, out)
        return out
    key = store_key(src, out)
    data = store.load(key)
    if data is None and store.acquire_build_lock(key):
        try:
            data = store.load(key)  # a builder may have finished in between
            if data is None:
                store.log_compile(key, _compile(src, out))
                store.store(key, out.read_bytes())
                return out
        finally:
            store.release_build_lock(key)
    if data is None:
        data = store.wait_for(key)
    if data is None:  # the builder died or the wait timed out: build here
        store.log_compile(key, _compile(src, out))
        return out
    _materialise(src, out, data)
    return out


def build_all(items: List[Union[str, Path]]) -> None:
    """Build several sources at once, one ``nvcc`` each, all in parallel."""
    errors: List[BaseException] = []

    def one(item: Union[str, Path]) -> None:
        try:
            build(item)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in items]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def load(name: str, declare: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use);
    ``declare(lib)`` sets the functions' ctypes signatures once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            if declare is not None:
                declare(lib)
            _LIBS[name] = lib
        return lib


@contextlib.contextmanager
def substitute(name: str, src: Path, declare: Callable[[ctypes.CDLL], None]):
    """Inside the block, ``load(name)`` returns the library built from the
    source file ``src`` instead of ``csrc/<name>.cu``: a mutation check runs
    a deliberately broken copy of a kernel through the same wrapper and
    checks that should catch it."""
    lib = ctypes.CDLL(str(build(src)))
    declare(lib)
    with _LOCK:
        old = _LIBS.get(name)
        _LIBS[name] = lib
    try:
        yield lib
    finally:
        with _LOCK:
            if old is None:
                _LIBS.pop(name, None)
            else:
                _LIBS[name] = old
