"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the
repository root (a directory ``.gitignore`` lists).  ``<hash>`` covers the
source, every header it includes from ``csrc/`` (``#include "..."``,
followed through headers), and the flags, so an edited source or header
rebuilds and an unchanged one loads the library already built.  Nothing
here runs at import time: the CPU tests import every module on hosts with
no ``nvcc``.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: per source: {"seconds": build time (0.0 when loaded from build/), "log": ptxas output}
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


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
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(item: Union[str, Path]) -> Path:
    """Compile ``csrc/<item>.cu`` (or the source file ``item``) unless the
    library for this source and these flags exists; returns its path.
    ``BUILD_INFO`` is keyed by the source's stem."""
    src = _source(item)
    out = _lib_path(src)
    if out.exists():
        BUILD_INFO.setdefault(src.stem, {"seconds": 0.0, "log": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process loads a whole file
    BUILD_INFO[src.stem] = {"seconds": time.perf_counter() - t0,
                            "log": proc.stderr}
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
