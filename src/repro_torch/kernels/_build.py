"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the
repository root (a directory ``.gitignore`` lists).  ``<hash>`` covers the
source and the flags, so an edited source rebuilds and an unchanged one
loads the library already built.  Nothing here runs at import time: the CPU
tests import every module on hosts with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

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


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this source and
    these flags exists; returns its path."""
    out = _lib_path(name)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process loads a whole file
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stderr}
    return out


def build_all(names: List[str]) -> None:
    """Build several sources at once, one ``nvcc`` each, all in parallel."""
    errors: List[BaseException] = []

    def one(n: str) -> None:
        try:
            build(n)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
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
