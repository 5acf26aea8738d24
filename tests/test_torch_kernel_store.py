"""The port's kernel store against the JAX package's, and ``_build``'s
builds through it, run on the CPU.

The store cases of ``tests/test_compile_cache.py`` run on both packages'
stores (the same layout, lock rules and log).  ``_build.build`` goes through
a store with a stub compiler standing in for ``nvcc`` (a script that logs
each compile and writes its output after a pause): two processes with empty
build directories race for one source and exactly one compiles — one line
in the stub's log and one ``compiles.log`` event — while the other loads
the library from the store; a third process with the same store compiles
nothing.  The fingerprint initialises no CUDA on a host without a card.
"""
import json
import multiprocessing
import os
import stat
import sys
import time
import warnings

import pytest
import torch

from repro.core import kernel_store as RKS
from repro_torch.core import kernel_store as TKS
from repro_torch.core import make_backend
from repro_torch.kernels import _build

STORES = pytest.mark.parametrize("ks", [RKS, TKS], ids=["jax", "port"])


# ---------------------------------------------------------------------------
# the store's own rules, in both packages
# ---------------------------------------------------------------------------


@STORES
def test_store_roundtrip_and_counters(ks, tmp_path):
    store = ks.PersistentKernelStore(str(tmp_path), {"v": 1})
    key = ("k", 1)
    assert store.load(key) is None and store.misses == 1
    assert store.store(key, b"payload" * 100)
    assert store.contains(key)
    assert store.load(key) == b"payload" * 100
    assert store.hits == 1 and store.bytes_written > 0
    assert store.stats()["artifacts"] == 1


@STORES
def test_store_build_lock_excludes_and_releases(ks, tmp_path):
    a = ks.PersistentKernelStore(str(tmp_path), {"v": 1})
    b = ks.PersistentKernelStore(str(tmp_path), {"v": 1})
    key = ("k", 1)
    assert a.acquire_build_lock(key)
    assert not b.acquire_build_lock(key)  # held by a
    a.store(key, b"artifact")
    a.release_build_lock(key)
    assert b.wait_for(key) == b"artifact"  # waiter sees the artifact
    assert b.acquire_build_lock(key)  # and the lock is free again
    b.release_build_lock(key)


@STORES
def test_store_stale_lock_ages_out(ks, tmp_path):
    a = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=0.0,
                                 skew_tolerance_s=0.0)
    key = ("k", 1)
    assert a.acquire_build_lock(key)
    b = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=0.0,
                                 skew_tolerance_s=0.0)
    assert b.acquire_build_lock(key)  # a crashed builder's lock is stolen


@STORES
def test_stale_lock_ages_on_owner_timestamp_not_mtime(ks, tmp_path):
    a = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=1.0,
                                 skew_tolerance_s=0.5)
    key = ("k", 1)
    assert a.acquire_build_lock(key)
    a._lock(key).write_text(json.dumps({"pid": 1, "t": time.time() - 100.0}))
    b = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=1.0,
                                 skew_tolerance_s=0.5)
    assert b.acquire_build_lock(key)
    b.release_build_lock(key)


@STORES
def test_live_lock_with_skewed_mtime_is_not_stolen(ks, tmp_path):
    a = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=1.0,
                                 skew_tolerance_s=0.5)
    key = ("k", 1)
    assert a.acquire_build_lock(key)
    old = time.time() - 10_000.0
    os.utime(a._lock(key), (old, old))
    b = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=1.0,
                                 skew_tolerance_s=0.5)
    assert not b.acquire_build_lock(key)
    a.release_build_lock(key)


@STORES
def test_forward_dated_lock_holds(ks, tmp_path):
    a = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=0.0,
                                 skew_tolerance_s=0.0)
    key = ("k", 1)
    assert a.acquire_build_lock(key)
    a._lock(key).write_text(json.dumps({"pid": 1, "t": time.time() + 1000.0}))
    old = time.time() - 10_000.0
    os.utime(a._lock(key), (old, old))  # mtime alone would say "steal it"
    b = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=0.0,
                                 skew_tolerance_s=0.0)
    assert not b.acquire_build_lock(key)


@STORES
def test_torn_lock_contents_fall_back_to_mtime(ks, tmp_path):
    a = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=1.0,
                                 skew_tolerance_s=0.5)
    key = ("k", 1)
    assert a.acquire_build_lock(key)
    a._lock(key).write_text("")  # torn write from a crashing builder
    old = time.time() - 100.0
    os.utime(a._lock(key), (old, old))
    b = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, stale_lock_s=1.0,
                                 skew_tolerance_s=0.5)
    assert b.acquire_build_lock(key)  # mtime age 100 > 1.5: stolen


@STORES
def test_store_wait_timeout_returns_none(ks, tmp_path):
    a = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, wait_timeout_s=0.1,
                                 poll_s=0.01)
    key = ("k", 1)
    assert a.acquire_build_lock(key)  # never builds, never releases
    b = ks.PersistentKernelStore(str(tmp_path), {"v": 1}, wait_timeout_s=0.1,
                                 poll_s=0.01)
    assert b.wait_for(key) is None  # times out -> caller builds locally
    assert b.wait_timeouts == 1


@STORES
def test_store_corrupt_artifact_dropped(ks, tmp_path):
    store = ks.PersistentKernelStore(str(tmp_path), {"v": 1})
    key = ("k", 1)
    store.store(key, b"good")
    store._artifact(key).write_bytes(b"\x00not-zlib")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert store.load(key) is None
    assert store.load_errors == 1
    assert not store.contains(key)  # dropped so the next builder replaces it


@STORES
def test_store_degrades_when_root_is_a_file(ks, tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("file where the cache dir should be")
    with pytest.warns(UserWarning, match="persistent kernel store at"):
        store = ks.PersistentKernelStore(str(blocker), {"v": 1})
    assert store.disabled
    assert store.load(("k",)) is None
    assert not store.store(("k",), b"x")
    assert store.acquire_build_lock(("k",))  # degraded = build locally
    assert ks.open_store(str(blocker), {"v": 1}) is None
    assert ks.open_store(None, {"v": 1}) is None


@STORES
def test_compile_log_counts_fleet_builds(ks, tmp_path):
    store = ks.PersistentKernelStore(str(tmp_path), {"v": 1})
    store.log_compile(("a",), 1.5)
    store.log_compile(("b",), 0.5)
    events = store.compile_events()
    assert len(events) == 2
    assert {e["key"] for e in events} == {ks.key_digest(("a",)), ks.key_digest(("b",))}
    assert store.stats()["fleet_compiles"] == 2


def test_digests_and_layout_are_the_reference_s(tmp_path):
    key = ("cuda-library", "matmul", "0123456789abcdef")
    fp = {"torch": "2.x", "capability": "sm_90"}
    assert TKS.key_digest(key) == RKS.key_digest(key)
    assert TKS.fingerprint_digest(fp) == RKS.fingerprint_digest(fp)
    TKS.PersistentKernelStore(str(tmp_path), fp).store(key, b"library bytes")
    # an artifact the port wrote reads back through the reference's store
    assert RKS.PersistentKernelStore(str(tmp_path), fp).load(key) == b"library bytes"


# ---------------------------------------------------------------------------
# _build through the store, with a stub compiler
# ---------------------------------------------------------------------------

STUB = """#!{python}
import sys, time
args = sys.argv[1:]
if args == ["--version"]:
    print("stub nvcc: Cuda compilation tools, release 0.0")
    sys.exit(0)
out = args[args.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(1.0)  # long enough for a second process to find the lock taken
with open(out, "wb") as f:
    f.write(b"library of " + args[-1].encode())
"""


def _stub_compiler(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "stub_compiles.log"
    stub = bindir / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return bindir, log


def _build_in_child(build_dir, cache_dir, src, bindir, out_q):
    os.environ["PATH"] = f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}"
    os.environ[_build.BUILD_DIR_ENV] = build_dir
    _build._STORE = None
    _build._NVCC_VERSION.clear()
    _build.BUILD_INFO.clear()
    try:
        _build.open_library_store(cache_dir)
        path = _build.build(src)
        out_q.put(("ok", _build.BUILD_INFO[src.stem]["source"], str(path),
                   path.read_bytes()))
    except BaseException as e:  # noqa: BLE001 — reported to the test
        out_q.put(("err", repr(e), "", b""))


def _run(ctx, args_list):
    q = ctx.Queue()
    procs = [ctx.Process(target=_build_in_child, args=(*args, q)) for args in args_list]
    for p in procs:
        p.start()
    got = [q.get(timeout=60) for _ in procs]
    for p in procs:
        p.join(timeout=30)
    return got


def test_build_through_the_store_compiles_once_across_processes(tmp_path):
    bindir, log = _stub_compiler(tmp_path)
    src = tmp_path / "kern.cu"
    src.write_text("// a kernel source with no includes\n")
    cache = str(tmp_path / "store")
    ctx = multiprocessing.get_context("fork")
    racing = _run(ctx, [(str(tmp_path / f"b{i}"), cache, src, bindir) for i in (1, 2)])
    assert all(r[0] == "ok" for r in racing), racing
    assert sorted(r[1] for r in racing) == ["nvcc", "store"]
    assert racing[0][3] == racing[1][3] == b"library of " + str(src).encode()
    assert len(log.read_text().splitlines()) == 1  # one compile, two processes
    # a third process with the same store and an empty build dir compiles nothing
    (fresh,) = _run(ctx, [(str(tmp_path / "b3"), cache, src, bindir)])
    assert fresh[:2] == ("ok", "store") and fresh[3] == racing[0][3]
    assert len(log.read_text().splitlines()) == 1
    store_dirs = [d for d in (tmp_path / "store").iterdir() if d.is_dir()]
    (events_dir,) = store_dirs
    events = [json.loads(ln) for ln in (events_dir / "compiles.log").read_text().splitlines()]
    assert len(events) == 1
    fp = json.loads((events_dir / "fingerprint.json").read_text())
    assert fp["nvcc"].startswith("stub nvcc") and fp["capability"] == "none"


def test_build_without_a_store_is_local(tmp_path, monkeypatch):
    bindir, log = _stub_compiler(tmp_path)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "b"))
    monkeypatch.setattr(_build, "_STORE", None)
    src = tmp_path / "solo.cu"
    src.write_text("// solo\n")
    path = _build.build(src)
    assert path.parent == tmp_path / "b" and _build.BUILD_INFO["solo"]["source"] == "nvcc"
    assert _build.build(src) == path  # found in the build dir: no second compile
    assert len(log.read_text().splitlines()) == 1


def test_fingerprint_initialises_no_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    fp = _build.fingerprint()
    assert fp["capability"] == "none" and fp["torch"] == torch.__version__
    assert not torch.cuda.is_initialized()


def test_card_executor_opens_the_store_and_others_tolerate_it(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_STORE", None)
    be = make_backend("torch", device="cpu", cache_dir=str(tmp_path / "k"))
    assert be.store is not None and _build._STORE is be.store
    assert be.compile_stats()["store"]["fleet_compiles"] == 0
    assert be.pool_spec()[1]["cache_dir"] == str(tmp_path / "k")
    for spec in ("tpu", "numpy"):
        make_backend(spec, cache_dir=str(tmp_path / spec))
        assert not (tmp_path / spec).exists()
