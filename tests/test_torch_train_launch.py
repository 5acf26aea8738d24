"""The port's training launcher on the CPU (``--device cpu``): the JAX
package's launcher cases (tests/test_launchers.py) run in process: olmoe's
smoke config surviving an injected failure and resuming from its
checkpoint, phi3-mini's with int8 gradient compression; the production
meshes refused; and a checkpoint directory handed from one package's
launcher to the other's, both ways."""
import json
import re

import pytest
import torch

from repro.launch import train as RTRAIN
from repro_torch.launch import train as TTRAIN


def _summary(out: str) -> dict:
    m = re.search(r"\[train\] done: (\{.*\})", out)
    assert m, out[-2000:]
    return json.loads(m.group(1))


def test_failure_and_resume(tmp_path, capsys):
    args = ["--arch", "olmoe-1b-7b", "--batch", "2", "--seq", "32", "--ckpt-dir",
            str(tmp_path), "--save-every", "8", "--device", "cpu"]
    assert TTRAIN.main(args + ["--steps", "24", "--fail-at", "13", "--log-every", "8"]) == 0
    summary = _summary(capsys.readouterr().out)
    assert summary["steps"] == 24 and summary["restarts"] == 1
    assert summary["loss_last"] < summary["loss_first"]
    assert TTRAIN.main(args + ["--steps", "28"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 24" in out and _summary(out)["steps"] == 28


def test_grad_compression(tmp_path, capsys):
    assert TTRAIN.main(["--arch", "phi3-mini-3.8b", "--steps", "10", "--batch", "2", "--seq",
                        "32", "--ckpt-dir", str(tmp_path), "--compress-grads", "--log-every",
                        "5", "--device", "cpu"]) == 0
    summary = _summary(capsys.readouterr().out)
    assert summary["loss_last"] < summary["loss_first"]
    assert set(summary) == {"arch", "steps", "wall_s", "loss_first", "loss_last", "restarts",
                            "straggler_events", "tokens_per_s"}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_production_meshes_refused(tmp_path, mesh):
    with pytest.raises(NotImplementedError, match="A5"):
        TTRAIN.main(["--arch", "phi3-mini-3.8b", "--mesh", mesh, "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)])


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device trains on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTRAIN.main(["--arch", "phi3-mini-3.8b", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoints_cross_packages(tmp_path, capsys, first):
    args = ["--arch", "musicgen-large", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path), "--save-every", "2"]
    launchers = {"jax": (RTRAIN.main, []), "port": (TTRAIN.main, ["--device", "cpu"])}
    second = "port" if first == "jax" else "jax"
    main, extra = launchers[first]
    assert main(args + ["--steps", "2"] + extra) == 0
    main, extra = launchers[second]
    assert main(args + ["--steps", "4"] + extra) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and _summary(out.split("resumed")[-1])["steps"] == 4
