"""The port's training launcher under a process group on the CPU.

``torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh auto``
(``gloo``, mesh (2, 1)) trains olmoe-1b-7b's smoke config with its loss
falling and checkpoints; the port's launcher at one rank resumes from the
two ranks' checkpoint, ``repro.launch.train`` from the port's, and two
ranks again from the JAX package's;
``--mesh single|multi`` refuse a world that is not 256 or 512 ranks, naming
it; ``launch.mesh.make_mesh`` refuses a process group of another size.
"""
import json
import os
import re
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro.launch import train as RTRAIN
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train as TTRAIN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


ARGS = ["--arch", "olmoe-1b-7b", "--batch", "4", "--seq", "32", "--save-every", "2",
        "--log-every", "2", "--lr", "3e-3"]


def _summary(out: str) -> dict:
    m = re.search(r"\[train\] done: (\{.*\})", out)
    assert m, out[-2000:]
    return json.loads(m.group(1))


def _torchrun(tmp_path, steps):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.train", *ARGS, "--device", "cpu", "--mesh", "auto",
         "--steps", str(steps), "--ckpt-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, _summary(proc.stdout)


def test_torchrun_two_ranks_train_and_resume_across_world_sizes_and_packages(tmp_path, capsys):
    out, summary = _torchrun(tmp_path, 8)
    assert "[train] mesh {'data': 2, 'model': 1}" in out
    assert out.count("[train] done") == 1  # rank 0 reports
    assert summary["steps"] == 8 and summary["loss_last"] < summary["loss_first"]
    # the 2 ranks' checkpoint at 1 rank, in the port and in the JAX package,
    # whose checkpoint the 2 ranks then resume from
    assert TTRAIN.main(ARGS + ["--device", "cpu", "--steps", "10", "--ckpt-dir",
                               str(tmp_path)]) == 0
    assert RTRAIN.main(ARGS + ["--steps", "12", "--ckpt-dir", str(tmp_path)]) == 0
    out1 = capsys.readouterr().out
    assert "resumed from step 8" in out1 and "resumed from step 10" in out1
    out, summary = _torchrun(tmp_path, 14)
    assert "resumed from step 12" in out and summary["steps"] == 14


@pytest.mark.parametrize("mesh,size", [("single", 256), ("multi", 512)])
def test_production_meshes_need_their_world(mesh, size):
    assert TTRAIN.mesh_layout(mesh, size)[0] in (MESH.PRODUCTION_SINGLE[0],
                                                 MESH.PRODUCTION_MULTI[0])
    with pytest.raises(ValueError, match=f"{size} ranks; the world size is 2"):
        TTRAIN.mesh_layout(mesh, 2)
    assert TTRAIN.mesh_layout("auto", 2) == ((2, 1), ("data", "model"))


def test_make_mesh_refuses_another_world(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none is initialised"):
        MESH.make_mesh((2, 2), ("data", "model"), "cpu")
    MESH.init_process_group("cpu", store_path=str(tmp_path / "store"))
    try:
        with pytest.raises(ValueError, match="needs 4 ranks; the process group has world size 1"):
            MESH.make_mesh((2, 2), ("data", "model"), "cpu")
        mesh = MESH.make_mesh((1, 1), ("data", "model"), "cpu")
        assert mesh.mesh_dim_names == ("data", "model")
    finally:
        dist.destroy_process_group()
