"""The port's roofline analysis against the JAX package's, on the CPU.

``model_flops`` is pure Python in both packages: equal for every
architecture and shape cell.  The terms of the reference's test record
(``tests/test_analysis.py``) under the H100 constants, the table's format,
and a skipped record.
"""
import json

import pytest

from repro.analysis import roofline as RR
from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro_torch.analysis import roofline as TR
from repro_torch.configs import ARCHS, SHAPES, get_config

RECORD = {
    "status": "ok", "arch": "phi3-mini-3.8b", "shape": "train_4k",
    "mesh": "single", "mesh_shape": {"data": 16, "model": 16},
    "cost_analysis": {"flops": 1e12, "bytes accessed": 1e11},
    "collective_bytes": {"all-reduce": 1e9},
    "corrected": {"flops": 9e13, "mem_bytes": 2e12, "coll_bytes_total": 5e10},
    "memory_analysis": {"argument_size_in_bytes": 2 << 30, "temp_size_in_bytes": 6 << 30},
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_the_reference(arch, shape):
    assert TR.model_flops(get_config(arch), SHAPES[shape]) == \
        RR.model_flops(r_get_config(arch), R_SHAPES[shape])
    cfg = get_config(arch)
    assert TR._matmul_params(cfg) == RR._matmul_params(r_get_config(arch))


def test_h100_constants():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert 79 < TR.HBM_GIB < 80  # an H100 80GB's device memory, in GiB


def test_roofline_from_record_terms():
    t = TR.roofline_from_record(RECORD)
    assert t.chips == 256
    assert t.t_compute == pytest.approx(9e13 / 989e12)
    assert t.t_memory == pytest.approx(2e12 / 3.35e12)
    assert t.t_collective == pytest.approx(5e10 / 450e9)
    assert t.dominant == "memory"
    assert t.fits_hbm and 7.9 < t.hbm_gib < 8.1
    assert not TR.roofline_from_record(RECORD, card_gib=4.0).fits_hbm
    assert t.model_flops_global == RR.roofline_from_record(RECORD).model_flops_global
    per_dev = t.model_flops_global / 256
    assert t.useful_ratio == pytest.approx(per_dev / 9e13)
    assert t.roofline_fraction == pytest.approx(per_dev / (989e12 * t.t_step))
    assert 0 < t.roofline_fraction < 1


def test_table_format(tmp_path):
    (tmp_path / "phi3__train_4k__single.json").write_text(json.dumps(RECORD))
    (tmp_path / "phi3__decode__single.json").write_text(json.dumps({"status": "skipped"}))
    (tmp_path / "phi3__train_4k__multi.json").write_text(json.dumps(RECORD))
    rows = TR.load_all(str(tmp_path))
    assert len(rows) == 1 and rows[0].arch == "phi3-mini-3.8b"
    table = TR.roofline_table(str(tmp_path)).splitlines()
    assert table[0] == ("| arch | shape | compute s | memory s | collective s | dominant "
                        "| t_step s | useful | roofline | HBM GiB |")
    assert len(table) == 3 and "**memory**" in table[2]
    # the same layout as the reference's table
    assert RR.roofline_table(str(tmp_path)).splitlines()[:2] == table[:2]


def test_skipped_record_returns_none():
    assert TR.roofline_from_record({"status": "skipped"}) is None
