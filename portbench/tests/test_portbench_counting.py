"""The yardstick's arithmetic against hand counts, and its dense sites
against the program's own harvest."""
import pytest

from tiny import TINY_MODEL
from yardstick import counting as N
from yardstick import trace as TR


def test_union_and_covered():
    u = TR.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 10.5)])
    assert u == [(0, 3), (5, 9), (10, 10.5)]
    assert TR.covered(u) == pytest.approx(7.5)


def test_summarize_busy_idle_and_gaps():
    ev = [{"ph": "X", "cat": "kernel", "name": "void tc_matmul<128>", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "flash_fwd_ws<96>", "ts": 25, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60, "dur": 5},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.prefill", "ts": 0, "dur": 50},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 45, "dur": 4}]
    s = TR.summarize(ev, (0.0, 100.0))
    assert s.busy_s == pytest.approx(30e-6) and s.window_s == pytest.approx(100e-6)
    assert s.idle_share == pytest.approx(0.7)
    assert s.by_class_s["tiled_matmul"] == pytest.approx(20e-6)
    assert s.by_class_s["flash_fwd"] == pytest.approx(10e-6)
    assert s.idle_gaps[0] == ["no harness span", pytest.approx(35e-6)]
    assert s.idle_gaps[1] == ["portbench.prefill/aten::mul", pytest.approx(25e-6)]


def test_no_device_rows_is_an_error():
    with pytest.raises(TR.NoDeviceRows):
        TR.summarize([{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5}],
                     (0.0, 10.0))


def test_matmul_bound():
    assert N.matmul_flops(2, 3, 4) == 48
    assert N.matmul_bytes(2, 3, 4, "bfloat16", "float32") == (6 + 12) * 2 + 8 * 4
    # a large square product is bound by its operations, a thin one by its bytes
    big = N.bound_s(N.matmul_flops(8192, 8192, 8192),
                    N.matmul_bytes(8192, 8192, 8192, "bfloat16", "bfloat16"))
    assert big == pytest.approx(2 * 8192 ** 3 / 989e12)
    thin = N.bound_s(N.matmul_flops(8, 8192, 8192),
                     N.matmul_bytes(8, 8192, 8192, "bfloat16", "bfloat16"))
    assert thin == pytest.approx((8 * 8192 * 2 + 8192 * 8192 * 2 + 8 * 8192 * 2) / 3.35e12)


def test_flash_work_by_hand():
    f, b = N.flash_fwd_work(2, 4, 3, 1, 8)
    assert f == 4 * (4 * 5 / 2) * 8 * 3 * 2
    assert b == 2 * 4 * 8 * (2 * 3 + 2 * 1) * 2
    fb, bb = N.flash_bwd_work(2, 4, 3, 1, 8)
    assert fb == 2 * f
    assert bb == 4 * (2 * 4 * 3 * 8 * 2) + 4 * (2 * 4 * 1 * 8 * 2) + 2 * 3 * 4 * 4


def test_model_flops_by_hand():
    m = dict(TINY_MODEL)   # 2 layers, d 64, 4 heads of 16, d_ff 96, vocab 128
    per_layer = 4 * 64 * 64 + 3 * 64 * 96
    tokens = 3 * 10
    fwd = 2 * 2 * per_layer * tokens + 2 * 64 * 128 * tokens + 3 * 2 * 4 * (100 / 2) * 4 * 16
    assert N.model_flops(m, 3, 10, "prefill") == pytest.approx(fwd)
    assert N.model_flops(m, 3, 10, "train") == pytest.approx(3 * fwd)


@pytest.mark.parametrize("frontend,act", [("embeds", "gelu"), ("tokens", "silu")])
def test_dense_sites_match_the_programs_harvest(frontend, act):
    """The benchmark's own list of dense sites is what the program's
    ``harvest_model`` records at a prefill of the same shape."""
    from repro_torch.launch.tune import harvest_model
    from yardstick import port

    model = dict(TINY_MODEL, frontend=frontend, act=act)
    recs = harvest_model(port.model_config(model), batch=2, prompt_len=8, max_len=12,
                         kinds=("prefill",), device="cpu")
    got = {(r["m"], r["k"], r["n"], r["dtype"]): r["count"] for r in recs}
    assert got == N.dense_keys(model, 16)
