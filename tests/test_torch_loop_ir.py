"""Parity of the port's loop-nest IR and actions with the JAX package's.

Seeded random action traces run on both packages' nests side by side; the
structure keys, legal masks and ``from_structure_key`` round-trips must be
equal (registry keys and farm wire dicts depend on them byte for byte).
"""
import numpy as np
import pytest

from repro.core import actions as RA
from repro.core import dataset as RD
from repro.core import loop_ir as RL
from repro_torch.core import actions as TA
from repro_torch.core import dataset as TD
from repro_torch.core import loop_ir as TL

N_MATMUL = 200
CHUNKS = 8


def _benches():
    rng = np.random.default_rng(0)
    mm = RD.matmul_dataset()
    idx = sorted(rng.choice(len(mm), size=N_MATMUL, replace=False))
    return [(i, mm[i]) for i in idx] + [
        (len(mm) + j, c) for j, c in enumerate(RD.mixed_ops_dataset())]


def _port_contraction(i):
    mm = TD.matmul_dataset()
    return mm[i] if i < len(mm) else TD.mixed_ops_dataset()[i - len(mm)]


def _trace(r_bench, t_bench, seed, splits, steps=12):
    rng = np.random.default_rng(seed)
    r_acts = RA.build_action_space(splits)
    t_acts = TA.build_action_space(splits)
    assert [a.name for a in r_acts] == [a.name for a in t_acts]
    rn, tn = RL.LoopNest(r_bench), TL.LoopNest(t_bench)
    for _ in range(steps):
        r_mask = RA.legal_mask(rn, r_acts)
        assert r_mask == TA.legal_mask(tn, t_acts)
        ai = int(rng.integers(len(r_acts)))
        assert RA.apply_action(rn, r_acts[ai]) == TA.apply_action(tn, t_acts[ai])
        assert rn.key() == tn.key()
    return rn, tn


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_random_traces_match(chunk):
    benches = _benches()
    for j, (i, rb) in enumerate(benches):
        if j % CHUNKS != chunk:
            continue
        tb = _port_contraction(i)
        assert repr(tb) == repr(rb)
        splits = TA.TPU_SPLITS if j % 2 else TA.CPU_SPLITS
        rn, tn = _trace(rb, tb, seed=1000 + j, splits=splits)
        key = tn.structure_key()
        assert key == rn.structure_key()
        assert repr(key) == repr(rn.structure_key())
        # round-trips across packages in both directions
        assert TL.LoopNest.from_structure_key(tb, rn.structure_key()).key() \
            == RL.LoopNest.from_structure_key(rb, key).key()
        assert repr(tn) == repr(rn)


def test_dataset_matches():
    # the dataclasses are distinct types per package: compare their reprs
    assert repr(TD.matmul_dataset()) == repr(RD.matmul_dataset())
    assert repr(TD.mixed_ops_dataset()) == repr(RD.mixed_ops_dataset())
    assert [c.name for c in TD.small_dataset(16, 3)] == \
        [c.name for c in RD.small_dataset(16, 3)]
    tr, te = TD.train_test_split(TD.matmul_dataset())
    rtr, rte = RD.train_test_split(RD.matmul_dataset())
    assert [c.name for c in tr] == [c.name for c in rtr]
    assert [c.name for c in te] == [c.name for c in rte]
