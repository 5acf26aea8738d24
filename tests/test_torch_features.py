"""Parity of the port's flat and packed-graph observations with the JAX
package's: equal arrays on the same nests after the same seeded traces."""
import numpy as np
import pytest

from repro.core import actions as RA
from repro.core import graph_features as RG
from repro.core import loop_ir as RL
from repro_torch.core import actions as TA
from repro_torch.core import graph_features as TG
from repro_torch.core import loop_ir as TL

BENCHES = [("matmul", (96, 64, 80)), ("matmul", (256, 64, 128)),
           ("conv2d", (64, 64, 3, 3)), ("reduction", (128, 512)),
           ("transpose", (64, 128))]


def _nests(kind, dims, seed):
    rb = getattr(RL, f"{kind}_benchmark")(*dims)
    tb = getattr(TL, f"{kind}_benchmark")(*dims)
    rn, tn = RL.LoopNest(rb), TL.LoopNest(tb)
    r_acts, t_acts = RA.build_action_space(), TA.build_action_space()
    rng = np.random.default_rng(seed)
    out = [(rn.clone(), tn.clone())]
    for _ in range(14):
        ai = int(rng.integers(len(r_acts)))
        RA.apply_action(rn, r_acts[ai])
        TA.apply_action(tn, t_acts[ai])
        out.append((rn.clone(), tn.clone()))
    return out


@pytest.mark.parametrize("kind,dims", BENCHES)
@pytest.mark.parametrize("seed", [0, 1])
def test_flat_and_graph_observations_equal(kind, dims, seed):
    r_flat, t_flat = RG.FlatFeaturizer(), TG.FlatFeaturizer()
    r_graph, t_graph = RG.GraphFeaturizer(), TG.GraphFeaturizer()
    assert t_flat.state_dim == r_flat.state_dim
    assert t_graph.state_dim == r_graph.state_dim
    for rn, tn in _nests(kind, dims, seed):
        np.testing.assert_array_equal(t_flat(tn), r_flat(rn))
        packed = t_graph(tn)
        np.testing.assert_array_equal(packed, r_graph(rn))
        tg, rg = TG.encode_graph(tn), RG.encode_graph(rn)
        np.testing.assert_array_equal(tg.adjacency(), rg.adjacency())
        np.testing.assert_array_equal(
            TG.LoopGraph.unpack(packed, TG.GRAPH_MAX_LOOPS).pack(), packed)
