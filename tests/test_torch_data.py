"""The port's data pipeline against the JAX package's: both are pure NumPy,
so every batch must be equal, byte for byte (same dtypes, same values), for
both dataset kinds, every frontend (tokens, embeds, with encoder states),
and each host's shard."""
import numpy as np
import pytest

from repro.configs import get_config as r_get_config
from repro.data import pipeline as RP
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TP

ARCHS = ["phi3-mini-3.8b", "musicgen-large", "llama-3.2-vision-11b"]  # tokens, embeds, encoder


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["markov", "uniform"])
def test_batches_equal(arch, kind):
    r_cfg, t_cfg = r_get_config(arch).smoke(), get_config(arch).smoke()
    r = RP.make_dataset(r_cfg, None, seed=3, kind=kind, global_batch=4, seq_len=16)
    t = TP.make_dataset(t_cfg, None, seed=3, kind=kind, global_batch=4, seq_len=16)
    assert type(r).__name__ == type(t).__name__
    for step in (0, 1, 7):
        _equal(r.batch(step), t.batch(step))


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_host_shards_equal(n_hosts):
    r_cfg, t_cfg = r_get_config("olmoe-1b-7b").smoke(), get_config("olmoe-1b-7b").smoke()
    shards = []
    for host in range(n_hosts):
        r = RP.make_dataset(r_cfg, None, seed=5, host_id=host, n_hosts=n_hosts,
                            global_batch=8, seq_len=12)
        t = TP.make_dataset(t_cfg, None, seed=5, host_id=host, n_hosts=n_hosts,
                            global_batch=8, seq_len=12)
        assert t.host_batch == 8 // n_hosts
        rb, tb = r.batch(2), t.batch(2)
        _equal(rb, tb)
        shards.append(tb["tokens"])
    assert len({s.tobytes() for s in shards}) == n_hosts  # each host its own shard
