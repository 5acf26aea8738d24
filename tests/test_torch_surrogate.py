"""The learned surrogate, in both packages on the same inputs: the same fit
on the same data (the initial weights carried across, the same numpy
generator for the minibatches), and a surrogate-guided greedy search on
the analytical backend that must prune the same frontiers.

Predictions are held at two tolerances.  A short fit (10 Adam steps in
f32) stays within 3e-5 relative: XLA and torch sum each step's gradients
in other orders, about 1e-6 a step (5.8e-6 read).  The full fit (150
steps, then a warm 50-step refit) is held at 2e-3 relative (1.1e-3 read):
Adam normalises each gradient entry by its own magnitude, so where an
entry sits at rounding level (1e-8) the two packages can step that weight
by lr = 1e-2 in opposite directions, and the fits settle ~1e-3 apart in
GFLOPS (1e-4 of the log1p targets, which predictions exponentiate).  The
search test below shows that this moves no ranking the search acts on.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import search as RS
from repro.core import surrogate as RSUR
from repro.core.env import LoopTuneEnv as REnv
from repro.core.loop_ir import matmul_benchmark as r_mm
from repro_torch.core import search as TS
from repro_torch.core import surrogate as TSUR
from repro_torch.core.env import LoopTuneEnv as TEnv
from repro_torch.core.loop_ir import matmul_benchmark as t_mm
from repro_torch.core.networks import params_from_numpy
from repro_torch.core.tuner import LoopTuner as TTuner

SHORT_FIT_RTOL = 3e-5
FIT_RTOL = 2e-3
SHAPES = [(128, 64, 96), (64, 128, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny networks: test workers share the
    host's cores, and torch's thread pool thrashes under that (a short
    graph DQN run took 168 s with three workers, 1.3 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed=0, **kw):
    """The two packages' models with the JAX model's initial weights."""
    r = RSUR.SurrogateModel(seed=seed, **kw)
    t = TSUR.SurrogateModel(seed=seed, device="cpu", **kw)
    t.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, r.params)))
    return r, t


def _dataset(n_steps=40):
    """Nests and analytical GFLOPS of the same random walks in both
    packages' envs: ``(jax nests, port nests, gflops)``."""
    r_env = REnv([r_mm(*s) for s in SHAPES], "tpu")
    t_env = TEnv([t_mm(*s) for s in SHAPES], "tpu")
    rng = np.random.default_rng(0)
    r_nests, t_nests, gs = [], [], []
    for bi in range(len(SHAPES)):
        r_env.reset(bi)
        t_env.reset(bi)
        for _ in range(n_steps):
            a = int(rng.choice(np.flatnonzero(r_env.action_mask())))
            _, _, done, info = r_env.step(a)
            t_env.step(a)
            r_nests.append(r_env.nest.clone())
            t_nests.append(t_env.nest.clone())
            gs.append(info["gflops"])
            if done:
                r_env.reset(bi)
                t_env.reset(bi)
    return r_nests, t_nests, gs


def test_same_fit_same_predictions():
    nests, tn, gs = _dataset()
    r, t = _models()
    rds, tds = RSUR.SurrogateDataset(r.featurizer), TSUR.SurrogateDataset(t.featurizer)
    assert rds.add_batch(nests, gs) == tds.add_batch(tn, gs) > 20
    np.testing.assert_array_equal(tds.arrays()[0], rds.arrays()[0])
    # a short fit, a full one and a warm-started refit, each continuing
    for steps, rtol in ((10, SHORT_FIT_RTOL), (140, FIT_RTOL), (50, FIT_RTOL)):
        r.fit(rds, steps=steps)
        t.fit(tds, steps=steps)
        assert (t._mu, t._sigma, t.n_fits) == (r._mu, r._sigma, r.n_fits)
        np.testing.assert_allclose(t.predict(tn), r.predict(nests), rtol=rtol)
    ranks = np.argsort(-r.predict(nests))
    np.testing.assert_array_equal(np.argsort(-t.predict(tn))[:5], ranks[:5])


def test_fit_on_empty_and_singleton_datasets():
    _, t = _models()
    ds = TSUR.SurrogateDataset(t.featurizer)
    t.fit(ds)
    assert not t.fitted
    _, nests, gs = _dataset(2)
    ds.add(nests[0], gs[0])
    t.fit(ds, steps=3)
    assert t.fitted and np.isfinite(t.predict(nests[:1])).all()


@pytest.mark.parametrize("search", ["greedy2", "beam4dfs"])
def test_surrogate_guided_search_prunes_the_same_frontiers(search):
    r_model, t_model = _models()
    kw = dict(min_fit=8, refit_every=16, fit_steps=40)
    r_sc, t_sc = RSUR.SurrogateScorer(r_model, **kw), TSUR.SurrogateScorer(t_model, **kw)
    r_env, t_env = REnv([r_mm(*SHAPES[0])], "tpu"), TEnv([t_mm(*SHAPES[0])], "tpu")
    rr = RS.SEARCHES[search](r_env, 0, budget_s=600.0, max_evals=120, surrogate=r_sc)
    tr = TS.SEARCHES[search](t_env, 0, budget_s=600.0, max_evals=120, surrogate=t_sc)
    assert rr.surrogate_stats["skipped"] > 0
    assert tr.surrogate_stats == rr.surrogate_stats
    assert (tr.actions, tr.n_evals, tr.best_gflops) == (rr.actions, rr.n_evals, rr.best_gflops)
    assert (tr.cache_hits, tr.cache_misses) == (rr.cache_hits, rr.cache_misses)


def test_searches_and_tuner_take_auto():
    env = TEnv([t_mm(*SHAPES[0])], "tpu")
    sc = TSUR.SurrogateScorer.for_env(env, device="cpu", min_fit=8)
    for name, fn in TS.SEARCHES.items():
        env.clear_cache()
        # random search ends on the clock once every state it draws is cached
        res = fn(env, 0, budget_s=0.5, max_evals=40, surrogate=sc)
        assert res.surrogate_stats is not None and res.best_gflops >= res.base_gflops, name
    assert TS.make_surrogate("off", env) is None and TS.make_surrogate(sc, env) is sc
    tuner = TTuner(backend="tpu", surrogate="auto", device="cpu")
    tuner.tune_many([t_mm(*s) for s in SHAPES], weights=[1, 1], budget_s=600.0,
                    eval_budget=160)
    st = tuner.stats()
    assert st["surrogate"]["mode"] == "auto" and st["surrogate"]["dataset_size"] > 8
    assert st["calibration"] == {"mode": "live"}
