"""The trainers' parts, in both packages on the same inputs: the replay
buffers (numpy: equal), one DQN and one APEX update on the same batch,
params and weights (f32: params after the step, the loss and the TD errors
at 1e-5), and short training runs on the analytical backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apex_dqn as RAPEX
from repro.core import dqn as RDQN
from repro.core import encoders as RENC
from repro.core import replay as RREP
from repro.core.env import LoopTuneEnv as REnv
from repro.core.loop_ir import matmul_benchmark as r_mm
from repro_torch.core import apex_dqn as TAPEX
from repro_torch.core import dqn as TDQN
from repro_torch.core import encoders as TENC
from repro_torch.core import replay as TREP
from repro_torch.core.env import LoopTuneEnv as TEnv
from repro_torch.core.loop_ir import matmul_benchmark as t_mm
from repro_torch.core.networks import make_adam, params_from_numpy, params_to_numpy

UPDATE_TOL = 1e-5  # f32, one step: XLA and torch sum the gradients in other orders
D, A, B = 40, 7, 32  # state width (two loops of 20 features), actions, batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny networks: test workers share the
    host's cores, and torch's thread pool thrashes under that (a short
    graph DQN run took 168 s with three workers, 1.3 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(buf, rng, n):
    for _ in range(n):
        buf.add(rng.standard_normal(D).astype(np.float32), int(rng.integers(A)),
                float(rng.standard_normal()), rng.standard_normal(D).astype(np.float32),
                bool(rng.random() < 0.2), mask2=rng.random(A) < 0.7,
                discount=0.99 ** int(rng.integers(1, 4)), noisy=bool(rng.random() < 0.1))


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_replay_buffer_samples_match():
    r, t = RREP.ReplayBuffer(64, D), TREP.ReplayBuffer(64, D)
    _fill(r, np.random.default_rng(0), 80)  # wraps the ring
    _fill(t, np.random.default_rng(0), 80)
    assert (t.size, t.pos) == (r.size, r.pos)
    for seed in range(3):
        _equal(t.sample(B, np.random.default_rng(seed)), r.sample(B, np.random.default_rng(seed)))
    np.testing.assert_array_equal(t.noisy, r.noisy)


def test_sum_tree_matches():
    r, t = RREP.SumTree(16), TREP.SumTree(16)
    rng = np.random.default_rng(1)
    for i, v in zip(rng.integers(0, 16, 40), rng.random(40)):
        r.set(int(i), float(v))
        t.set(int(i), float(v))
    np.testing.assert_array_equal(t.tree, r.tree)
    for u in rng.random(20) * r.total():
        assert t.sample(u) == r.sample(u)


def test_prioritized_replay_matches():
    r = RREP.PrioritizedReplay(64, D, beta_steps=100)
    t = TREP.PrioritizedReplay(64, D, beta_steps=100)
    _fill(r, np.random.default_rng(2), 50)
    _fill(t, np.random.default_rng(2), 50)
    rr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        (rd, rw), (td, tw) = r.sample(B, rr), t.sample(B, tr)
        _equal(td, rd)
        np.testing.assert_array_equal(tw, rw)
        err = rr.standard_normal(B)
        tr.standard_normal(B)
        r.update_priorities(rd[-1], err)
        t.update_priorities(td[-1], err)
        np.testing.assert_array_equal(t.tree.tree, r.tree.tree)
        assert t.max_priority == r.max_priority and t.beta() == r.beta()


# ---------------------------------------------------------------------------
# One learner update, both packages
# ---------------------------------------------------------------------------


def _batch(seed):
    rng = np.random.default_rng(seed)
    mask2 = rng.random((B, A)) < 0.6
    mask2[:, 0] = True
    return (rng.standard_normal((B, D)).astype(np.float32),
            rng.integers(0, A, B).astype(np.int32),
            rng.standard_normal(B).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32),
            (rng.random(B) < 0.3).astype(np.float32), mask2,
            np.full(B, 0.97, np.float32)), rng.uniform(0.3, 1.0, B).astype(np.float32)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=UPDATE_TOL, atol=UPDATE_TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("algo", ["dqn", "dqn_single", "apex"])
def test_one_update_matches(algo):
    head = "dueling" if algo == "apex" else "q"
    jcfg = (RAPEX.ApexConfig(hidden=(32, 32)) if algo == "apex"
            else RDQN.DQNConfig(hidden=(32, 32), double=algo == "dqn"))
    enc = RENC.EncoderConfig(hidden=(32, 32), max_loops=D // 20)
    rnet = RENC.build_network(head, enc, A)
    params = rnet.init(jax.random.PRNGKey(0))
    target = rnet.init(jax.random.PRNGKey(1))
    update = (RAPEX if algo == "apex" else RDQN).make_update_fn(jcfg, rnet.apply)
    opt = RDQN.adam_init(params)
    batch, w = _batch(4)
    new, _, loss, td = update(params, target, opt, tuple(map(jnp.asarray, batch)),
                              jnp.asarray(w))

    tnet = TENC.build_network(head, TENC.EncoderConfig(hidden=(32, 32), max_loops=D // 20),
                              A, "cpu")
    online, tgt = tnet.init(), tnet.init()
    online.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    tgt.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, target)))
    t_loss, t_td = TDQN.q_update(online, tgt, make_adam(online, jcfg.lr),
                                 TDQN.batch_to_device(batch, tnet.device),
                                 torch.from_numpy(w), double=algo != "dqn_single")
    _close(float(t_loss), float(loss), "loss")
    _close(t_td.numpy(), np.asarray(td), "td")
    got = params_to_numpy(online)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, new))
    for path, (g, want) in enumerate(zip(jax.tree.leaves(got), jax.tree.leaves(new))):
        _close(g, np.asarray(want), f"param leaf {path}")


# ---------------------------------------------------------------------------
# Short runs on the analytical backend
# ---------------------------------------------------------------------------

SHAPES = [(64, 64, 64), (32, 48, 16)]


def _meta_keys():
    return set(RENC.checkpoint_meta("q", RENC.EncoderConfig().resolved(), [], 0))


@pytest.mark.parametrize("encoder", ["flat", "graph"])
def test_train_dqn_runs(encoder):
    env = TEnv([t_mm(*s) for s in SHAPES], "tpu")
    res = TDQN.train_dqn(env, 3, TDQN.DQNConfig(
        hidden=(32,), encoder=TENC.EncoderConfig(kind=encoder), warmup_steps=20,
        n_envs=2, device="cpu"))
    assert len(res.rewards) == 3 and np.isfinite(res.rewards).all()
    assert res.extra["updates"] > 0
    assert set(res.meta) == _meta_keys()
    assert res.meta["head"] == "q" and res.meta["backend"] == "tpu"
    assert res.meta["encoder"]["kind"] == encoder


def test_train_apex_runs_and_matches_the_jax_meta():
    def factory(pkg_env, mm):
        return lambda i: pkg_env([mm(*s) for s in SHAPES], "tpu")

    cfg = dict(hidden=(32,), n_actors=3, warmup_steps=20)
    res = TAPEX.train_apex(factory(TEnv, t_mm), 3, TAPEX.ApexConfig(**cfg, device="cpu"))
    ref = RAPEX.train_apex(factory(REnv, r_mm), 3, RAPEX.ApexConfig(**cfg))
    assert len(res.rewards) == 3 and np.isfinite(res.rewards).all()
    assert res.extra["updates"] == ref.extra["updates"] > 0
    assert set(res.meta) == set(ref.meta)
    assert {k: v for k, v in res.meta.items() if k != "measure"} == \
        {k: v for k, v in ref.meta.items() if k != "measure"}
