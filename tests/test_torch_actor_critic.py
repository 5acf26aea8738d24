"""The actor-critic trainers (PPO, A2C, IMPALA), in both packages on the
same inputs: one update from the same parameters on the same batch (the
parameters after the step, Adam's first moment, which holds the clipped
gradient, and the loss at 1e-5), with the global-norm clip active and not;
``gae`` and ``vtrace`` (numpy: equal); IMPALA's behaviour policy a copy of
the learner, not an alias; and short runs on the analytical backend whose
checkpoints load in the other package with equal greedy actions on the
states clear of ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import a2c as RA2C
from repro.core import encoders as RENC
from repro.core import impala as RIMP
from repro.core import ppo as RPPO
from repro.core import rl_common as RRL
from repro.core import tuner as RT
from repro.core.env import LoopTuneEnv as REnv
from repro.core.loop_ir import matmul_benchmark as r_mm
from repro.core.vec_env import VecLoopTuneEnv as RVec
from repro_torch.core import a2c as TA2C
from repro_torch.core import encoders as TENC
from repro_torch.core import impala as TIMP
from repro_torch.core import ppo as TPPO
from repro_torch.core import tuner as TT
from repro_torch.core.env import LoopTuneEnv as TEnv
from repro_torch.core.loop_ir import matmul_benchmark as t_mm
from repro_torch.core.networks import make_adam, params_from_numpy
from repro_torch.core.rl_common import to_device

UPDATE_TOL = 1e-5  # f32, one step: XLA and torch sum the gradients in other orders
TIE_GAP = 1e-3  # greedy actions compared where the top-2 gap exceeds 100x 1e-5
D, A, B = 40, 7, 48  # state width (two loops of 20 features), actions, batch
HIDDEN = (32, 32)
SHAPES = [(64, 64, 64), (32, 48, 16), (16, 32, 32)]
PKGS = {"ppo": (RPPO, TPPO), "a2c": (RA2C, TA2C), "impala": (RIMP, TIMP)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny networks: test workers share the
    host's cores, and torch's thread pool thrashes under that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=UPDATE_TOL, atol=UPDATE_TOL * scale,
                               err_msg=what)


def _batch(algo, rnet, params, seed):
    """A batch of the trainer's update: states, legal masks (action 0
    always legal), legal actions, and the trainer's targets; PPO's old
    log-probabilities are the network's own plus noise, so some ratios
    fall outside the clip range and some inside."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((B, D)).astype(np.float32)
    mask = rng.random((B, A)) < 0.6
    mask[:, 0] = True
    a = np.array([rng.choice(np.flatnonzero(m)) for m in mask], np.int32)
    if algo == "ppo":
        logits = np.asarray(rnet.batch(params, jnp.asarray(s))[0], np.float64)
        z = np.where(mask, logits, -1e9)
        z = z - z.max(1, keepdims=True)
        logp = (z - np.log(np.exp(z).sum(1, keepdims=True)))[np.arange(B), a]
        logp_old = (logp + 0.3 * rng.standard_normal(B)).astype(np.float32)
        return (s, a, logp_old, rng.standard_normal(B).astype(np.float32),
                rng.standard_normal(B).astype(np.float32), mask)
    if algo == "a2c":
        return s, a, rng.standard_normal(B).astype(np.float32), mask
    return (s, a, rng.standard_normal(B).astype(np.float32),
            rng.standard_normal(B).astype(np.float32), mask)


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("algo", ["ppo", "a2c", "impala"])
def test_one_update_matches(algo, clip):
    rmod, tmod = PKGS[algo]
    max_norm = 0.05 if clip == "active" else 1e3
    cfg_cls = {"ppo": "PPOConfig", "a2c": "A2CConfig", "impala": "ImpalaConfig"}[algo]
    jcfg = getattr(rmod, cfg_cls)(hidden=HIDDEN, max_grad_norm=max_norm)
    tcfg = getattr(tmod, cfg_cls)(hidden=HIDDEN, max_grad_norm=max_norm, device="cpu")
    rnet = RENC.build_network("actor_critic", RENC.EncoderConfig(hidden=HIDDEN,
                                                                max_loops=D // 20), A)
    params = rnet.init(jax.random.PRNGKey(3))
    batch = _batch(algo, rnet, params, 4)
    opt = (jax.tree.map(jnp.zeros_like, params), jax.tree.map(jnp.zeros_like, params),
           jnp.zeros((), jnp.int32))
    new, (m, _, _), loss = rmod.make_update_fn(jcfg, rnet.apply)(
        params, opt, tuple(map(jnp.asarray, batch)))

    tnet = TENC.build_network("actor_critic", TENC.EncoderConfig(hidden=HIDDEN,
                                                                max_loops=D // 20), A, "cpu")
    module = tnet.init(9)  # other weights until the load below
    module.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    topt = make_adam(module, tcfg.lr)
    t_loss = tmod.update(module, topt, to_device(batch, tnet.device), tcfg)

    _close(float(t_loss), float(loss), "loss")
    # the clip did what the case says: the clipped gradient's norm is the
    # limit when active, below it when not
    gnorm = float(torch.sqrt(sum((p.grad ** 2).sum() for p in module.parameters())))
    if clip == "active":
        assert abs(gnorm - max_norm) < 1e-4 * max_norm
    else:
        assert gnorm < 0.5 * max_norm and gnorm > 0
    # Adam's first moment after one step is 0.1 x the clipped gradient
    want_m = params_from_numpy(jax.tree.map(np.asarray, m))
    got_m = {k: topt.state[p]["exp_avg"] for k, p in module.named_parameters()}
    assert set(got_m) == set(want_m)
    for k, g in got_m.items():
        _close(g.numpy(), want_m[k].numpy(), f"first moment {k}")
    want_p = params_from_numpy(jax.tree.map(np.asarray, new))
    for k, t in module.state_dict().items():
        _close(t.numpy(), want_p[k].numpy(), f"param {k}")


def test_gae_matches():
    rng = np.random.default_rng(0)
    t_len, n = 12, 5
    r = rng.standard_normal((t_len, n)).astype(np.float32)
    v = rng.standard_normal((t_len, n)).astype(np.float32)
    d = (rng.random((t_len, n)) < 0.2).astype(np.float32)
    last = rng.standard_normal(n).astype(np.float32)
    for got, want in zip(TPPO.gae(r, v, d, last, 0.99, 0.95),
                         RPPO.gae(r, v, d, last, 0.99, 0.95)):
        np.testing.assert_array_equal(got, want)


def test_vtrace_matches():
    rng = np.random.default_rng(1)
    t_len, n = 10, 6
    blp = -rng.uniform(0.1, 3.0, (t_len, n)).astype(np.float32)
    tlp = -rng.uniform(0.1, 3.0, (t_len, n)).astype(np.float32)
    r = rng.standard_normal((t_len, n)).astype(np.float32)
    v = rng.standard_normal((t_len, n)).astype(np.float32)
    d = (rng.random((t_len, n)) < 0.2).astype(np.float32)
    boot = rng.standard_normal(n).astype(np.float32)
    for rho_bar, c_bar in ((1.0, 1.0), (0.8, 0.5)):
        for got, want in zip(TIMP.vtrace(blp, tlp, r, v, d, boot, 0.99, rho_bar, c_bar),
                             RIMP.vtrace(blp, tlp, r, v, d, boot, 0.99, rho_bar, c_bar)):
            np.testing.assert_array_equal(got, want)


def test_impala_actor_is_a_copy_not_an_alias():
    """Synced at iteration 0 only, the actor keeps the initial weights
    while the learner steps away from them, in storage of its own."""
    env = TEnv([t_mm(*s) for s in SHAPES], "tpu")
    cfg = TIMP.ImpalaConfig(hidden=HIDDEN, n_envs=2, rollout_len=5, actor_sync_every=4,
                            device="cpu")
    res = TIMP.train_impala(lambda i: env, 3, cfg)
    actor, learner = res.extra["actor"], res.params
    assert res.extra["updates"] == 3
    initial = TENC.build_network("actor_critic", cfg.encoder.resolved(HIDDEN),
                                 env.n_actions, "cpu").init(cfg.seed)
    for (k, a), (_, p), (_, p0) in zip(actor.state_dict().items(),
                                       learner.state_dict().items(),
                                       initial.state_dict().items()):
        assert a.data_ptr() != p.data_ptr(), k
        np.testing.assert_array_equal(a.numpy(), p0.numpy())
    assert any(not torch.equal(a, p) for a, p in zip(actor.parameters(),
                                                     learner.parameters()))


# ---------------------------------------------------------------------------
# Short runs, checkpoints across the packages
# ---------------------------------------------------------------------------

SMALL = {"ppo": dict(rollout_len=8, n_epochs=1, n_minibatches=2),
         "a2c": dict(rollout_len=5),
         "impala": dict(rollout_len=5, actor_sync_every=2)}
TRAIN = {"ppo": "train_ppo", "a2c": "train_a2c", "impala": "train_impala"}
CFG = {"ppo": "PPOConfig", "a2c": "A2CConfig", "impala": "ImpalaConfig"}


def _train(pkg, algo, path):
    mod = PKGS[algo][0 if pkg == "jax" else 1]
    env_cls, mm = (REnv, r_mm) if pkg == "jax" else (TEnv, t_mm)
    env = env_cls([mm(*s) for s in SHAPES], "tpu")
    kw = dict(hidden=HIDDEN, n_envs=2, **SMALL[algo])
    if pkg == "torch":
        kw["device"] = "cpu"
    res = getattr(mod, TRAIN[algo])(lambda i: env, 3, getattr(mod, CFG[algo])(**kw))
    assert len(res.rewards) == 3 and np.isfinite(res.rewards).all()
    res.save(path)
    return res


def _states(n=64):
    """Observations and legal masks of ``n`` states reached by random
    walks on the analytical backend."""
    env = RVec([r_mm(*s) for s in SHAPES], "tpu", 4, seed=1)
    rng = np.random.default_rng(2)
    obs, masks = [env.reset()], [env.action_mask()]
    while sum(len(o) for o in obs) < n:
        a = [int(rng.choice(np.flatnonzero(m))) for m in env.action_mask()]
        o, _, d, _ = env.step(a)
        obs.append(env.reset() if d.all() else o)
        masks.append(env.action_mask())
    return np.concatenate(obs)[:n], np.concatenate(masks)[:n]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("algo", ["ppo", "a2c", "impala"])
def test_checkpoint_loads_across_the_packages(tmp_path, algo, direction):
    path = str(tmp_path / f"{algo}.pkl")
    res = _train("jax" if direction == "jax_to_port" else "torch", algo, path)
    d = RRL.load_checkpoint(path)
    assert d["algo"] == algo and d["meta"]["head"] == "actor_critic"
    assert set(d["meta"]) == set(RENC.checkpoint_meta(
        "actor_critic", RENC.EncoderConfig().resolved(), [], 0))
    r_tuner = RT.LoopTuner.from_checkpoint(path, backend="tpu")
    t_tuner = TT.LoopTuner.from_checkpoint(path, backend="tpu", device="cpu")
    assert r_tuner.calibration == t_tuner.calibration
    assert t_tuner.calibration["mode"] == "recorded"
    assert [a.name for a in t_tuner.actions] == [a.name for a in r_tuner.actions]
    obs, mask = _states()
    net = RENC.build_network("actor_critic", RENC.EncoderConfig.from_dict(
        d["meta"]["encoder"]).resolved(), d["meta"]["n_actions"])
    scores = np.asarray(RENC.make_score_fn(net)(jax.tree.map(jnp.asarray, d["params"]), obs))
    top2 = np.sort(np.where(mask, scores, -np.inf), axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TIE_GAP * np.maximum(np.abs(scores).max(1), 1e-6)
    assert clear.sum() >= len(obs) // 2
    want = np.asarray(r_tuner.act(obs, mask))[clear]
    np.testing.assert_array_equal(np.asarray(t_tuner.act(obs, mask))[clear], want)
    np.testing.assert_array_equal(np.asarray(res.act(obs, mask))[clear], want)
