"""The policy path, in both packages on the same inputs: the vectorised
environment, the encoders and heads (weights carried across with
``params_from_numpy``), masked acting and sampling, batched greedy
rollouts, and checkpoints loaded across the packages.

Numpy code must agree exactly.  Network scores are held at 1e-5 relative
(f32; XLA and torch sum in other orders), and greedy actions must be equal
on every state whose top two legal scores differ by more than 100 times
that tolerance.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import actions as RA
from repro.core import encoders as RENC
from repro.core import rl_common as RRL
from repro.core import tuner as RT
from repro.core.cpu_backend import CPUMeasuredBackend as RCPU
from repro.core.dqn import DQNConfig as RDQNConfig
from repro.core.dqn import train_dqn as r_train_dqn
from repro.core.env import LoopTuneEnv as REnv
from repro.core.graph_features import GraphFeaturizer as RGraphF
from repro.core.loop_ir import matmul_benchmark as r_mm
from repro.core.measure import MeasurementPolicy as RPolicy
from repro.core.vec_env import VecLoopTuneEnv as RVec
from repro_torch.core import actions as TA
from repro_torch.core import encoders as TENC
from repro_torch.core import rl_common as TRL
from repro_torch.core import tuner as TT
from repro_torch.core.apex_dqn import ApexConfig as TApexConfig
from repro_torch.core.apex_dqn import train_apex as t_train_apex
from repro_torch.core.backend import make_backend as t_make_backend
from repro_torch.core.cpu_backend import CPUMeasuredBackend as TCPU
from repro_torch.core.env import LoopTuneEnv as TEnv
from repro_torch.core.graph_features import GraphFeaturizer as TGraphF
from repro_torch.core.loop_ir import matmul_benchmark as t_mm
from repro_torch.core.measure import MeasurementPolicy as TPolicy
from repro_torch.core.networks import params_from_numpy
from repro_torch.core.vec_env import VecLoopTuneEnv as TVec

SHAPES = [(64, 64, 64), (32, 48, 16), (16, 32, 32)]
HIDDEN = (32, 32)
SCORE_RTOL = 1e-5  # f32 network scores, XLA against torch
TIE_GAP = 100 * SCORE_RTOL  # greedy actions compared where the top-2 gap exceeds this


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny networks: test workers share the
    host's cores, and torch's thread pool thrashes under that (a short
    graph DQN run took 168 s with three workers, 1.3 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clock():
    """A deterministic stand-in for the host clock: successive readings
    differ by 0.4-1.6 in a fixed pattern, so both packages' measured
    backends see the same timings (and the same spread escalations and
    noisy flags) when they time the same nests in the same order."""
    k = itertools.count()

    def clock():
        i = next(k)
        return i + 0.1 * (i * i % 7)

    return clock


def _backends(kind):
    if kind == "tpu":
        return "tpu", "tpu"
    return (RCPU(policy=RPolicy(repeats=2, clock=_clock())),
            TCPU(policy=TPolicy(repeats=2, clock=_clock())))


def _featurizers(kind):
    return (None, None) if kind == "flat" else (RGraphF(), TGraphF())


# ---------------------------------------------------------------------------
# VecLoopTuneEnv, lane by lane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["tpu", "numpy"])
@pytest.mark.parametrize("feat", ["flat", "graph"])
def test_vec_env_lanes_match(backend, feat):
    shapes = SHAPES[:2] if backend == "numpy" else SHAPES
    rb, tb = _backends(backend)
    rf, tf = _featurizers(feat)
    splits = (16, 8) if backend == "numpy" else RA.TPU_SPLITS
    # the interpreter's peak() times a host matmul on the real clock: give
    # both the same normaliser
    peak = None if backend == "tpu" else 1e3
    rv = RVec([r_mm(*s) for s in shapes], rb, 3, seed=5, featurizer=rf,
              actions=RA.build_action_space(splits), peak=peak)
    tv = TVec([t_mm(*s) for s in shapes], tb, 3, seed=5, featurizer=tf,
              actions=TA.build_action_space(splits), peak=peak)
    np.testing.assert_array_equal(tv.reset(), rv.reset())
    np.testing.assert_array_equal(tv.initial_gflops, rv.initial_gflops)
    rng = np.random.default_rng(0)
    for step in range(2 * rv.episode_len):
        mask = rv.action_mask()
        np.testing.assert_array_equal(tv.action_mask(), mask)
        a = [int(rng.choice(np.flatnonzero(m))) for m in mask]
        ro, rr, rd, ri = rv.step(a)
        to, tr, td, ti = tv.step(a)
        np.testing.assert_array_equal(to, ro)
        np.testing.assert_array_equal(tr, rr)
        np.testing.assert_array_equal(td, rd)
        assert [(i["gflops"], i["action"], i["noisy"]) for i in ti] == \
            [(i["gflops"], i["action"], i["noisy"]) for i in ri]
        if rd.any():
            lanes = [int(i) for i in np.flatnonzero(rd)]
            rv.reset_lanes(lanes)
            tv.reset_lanes(lanes)
            for i in lanes:
                np.testing.assert_array_equal(tv.observe_lane(i), rv.observe_lane(i))
            np.testing.assert_array_equal(tv.initial_gflops, rv.initial_gflops)
            np.testing.assert_array_equal(tv.t, rv.t)


# ---------------------------------------------------------------------------
# Heads x encoders, weights carried across
# ---------------------------------------------------------------------------


def _states(feat, n=48):
    """Observations and legal masks of ``n`` states reached by random
    walks on the analytical backend."""
    rf, _ = _featurizers(feat)
    env = RVec([r_mm(*s) for s in SHAPES], "tpu", 4, seed=1, featurizer=rf)
    rng = np.random.default_rng(2)
    obs, masks = [env.reset()], [env.action_mask()]
    while sum(len(o) for o in obs) < n:
        a = [int(rng.choice(np.flatnonzero(m))) for m in env.action_mask()]
        o, _, d, _ = env.step(a)
        if d.all():
            o = env.reset()
        obs.append(o)
        masks.append(env.action_mask())
    return np.concatenate(obs)[:n], np.concatenate(masks)[:n]


def _pair(head, feat, n_actions, seed=0):
    """(JAX network, its params, port network, its module carrying the same
    weights)."""
    cfg = RENC.EncoderConfig(kind=feat, hidden=HIDDEN)
    rnet = RENC.build_network(head, cfg, n_actions)
    params = rnet.init(jax.random.PRNGKey(seed))
    tcfg = TENC.EncoderConfig(kind=feat, hidden=HIDDEN)
    tnet = TENC.build_network(head, tcfg, n_actions, "cpu")
    module = tnet.init(seed + 1)  # other weights until the load below
    module.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return rnet, params, tnet, module


def _clear_of_ties(scores, mask):
    s = np.sort(np.where(mask, scores, -np.inf), axis=1)
    scale = np.abs(scores).max(axis=1)
    return (s[:, -1] - s[:, -2]) > TIE_GAP * np.maximum(scale, 1e-6)


@pytest.mark.parametrize("head", ["q", "dueling", "actor_critic"])
@pytest.mark.parametrize("feat", ["flat", "graph"])
def test_scores_and_greedy_actions_match(head, feat):
    obs, mask = _states(feat)
    n_actions = mask.shape[1]
    rnet, params, tnet, module = _pair(head, feat, n_actions)
    ref = rnet.batch(params, jnp.asarray(obs))
    out = tnet.batch(module, obs)
    if head == "actor_critic":
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   rtol=SCORE_RTOL, atol=SCORE_RTOL)
        ref, out = ref[0], out[0]
    ref, out = np.asarray(ref), out.numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=SCORE_RTOL, atol=SCORE_RTOL * scale)
    clear = _clear_of_ties(ref, mask)
    assert clear.sum() >= len(obs) // 2
    r_act = RENC.make_policy_act(head, rnet.config)([params])
    t_act = TENC.make_policy_act(head, tnet.config, n_actions, "cpu")([module])
    np.testing.assert_array_equal(np.asarray(t_act(obs, mask))[clear],
                                  np.asarray(r_act(obs, mask))[clear])
    i = int(np.flatnonzero(clear)[0])
    assert t_act(obs[i], mask[i]) == r_act(obs[i], mask[i])


def test_params_round_trip_keeps_the_jax_tree():
    from repro_torch.core.networks import params_to_numpy

    _, params, _, module = _pair("dueling", "graph", 6)
    back = params_to_numpy(module)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# Masked acting and sampling (numpy: equal)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_lane", [False, True])
def test_epsilon_greedy_batch_matches(per_lane):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((8, 7)).astype(np.float32)
    mask = rng.random((8, 7)) < 0.6
    mask[:, 0] = True
    eps = RRL.epsilon_ladder(8) if per_lane else 0.5

    def gen():
        if per_lane:
            return [np.random.default_rng(100 + i) for i in range(8)]
        return np.random.default_rng(9)

    rg, tg = gen(), gen()
    for _ in range(5):
        np.testing.assert_array_equal(TRL.epsilon_greedy_batch(q, mask, eps, tg),
                                      RRL.epsilon_greedy_batch(q, mask, eps, rg))
    np.testing.assert_array_equal(TRL.epsilon_ladder(8), RRL.epsilon_ladder(8))


def test_sample_masked_matches():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((16, 9))
    mask = rng.random((16, 9)) < 0.5
    mask[:, 3] = True
    mask[0] = False  # a fully masked row: uniform, no NaN
    ra, rl = RRL.sample_masked(logits, mask, np.random.default_rng(1))
    ta, tl = TRL.sample_masked(logits, mask, np.random.default_rng(1))
    np.testing.assert_array_equal(ta, ra)
    np.testing.assert_array_equal(tl, rl)


@pytest.mark.parametrize("feat", ["flat", "graph"])
def test_greedy_rollout_vec_matches(feat):
    obs, mask = _states(feat, 8)
    rnet, params, tnet, module = _pair("dueling", feat, mask.shape[1], seed=3)
    rf, tf = _featurizers(feat)
    rv = RVec([r_mm(*s) for s in SHAPES], "tpu", 3, featurizer=rf)
    tv = TVec([t_mm(*s) for s in SHAPES], "tpu", 3, featurizer=tf)
    r_act = RENC.make_policy_act("dueling", rnet.config)([params])
    t_act = TENC.make_policy_act("dueling", tnet.config, mask.shape[1], "cpu")([module])
    rg, rn, _ = RRL.greedy_rollout_vec(rv, r_act, [0, 1, 2])
    tg, tn, tnests = TRL.greedy_rollout_vec(tv, t_act, [0, 1, 2])
    assert tn == rn
    np.testing.assert_array_equal(tg, rg)
    # the scalar inference phase takes the same actions
    g, names, _ = TRL.greedy_rollout(TEnv([t_mm(*s) for s in SHAPES], "tpu", featurizer=tf),
                                     t_act, 1)
    assert names == rn[1]


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

TUNE = [(64, 128, 64), (128, 64, 32)]


def _greedy_both(path, obs, mask):
    """Greedy actions of a checkpoint through both packages' ``load_policy``
    on the states clear of ties (by the JAX package's scores)."""
    d = RRL.load_checkpoint(path)
    meta = d["meta"]
    net = RENC.build_network(meta["head"], RENC.EncoderConfig.from_dict(
        meta["encoder"]).resolved(), meta["n_actions"])
    scores = RENC.make_score_fn(net)(jax.tree.map(jnp.asarray, d["params"]), obs)
    clear = _clear_of_ties(np.asarray(scores), mask)
    assert clear.sum() >= len(obs) // 2
    r_act, t_act = RT.make_act_from_checkpoint(path), TT.make_act_from_checkpoint(path, "cpu")
    return (np.asarray(r_act(obs, mask))[clear], np.asarray(t_act(obs, mask))[clear],
            clear)


@pytest.mark.parametrize("feat", ["flat", "graph"])
def test_jax_checkpoint_through_the_port(tmp_path, feat):
    path = str(tmp_path / "dqn.pkl")
    env = REnv([r_mm(*s) for s in SHAPES], "tpu")
    r_train_dqn(env, 3, RDQNConfig(hidden=HIDDEN, warmup_steps=20, n_envs=2,
                                   encoder=RENC.EncoderConfig(kind=feat))).save(path)
    r_tuner = RT.LoopTuner.from_checkpoint(path)
    t_tuner = TT.LoopTuner.from_checkpoint(path, device="cpu")
    assert t_tuner.policy == "policy" and t_tuner.backend_kind == "tpu"
    assert t_tuner.calibration == r_tuner.calibration
    assert t_tuner.calibration["mode"] == "recorded"
    assert [a.name for a in t_tuner.actions] == [a.name for a in r_tuner.actions]
    want, got, _ = _greedy_both(path, *_states(feat, 64))
    np.testing.assert_array_equal(got, want)
    te = t_tuner.tune_many([t_mm(*s) for s in TUNE])
    re = r_tuner.tune_many([r_mm(*s) for s in TUNE])
    assert [e["actions"] for e in te] == [e["actions"] for e in re]
    assert [e["gflops"] for e in te] == [e["gflops"] for e in re]


def _port_apex(path, backend="tpu"):
    env = TEnv([t_mm(*s) for s in SHAPES], backend)
    res = t_train_apex(lambda i: env, 4,
                       TApexConfig(hidden=HIDDEN, n_actors=3, warmup_steps=30,
                                   device="cpu"))
    res.save(path)
    return res


def test_port_checkpoint_through_jax(tmp_path):
    path = str(tmp_path / "apex.pkl")
    res = _port_apex(path)
    d = RRL.load_checkpoint(path)
    assert d["algo"] == "apex_dqn" and set(d["meta"]) == set(RENC.checkpoint_meta(
        "dueling", RENC.EncoderConfig().resolved(), [], 0))
    obs, mask = _states("flat", 64)
    want, got, clear = _greedy_both(path, obs, mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(res.act(obs, mask))[clear], want)
    r_tuner = RT.LoopTuner.from_checkpoint(path)
    t_tuner = TT.LoopTuner.from_checkpoint(path, device="cpu")
    assert r_tuner.calibration == t_tuner.calibration
    assert t_tuner.calibration["mode"] == "recorded"
    te = t_tuner.tune_many([t_mm(*s) for s in TUNE])
    re = r_tuner.tune_many([r_mm(*s) for s in TUNE])
    assert [e["actions"] for e in te] == [e["actions"] for e in re]


def test_checkpoint_backends_across_the_packages(tmp_path):
    """A JAX checkpoint of its ``"jax"`` executor names a backend the port
    does not register: the port raises the registry's error unless given a
    backend, and calibrates cross-backend on the card executor.  A port
    checkpoint of ``"torch"`` goes the other way."""
    jpath = str(tmp_path / "jax.pkl")
    env = REnv([r_mm(*s) for s in SHAPES], "tpu")
    res = r_train_dqn(env, 2, RDQNConfig(hidden=HIDDEN, warmup_steps=10, n_envs=2))
    res.meta["backend"] = "jax"
    res.save(jpath)
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        TT.LoopTuner.from_checkpoint(jpath, device="cpu")
    t = TT.LoopTuner.from_checkpoint(jpath, backend=t_make_backend("torch", device="cpu"),
                                     device="cpu")
    assert t.calibration["mode"] == "cross-backend" and t.calibration["trained_on"] == "jax"

    tpath = str(tmp_path / "torch.pkl")
    _port_apex(tpath, backend=t_make_backend("torch", device="cpu", repeats=1))
    assert RRL.load_checkpoint(tpath)["meta"]["backend"] == "torch"
    with pytest.raises(ValueError, match="unknown backend 'torch'"):
        RT.LoopTuner.from_checkpoint(tpath)
    for backend in ("tpu", "numpy"):
        r = RT.LoopTuner.from_checkpoint(tpath, backend=backend)
        t = TT.LoopTuner.from_checkpoint(tpath, backend=backend, device="cpu")
        assert r.calibration["mode"] == t.calibration["mode"] == "cross-backend"


def test_networks_on_the_card_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        TENC.build_network("q", TENC.EncoderConfig(), 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train_apex(lambda i: TEnv([t_mm(*SHAPES[0])], "tpu"), 1)
