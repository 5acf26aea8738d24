"""Shared RL utilities: batched rollout collection, policy evaluation,
masked sampling, param I/O, and the learner's device synchronisation.

Every trainer returns a :class:`TrainResult` and collects experience with
:func:`collect_vec_rollout` over a :class:`VecLoopTuneEnv` — one batched
policy call and one batched (cached) backend call per step for the whole
lane fleet, instead of per-env scalar loops.  ``greedy_rollout`` is the
paper's *inference phase* (§III): iterate the policy's best action with NO
backend measurement in the loop — this is what makes tuning take ~a second;
``greedy_rollout_vec`` runs that phase over many contractions at once.
"""
from __future__ import annotations

import pickle
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .env import LoopTuneEnv
from .loop_ir import LoopNest
from .networks import masked_fill, params_to_numpy
from .vec_env import VecLoopTuneEnv

# act(obs, mask, greedy) -> action index.  Every trainer's act() also accepts
# a batch — obs (N, D), mask (N, A) — returning an (N,) int array.
ActFn = Callable[[np.ndarray, np.ndarray, bool], int]

# policy(obs (N, D), mask (N, A)) -> (actions (N,), aux arrays keyed by name)
VecPolicyFn = Callable[[np.ndarray, np.ndarray],
                       Tuple[np.ndarray, Dict[str, np.ndarray]]]


@dataclass
class TrainResult:
    algo: str
    params: Any
    act: ActFn
    rewards: List[float] = field(default_factory=list)  # episode_reward_mean / iter
    times: List[float] = field(default_factory=list)    # wall-clock per iter
    extra: Dict[str, Any] = field(default_factory=dict)
    # checkpoint metadata: head, encoder config, action space (see
    # encoders.checkpoint_meta) — everything from_checkpoint needs to
    # rebuild acting without assuming defaults
    meta: Dict[str, Any] = field(default_factory=dict)

    def save(self, path: str) -> None:
        """Pickle ``{"algo", "params", "rewards", "meta"}`` with the params
        as the JAX package's tree of numpy arrays, so either package loads
        the file."""
        params = (params_to_numpy(self.params)
                  if isinstance(self.params, torch.nn.Module) else self.params)
        with open(path, "wb") as f:
            pickle.dump(
                {"algo": self.algo,
                 "params": params,
                 "rewards": self.rewards,
                 "meta": self.meta},
                f)


def sync_device(device: torch.device) -> None:
    """Leave the card idle: a learner's updates stay queued on the stream
    after the host returns, and the next rollout's reward clock (a host
    clock around a launch that synchronises only after it) would absorb
    them.  Trainers call this after each burst of updates."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(arrays, device: torch.device):
    """numpy arrays as tensors on ``device``: bool masks stay bool, integer
    actions become int64 (``gather``'s index), the rest float32."""
    out = []
    for x in arrays:
        x = np.asarray(x)
        dt = (torch.bool if x.dtype == bool else
              torch.int64 if np.issubdtype(x.dtype, np.integer) else torch.float32)
        out.append(torch.as_tensor(x, dtype=dt, device=device))
    return tuple(out)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Full checkpoint dict: algo, params, rewards, meta (``meta`` is empty
    for pre-metadata checkpoints, which load fine with flat defaults)."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    d.setdefault("meta", {})
    return d


def load_params(path: str) -> Tuple[str, Any]:
    d = load_checkpoint(path)
    return d["algo"], d["params"]


@dataclass
class RolloutBatch:
    """One rollout segment from :func:`collect_vec_rollout`.

    All arrays are time-major ``(T, N, ...)``.  ``next_obs``/``next_masks``
    are the *pre-reset* successor states, so DQN-family targets see the true
    terminal observation even though done lanes are reset in place.
    """

    obs: np.ndarray         # (T, N, D) float32
    masks: np.ndarray       # (T, N, A) bool
    actions: np.ndarray     # (T, N) int32
    rewards: np.ndarray     # (T, N) float32
    dones: np.ndarray       # (T, N) float32
    # reward-quality flags from the measurement guardrails: True where the
    # step's reward came from a measurement still flagged noisy after
    # escalation + re-measurement (see core.measure) — trainers must not
    # let such rewards into a replay buffer unmarked
    noisy: np.ndarray       # (T, N) bool
    next_obs: np.ndarray    # (T, N, D) float32
    next_masks: np.ndarray  # (T, N, A) bool
    aux: Dict[str, np.ndarray]  # per-step policy aux, stacked (T, N, ...)
    final_obs: np.ndarray   # (N, D) — post-reset obs to continue from

    @property
    def n_steps(self) -> int:
        return self.obs.shape[0] * self.obs.shape[1]

    def flat(self, x: np.ndarray) -> np.ndarray:
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def collect_vec_rollout(
    venv: VecLoopTuneEnv,
    policy: VecPolicyFn,
    t_len: int,
    obs: np.ndarray,
    ep_rewards: np.ndarray,
    finished: List[float],
) -> RolloutBatch:
    """Collect ``t_len`` batched steps from every lane of ``venv``.

    ``obs`` is the current observation batch ``(N, D)``; ``ep_rewards`` (N,)
    accumulates per-lane episode reward across calls and ``finished`` receives
    each completed episode's total.  Done lanes are reset in place (after the
    pre-reset successor state is recorded) so collection never stalls.
    """
    n = venv.n_envs
    S = np.zeros((t_len, n, venv.state_dim), np.float32)
    M = np.zeros((t_len, n, venv.n_actions), bool)
    A = np.zeros((t_len, n), np.int32)
    R = np.zeros((t_len, n), np.float32)
    D = np.zeros((t_len, n), np.float32)
    NZ = np.zeros((t_len, n), bool)
    S2 = np.zeros((t_len, n, venv.state_dim), np.float32)
    M2 = np.zeros((t_len, n, venv.n_actions), bool)
    aux_steps: List[Dict[str, np.ndarray]] = []
    mask = venv.action_mask()
    for t in range(t_len):
        a, aux = policy(obs, mask)
        obs2, r, done, infos = venv.step(a)
        next_mask = venv.action_mask()
        S[t], M[t], A[t] = obs, mask, a
        R[t], D[t] = r, done.astype(np.float32)
        NZ[t] = [bool(info.get("noisy", False)) for info in infos]
        S2[t], M2[t] = obs2, next_mask
        aux_steps.append(aux)
        ep_rewards += r
        obs = obs2
        if done.any():
            obs, next_mask = obs.copy(), next_mask.copy()
            lanes = [int(i) for i in np.flatnonzero(done)]
            for i in lanes:
                finished.append(float(ep_rewards[i]))
                ep_rewards[i] = 0.0
            venv.reset_lanes(lanes)  # one batched eval for all fresh nests
            for i in lanes:
                obs[i] = venv.observe_lane(i)
                next_mask[i] = venv.action_mask_lane(i)
        mask = next_mask  # carry forward: recomputed only for reset lanes
    aux_stacked = {
        k: np.stack([step[k] for step in aux_steps])
        for k in (aux_steps[0] if aux_steps else {})
    }
    return RolloutBatch(S, M, A, R, D, NZ, S2, M2, aux_stacked, obs)


def make_masked_act(score_fn) -> Callable[[list], ActFn]:
    """Build a trainer's ``make_act(params_ref)`` from its batched scoring
    function ``score_fn(params, obs (N, D)) -> scores (N, A)`` (Q-values or
    logits).  The returned act() dispatches on obs rank: (D,) -> int,
    (N, D) -> (N,) ints — the batch path feeds ``greedy_rollout_vec`` and
    the tuner without a per-lane network call."""

    def make_act(params_ref):
        def act(obs: np.ndarray, mask: np.ndarray, greedy: bool = True):
            obs = np.asarray(obs)
            if obs.ndim == 1:
                q = np.asarray(score_fn(params_ref[0], obs[None]))[0]
                return int(np.argmax(masked_fill(q, mask)))
            q = np.asarray(score_fn(params_ref[0], obs))
            return np.argmax(masked_fill(q, mask), axis=1)

        return act

    return make_act


def epsilon_greedy_batch(
    q: np.ndarray,
    mask: np.ndarray,
    eps,
    rng,
) -> np.ndarray:
    """Masked argmax over ``q`` (N, A) with per-lane ε-exploration.

    ``eps`` is a scalar or per-lane array; ``rng`` is one shared Generator or
    a per-lane sequence (APEX ladder).  Returns (N,) int32 actions.

    The shared-generator case is fully vectorized (one ε draw and one
    uniform tie-break matrix for the whole fleet); the per-lane-rng path
    keeps the original draw order exactly, so APEX ladder actors stay
    bit-compatible with their per-lane seeds."""
    q = np.asarray(q)
    n = len(q)
    a = np.argmax(masked_fill(q, mask), axis=1).astype(np.int32)
    eps_arr = np.broadcast_to(np.asarray(eps, np.float64), (n,))
    if isinstance(rng, (list, tuple)):
        # APEX ε-ladder: one Generator per actor lane, original draw order
        for i in range(n):
            if rng[i].random() < eps_arr[i]:
                a[i] = int(rng[i].choice(np.flatnonzero(mask[i])))
        return a
    explore = rng.random(n) < eps_arr
    if explore.any():
        # uniform over each lane's legal actions: argmax of iid U(0,1)
        # restricted to the mask (illegal entries can never win)
        u = np.where(mask, rng.random(mask.shape), -1.0)
        a[explore] = np.argmax(u, axis=1).astype(np.int32)[explore]
    return a


def sample_masked(
    logits: np.ndarray, mask: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample one action per row from the masked softmax of ``logits``
    (N, A); returns ``(actions (N,) int32, log_probs (N,) float32)``.

    Vectorized as a batched Gumbel-max draw: ``argmax(logp + G)`` with iid
    Gumbel noise samples the softmax exactly, with no per-row Python loop
    and no per-row ``rng.choice``.  Masked entries get the shared finite
    ``MASK_SENTINEL`` (not -inf): with any legal action present their
    probability underflows to exactly 0 (sentinel rows lose every Gumbel
    race against a legal entry), and a fully-masked row degrades to a
    uniform draw instead of NaN."""
    logits = np.asarray(logits, np.float64)
    z = masked_fill(logits, mask)
    z = z - z.max(axis=1, keepdims=True)
    logp_all = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    a = np.argmax(logp_all + rng.gumbel(size=logp_all.shape), axis=1)
    a = a.astype(np.int32)
    logp = logp_all[np.arange(len(a)), a]
    logp = np.maximum(logp, np.log(1e-12)).astype(np.float32)
    return a, logp


def greedy_rollout(
    env: LoopTuneEnv,
    act: ActFn,
    benchmark_idx: int,
    steps: Optional[int] = None,
    measure_final_only: bool = True,
) -> Tuple[float, List[str], LoopNest]:
    """Run the policy greedily from the initial nest (the paper's inference
    phase).  Actions are chosen by the network alone; the backend is queried
    only to report the final GFLOPS (and for the reward bookkeeping the env
    does internally).  Returns (best_gflops, action_names, best_nest)."""
    steps = steps if steps is not None else env.episode_len
    obs = env.reset(benchmark_idx)
    best_g = env.current_gflops
    best_nest = env.nest.clone()
    names: List[str] = []
    for _ in range(steps):
        a = act(obs, env.action_mask(), True)
        obs, _, done, info = env.step(a)
        names.append(info["action"])
        if info["gflops"] > best_g:
            best_g = info["gflops"]
            best_nest = env.nest.clone()
        if done:
            break
    return best_g, names, best_nest


def _probe_batch_act(act: ActFn, obs: np.ndarray, mask: np.ndarray):
    """One-time capability probe: returns ``(actions, step_fn)`` where
    ``step_fn(obs, mask)`` uses the act()'s batched path when it has one and
    falls back to per-lane fan-out for scalar-only acts (the pre-batching
    ActFn contract).  The probe runs once per rollout, so a batched-path
    failure surfaces through the scalar path instead of being re-swallowed
    every step."""

    def fan_out(o, m):
        return np.array([int(act(o[i], m[i], True)) for i in range(len(o))])

    try:
        a = np.asarray(act(obs, mask, True))
        if a.shape == (len(obs),):
            return a, lambda o, m: np.asarray(act(o, m, True))
    except Exception:  # noqa: BLE001 — scalar-only act choked on a batch
        pass
    return fan_out(obs, mask), fan_out


def greedy_rollout_vec(
    venv: VecLoopTuneEnv,
    act: ActFn,
    benchmark_indices: Optional[Sequence[int]] = None,
    steps: Optional[int] = None,
) -> Tuple[np.ndarray, List[List[str]], List[LoopNest]]:
    """Batched inference phase: roll the policy greedily over every lane at
    once (one batched act() and one batched backend call per step).  Returns
    ``(best_gflops (N,), action_names per lane, best_nests per lane)``."""
    steps = steps if steps is not None else venv.episode_len
    obs = venv.reset(benchmark_indices)
    best_g = venv.current_gflops.copy()
    best_nests = [venv.nests[i].clone() for i in range(venv.n_envs)]
    names: List[List[str]] = [[] for _ in range(venv.n_envs)]
    step_act = None
    for _ in range(min(steps, venv.episode_len)):
        if step_act is None:
            a, step_act = _probe_batch_act(act, obs, venv.action_mask())
        else:
            a = step_act(obs, venv.action_mask())
        obs, _, done, infos = venv.step(a)
        for i, info in enumerate(infos):
            names[i].append(info["action"])
            if info["gflops"] > best_g[i]:
                best_g[i] = info["gflops"]
                best_nests[i] = venv.nests[i].clone()
        if done.all():
            break
    return best_g, names, best_nests


def evaluate_policy(
    env: LoopTuneEnv,
    act: ActFn,
    benchmark_indices: Sequence[int],
    steps: Optional[int] = None,
) -> Dict[str, Any]:
    """Speedup of the tuned schedule over the untuned nest per benchmark."""
    speedups, finals, bases, times = [], [], [], []
    for bi in benchmark_indices:
        t0 = time.perf_counter()
        best_g, _, _ = greedy_rollout(env, act, bi, steps)
        times.append(time.perf_counter() - t0)
        base = env.initial_gflops
        speedups.append(best_g / max(base, 1e-9))
        finals.append(best_g)
        bases.append(base)
    return {
        "speedup_mean": float(np.mean(speedups)),
        "speedup_geomean": float(np.exp(np.mean(np.log(np.maximum(speedups, 1e-9))))),
        "speedups": speedups,
        "final_gflops": finals,
        "base_gflops": bases,
        "time_mean_s": float(np.mean(times)),
    }


def epsilon_ladder(n_actors: int, eps_base: float = 0.4, alpha: float = 7.0) -> np.ndarray:
    """APEX per-actor exploration ladder (Horgan et al. 2018 eq. 1)."""
    if n_actors == 1:
        return np.array([eps_base])
    i = np.arange(n_actors)
    return eps_base ** (1 + i / (n_actors - 1) * alpha)
