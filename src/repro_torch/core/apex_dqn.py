"""APEX_DQN (Horgan et al. 2018) — the paper's winning trainer (§VI-A).

Distributed prioritized experience replay, adapted to one process: the
actor fleet is the lane dimension of a :class:`VecLoopTuneEnv` — lane i
carries ε_i from the APEX exploration ladder, all lanes share one Q call on
the network's device and one batched backend call per step, and their
experiences land in a shared proportional prioritized replay (sum-tree)
through per-lane n-step accumulators.  The learner uses Double-DQN with a
dueling head (``dqn.q_update``); priorities are updated from the sampled TD
errors, which each update reads back to the host — so the card is idle
again when the next rollout times its rewards.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .dqn import batch_to_device, q_update
from .encoders import (EncoderConfig, build_network, checkpoint_meta,
                       get_encoder, make_score_fn)
from .measure import measure_settings
from .networks import make_adam
from .replay import PrioritizedReplay
from .rl_common import (TrainResult, collect_vec_rollout, epsilon_greedy_batch,
                        epsilon_ladder, make_masked_act, sync_device)
from .vec_env import VecLoopTuneEnv


@dataclass
class ApexConfig:
    hidden: Tuple[int, ...] = (256, 256)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    lr: float = 1e-3
    gamma: float = 0.99
    n_step: int = 3
    n_actors: int = 8
    batch_size: int = 64
    buffer_size: int = 100_000
    eps_base: float = 0.4
    eps_alpha: float = 7.0
    per_alpha: float = 0.6
    per_beta0: float = 0.4
    target_sync_every: int = 100
    update_every: int = 2  # env steps per learner update
    warmup_steps: int = 300
    seed: int = 0
    # surrogate policy the tuner should use with this checkpoint's policy
    # ("auto" | "off") — persisted via checkpoint_meta
    surrogate: str = "auto"
    # reward-source executor for the rollout fleet, by registry name
    # ("numpy" | "torch" | "tpu" | "auto"; see core.backend.make_backend).
    # None = keep the executor of the env the factory provides.  The
    # resolved name is persisted via checkpoint_meta.
    backend: Optional[str] = None
    # learner weight multiplier for transitions whose (n-step) reward
    # includes a measurement flagged noisy by the guardrails — composes
    # with the importance-sampling weights
    noisy_weight: float = 0.5
    # where the networks and the learner run; "cuda" raises without a card
    device: str = "cuda"


class _NStepLane:
    """Per-lane n-step accumulator feeding the shared prioritized replay."""

    def __init__(self, gamma: float, n_step: int):
        self.gamma = gamma
        self.n_step = n_step
        self.pending: List[Tuple] = []  # (s, a, r, noisy)

    def push(self, buf: PrioritizedReplay, s, a, r, s2, done, mask2,
             noisy: bool = False) -> None:
        self.pending.append((s, a, r, noisy))
        while self.pending and (len(self.pending) >= self.n_step or done):
            ret, disc = 0.0, 1.0
            any_noisy = False
            for (_, _, r_i, nz_i) in self.pending[: self.n_step]:
                ret += disc * r_i
                disc *= self.gamma
                any_noisy = any_noisy or nz_i
            s0, a0 = self.pending[0][0], self.pending[0][1]
            # an n-step return is only as trustworthy as its noisiest term
            buf.add(s0, a0, ret, s2, done, mask2=mask2, discount=disc,
                    noisy=any_noisy)
            self.pending.pop(0)
            if not done:
                break


def train_apex(
    env_factory,
    n_iterations: int = 300,
    cfg: Optional[ApexConfig] = None,
    steps_per_iteration: int = 10,
) -> TrainResult:
    """Actors run as vector lanes.  ``env_factory`` is called once with
    index 0 — pass a scalar LoopTuneEnv factory (actor lanes get the ε-ladder
    plus per-lane rng seeds, sharing the env's benchmarks/backend/cache) or
    return a ready VecLoopTuneEnv.  One iteration ~ one episode per actor
    (paper: episode of 10 actions, then net updates)."""
    cfg = cfg or ApexConfig()
    enc_cfg = cfg.encoder.resolved(cfg.hidden)
    venv = VecLoopTuneEnv.ensure(
        env_factory(0), cfg.n_actors, seed=cfg.seed,
        featurizer=get_encoder(enc_cfg.kind).featurizer(enc_cfg),
        backend=cfg.backend)
    net = build_network("dueling", enc_cfg, venv.n_actions, cfg.device)
    n = venv.n_envs
    online = net.init(cfg.seed)
    target = copy.deepcopy(online).requires_grad_(False)
    opt = make_adam(online, cfg.lr)
    buf = PrioritizedReplay(cfg.buffer_size, venv.state_dim,
                            alpha=cfg.per_alpha, beta0=cfg.per_beta0)
    score = make_score_fn(net)
    params_ref = [online]

    eps = epsilon_ladder(n, cfg.eps_base, cfg.eps_alpha)
    lane_rngs = [np.random.default_rng(cfg.seed * 1000 + i) for i in range(n)]
    lanes = [_NStepLane(cfg.gamma, cfg.n_step) for _ in range(n)]

    def policy(obs, mask):
        return epsilon_greedy_batch(score(online, obs), mask, eps, lane_rngs), {}

    obs = venv.reset()
    ep_rewards = np.zeros(n, np.float32)
    finished: list = []
    rewards, times = [], []
    updates = 0
    step_debt = 0  # env steps not yet consumed by a learner update
    t_start = time.perf_counter()
    rng = np.random.default_rng(cfg.seed + 999)
    for it in range(n_iterations):
        batch = collect_vec_rollout(venv, policy, steps_per_iteration, obs,
                                    ep_rewards, finished)
        obs = batch.final_obs
        for t in range(batch.obs.shape[0]):
            done_t = batch.dones[t]
            for i in range(n):
                lanes[i].push(buf, batch.obs[t, i], int(batch.actions[t, i]),
                              float(batch.rewards[t, i]), batch.next_obs[t, i],
                              bool(done_t[i]), batch.next_masks[t, i],
                              noisy=bool(batch.noisy[t, i]))
        if buf.size >= cfg.warmup_steps:
            # one update per post-warmup update_every env steps, remainder
            # carried over (pre-warmup steps never accrue update debt)
            step_debt += batch.n_steps
            n_updates, step_debt = divmod(step_debt, cfg.update_every)
            for _ in range(n_updates):
                (s, a, r, s2, d, m2, disc, idx), w = buf.sample(
                    cfg.batch_size, rng)
                # noisy-marked transitions learn at reduced weight, on top
                # of the importance-sampling correction
                w = w * np.where(buf.noisy[idx], cfg.noisy_weight, 1.0)
                _, td = q_update(
                    online, target, opt,
                    batch_to_device((s, a, r, s2, d, m2, disc), net.device),
                    torch.as_tensor(w, dtype=torch.float32, device=net.device))
                buf.update_priorities(idx, td.cpu().numpy())
                updates += 1
                if updates % cfg.target_sync_every == 0:
                    target.load_state_dict(online.state_dict())
            # the target copies above are queued after the last read-back
            sync_device(net.device)
        recent = finished[-5 * n:]
        rewards.append(float(np.mean(recent)) if recent else 0.0)
        times.append(time.perf_counter() - t_start)
    mstats = getattr(venv.backend, "measure_stats", None)
    extra = {"updates": updates,
             "measure": mstats() if mstats is not None else {}}
    return TrainResult("apex_dqn", online, make_masked_act(score)(params_ref),
                       rewards, times, extra=extra,
                       meta=checkpoint_meta("dueling", enc_cfg, venv.actions,
                                            venv.state_dim,
                                            surrogate=cfg.surrogate,
                                            backend=venv.backend_name,
                                            peak=venv.peak,
                                            measure=measure_settings(
                                                venv.backend)))
