"""DQN (Mnih et al. 2013) with Double-DQN targets, in PyTorch.

The paper's baseline "DQN" trainer: uniform replay, ε-greedy exploration,
target network, Huber loss.  Rollouts come from a :class:`VecLoopTuneEnv`
lane fleet through the shared batched-rollout helper — one Q call on the
network's device and one batched backend call per step for all lanes.
APEX_DQN (the paper's winner) extends this with prioritized replay, n-step
returns and the ε-ladder actor fleet — see ``apex_dqn.py``.

The update is the JAX package's: the double-DQN target under
``torch.no_grad()`` (its ``stop_gradient``), the weighted Huber loss, and
``torch.optim.Adam`` with the hand-written JAX Adam's constants (β 0.9 /
0.999, ε 1e-8 outside the square root of the bias-corrected second
moment), which computes the same step.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .encoders import (EncoderConfig, build_network, checkpoint_meta,
                       get_encoder, make_score_fn)
from .env import LoopTuneEnv
from .measure import measure_settings
from .networks import make_adam, masked_logits
from .replay import ReplayBuffer
from .rl_common import (TrainResult, collect_vec_rollout, epsilon_greedy_batch,
                        make_masked_act, sync_device, to_device)
from .vec_env import VecLoopTuneEnv


@dataclass
class DQNConfig:
    hidden: Tuple[int, ...] = (256, 256)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    lr: float = 1e-3
    gamma: float = 0.99
    batch_size: int = 64
    buffer_size: int = 50_000
    n_envs: int = 4  # vectorized rollout lanes
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 5_000
    target_sync_every: int = 200  # learner updates between target syncs
    update_every: int = 1  # env steps per learner update
    warmup_steps: int = 200
    double: bool = True
    seed: int = 0
    # surrogate policy the tuner should use with this checkpoint's policy
    # ("auto" | "off") — persisted via checkpoint_meta
    surrogate: str = "auto"
    # reward-source executor for the rollout fleet, by registry name
    # ("numpy" | "torch" | "tpu" | "auto"; see core.backend.make_backend).
    # None = keep the executor of the env the factory provides.  The
    # resolved name is persisted via checkpoint_meta.
    backend: Optional[str] = None
    # learner weight for transitions whose reward the measurement
    # guardrails flagged noisy
    noisy_weight: float = 0.5
    # where the networks and the learner run; "cuda" raises without a card
    device: str = "cuda"


def q_update(online: nn.Module, target: nn.Module, opt: torch.optim.Optimizer,
             batch, weights, double: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Q-learning step on tensors already on the device: updates
    ``online`` in place through ``opt``; returns ``(loss, td)`` on the
    device (nothing is read back, so the step stays queued)."""
    s, a, r, s2, done, mask2, disc = batch
    q_sa = online(s).gather(1, a[:, None])[:, 0]
    with torch.no_grad():
        q2_target = target(s2)
        if double:
            a2 = masked_logits(online(s2), mask2).argmax(dim=1)
            q2 = q2_target.gather(1, a2[:, None])[:, 0]
        else:
            q2 = masked_logits(q2_target, mask2).max(dim=1).values
        y = r + disc * (1.0 - done) * q2
    td = q_sa - y
    abs_td = td.abs()
    loss = torch.where(abs_td < 1.0, 0.5 * td * td, abs_td - 0.5)
    loss = (weights * loss).mean()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach(), td.detach()


def batch_to_device(sample, device: torch.device):
    """A replay sample ``(s, a, r, s2, done, mask2, disc)`` as tensors on
    the device (one copy each): the actions int64, the mask bool, the rest
    float32."""
    return to_device(sample, device)


def train_dqn(
    env: Union[LoopTuneEnv, VecLoopTuneEnv],
    n_iterations: int = 300,
    cfg: Optional[DQNConfig] = None,
    log_every: int = 10,
) -> TrainResult:
    """One iteration = one vectorized episode: every lane plays its 10-action
    episode (paper: 'the optimizer applies the episode of 10 actions and
    updates the neural network'), then the learner consumes the batch and
    the card is synchronised before the next rollout."""
    cfg = cfg or DQNConfig()
    enc_cfg = cfg.encoder.resolved(cfg.hidden)
    venv = VecLoopTuneEnv.ensure(
        env, cfg.n_envs, seed=cfg.seed,
        featurizer=get_encoder(enc_cfg.kind).featurizer(enc_cfg),
        backend=cfg.backend)
    net = build_network("q", enc_cfg, venv.n_actions, cfg.device)
    n = venv.n_envs
    rng = np.random.default_rng(cfg.seed)
    online = net.init(cfg.seed)
    target = copy.deepcopy(online).requires_grad_(False)
    opt = make_adam(online, cfg.lr)
    buf = ReplayBuffer(cfg.buffer_size, venv.state_dim)
    score = make_score_fn(net)
    params_ref = [online]

    steps_seen = [0]

    def policy(obs, mask):
        eps = cfg.eps_end + (cfg.eps_start - cfg.eps_end) * max(
            0.0, 1.0 - steps_seen[0] / cfg.eps_decay_steps)
        q = score(online, obs)
        steps_seen[0] += n
        return epsilon_greedy_batch(q, mask, eps, rng), {}

    obs = venv.reset()
    ep_rewards = np.zeros(n, np.float32)
    finished: list = []
    rewards, times = [], []
    updates = 0
    step_debt = 0  # env steps not yet consumed by a learner update
    t_start = time.perf_counter()
    for it in range(n_iterations):
        n_done_before = len(finished)
        batch = collect_vec_rollout(venv, policy, venv.episode_len, obs,
                                    ep_rewards, finished)
        obs = batch.final_obs
        for t in range(batch.obs.shape[0]):
            for i in range(n):
                buf.add(batch.obs[t, i], int(batch.actions[t, i]),
                        float(batch.rewards[t, i]), batch.next_obs[t, i],
                        bool(batch.dones[t, i]), mask2=batch.next_masks[t, i],
                        discount=cfg.gamma, noisy=bool(batch.noisy[t, i]))
        if buf.size >= cfg.warmup_steps:
            # one update per post-warmup update_every env steps, remainder
            # carried over (pre-warmup steps never accrue update debt)
            step_debt += batch.n_steps
            n_updates, step_debt = divmod(step_debt, cfg.update_every)
            for _ in range(n_updates):
                s, a_, r_, s2, d_, m2, disc, idx = buf.sample(cfg.batch_size, rng)
                # noisy-marked transitions learn at reduced weight
                w = np.where(buf.noisy[idx], cfg.noisy_weight, 1.0)
                q_update(online, target, opt,
                         batch_to_device((s, a_, r_, s2, d_, m2, disc), net.device),
                         torch.as_tensor(w, dtype=torch.float32, device=net.device),
                         cfg.double)
                updates += 1
                if updates % cfg.target_sync_every == 0:
                    target.load_state_dict(online.state_dict())
            # nothing above reads the device: drain the queued updates so
            # the next rollout's reward clocks time only their own launches
            sync_device(net.device)
        new_eps = finished[n_done_before:]
        rewards.append(float(np.mean(new_eps)) if new_eps else 0.0)
        times.append(time.perf_counter() - t_start)
    return TrainResult("dqn", online, make_masked_act(score)(params_ref),
                       rewards, times, extra={"updates": updates},
                       meta=checkpoint_meta("q", enc_cfg, venv.actions,
                                            venv.state_dim,
                                            surrogate=cfg.surrogate,
                                            backend=venv.backend_name,
                                            peak=venv.peak,
                                            measure=measure_settings(
                                                venv.backend)))
