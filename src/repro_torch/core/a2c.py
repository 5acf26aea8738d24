"""A2C — synchronous advantage actor-critic (the 1-core equivalent of A3C,
Mnih et al. 2016).

A3C's workers compute gradients asynchronously and ship them to a central
model; on one core the unbiased synchronous variant (A2C) is the standard
stand-in: the worker fleet is the lane dimension of a
:class:`VecLoopTuneEnv` stepped in lockstep through the shared
batched-rollout helper, and a single n-step actor-critic update is applied
per rollout.

The update is the JAX package's: the advantage ``ret - V(s)`` carries no
gradient (``.detach()``, its ``stop_gradient``), and the step is
``networks.clipped_step``.  The card is synchronised after each update, so
the next rollout's reward clocks time only their own launches.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .encoders import (EncoderConfig, build_network, checkpoint_meta,
                       get_encoder, make_score_fn)
from .measure import measure_settings
from .networks import actor_critic_terms, clipped_step, make_adam
from .rl_common import (TrainResult, collect_vec_rollout, make_masked_act,
                        sample_masked, sync_device, to_device)
from .vec_env import VecLoopTuneEnv


@dataclass
class A2CConfig:
    hidden: Tuple[int, ...] = (256, 256)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    lr: float = 7e-4
    gamma: float = 0.99
    n_envs: int = 8
    rollout_len: int = 10
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    seed: int = 0
    # surrogate policy the tuner should use with this checkpoint's policy
    # ("auto" | "off") — persisted via checkpoint_meta
    surrogate: str = "auto"
    # reward-source executor for the rollout fleet, by registry name
    # ("numpy" | "torch" | "tpu" | "auto"; see core.backend.make_backend).
    # None = keep the executor of the env the factory provides.  The
    # resolved name is persisted via checkpoint_meta.
    backend: Optional[str] = None
    # where the network and the learner run; "cuda" raises without a card
    device: str = "cuda"


def update(module: nn.Module, opt: torch.optim.Optimizer, batch,
           cfg: A2CConfig) -> torch.Tensor:
    """One n-step actor-critic step on tensors on the device ``(s, a, ret,
    mask)``; returns the loss, unread."""
    s, a, ret, mask = batch
    logp, value, entropy = actor_critic_terms(module, s, a, mask)
    adv = (ret - value).detach()
    pg = -(logp * adv).mean()
    v_loss = torch.mean(torch.square(value - ret))
    total = pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
    clipped_step(module, opt, total, cfg.max_grad_norm)
    return total.detach()


def n_step_returns(rewards, dones, bootstrap, gamma):
    """Discounted returns (T, N) of a rollout, bootstrapped from the value
    of the state after its last step."""
    t_len, n = rewards.shape
    ret = np.zeros((t_len, n), np.float32)
    nxt = bootstrap
    for t in reversed(range(t_len)):
        nxt = rewards[t] + gamma * (1.0 - dones[t]) * nxt
        ret[t] = nxt
    return ret


def train_a2c(env_factory, n_iterations: int = 300,
              cfg: Optional[A2CConfig] = None) -> TrainResult:
    """The worker fleet steps as vectorized lanes.  ``env_factory`` is
    called once with index 0 — pass a scalar LoopTuneEnv factory (lanes are
    differentiated by per-lane rng seeds ``cfg.seed + lane``, sharing the
    env's benchmarks/backend/cache) or return a ready VecLoopTuneEnv."""
    cfg = cfg or A2CConfig()
    enc_cfg = cfg.encoder.resolved(cfg.hidden)
    rng = np.random.default_rng(cfg.seed)
    venv = VecLoopTuneEnv.ensure(
        env_factory(0), cfg.n_envs, seed=cfg.seed,
        featurizer=get_encoder(enc_cfg.kind).featurizer(enc_cfg),
        backend=cfg.backend)
    net = build_network("actor_critic", enc_cfg, venv.n_actions, cfg.device)
    n_envs = venv.n_envs
    module = net.init(cfg.seed)
    opt = make_adam(module, cfg.lr)
    params_ref = [module]

    def policy(obs, mask):
        logits, _ = net.batch(module, obs)
        a, _ = sample_masked(logits.cpu().numpy(), mask, rng)
        return a, {}

    obs = venv.reset()
    ep_rewards = np.zeros(n_envs, np.float32)
    finished: list = []
    rewards_log, times = [], []
    noisy_steps = total_steps = 0  # measurement-guardrail observability
    updates = 0
    t_start = time.perf_counter()
    t_len = cfg.rollout_len

    for it in range(n_iterations):
        batch = collect_vec_rollout(venv, policy, t_len, obs, ep_rewards,
                                    finished)
        obs = batch.final_obs
        noisy_steps += int(batch.noisy.sum())
        total_steps += batch.noisy.size
        boot = net.batch(module, obs)[1].cpu().numpy().astype(np.float32)
        ret = n_step_returns(batch.rewards, batch.dones, boot, cfg.gamma)
        update(module, opt, to_device([batch.flat(x) for x in
                                       (batch.obs, batch.actions, ret, batch.masks)],
                                      net.device), cfg)
        updates += 1
        sync_device(net.device)  # the update is queued: drain it before the rewards
        rewards_log.append(float(np.mean(finished[-20:])) if finished else 0.0)
        times.append(time.perf_counter() - t_start)
    return TrainResult("a2c", module,
                       make_masked_act(make_score_fn(net))(params_ref),
                       rewards_log, times,
                       extra={"noisy_frac": (noisy_steps / total_steps
                                             if total_steps else 0.0),
                              "updates": updates},
                       meta=checkpoint_meta("actor_critic", enc_cfg,
                                            venv.actions, venv.state_dim,
                                            surrogate=cfg.surrogate,
                                            backend=venv.backend_name,
                                            peak=venv.peak,
                                            measure=measure_settings(
                                                venv.backend)))
