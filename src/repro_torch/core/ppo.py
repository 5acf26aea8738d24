"""PPO (Schulman et al. 2017): clipped surrogate + GAE(λ), minibatch epochs.

The paper's second-best trainer (Fig. 7: converges ~1000 iters to ~8% of
peak).  Rollouts come from a :class:`VecLoopTuneEnv` lane fleet via the
shared batched-rollout helper; the policy is a masked categorical over the
action space, sampled from one batched network call per step.

The update is the JAX package's: advantages normalised with the population
standard deviation (``jnp.std``'s ddof 0), the global-norm clip
``min(1, max_norm / (norm + 1e-8))`` and the hand-written Adam, which
``torch.optim.Adam`` computes (``networks.clipped_step``).  Each
iteration's minibatch updates stay queued on the card until
``rl_common.sync_device`` drains them before the next rollout, whose
rewards are timed launches.
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
class PPOConfig:
    hidden: Tuple[int, ...] = (256, 256)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    n_envs: int = 8
    rollout_len: int = 40  # env steps per env per iteration
    n_epochs: int = 4
    n_minibatches: int = 4
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
           cfg: PPOConfig) -> torch.Tensor:
    """One clipped-surrogate step on a minibatch of tensors on the device
    ``(s, a, logp_old, adv, ret, mask)``; returns the loss, unread."""
    s, a, logp_old, adv, ret, mask = batch
    logp, value, entropy = actor_critic_terms(module, s, a, mask)
    ratio = torch.exp(logp - logp_old)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(ratio * adv_n,
                        torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv_n).mean()
    v_loss = torch.mean(torch.square(value - ret))
    total = pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
    clipped_step(module, opt, total, cfg.max_grad_norm)
    return total.detach()


def gae(rewards, values, dones, last_value, gamma, lam):
    """rewards/values/dones: (T, N).  Returns (advantages, returns)."""
    t_len, n = rewards.shape
    adv = np.zeros((t_len, n), np.float32)
    last = np.zeros(n, np.float32)
    next_v = last_value
    for t in reversed(range(t_len)):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_v * nonterm - values[t]
        last = delta + gamma * lam * nonterm * last
        adv[t] = last
        next_v = values[t]
    return adv, adv + values


def train_ppo(
    env_factory,
    n_iterations: int = 300,
    cfg: Optional[PPOConfig] = None,
) -> TrainResult:
    """Rollouts are collected over vectorized lanes.  ``env_factory`` is
    called once with index 0 — pass a scalar LoopTuneEnv factory (lanes are
    differentiated by per-lane rng seeds ``cfg.seed + lane``, sharing the
    env's benchmarks/backend/cache) or return a ready VecLoopTuneEnv."""
    cfg = cfg or PPOConfig()
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
        logits, value = net.batch(module, obs)
        a, logp = sample_masked(logits.cpu().numpy(), mask, rng)
        return a, {"logp": logp, "value": value.cpu().numpy().astype(np.float32)}

    obs = venv.reset()
    ep_rewards = np.zeros(n_envs, np.float32)
    finished: list = []
    rewards_log, times = [], []
    noisy_steps = total_steps = 0  # measurement-guardrail observability
    updates = 0
    t_start = time.perf_counter()
    t_len, n = cfg.rollout_len, n_envs

    for it in range(n_iterations):
        batch = collect_vec_rollout(venv, policy, t_len, obs, ep_rewards,
                                    finished)
        obs = batch.final_obs
        noisy_steps += int(batch.noisy.sum())
        total_steps += batch.noisy.size
        last_v = net.batch(module, obs)[1].cpu().numpy().astype(np.float32)
        adv, ret = gae(batch.rewards, batch.aux["value"], batch.dones, last_v,
                       cfg.gamma, cfg.lam)

        data = (batch.flat(batch.obs), batch.flat(batch.actions),
                batch.flat(batch.aux["logp"]), batch.flat(adv),
                batch.flat(ret), batch.flat(batch.masks))
        idx_all = np.arange(t_len * n)
        mb = t_len * n // cfg.n_minibatches
        for _ in range(cfg.n_epochs):
            rng.shuffle(idx_all)
            for k in range(cfg.n_minibatches):
                sel = idx_all[k * mb:(k + 1) * mb]
                update(module, opt, to_device([d[sel] for d in data], net.device), cfg)
                updates += 1
        # nothing above reads the device: drain the queued updates so the
        # next rollout's reward clocks time only their own launches
        sync_device(net.device)
        rewards_log.append(float(np.mean(finished[-20:])) if finished else 0.0)
        times.append(time.perf_counter() - t_start)
    return TrainResult("ppo", module,
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
