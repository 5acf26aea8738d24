"""IMPALA (Espeholt et al. 2018): V-trace off-policy actor-critic.

Actors run a *stale* copy of the policy (synced every ``actor_sync_every``
iterations — modelling IMPALA's decoupled actor/learner lag on one core)
over :class:`VecLoopTuneEnv` lanes via the shared batched-rollout helper;
the learner corrects the off-policy-ness with V-trace importance weights.

The behaviour policy is a module of its own whose parameters are copied
from the learner's at each sync (``load_state_dict`` copies into the
actor's own tensors): Adam steps the learner's parameters in place, so an
aliased actor would be the learner, every importance ratio 1 and V-trace
plain A2C.  The target log-probabilities are the JAX package's numpy
arithmetic over the learner's logits; the step is
``networks.clipped_step``, and the card is synchronised after it.
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
from .networks import MASK_SENTINEL, actor_critic_terms, clipped_step, make_adam
from .rl_common import (TrainResult, collect_vec_rollout, make_masked_act,
                        sample_masked, sync_device, to_device)
from .vec_env import VecLoopTuneEnv


@dataclass
class ImpalaConfig:
    hidden: Tuple[int, ...] = (256, 256)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    lr: float = 3e-4
    gamma: float = 0.99
    n_envs: int = 8
    rollout_len: int = 20
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    rho_bar: float = 1.0
    c_bar: float = 1.0
    actor_sync_every: int = 4  # iterations of lag between actor & learner
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
    # where the networks and the learner run; "cuda" raises without a card
    device: str = "cuda"


def vtrace(behavior_logp, target_logp, rewards, values, dones, bootstrap,
           gamma, rho_bar, c_bar):
    """V-trace targets (T, N) — numpy reference implementation."""
    rho = np.minimum(np.exp(target_logp - behavior_logp), rho_bar)
    c = np.minimum(np.exp(target_logp - behavior_logp), c_bar)
    t_len, n = rewards.shape
    vs = np.zeros((t_len, n), np.float32)
    acc = np.zeros(n, np.float32)
    next_values = np.concatenate([values[1:], bootstrap[None]], 0)
    for t in reversed(range(t_len)):
        nonterm = 1.0 - dones[t]
        delta = rho[t] * (rewards[t] + gamma * next_values[t] * nonterm
                          - values[t])
        acc = delta + gamma * c[t] * nonterm * acc
        vs[t] = values[t] + acc
    vs_next = np.concatenate([vs[1:], bootstrap[None]], 0)
    pg_adv = rho * (rewards + gamma * vs_next * (1.0 - dones) - values)
    return vs, pg_adv


def target_logp(logits: np.ndarray, masks: np.ndarray,
                actions: np.ndarray) -> np.ndarray:
    """log π(a|s) of the learner's logits ``(T, N, A)`` at the rollout's
    actions, masked by the sentinel and floored at 1e-12 — in numpy, as
    the JAX package computes it."""
    logits = np.array(logits)  # writable copy
    logits[~masks] = MASK_SENTINEL
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    return np.log(np.maximum(
        np.take_along_axis(p, actions[..., None].astype(np.int64), -1)[..., 0],
        1e-12))


def update(module: nn.Module, opt: torch.optim.Optimizer, batch,
           cfg: ImpalaConfig) -> torch.Tensor:
    """One V-trace actor-critic step on tensors on the device ``(s, a, vs,
    pg_adv, mask)``; returns the loss, unread."""
    s, a, vs, pg_adv, mask = batch
    logp, value, entropy = actor_critic_terms(module, s, a, mask)
    pg = -(logp * pg_adv).mean()
    v_loss = torch.mean(torch.square(value - vs))
    total = pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
    clipped_step(module, opt, total, cfg.max_grad_norm)
    return total.detach()


def train_impala(env_factory, n_iterations: int = 300,
                 cfg: Optional[ImpalaConfig] = None) -> TrainResult:
    """Stale-policy actors run as vectorized lanes.  ``env_factory`` is
    called once with index 0 — pass a scalar LoopTuneEnv factory (lanes are
    differentiated by per-lane rng seeds ``cfg.seed + lane``, sharing the
    env's benchmarks/backend/cache) or return a ready VecLoopTuneEnv."""
    cfg = cfg or ImpalaConfig()
    enc_cfg = cfg.encoder.resolved(cfg.hidden)
    rng = np.random.default_rng(cfg.seed)
    venv = VecLoopTuneEnv.ensure(
        env_factory(0), cfg.n_envs, seed=cfg.seed,
        featurizer=get_encoder(enc_cfg.kind).featurizer(enc_cfg),
        backend=cfg.backend)
    net = build_network("actor_critic", enc_cfg, venv.n_actions, cfg.device)
    n_envs = venv.n_envs
    module = net.init(cfg.seed)
    actor = net.init(cfg.seed).requires_grad_(False)  # the stale behaviour policy
    opt = make_adam(module, cfg.lr)
    params_ref = [module]

    def policy(obs, mask):
        logits, _ = net.batch(actor, obs)
        a, logp = sample_masked(logits.cpu().numpy(), mask, rng)
        return a, {"logp": logp}

    obs = venv.reset()
    ep_rewards = np.zeros(n_envs, np.float32)
    finished: list = []
    rewards_log, times = [], []
    noisy_steps = total_steps = 0  # measurement-guardrail observability
    updates = 0
    t_start = time.perf_counter()
    t_len, n = cfg.rollout_len, n_envs

    for it in range(n_iterations):
        if it % cfg.actor_sync_every == 0:
            actor.load_state_dict(module.state_dict())  # copies, never aliases
        batch = collect_vec_rollout(venv, policy, t_len, obs, ep_rewards,
                                    finished)
        obs = batch.final_obs
        noisy_steps += int(batch.noisy.sum())
        total_steps += batch.noisy.size
        S, A, M = batch.obs, batch.actions, batch.masks
        R, D, BLP = batch.rewards, batch.dones, batch.aux["logp"]
        # learner: evaluate target policy on the rollout, V-trace correct
        logits_t, values_t = net.batch(module, batch.flat(S))
        tlp = target_logp(logits_t.cpu().numpy().reshape(t_len, n, -1), M, A)
        values_t = values_t.cpu().numpy().reshape(t_len, n)
        boot = net.batch(module, obs)[1].cpu().numpy().astype(np.float32)
        vs, pg_adv = vtrace(BLP, tlp.astype(np.float32), R, values_t, D, boot,
                            cfg.gamma, cfg.rho_bar, cfg.c_bar)
        update(module, opt, to_device([batch.flat(x) for x in (S, A, vs, pg_adv, M)],
                                      net.device), cfg)
        updates += 1
        sync_device(net.device)  # the update is queued: drain it before the rewards
        rewards_log.append(float(np.mean(finished[-20:])) if finished else 0.0)
        times.append(time.perf_counter() - t_start)
    return TrainResult("impala", module,
                       make_masked_act(make_score_fn(net))(params_ref),
                       rewards_log, times,
                       extra={"noisy_frac": (noisy_steps / total_steps
                                             if total_steps else 0.0),
                              "updates": updates, "actor": actor},
                       meta=checkpoint_meta("actor_critic", enc_cfg,
                                            venv.actions, venv.state_dim,
                                            surrogate=cfg.surrogate,
                                            backend=venv.backend_name,
                                            peak=venv.peak,
                                            measure=measure_settings(
                                                venv.backend)))
