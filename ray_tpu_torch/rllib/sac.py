"""SAC's learner and env runner: continuous-action soft actor-critic with
a squashed-Gaussian policy (port of ``ray_tpu/rllib/sac.py``).

Role-equivalent to the reference's SAC
(reference: rllib/algorithms/sac/sac.py:31 — off-policy, twin Q networks,
tanh-squashed Gaussian actor, automatic entropy-temperature tuning;
sac_torch_learner computes the actor/critic/alpha losses).  The whole
update (twin critics, actor, alpha, Polyak targets) runs on the learner's
device (the card unless ``device="cpu"``), in the JAX package's order.
``SACConfig`` and the ``SAC`` algorithm drive runner actors (granted no
card, so built with ``device="cpu"``); the learner stays in the driver, on
the card unless the config says ``device="cpu"``.

Includes PendulumEnv — the classic continuous-control benchmark (public
textbook dynamics, same constants as gym's pendulum.py), so nothing needs
gymnasium.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

import ray_tpu_torch
from ..device import DeviceLike, resolve_device
from .learner import (Program, _he_normal, _linear, _set_linear,
                      host_floats, is_state, make_adam, params_state,
                      set_grads, to_device)


class PendulumEnv:
    """Pendulum-v1 semantics: swing up and hold; obs [cos th, sin th,
    thdot], action torque in [-2, 2], reward -(th^2 + .1 thdot^2 + .001
    a^2), 200-step episodes (truncation only)."""

    observation_size = 3
    observation_shape = (3,)
    action_size = 1
    action_low = -2.0
    action_high = 2.0
    max_episode_steps = 200

    MAX_SPEED = 8.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.th = 0.0
        self.thdot = 0.0
        self.steps = 0

    def _obs(self) -> np.ndarray:
        return np.array([math.cos(self.th), math.sin(self.th), self.thdot],
                        np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.th = float(self.rng.uniform(-math.pi, math.pi))
        self.thdot = float(self.rng.uniform(-1.0, 1.0))
        self.steps = 0
        return self._obs()

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool]:
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          self.action_low, self.action_high))
        th_norm = ((self.th + math.pi) % (2 * math.pi)) - math.pi
        cost = th_norm**2 + 0.1 * self.thdot**2 + 0.001 * u**2
        acc = (3 * self.G / (2 * self.L) * math.sin(self.th)
               + 3.0 / (self.M * self.L**2) * u)
        self.thdot = float(np.clip(self.thdot + acc * self.DT,
                                   -self.MAX_SPEED, self.MAX_SPEED))
        self.th += self.thdot * self.DT
        self.steps += 1
        return self._obs(), -cost, False, self.steps >= self.max_episode_steps


def _mlp_init(gen: torch.Generator, sizes: Sequence[int]) -> nn.ModuleList:
    """He-normal ``nn.Linear`` layers with zero biases, from ``gen`` (on
    the CPU)."""
    layers = nn.ModuleList()
    with torch.no_grad():
        for m, n in zip(sizes[:-1], sizes[1:]):
            layer = _linear(m, n)
            _he_normal(layer.weight, m, gen)
            nn.init.zeros_(layer.bias)
            layers.append(layer)
    return layers


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor, final_act=None):
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def _mlp_from_jax(tree) -> nn.ModuleList:
    """A JAX ``_mlp_init`` list of {"w", "b"} as ``nn.Linear`` layers."""
    layers = nn.ModuleList()
    for layer in tree:
        w, b = (np.array(layer[k], np.float32) for k in ("w", "b"))
        lin = _linear(*w.shape)
        _set_linear(lin, w, b)
        layers.append(lin)
    return layers


def _sech2(x: torch.Tensor) -> torch.Tensor:
    """1 - tanh(x)^2 as sech(x)^2 = 4 t / (1 + t)^2, t = exp(-2 |x|).  The
    JAX package computes 1 - a^2 from a = tanh(x) rounded to fp32, which
    near |a| = 1 keeps little but a's rounding: there two fp32 tanh
    implementations (the card's and the CPU's, or XLA's) give
    log(1 - a^2 + 1e-6) up to 0.3 apart a sample.  This form is accurate
    to a few ulps everywhere and equals the JAX value to fp32 where tanh is
    not saturated."""
    t = torch.exp(-2 * x.abs())
    return 4 * t / (1 + t) ** 2


class SACParams(nn.Module):
    """The actor, the twin critics and their targets, and the 0-d
    ``log_alpha``."""

    def __init__(self, actor, q1, q2, q1_target, q2_target,
                 log_alpha: float = 0.0):
        super().__init__()
        self.actor, self.q1, self.q2 = actor, q1, q2
        self.q1_target, self.q2_target = q1_target, q2_target
        self.q1_target.requires_grad_(False)
        self.q2_target.requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.tensor(float(log_alpha)))


def sac_params_from_jax(tree, device: DeviceLike = None) -> SACParams:
    """The port's ``SACParams`` holding a JAX ``SACParams`` of numpy arrays
    (``jax.tree.map(np.asarray, learner.params)``)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    params = SACParams(*(_mlp_from_jax(tree[k]) for k in
                         ("actor", "q1", "q2", "q1_target", "q2_target")),
                       log_alpha=float(np.asarray(tree["log_alpha"])))
    return params.to(resolve_device(device))


class SACLearner:
    """Twin-Q + squashed-Gaussian actor + auto-alpha.

    reference: sac_torch_learner.py compute_loss_for_module — critic target
    uses min(Q1', Q2') - alpha * logp of a fresh next-action sample; actor
    maximizes min(Q) - alpha * logp; alpha tracks -|A| target entropy."""

    LOG_STD_MIN = -20.0
    LOG_STD_MAX = 2.0

    def __init__(self, obs_size: int, action_size: int, *,
                 action_low: float, action_high: float,
                 lr: float = 3e-4, gamma: float = 0.99, tau: float = 0.005,
                 hidden: int = 256, seed: int = 0,
                 target_entropy: Optional[float] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.gamma = gamma
        self.tau = tau
        self.action_size = action_size
        self.scale = (action_high - action_low) / 2.0
        self.bias = (action_high + action_low) / 2.0
        self.target_entropy = (-float(action_size)
                               if target_entropy is None else target_entropy)
        gen = torch.Generator().manual_seed(seed)
        actor = _mlp_init(gen, [obs_size, hidden, hidden, 2 * action_size])
        q1 = _mlp_init(gen, [obs_size + action_size, hidden, hidden, 1])
        q2 = _mlp_init(gen, [obs_size + action_size, hidden, hidden, 1])
        self.params = SACParams(actor, q1, q2, copy.deepcopy(q1),
                                copy.deepcopy(q2)).to(self.device)
        p = self.params
        self.opts = {
            "actor": make_adam(p.actor.parameters(), lr, 1e-8, self.device),
            "q1": make_adam(p.q1.parameters(), lr, 1e-8, self.device),
            "q2": make_adam(p.q2.parameters(), lr, 1e-8, self.device),
            "alpha": make_adam([p.log_alpha], lr, 1e-8, self.device),
        }
        # The JAX learner splits a PRNG key per call; the port draws its
        # noise from this generator (seed + 7, as the JAX key).
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 7)
        self._program = Program("sac_update")

    # -- policy math ---------------------------------------------------------

    def _dist(self, actor, obs):
        out = _mlp_apply(actor, obs)
        mu, log_std = out[..., :self.action_size], out[..., self.action_size:]
        return mu, torch.clamp(log_std, self.LOG_STD_MIN, self.LOG_STD_MAX)

    def _sample_action(self, actor, obs, eps):
        """Reparameterized tanh-Gaussian sample from the standard normal
        noise ``eps`` + log-prob (with the tanh Jacobian correction
        log(1 - tanh(pre)^2 + 1e-6), ``_sech2`` for 1 - tanh^2)."""
        mu, log_std = self._dist(actor, obs)
        pre = mu + torch.exp(log_std) * eps
        logp = (-0.5 * (eps**2 + 2 * log_std + math.log(2 * math.pi))
                ).sum(-1)
        logp = logp - torch.log(_sech2(pre) + 1e-6).sum(-1)
        return torch.tanh(pre) * self.scale + self.bias, logp

    def _q(self, qp, obs, act):
        return _mlp_apply(qp, torch.cat(
            [obs, (act - self.bias) / self.scale], -1))[..., 0]

    def _step(self, name: str, params: List[nn.Parameter], loss) -> None:
        set_grads(params, torch.autograd.grad(loss, params))
        self.opts[name].step()

    def _update(self, batch: Dict[str, torch.Tensor], eps1: torch.Tensor,
                eps2: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update with the given noise: ``eps1`` for the next-state
        action of the critic target, ``eps2`` for the actor's action (the
        JAX update's draws from its keys k1 and k2)."""
        self._program(batch)
        p = self.params
        obs = batch["obs"]
        alpha = torch.exp(p.log_alpha.detach())

        # Critic target from the old actor and the old targets:
        # r + gamma (1-d) [min Q'(s', a') - alpha logp].
        with torch.no_grad():
            next_a, next_logp = self._sample_action(p.actor,
                                                    batch["next_obs"], eps1)
            q_next = torch.minimum(
                self._q(p.q1_target, batch["next_obs"], next_a),
                self._q(p.q2_target, batch["next_obs"], next_a),
            ) - alpha * next_logp
            target = (batch["rewards"]
                      + self.gamma * (1 - batch["dones"]) * q_next)

        q_losses = []
        for name in ("q1", "q2"):
            qp = getattr(p, name)
            loss = ((self._q(qp, obs, batch["actions"]) - target) ** 2
                    ).mean()
            self._step(name, list(qp.parameters()), loss)
            q_losses.append(loss.detach())

        # Actor: maximize min Q(s, pi(s)) - alpha logp against the NEW
        # critics, whose parameters get no gradient (autograd.grad is
        # taken for the actor's alone).
        a, logp = self._sample_action(p.actor, obs, eps2)
        q = torch.minimum(self._q(p.q1, obs, a), self._q(p.q2, obs, a))
        a_loss = (alpha * logp - q).mean()
        self._step("actor", list(p.actor.parameters()), a_loss)

        # Temperature: drive E[-logp] toward the target entropy.
        al_loss = -(torch.exp(p.log_alpha)
                    * (logp.detach() + self.target_entropy)).mean()
        self._step("alpha", [p.log_alpha], al_loss)

        # Polyak targets against the new critics.
        with torch.no_grad():
            for tgt, src in ((p.q1_target, p.q1), (p.q2_target, p.q2)):
                for t, o in zip(tgt.parameters(), src.parameters()):
                    t.mul_(1 - self.tau).add_(self.tau * o)
        return {"critic_loss": q_losses[0] + q_losses[1],
                "actor_loss": a_loss.detach(), "alpha": alpha,
                "entropy": -logp.detach().mean()}

    # -- API -----------------------------------------------------------------

    @torch.no_grad()
    def act(self, obs: np.ndarray, *, deterministic: bool = False):
        """Host-side action selection for env runners."""
        x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
        mu, log_std = self._dist(self.params.actor, x)
        if not deterministic:
            eps = torch.randn(mu.shape, generator=self._gen,
                              device=self.device)
            mu = mu + torch.exp(log_std) * eps
        return (torch.tanh(mu) * self.scale + self.bias).cpu().numpy()

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        mb = to_device(batch, self.device)
        shape = (len(mb["rewards"]), self.action_size)
        eps1, eps2 = (torch.randn(shape, generator=self._gen,
                                  device=self.device) for _ in range(2))
        return host_floats(self._update(mb, eps1, eps2))

    def get_actor_weights(self) -> Dict[str, torch.Tensor]:
        return params_state(self.params.actor)

    def set_weights(self, weights) -> None:
        """Every network and alpha from a ``params`` state dict, or a JAX
        ``SACParams`` of numpy arrays."""
        if not is_state(weights):
            weights = sac_params_from_jax(weights, "cpu").state_dict()
        self.params.load_state_dict(weights)


class ContinuousEnvRunner:
    """Vectorized continuous-action rollouts (SAC's off-policy runner;
    reference: single_agent_env_runner used by SAC with a connector turning
    episodes into transitions).

    A plain in-process object: it becomes an actor with the port's runtime,
    whose algorithms pass ``device="cpu"`` (the JAX actor pins itself to
    the CPU with ``JAX_PLATFORMS``; the port copies no such default)."""

    def __init__(self, env_cls, num_envs: int, *, action_size: int,
                 scale: float, bias: float, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.envs = [env_cls(seed=seed * 1000 + i) for i in range(num_envs)]
        self.obs = np.stack([e.reset() for e in self.envs])
        self.num_envs = num_envs
        self.action_size = action_size
        self.scale = scale
        self.bias = bias
        self._rng = np.random.default_rng(seed + 1)
        self._actor = None
        self._log_std_clip = (-20.0, 2.0)
        self.episode_returns = np.zeros(num_envs)
        self.completed: List[float] = []

    def set_actor_weights(self, weights, log_std_clip=(-20.0, 2.0)) -> bool:
        """The learner's ``get_actor_weights`` state, or the JAX actor's
        list of {"w", "b"} numpy arrays."""
        if is_state(weights):
            n = len(weights) // 2
            layers = nn.ModuleList(
                _linear(weights[f"{i}.weight"].shape[1],
                        weights[f"{i}.weight"].shape[0]) for i in range(n))
            layers.load_state_dict(weights)
        else:
            layers = _mlp_from_jax(weights)
        self._actor = layers.to(self.device)
        self._log_std_clip = tuple(log_std_clip)
        return True

    @torch.no_grad()
    def _act(self, eps: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(self.obs)).to(self.device)
        out = _mlp_apply(self._actor, x)
        a = self.action_size
        mu = out[..., :a]
        log_std = torch.clamp(out[..., a:], *self._log_std_clip)
        e = torch.from_numpy(eps).to(self.device)
        return (torch.tanh(mu + torch.exp(log_std) * e) * self.scale
                + self.bias).cpu().numpy()

    def sample_transitions(self, num_steps: int,
                           random_actions: bool = False):
        N = self.num_envs
        D = self.obs.shape[1]
        obs_b = np.empty((num_steps, N, D), np.float32)
        next_b = np.empty((num_steps, N, D), np.float32)
        act_b = np.empty((num_steps, N, self.action_size), np.float32)
        rew_b = np.empty((num_steps, N), np.float32)
        done_b = np.zeros((num_steps, N), np.float32)
        for t in range(num_steps):
            if random_actions or self._actor is None:
                acts = self._rng.uniform(
                    self.bias - self.scale, self.bias + self.scale,
                    (N, self.action_size)).astype(np.float32)
            else:
                eps = self._rng.standard_normal(
                    (N, self.action_size)).astype(np.float32)
                acts = self._act(eps)
            obs_b[t] = self.obs
            act_b[t] = acts
            for i, env in enumerate(self.envs):
                o, r, term, trunc = env.step(acts[i])
                rew_b[t, i] = r
                self.episode_returns[i] += r
                # done=termination only; truncation still bootstraps.
                done_b[t, i] = float(term)
                next_b[t, i] = o
                if term or trunc:
                    self.completed.append(float(self.episode_returns[i]))
                    self.episode_returns[i] = 0.0
                    o = env.reset()
                self.obs[i] = o
        out, self.completed = self.completed, []
        return {
            "obs": obs_b.reshape(-1, D),
            "next_obs": next_b.reshape(-1, D),
            "actions": act_b.reshape(-1, self.action_size),
            "rewards": rew_b.reshape(-1),
            "dones": done_b.reshape(-1),
            "episode_returns": np.asarray(out),
        }


#: The runner as an actor (the JAX package's ``ContinuousEnvRunner`` is one).
ContinuousEnvRunnerActor = ray_tpu_torch.remote(ContinuousEnvRunner)


class SACConfig:
    def __init__(self):
        self.env_cls = PendulumEnv
        self.num_env_runners = 1
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 32
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005
        self.hidden = 256
        self.buffer_size = 100_000
        self.batch_size = 256
        self.updates_per_round = 16
        self.warmup_steps = 1_000
        self.seed = 0
        # The learner's device (the card unless "cpu") and its starting
        # weights (a params state dict or a JAX SACParams tree), as
        # PPOConfig's.
        self.device = None
        self.initial_weights = None

    def environment(self, env_cls) -> "SACConfig":
        self.env_cls = env_cls
        return self

    def training(self, **kwargs) -> "SACConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown SAC option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "SAC":
        return SAC(self)


class SAC:
    """Off-policy loop: sample transitions -> replay buffer -> k updates ->
    actor-weight sync (reference: sac.py training_step)."""

    def __init__(self, config: SACConfig):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.config = config
        env = config.env_cls()
        obs_size = env.observation_size
        self.learner = SACLearner(
            obs_size, env.action_size,
            action_low=env.action_low, action_high=env.action_high,
            lr=config.lr, gamma=config.gamma, tau=config.tau,
            hidden=config.hidden, seed=config.seed, device=config.device,
        )
        if config.initial_weights is not None:
            self.learner.set_weights(config.initial_weights)
        scale = (env.action_high - env.action_low) / 2.0
        bias = (env.action_high + env.action_low) / 2.0
        self.runners = [
            ContinuousEnvRunnerActor.remote(
                config.env_cls, config.num_envs_per_runner,
                action_size=env.action_size, scale=scale, bias=bias,
                seed=config.seed + i, device="cpu")
            for i in range(config.num_env_runners)
        ]
        self._rng = np.random.default_rng(config.seed)
        self._buffer: Dict[str, np.ndarray] = {}
        self._buf_n = 0
        self._sync_weights()
        self.iteration = 0
        self.total_env_steps = 0
        self._recent: List[float] = []

    def _sync_weights(self):
        ref = ray_tpu_torch.put(self.learner.get_actor_weights())
        ray_tpu_torch.get([r.set_actor_weights.remote(ref)
                           for r in self.runners])

    def _add_to_buffer(self, batch):
        n = len(batch["rewards"])
        cap = self.config.buffer_size
        if not self._buffer:
            self._buffer = {
                k: np.empty((cap, *v.shape[1:]), v.dtype)
                for k, v in batch.items() if k != "episode_returns"
            }
            self._pos = 0
        for k, buf in self._buffer.items():
            data = batch[k]
            idx = (self._pos + np.arange(n)) % cap
            buf[idx] = data
        self._pos = (self._pos + n) % cap
        self._buf_n = min(self._buf_n + n, cap)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        warmup = self.total_env_steps < cfg.warmup_steps
        samples = ray_tpu_torch.get([
            r.sample_transitions.remote(cfg.rollout_fragment_length,
                                        random_actions=warmup)
            for r in self.runners
        ])
        for s in samples:
            self._recent.extend(s.pop("episode_returns").tolist())
            self._add_to_buffer(s)
            self.total_env_steps += len(s["rewards"])
        self._recent = self._recent[-50:]

        metrics: Dict[str, float] = {}
        if self._buf_n >= cfg.batch_size and not warmup:
            for _ in range(cfg.updates_per_round):
                idx = self._rng.integers(0, self._buf_n, cfg.batch_size)
                mb = {k: v[idx] for k, v in self._buffer.items()}
                metrics = self.learner.update_from_batch(mb)
            self._sync_weights()
        self.iteration += 1
        wall = time.perf_counter() - t0
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self.total_env_steps,
            "episode_return_mean": (float(np.mean(self._recent))
                                    if self._recent else float("nan")),
            "env_steps_per_sec": (
                len(samples) * cfg.rollout_fragment_length
                * cfg.num_envs_per_runner / max(wall, 1e-9)),
            **metrics,
        }

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
