"""DQN's learner: double-Q TD updates with a target network (port of
``ray_tpu/rllib/dqn.py``).

Role-equivalent to the reference's DQN learner (reference:
rllib/algorithms/dqn/dqn.py training_step: sample with epsilon-greedy ->
add to EpisodeReplayBuffer -> sample train batches -> Learner TD update with
double-Q + target net -> periodic target sync).  Online and target
networks live on the learner's device (the card unless ``device="cpu"``);
under a mesh each rank takes its rows of the batch and the gradients are
averaged over dp x fsdp.  ``DQNConfig`` and the ``DQN`` algorithm drive
env runner actors (granted no card, so built with ``device="cpu"``); the
learner stays in the driver, on the card unless the config says
``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

import ray_tpu_torch
from ..device import DeviceLike, resolve_device
from .learner import (Program, _fields, _he_normal, _linear, _orthogonal,
                      _set_linear, host_floats, is_state, make_adam,
                      mesh_shard, params_state, sgd_step, to_device)
from .replay import ReplayBuffer

#: The JAX ``QParams`` fields, in order.
Q_FIELDS = ("w1", "b1", "w2", "b2", "w3", "b3")


class QParams(nn.Module):
    """The Q-MLP: ``l{i}`` holds the JAX tree's ``w{i}`` transposed and
    ``b{i}``."""

    def __init__(self, obs_size: int, num_actions: int, hidden: int = 64):
        super().__init__()
        self.l1 = _linear(obs_size, hidden)
        self.l2 = _linear(hidden, hidden)
        self.l3 = _linear(hidden, num_actions)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return q_forward(self, obs)


def init_q(obs_size: int, num_actions: int, hidden: int = 64,
           seed: int = 0, device: DeviceLike = None) -> QParams:
    """He-normal hidden layers and an orthogonal (0.01) head, zero biases,
    as the JAX package draws them; drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed``, then moved."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = QParams(obs_size, num_actions, hidden)
    with torch.no_grad():
        for layer in (params.l1, params.l2):
            _he_normal(layer.weight, layer.in_features, gen)
            nn.init.zeros_(layer.bias)
        _orthogonal(params.l3, 0.01, gen)
    return params.to(dev)


def q_forward(params: QParams, obs: torch.Tensor) -> torch.Tensor:
    h = torch.relu(params.l1(obs))
    h = torch.relu(params.l2(h))
    return params.l3(h)


def q_params_from_jax(tree, device: DeviceLike = None) -> QParams:
    """The port's ``QParams`` holding a JAX ``QParams`` of numpy arrays (or
    the list ``DQNLearner.get_weights`` returns there)."""
    f = _fields(tree, Q_FIELDS)
    obs_size, hidden = f["w1"].shape
    params = QParams(obs_size, f["w3"].shape[1], hidden)
    for i, layer in enumerate((params.l1, params.l2, params.l3), 1):
        _set_linear(layer, f[f"w{i}"], f[f"b{i}"])
    return params.to(resolve_device(device))


def dqn_loss(params: QParams, target_params: QParams,
             batch: Dict[str, torch.Tensor], gamma: float):
    """Double-DQN Huber TD loss: (loss, {td_error_mean, qf_mean})."""
    q = q_forward(params, batch["obs"])
    q_sa = q.gather(1, batch["actions"].long()[:, None])[:, 0]
    with torch.no_grad():
        # Double DQN: online net picks a' (the first maximum, as
        # jnp.argmax), target net evaluates it (reference: dqn learner
        # uses double_q by default).
        next_a = torch.argmax(q_forward(params, batch["next_obs"]), dim=-1)
        next_q = q_forward(target_params, batch["next_obs"]).gather(
            1, next_a[:, None])[:, 0]
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * next_q
    td = q_sa - target
    # Huber loss keeps early-training TD spikes from blowing up Adam.
    loss = torch.mean(torch.where(td.abs() <= 1.0, 0.5 * td ** 2,
                                  td.abs() - 0.5))
    return loss, {"td_error_mean": td.detach().abs().mean(),
                  "qf_mean": q_sa.detach().mean()}


class DQNLearner:
    """Online + target params; the double-DQN TD update."""

    def __init__(self, obs_size: int, num_actions: int, *, lr: float,
                 gamma: float, grad_clip: float, hidden: int, seed: int,
                 mesh=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = init_q(obs_size, num_actions, hidden, seed,
                             self.device)
        self.target_params = init_q(obs_size, num_actions, hidden, seed,
                                    self.device).requires_grad_(False)
        self.opt = make_adam(self.params.parameters(), lr, 1e-8, self.device)
        self.gamma = gamma
        self.grad_clip = grad_clip
        self.mesh = mesh
        self._program = Program("dqn_update")

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return params_state(self.params)

    @torch.no_grad()
    def set_weights(self, weights) -> None:
        """Online and target networks from the port's ``get_weights`` state
        or a JAX ``QParams`` of numpy arrays (or its field list)."""
        if not is_state(weights):
            weights = q_params_from_jax(weights, "cpu").state_dict()
        self.params.load_state_dict(weights)
        self.target_params.load_state_dict(weights)

    def update_raw(self, batch: Dict[str, np.ndarray]):
        """One TD update, aux left ON DEVICE: a loop of K updates calls
        this so the host never blocks on loss readback mid-loop; only the
        loop's last aux is converted, once, by the caller."""
        mb = to_device(batch, self.device)
        self._program(mb)
        if self.mesh is not None:
            mb = mesh_shard(self.mesh, mb)
        loss, aux = dqn_loss(self.params, self.target_params, mb, self.gamma)
        aux["loss"] = loss
        return sgd_step(self.params, self.opt, loss, aux, self.grad_clip,
                        self.mesh)

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        # THE readback point for one-off callers (single update -> floats).
        return host_floats(self.update_raw(batch))

    @torch.no_grad()
    def sync_target(self):
        self.target_params.load_state_dict(self.params.state_dict())


class DQNConfig:
    """Fluent config (reference: algorithm_config.py AlgorithmConfig)."""

    def __init__(self):
        self.env_spec: Any = "CartPole-v1"
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 32
        self.lr = 5e-4
        self.gamma = 0.99
        self.hidden = 64
        self.buffer_size = 50_000
        self.train_batch_size = 64
        self.num_updates_per_iteration = 64
        self.target_update_freq = 500       # gradient steps between syncs
        self.learning_starts = 1_000        # env steps before updates begin
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 10_000   # env steps to anneal over
        self.grad_clip = 10.0
        self.seed = 0
        self.mesh = None
        # The learner's device (the card unless "cpu") and its starting
        # weights (get_weights state or a JAX QParams tree), as PPOConfig's.
        self.device = None
        self.initial_weights = None

    def environment(self, env: Any) -> "DQNConfig":
        self.env_spec = env
        return self

    def env_runners(self, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 8,
                    rollout_fragment_length: int = 32) -> "DQNConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "DQNConfig":
        for name, val in kwargs.items():
            if not hasattr(self, name):
                raise TypeError(f"unknown DQN config field {name!r}")
            setattr(self, name, val)
        return self

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    """The Algorithm: one train() = sample -> replay -> K TD updates -> sync
    (port of ``ray_tpu/rllib/dqn.py``'s)."""

    def __init__(self, config: DQNConfig):
        from .ppo import EnvRunnerActor

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.config = config
        self.runners = [
            EnvRunnerActor.remote(config.env_spec, config.num_envs_per_runner,
                                  seed=config.seed + i, device="cpu")
            for i in range(config.num_env_runners)
        ]
        info = ray_tpu_torch.get(self.runners[0].env_info.remote())
        self.learner = DQNLearner(
            info["observation_size"], info["num_actions"],
            lr=config.lr, gamma=config.gamma, grad_clip=config.grad_clip,
            hidden=config.hidden, seed=config.seed, mesh=config.mesh,
            device=config.device,
        )
        if config.initial_weights is not None:
            self.learner.set_weights(config.initial_weights)
        self.buffer = ReplayBuffer(
            config.buffer_size, info["observation_size"], seed=config.seed)
        self._sync_weights()
        self.iteration = 0
        self.total_env_steps = 0
        self.total_updates = 0
        self._recent_returns: List[float] = []

    def _sync_weights(self):
        ref = ray_tpu_torch.put(self.learner.get_weights())
        ray_tpu_torch.get([r.set_q_weights.remote(ref)
                           for r in self.runners])

    def epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.total_env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (
            cfg.epsilon_final - cfg.epsilon_initial)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        eps = self.epsilon()
        samples = ray_tpu_torch.get([
            r.sample_transitions.remote(cfg.rollout_fragment_length, eps)
            for r in self.runners
        ])
        n_steps = 0
        for s in samples:
            self.buffer.add_batch(s)
            n_steps += len(s["actions"])
            self._recent_returns.extend(s["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-100:]
        self.total_env_steps += n_steps

        metrics: Dict[str, float] = {}
        if self.total_env_steps >= cfg.learning_starts:
            last_aux = None
            for _ in range(cfg.num_updates_per_iteration):
                last_aux = self.learner.update_raw(
                    self.buffer.sample(cfg.train_batch_size))
                self.total_updates += 1
                if self.total_updates % cfg.target_update_freq == 0:
                    self.learner.sync_target()
            self._sync_weights()
            if last_aux is not None:
                # ONE host sync after the K TD updates: the device runs the
                # whole burst instead of stalling on each loss readback.
                metrics = host_floats(last_aux)

        self.iteration += 1
        wall = time.perf_counter() - t0
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": n_steps,
            "num_env_steps_sampled_lifetime": self.total_env_steps,
            "num_gradient_updates_lifetime": self.total_updates,
            "episode_return_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")
            ),
            "epsilon": eps,
            "env_steps_per_sec": n_steps / max(wall, 1e-9),
            **metrics,
        }

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

    @classmethod
    def as_trainable(cls, config: DQNConfig, stop_iters: int = 100,
                     stop_reward: Optional[float] = None):
        """Function trainable for tune (reference: Algorithm is a
        Trainable).  Refused until ``tune`` is ported."""
        from .ppo import as_trainable_refused

        as_trainable_refused(cls)
