"""EnvRunner: vectorized rollout collection with the policy on a device
(port of ``ray_tpu/rllib/env_runner.py``).

Role-equivalent to the reference's SingleAgentEnvRunner
(reference: rllib/env/single_agent_env_runner.py:61 sample:131 — vectorized
envs, forward_exploration on the local policy copy, episode bookkeeping).
The runner holds its own copy of the policy; weights arrive through
``set_weights`` each iteration (reference: env_runner_group.sync_weights).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .env import VectorEnv
from .learner import is_state, sample_categorical


class EnvRunner:
    """A plain in-process object: it becomes an actor with the port's
    runtime, whose algorithms pass ``device="cpu"`` (the JAX actor pins
    itself to the CPU with ``JAX_PLATFORMS``; the port copies no such
    default, so the policy runs on the card unless ``device="cpu"``)."""

    def __init__(self, env_spec, num_envs: int, seed: int = 0, model=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vec = VectorEnv(env_spec, num_envs, seed=seed)
        self.obs = self.vec.reset()
        self.seed = seed
        # Optional models.* instance.  None = the separate-torso MLP, whose
        # weights may also arrive as the JAX PolicyParams field list.
        if model is None:
            from .models import MLPModel

            model = MLPModel(self.vec.observation_shape,
                             self.vec.num_actions)
        self.model = model
        self._params = None
        self._q_params = None
        self._rng = np.random.default_rng(seed + 1)

    @torch.no_grad()
    def _policy(self, obs: np.ndarray):
        """(logits, values) of the policy on host obs, as numpy."""
        x = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)
        logits, value = self.model.apply(self._params, x)
        return logits.cpu().numpy(), value.cpu().numpy()

    def set_weights(self, weights) -> bool:
        """The learner's ``get_weights`` state, or a JAX tree of numpy
        arrays (the model's ``from_jax`` layout; for the MLP also the
        legacy flat field list)."""
        if is_state(weights):
            if self._params is None:
                self._params = self.model.init(device=self.device)
            self._params.load_state_dict(weights)
        else:
            self._params = self.model.from_jax(weights, self.device)
        return True

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect [T, N] rollout fragments with logp/value for PPO
        (reference: sample:131 returns episode lists; here the batch format
        is the tensorized equivalent)."""
        if self._params is None:
            raise RuntimeError("set_weights before sample")
        N = self.vec.num_envs
        obs_buf = np.empty((num_steps, N, *self.vec.observation_shape),
                           np.float32)
        act_buf = np.empty((num_steps, N), np.int32)
        logp_buf = np.empty((num_steps, N), np.float32)
        val_buf = np.empty((num_steps, N), np.float32)
        rew_buf = np.empty((num_steps, N), np.float32)
        done_buf = np.empty((num_steps, N), np.bool_)
        # V(s_{t+1}) per row with episode semantics (see compute_gae):
        # default = next row's value (filled after the loop); terminal = 0;
        # truncated = V(true pre-reset state).
        boot_buf = np.zeros((num_steps, N), np.float32)
        boot_override: dict = {}
        obs = self.obs
        for t in range(num_steps):
            logits, value = self._policy(obs)
            actions, logp = sample_categorical(logits, self._rng)
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logp
            val_buf[t] = value
            obs, rewards, terms, truncs, final_obs = self.vec.step(actions)
            rew_buf[t] = rewards
            done_buf[t] = terms | truncs
            for i, o in final_obs.items():
                # Terminated: bootstrap 0.  Truncated: V(true next state).
                boot_override[(t, i)] = None if terms[i] else o
        self.obs = obs
        _, last_value = self._policy(obs)
        boot_buf[:-1] = val_buf[1:]
        boot_buf[-1] = last_value
        if boot_override:
            keys = [(t, i) for (t, i), o in boot_override.items()
                    if o is not None]
            if keys:
                finals = np.stack([boot_override[k] for k in keys])
                _, v_final = self._policy(finals)
                for (t, i), v in zip(keys, v_final):
                    boot_buf[t, i] = v
            for (t, i), o in boot_override.items():
                if o is None:
                    boot_buf[t, i] = 0.0
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp_old": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "bootstrap_values": boot_buf,
            "episode_returns": np.array(self.vec.drain_completed(),
                                        np.float64),
        }

    def env_info(self) -> Dict[str, Any]:
        return {
            "observation_size": self.vec.observation_size,
            "observation_shape": self.vec.observation_shape,
            "num_actions": self.vec.num_actions,
        }

    # -- off-policy sampling (DQN-family) ------------------------------------

    def set_q_weights(self, weights) -> bool:
        """Install Q-network params: the DQN learner's ``get_weights`` state,
        or a JAX ``QParams`` of numpy arrays (or its field list)."""
        from .dqn import QParams, q_params_from_jax

        if is_state(weights):
            if self._q_params is None:
                hidden = weights["l1.weight"].shape[0]
                self._q_params = QParams(self.vec.observation_size,
                                         self.vec.num_actions, hidden
                                         ).to(self.device)
            self._q_params.load_state_dict(weights)
        else:
            self._q_params = q_params_from_jax(weights, self.device)
        return True

    @torch.no_grad()
    def sample_transitions(self, num_steps: int,
                           epsilon: float) -> Dict[str, np.ndarray]:
        """Collect flat (s, a, r, s', done) transitions with epsilon-greedy
        exploration for replay-buffer algorithms (reference:
        single_agent_env_runner.py:131 sample — episodes are post-processed
        into transition batches by the DQN pipeline; here the runner emits
        transitions directly).

        ``done`` marks *termination only*: a time-limit truncation still
        bootstraps from V/Q of the true next state (same semantics as the
        PPO path's bootstrap_values)."""
        if self._q_params is None:
            raise RuntimeError("set_q_weights before sample")
        from .dqn import q_forward

        N = self.vec.num_envs
        D = self.vec.observation_size
        obs_buf = np.empty((num_steps, N, D), np.float32)
        next_buf = np.empty((num_steps, N, D), np.float32)
        act_buf = np.empty((num_steps, N), np.int32)
        rew_buf = np.empty((num_steps, N), np.float32)
        done_buf = np.empty((num_steps, N), np.float32)
        obs = self.obs
        for t in range(num_steps):
            x = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)
            q = q_forward(self._q_params, x).cpu().numpy()
            actions = np.argmax(q, axis=-1).astype(np.int32)
            explore = self._rng.random(N) < epsilon
            actions = np.where(
                explore,
                self._rng.integers(0, self.vec.num_actions, N),
                actions,
            ).astype(np.int32)
            obs_buf[t] = obs
            act_buf[t] = actions
            obs, rewards, terms, truncs, final_obs = self.vec.step(actions)
            rew_buf[t] = rewards
            done_buf[t] = terms.astype(np.float32)
            next_buf[t] = obs
            for i, o in final_obs.items():
                next_buf[t, i] = o  # true pre-reset successor state
        self.obs = obs
        return {
            "obs": obs_buf.reshape(num_steps * N, D),
            "next_obs": next_buf.reshape(num_steps * N, D),
            "actions": act_buf.reshape(-1),
            "rewards": rew_buf.reshape(-1),
            "dones": done_buf.reshape(-1),
            "episode_returns": np.array(self.vec.drain_completed(),
                                        np.float64),
        }
