"""Built-in environments + vectorization (port of ``ray_tpu/rllib/env.py``,
numpy only, episode semantics bit-identical to the JAX package's).

Role-equivalent to the reference's env layer (reference:
rllib/env/single_agent_env_runner.py:756-806 wraps gym.vector envs).  The
classic CartPole dynamics (public textbook equations, same constants as
gym's cartpole.py) are implemented here, so nothing needs gymnasium; any
object with reset(seed)/step(action) and observation_size/num_actions works
as an env.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


class CartPoleEnv:
    """CartPole-v1 semantics: episode ends past +/-2.4m or +/-12deg or 500
    steps; reward 1 per step (solved ~= 475+)."""

    observation_size = 4
    num_actions = 2
    max_episode_steps = 500

    GRAVITY = 9.8
    MASS_CART = 1.0
    MASS_POLE = 0.1
    LENGTH = 0.5  # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * math.pi / 180

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.state = np.zeros(4, np.float32)
        self.steps = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self.steps = 0
        return self.state.copy()

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, bool]:
        x, x_dot, theta, theta_dot = self.state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        total_mass = self.MASS_CART + self.MASS_POLE
        pole_mass_length = self.MASS_POLE * self.LENGTH
        cos_t, sin_t = math.cos(theta), math.sin(theta)
        temp = (force + pole_mass_length * theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASS_POLE * cos_t**2 / total_mass)
        )
        x_acc = temp - pole_mass_length * theta_acc * cos_t / total_mass
        x += self.TAU * x_dot
        x_dot += self.TAU * x_acc
        theta += self.TAU * theta_dot
        theta_dot += self.TAU * theta_acc
        self.state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self.steps += 1
        terminated = bool(
            abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT
        )
        truncated = self.steps >= self.max_episode_steps
        return self.state.copy(), 1.0, terminated, truncated


class CatchEnv:
    """Pixel-observation Catch (the bsuite/DeepMind-classic test problem):
    a ball falls from a random top column; the paddle on the bottom row
    moves left/stay/right; terminal reward +1 on catch, -1 on miss.
    Observations are a (rows, cols, 1) float image — exercises the conv
    policy path (reference: image envs routed to conv nets via
    models/utils.py get_filter_config; benchmark_atari_ppo.py is the
    conv-scale benchmark)."""

    ROWS = 10
    COLS = 5
    observation_shape = (ROWS, COLS, 1)
    observation_size = ROWS * COLS
    num_actions = 3
    max_episode_steps = ROWS  # ball reaches the bottom in ROWS-1 steps

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.ball_row = 0
        self.ball_col = 0
        self.paddle = 0
        self.steps = 0

    def _obs(self) -> np.ndarray:
        img = np.zeros(self.observation_shape, np.float32)
        img[self.ball_row, self.ball_col, 0] = 1.0
        img[self.ROWS - 1, self.paddle, 0] = 1.0
        return img

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.ball_row = 0
        self.ball_col = int(self.rng.integers(0, self.COLS))
        self.paddle = self.COLS // 2
        self.steps = 0
        return self._obs()

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, bool]:
        self.paddle = int(np.clip(self.paddle + (action - 1), 0,
                                  self.COLS - 1))
        self.ball_row += 1
        self.steps += 1
        if self.ball_row == self.ROWS - 1:
            reward = 1.0 if self.paddle == self.ball_col else -1.0
            return self._obs(), reward, True, False
        return self._obs(), 0.0, False, False


ENV_REGISTRY = {"CartPole-v1": CartPoleEnv, "Catch-v0": CatchEnv}


def register_env(name: str, cls) -> None:
    ENV_REGISTRY[name] = cls


def make_env(spec, seed: Optional[int] = None):
    if isinstance(spec, str):
        return ENV_REGISTRY[spec](seed=seed)
    return spec(seed=seed)


class VectorEnv:
    """N independent env copies stepped together with auto-reset (the
    reference's gym.vector.SyncVectorEnv role)."""

    def __init__(self, spec, num_envs: int, seed: int = 0):
        self.envs: List = [
            make_env(spec, seed=seed * 10_000 + i) for i in range(num_envs)
        ]
        self.num_envs = num_envs
        self.observation_size = self.envs[0].observation_size
        # Image envs expose observation_shape (H, W, C); 1D envs fall back
        # to (observation_size,).  Everything downstream keys off the shape.
        self.observation_shape = tuple(getattr(
            self.envs[0], "observation_shape", (self.observation_size,)))
        self.num_actions = self.envs[0].num_actions
        self.episode_returns = np.zeros(num_envs, np.float64)
        self.completed_returns: List[float] = []

    def reset(self) -> np.ndarray:
        self.episode_returns[:] = 0.0
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions: np.ndarray):
        """Returns (obs, rewards, terminateds, truncateds, final_obs):
        terminated and truncated are separate (truncated episodes must
        bootstrap from the true next state, not be treated as terminal —
        the gymnasium v26 semantics); final_obs holds the pre-reset next
        observation for done envs."""
        obs, rewards, terms, truncs = [], [], [], []
        final_obs: dict = {}
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            o, r, term, trunc = env.step(int(a))
            self.episode_returns[i] += r
            if term or trunc:
                self.completed_returns.append(self.episode_returns[i])
                self.episode_returns[i] = 0.0
                final_obs[i] = o
                o = env.reset()
            obs.append(o)
            rewards.append(r)
            terms.append(term)
            truncs.append(trunc)
        return (
            np.stack(obs),
            np.array(rewards, np.float32),
            np.array(terms, np.bool_),
            np.array(truncs, np.bool_),
            final_obs,
        )

    def drain_completed(self) -> List[float]:
        out, self.completed_returns = self.completed_returns, []
        return out
