"""Replay buffer for off-policy algorithms (port of
``ray_tpu/rllib/replay.py``: the same ring wrap and the same
``default_rng`` draws).

Role-equivalent to the reference's replay buffers
(reference: rllib/utils/replay_buffers/replay_buffer.py ReplayBuffer with
uniform sampling; episode/prioritized variants build on it) — re-designed as
flat preallocated numpy rings: transitions arrive as whole [B] batches from
vectorized EnvRunners, so insertion is a slice copy, and a sampled
minibatch goes to the learner's device in one copy a column.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class ReplayBuffer:
    """Uniform FIFO transition buffer."""

    def __init__(self, capacity: int, obs_size: int, seed: int = 0):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_size), np.float32)
        self.next_obs = np.zeros((capacity, obs_size), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """Insert [B] transitions, wrapping the ring as needed."""
        n = len(batch["actions"])
        start = 0
        while start < n:
            room = min(n - start, self.capacity - self._idx)
            sl = slice(self._idx, self._idx + room)
            bl = slice(start, start + room)
            self.obs[sl] = batch["obs"][bl]
            self.next_obs[sl] = batch["next_obs"][bl]
            self.actions[sl] = batch["actions"][bl]
            self.rewards[sl] = batch["rewards"][bl]
            self.dones[sl] = batch["dones"][bl]
            self._idx = (self._idx + room) % self.capacity
            self._size = min(self._size + room, self.capacity)
            start += room

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        return {
            "obs": self.obs[idx],
            "next_obs": self.next_obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
        }
