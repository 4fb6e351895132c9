"""Offline RL: JSONL sample IO, behavior cloning, off-policy estimators
(port of ``ray_tpu/rllib/offline.py``: the same JSONL files, read and
written by either package; behavior cloning on the port's models, on the
card unless ``device="cpu"``).

Role-equivalent to the reference's offline stack (reference:
rllib/offline/json_reader.py:227 JsonReader — JSONL sample batches,
shuffled iteration; json_writer.py — episode batches to timestamped JSONL;
offline/estimators/importance_sampling.py + weighted_importance_sampling.py
— per-episode IS/WIS value estimates; algorithms/bc/bc.py — behavior
cloning as the marquee offline algorithm).

The on-disk format is JSONL where each line is one flat sample batch
(columns -> lists), so files stream without loading whole datasets, shard
across the data library's tasks, and stay human-readable.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .learner import make_adam, set_grads


class JsonWriter:
    """Append sample batches to a JSONL file (reference: json_writer.py —
    one compressed JSON batch per line under a timestamped name)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        row = {k: np.asarray(v).tolist() for k, v in batch.items()}
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class JsonReader:
    """Stream sample batches back from JSONL files (reference:
    json_reader.py:227 next() returns one batch per call, cycling and
    shuffling across input files)."""

    def __init__(self, paths, *, shuffle: bool = True, seed: int = 0):
        if isinstance(paths, str):
            paths = [paths]
        self.paths = list(paths)
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self._batches: Optional[List[Dict[str, np.ndarray]]] = None

    def _load(self) -> List[Dict[str, np.ndarray]]:
        if self._batches is None:
            out = []
            for p in self.paths:
                with open(p, encoding="utf-8") as f:
                    for line in f:
                        if line.strip():
                            row = json.loads(line)
                            out.append({
                                k: np.asarray(v) for k, v in row.items()
                            })
            if not out:
                raise ValueError(f"no batches found in {self.paths}")
            self._batches = out
        return self._batches

    def next(self) -> Dict[str, np.ndarray]:
        batches = self._load()
        i = (int(self.rng.integers(len(batches)))
             if self.shuffle else getattr(self, "_i", 0) % len(batches))
        if not self.shuffle:
            self._i = i + 1
        return batches[i]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for b in self._load():
            yield b

    def read_all(self) -> Dict[str, np.ndarray]:
        """Concatenate every batch into one flat table."""
        batches = self._load()
        return {
            k: np.concatenate([np.atleast_1d(b[k]) for b in batches])
            for k in batches[0]
        }


def collect_offline_dataset(env_spec, path: str, *, num_episodes: int = 50,
                            policy=None, seed: int = 0,
                            epsilon: float = 0.3) -> int:
    """Roll episodes with a (possibly epsilon-soft) behavior policy and
    write per-episode batches with action probabilities — the columns the
    IS/WIS estimators need (reference: offline data includes
    action_prob/action_logp).  Returns total steps written."""
    from .env import make_env

    env = make_env(env_spec, seed=seed)
    rng = np.random.default_rng(seed)
    writer = JsonWriter(path)
    total = 0
    for ep in range(num_episodes):
        obs = env.reset(seed=seed * 10_000 + ep)
        rows: Dict[str, List] = {"obs": [], "actions": [], "rewards": [],
                                 "action_prob": [], "dones": []}
        while True:
            if policy is None:
                a = int(rng.integers(env.num_actions))
                prob = 1.0 / env.num_actions
            else:
                greedy_a, greedy_p = policy(obs)
                if rng.random() >= epsilon:
                    a = greedy_a
                else:
                    a = int(rng.integers(env.num_actions))
                # Behavior prob of the ACTION TAKEN under the epsilon-soft
                # mixture: the policy's mass on a (its reported prob when a
                # is its own choice, 0 otherwise — the protocol's policies
                # are deterministic-per-obs) plus the uniform explore mass.
                p_pol = greedy_p if a == greedy_a else 0.0
                prob = (1 - epsilon) * p_pol + epsilon / env.num_actions
            nxt, r, term, trunc = env.step(a)
            rows["obs"].append(np.asarray(obs).tolist())
            rows["actions"].append(int(a))
            rows["rewards"].append(float(r))
            rows["action_prob"].append(float(prob))
            rows["dones"].append(bool(term or trunc))
            total += 1
            obs = nxt
            if term or trunc:
                break
        writer.write({k: np.asarray(v) for k, v in rows.items()})
    writer.close()
    return total


class BC:
    """Behavior cloning: supervised learning of the dataset's action
    distribution (reference: algorithms/bc/bc.py — the BC loss is plain
    -logp on offline batches, sharing the learner stack).  Reuses the PPO
    model catalog, so MLP or CNN policies clone equally.  The dataset goes
    to the device once per ``train_on``; minibatches are indexed there."""

    def __init__(self, obs_shape, num_actions: int, *, lr: float = 1e-3,
                 hidden: int = 64, seed: int = 0, model=None,
                 device: DeviceLike = None):
        from .models import default_model

        self.device = resolve_device(device)
        self.model = model or default_model(tuple(obs_shape), num_actions,
                                            hidden)
        self.params = self.model.init(seed, device=self.device)
        self.opt = make_adam(self.params.parameters(), lr, 1e-8, self.device)

    def _update(self, obs: torch.Tensor,
                actions: torch.Tensor) -> torch.Tensor:
        logits, _ = self.model.apply(self.params, obs)
        loss = -F.log_softmax(logits, dim=-1).gather(
            1, actions.long()[:, None]).mean()
        params = list(self.params.parameters())
        # The value head takes no part in the loss: its gradient is None
        # and Adam leaves it as it is (JAX's zero gradient moves it by 0).
        set_grads(params, torch.autograd.grad(loss, params,
                                              allow_unused=True))
        self.opt.step()
        return loss.detach()

    def train_on(self, reader: JsonReader, *, num_steps: int = 200,
                 batch_size: int = 256, seed: int = 0) -> float:
        table = reader.read_all()
        obs = torch.from_numpy(np.asarray(table["obs"], np.float32)).to(
            self.device)
        actions = torch.from_numpy(np.asarray(table["actions"], np.int32)
                                   ).to(self.device)
        rng = np.random.default_rng(seed)
        loss = None
        for _ in range(num_steps):
            idx = torch.from_numpy(
                rng.integers(0, len(actions), batch_size)).to(self.device)
            loss = self._update(obs[idx], actions[idx])
        return float("nan") if loss is None else float(loss)

    @torch.no_grad()
    def compute_action(self, obs: np.ndarray) -> int:
        x = torch.from_numpy(np.asarray(obs, np.float32)[None]).to(
            self.device)
        logits, _ = self.model.apply(self.params, x)
        return int(torch.argmax(logits[0]))


def importance_sampling_estimate(
    reader: JsonReader, target_action_probs, *, gamma: float = 0.99,
    weighted: bool = False,
) -> Dict[str, float]:
    """Off-policy value estimation for a target policy from behavior data.

    target_action_probs(obs [T, D], actions [T]) -> [T] probabilities under
    the TARGET policy.  Ordinary IS multiplies per-step ratios over the
    episode and weights its discounted return; WIS normalizes by the mean
    cumulative ratio, trading bias for variance (reference:
    estimators/importance_sampling.py:21, weighted_importance_sampling.py).
    """
    v_behavior: List[float] = []
    v_target: List[float] = []
    weights: List[float] = []
    for ep in reader:
        rewards = np.asarray(ep["rewards"], np.float64)
        probs_b = np.asarray(ep["action_prob"], np.float64)
        probs_t = np.asarray(
            target_action_probs(np.asarray(ep["obs"], np.float32),
                                np.asarray(ep["actions"], np.int32)),
            np.float64)
        t = len(rewards)
        disc = gamma ** np.arange(t)
        ret = float((rewards * disc).sum())
        rho = float(np.prod(probs_t / np.clip(probs_b, 1e-8, None)))
        v_behavior.append(ret)
        v_target.append(rho * ret)
        weights.append(rho)
    if weighted:
        denom = max(float(np.mean(weights)), 1e-8)
        v_est = float(np.mean(v_target)) / denom
    else:
        v_est = float(np.mean(v_target))
    return {
        "v_behavior": float(np.mean(v_behavior)),
        "v_target": v_est,
        "mean_is_weight": float(np.mean(weights)),
        "episodes": len(v_behavior),
    }
