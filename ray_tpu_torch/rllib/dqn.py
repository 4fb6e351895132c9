"""DQN's learner: double-Q TD updates with a target network (port of
``ray_tpu/rllib/dqn.py``).

Role-equivalent to the reference's DQN learner (reference:
rllib/algorithms/dqn/dqn.py training_step: sample with epsilon-greedy ->
add to EpisodeReplayBuffer -> sample train batches -> Learner TD update with
double-Q + target net -> periodic target sync).  Online and target
networks live on the learner's device (the card unless ``device="cpu"``);
under a mesh each rank takes its rows of the batch and the gradients are
averaged over dp x fsdp.  ``DQNConfig`` and the ``DQN`` algorithm, which
drive env runner actors, wait for the port's runtime.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .learner import (Program, _fields, _he_normal, _linear, _orthogonal,
                      _set_linear, host_floats, make_adam, mesh_shard,
                      params_state, sgd_step, to_device)

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
