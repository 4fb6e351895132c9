"""IMPALA's env runner and V-trace learner (port of
``ray_tpu/rllib/impala.py``).

Role-equivalent to the reference's IMPALA stack (reference:
rllib/algorithms/impala/impala.py:81-349; V-trace corrections follow
Espeholt et al. 2018, "IMPALA: Scalable Distributed Deep-RL").  The
learner's update runs on its device (the card unless ``device="cpu"``):
the V-trace recursion is a reverse loop over T on the device, the
importance ratios are held constant for the gradient as in the JAX
package; under a mesh each rank takes its env columns and the gradients
are averaged over dp x fsdp.  ``ImpalaConfig`` and the ``Impala``
algorithm, which keep sample calls in flight on runner actors, wait for
the port's runtime.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .env import VectorEnv
from .learner import (Program, host_floats, init_policy, is_state,
                      make_adam, mesh_shard, params_state, policy_forward,
                      policy_params_from_jax, sample_categorical, sgd_step,
                      to_device)


class ImpalaEnvRunner:
    """Sampler: vectorized envs + its own copy of the policy.

    Unlike the PPO EnvRunner it returns the TRUE successor state per step
    (pre-reset where an episode ended) so the learner can evaluate V(x_{t+1})
    under the CURRENT parameters — V-trace needs learner-side values, not the
    behavior policy's (reference: vtrace uses values recomputed by the
    learner, impala_learner.py).

    A plain in-process object: it becomes an actor with the port's runtime,
    whose algorithms will pass ``device="cpu"`` (the JAX actor pins itself to
    the CPU with ``JAX_PLATFORMS``; the port copies no such default)."""

    def __init__(self, env_spec, num_envs: int, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vec = VectorEnv(env_spec, num_envs, seed=seed)
        self.obs = self.vec.reset()
        self._params = None
        self._weights_version = -1
        self._rng = np.random.default_rng(seed + 1)

    def env_info(self) -> Dict[str, int]:
        return {
            "observation_size": self.vec.observation_size,
            "num_actions": self.vec.num_actions,
        }

    def set_weights(self, weights, version: int) -> bool:
        """The learner's ``get_weights`` state, or a JAX ``PolicyParams``
        of numpy arrays (or its field list)."""
        if is_state(weights):
            if self._params is None:
                hidden = weights["pi.0.weight"].shape[0]
                self._params = init_policy(self.vec.observation_size,
                                           self.vec.num_actions, hidden,
                                           device=self.device)
            self._params.load_state_dict(weights)
        else:
            self._params = policy_params_from_jax(weights, self.device)
        self._weights_version = version
        return True

    @torch.no_grad()
    def sample(self, num_steps: int) -> Dict[str, Any]:
        """One [T, N] fragment under the runner's current (possibly stale)
        weights.  ``terminated`` masks bootstrap values; ``done``
        (terminated|truncated) cuts the V-trace recursion."""
        if self._params is None:
            raise RuntimeError("set_weights before sample")
        N = self.vec.num_envs
        D = self.vec.observation_size
        obs_buf = np.empty((num_steps, N, D), np.float32)
        next_buf = np.empty((num_steps, N, D), np.float32)
        act_buf = np.empty((num_steps, N), np.int32)
        logp_buf = np.empty((num_steps, N), np.float32)
        rew_buf = np.empty((num_steps, N), np.float32)
        term_buf = np.empty((num_steps, N), np.bool_)
        done_buf = np.empty((num_steps, N), np.bool_)
        obs = self.obs
        for t in range(num_steps):
            x = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)
            logits, _ = policy_forward(self._params, x)
            actions, logp = sample_categorical(logits, self._rng)
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logp
            obs, rewards, terms, truncs, final_obs = self.vec.step(actions)
            rew_buf[t] = rewards
            term_buf[t] = terms
            done_buf[t] = terms | truncs
            next_buf[t] = obs
            for i, o in final_obs.items():
                next_buf[t, i] = o  # true pre-reset successor
        self.obs = obs
        return {
            "obs": obs_buf,
            "next_obs": next_buf,
            "actions": act_buf,
            "logp_behavior": logp_buf,
            "rewards": rew_buf,
            "terminated": term_buf,
            "done": done_buf,
            "episode_returns": np.array(self.vec.drain_completed(),
                                        np.float64),
            "weights_version": self._weights_version,
        }


def vtrace(deltas: torch.Tensor, discounts: torch.Tensor) -> torch.Tensor:
    """vs_t - V_t = delta_t + discount_t * (vs_{t+1} - V_{t+1}) over [T, N],
    zero after the last row (Espeholt et al. eq. 1): the JAX package's
    reverse ``lax.scan``, as a reverse loop over T."""
    out = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + discounts[t] * carry
        out[t] = carry
    return out


def impala_loss(params, batch: Dict[str, torch.Tensor], *, gamma: float,
                rho_bar: float, c_bar: float, vf_c: float, ent_c: float):
    """The V-trace actor-critic loss over a [T, N] batch: (total, aux)."""
    logits, values = policy_forward(params, batch["obs"])
    next_values = policy_forward(params, batch["next_obs"])[1]
    # Terminated: no bootstrap.  Truncated: V(true next state).
    next_values = next_values * (1.0 - batch["terminated"])
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"].long()[..., None])[..., 0]
    # Importance ratios pi/mu on the chosen actions, constant for the
    # gradient.
    ratio = torch.exp(logp - batch["logp_behavior"])
    rho = torch.clamp(ratio.detach(), max=rho_bar)
    c = torch.clamp(ratio.detach(), max=c_bar)
    cont = 1.0 - batch["done"]  # episode boundary cuts the recursion
    v = values.detach()
    nv = next_values.detach()
    deltas = rho * (batch["rewards"] + gamma * nv - v)
    vs_minus_v = vtrace(deltas, gamma * cont * c)
    vs = v + vs_minus_v
    # Policy-gradient advantage: q_t = r_t + gamma*(V(x_{t+1}) +
    # cont*(vs_{t+1} - V_{t+1})); adv = rho*(q_t - V_t).
    vs_next_minus = torch.cat([vs_minus_v[1:],
                               torch.zeros_like(vs_minus_v[:1])])
    q = batch["rewards"] + gamma * (nv + cont * vs_next_minus)
    adv = rho * (q - v)
    pi_loss = -torch.mean(logp * adv)
    vf_loss = 0.5 * torch.mean((vs - values) ** 2)
    entropy = -torch.mean(torch.sum(F.softmax(logits, dim=-1) * logp_all,
                                    dim=-1))
    total = pi_loss + vf_c * vf_loss - ent_c * entropy
    return total, {
        "policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy,
        "mean_rho": torch.mean(torch.clamp(ratio.detach(), max=rho_bar)),
    }


class ImpalaLearner:
    """V-trace actor-critic update (reference: impala_torch_learner.py
    compute_loss_for_module + vtrace_torch.py)."""

    def __init__(
        self,
        obs_size: int,
        num_actions: int,
        *,
        lr: float = 7e-4,
        gamma: float = 0.99,
        rho_bar: float = 1.0,
        c_bar: float = 1.0,
        vf_coeff: float = 0.5,
        entropy_coeff: float = 0.01,
        grad_clip: float = 40.0,
        hidden: int = 64,
        seed: int = 0,
        mesh=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.params = init_policy(obs_size, num_actions, hidden, seed,
                                  self.device)
        self.opt = make_adam(self.params.parameters(), lr, 1e-5, self.device)
        self.loss_kw = dict(gamma=gamma, rho_bar=rho_bar, c_bar=c_bar,
                            vf_c=vf_coeff, ent_c=entropy_coeff)
        self.grad_clip = grad_clip
        self.mesh = mesh
        self._program = Program("impala_update")

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return params_state(self.params)

    def _update(self, batch: Dict[str, torch.Tensor]):
        self._program(batch)
        if self.mesh is not None:
            # Env columns split over dp x fsdp (JAX's P(None, ("dp",
            # "fsdp"))); T stays whole for the recursion.
            batch = mesh_shard(self.mesh, batch, dim=1)
        total, aux = impala_loss(self.params, batch, **self.loss_kw)
        aux["total_loss"] = total
        return sgd_step(self.params, self.opt, total, aux, self.grad_clip,
                        self.mesh)

    def update_from_fragments(self, fragments: List[Dict[str, Any]]
                              ) -> Dict[str, float]:
        """One V-trace SGD step on fragments stacked along the env axis
        (single pass — IMPALA consumes each batch once, unlike PPO's
        epoch loop)."""
        batch = {
            k: np.concatenate([f[k] for f in fragments], axis=1)
            for k in ("obs", "next_obs", "actions", "logp_behavior",
                      "rewards")
        }
        for k in ("terminated", "done"):
            batch[k] = np.concatenate([f[k] for f in fragments],
                                      axis=1).astype(np.float32)
        return host_floats(self._update(to_device(batch, self.device)))
