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
algorithm keep sample calls in flight on runner actors (granted no card,
so built with ``device="cpu"``); the learner stays in the driver, on the
card unless the config says ``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
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
    whose algorithms pass ``device="cpu"`` (the JAX actor pins itself to
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

    def set_weights(self, weights) -> None:
        """The port's ``get_weights`` state, or a JAX ``PolicyParams`` of
        numpy arrays (or its field list)."""
        if not is_state(weights):
            weights = policy_params_from_jax(weights, "cpu").state_dict()
        self.params.load_state_dict(weights)

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


#: The runner as an actor (the JAX package's ``ImpalaEnvRunner`` is one).
ImpalaEnvRunnerActor = ray_tpu_torch.remote(ImpalaEnvRunner)


class ImpalaConfig:
    """Fluent config (reference: impala.py IMPALAConfig)."""

    def __init__(self):
        self.env_spec: Any = "CartPole-v1"
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 64
        self.num_inflight_per_runner = 2
        self.fragments_per_update = 2
        self.updates_per_iteration = 8
        self.broadcast_interval = 1
        self.lr = 7e-4
        self.gamma = 0.99
        self.rho_bar = 1.0
        self.c_bar = 1.0
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0
        self.hidden = 64
        self.seed = 0
        self.mesh = None
        # The learner's device (the card unless "cpu") and its starting
        # weights, set before the first broadcast primes the runners (a
        # get_weights state or a JAX PolicyParams tree), as PPOConfig's.
        self.device = None
        self.initial_weights = None

    def environment(self, env: Any) -> "ImpalaConfig":
        self.env_spec = env
        return self

    def env_runners(self, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 8,
                    rollout_fragment_length: int = 64,
                    num_inflight_per_runner: int = 2) -> "ImpalaConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_fragment_length = rollout_fragment_length
        self.num_inflight_per_runner = num_inflight_per_runner
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 vf_coeff: Optional[float] = None,
                 rho_bar: Optional[float] = None,
                 c_bar: Optional[float] = None,
                 fragments_per_update: Optional[int] = None,
                 updates_per_iteration: Optional[int] = None,
                 broadcast_interval: Optional[int] = None,
                 mesh=None, device=None,
                 initial_weights=None) -> "ImpalaConfig":
        for name, val in (("lr", lr), ("gamma", gamma),
                          ("entropy_coeff", entropy_coeff),
                          ("vf_coeff", vf_coeff), ("rho_bar", rho_bar),
                          ("c_bar", c_bar),
                          ("fragments_per_update", fragments_per_update),
                          ("updates_per_iteration", updates_per_iteration),
                          ("broadcast_interval", broadcast_interval),
                          ("mesh", mesh), ("device", device),
                          ("initial_weights", initial_weights)):
            if val is not None:
                setattr(self, name, val)
        return self

    def build(self) -> "Impala":
        return Impala(self)


class Impala:
    """The Algorithm: async sample -> V-trace update -> cadenced broadcast
    (reference: impala.py:81 training_step — sampling never blocks on the
    learner; the learner never waits for a full on-policy batch)."""

    def __init__(self, config: ImpalaConfig):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.config = config
        self.runners = [
            ImpalaEnvRunnerActor.remote(
                config.env_spec, config.num_envs_per_runner,
                seed=config.seed + i, device="cpu",
            )
            for i in range(config.num_env_runners)
        ]
        info = ray_tpu_torch.get(self.runners[0].env_info.remote())
        self.learner = ImpalaLearner(
            info["observation_size"], info["num_actions"],
            lr=config.lr, gamma=config.gamma, rho_bar=config.rho_bar,
            c_bar=config.c_bar, vf_coeff=config.vf_coeff,
            entropy_coeff=config.entropy_coeff, grad_clip=config.grad_clip,
            hidden=config.hidden, seed=config.seed, mesh=config.mesh,
            device=config.device,
        )
        if config.initial_weights is not None:
            self.learner.set_weights(config.initial_weights)
        self.weights_version = 0
        self._broadcast(block=True)
        # Prime the pipeline: each runner keeps num_inflight sample calls
        # queued (per-actor FIFO), so sampling overlaps learner updates —
        # the bounded queue (reference: learner_thread inqueue).
        self._inflight: Dict[Any, int] = {}
        for i, r in enumerate(self.runners):
            for _ in range(config.num_inflight_per_runner):
                self._inflight[r.sample.remote(
                    config.rollout_fragment_length)] = i
        self.iteration = 0
        self.total_env_steps = 0
        self.total_updates = 0
        self._recent_returns: List[float] = []

    def _broadcast(self, block: bool = False):
        """Ship current learner weights to every runner (one object-store
        copy, reference: env_runner_group.sync_weights on a cadence)."""
        ref = ray_tpu_torch.put(self.learner.get_weights())
        calls = [r.set_weights.remote(ref, self.weights_version)
                 for r in self.runners]
        if block:
            ray_tpu_torch.get(calls)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        staleness: List[int] = []
        learn_time = 0.0
        n_steps = 0
        metrics: Dict[str, float] = {}
        for _ in range(cfg.updates_per_iteration):
            fragments = []
            while len(fragments) < cfg.fragments_per_update:
                done_refs, _ = ray_tpu_torch.wait(
                    list(self._inflight), num_returns=1
                )
                ref = done_refs[0]
                idx = self._inflight.pop(ref)
                frag = ray_tpu_torch.get(ref)
                # Immediately resubmit: the runner never idles.
                self._inflight[self.runners[idx].sample.remote(
                    cfg.rollout_fragment_length)] = idx
                fragments.append(frag)
                self._recent_returns.extend(
                    frag["episode_returns"].tolist())
                staleness.append(
                    self.weights_version - frag["weights_version"])
                n_steps += frag["rewards"].size
            t1 = time.perf_counter()
            metrics = self.learner.update_from_fragments(fragments)
            learn_time += time.perf_counter() - t1
            self.total_updates += 1
            self.weights_version += 1
            if self.total_updates % cfg.broadcast_interval == 0:
                self._broadcast(block=False)
        self._recent_returns = self._recent_returns[-100:]
        self.total_env_steps += n_steps
        self.iteration += 1
        wall = time.perf_counter() - t0
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": n_steps,
            "num_env_steps_sampled_lifetime": self.total_env_steps,
            "num_learner_updates_lifetime": self.total_updates,
            "episode_return_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")
            ),
            "env_steps_per_sec": n_steps / max(wall, 1e-9),
            "learner_updates_per_sec":
                cfg.updates_per_iteration / max(wall, 1e-9),
            "mean_weight_staleness":
                float(np.mean(staleness)) if staleness else 0.0,
            "time_learn_s": learn_time,
            **metrics,
        }

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
