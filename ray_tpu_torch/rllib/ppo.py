"""PPO algorithm: sample -> update -> weight-sync over EnvRunner actors
(port of ``ray_tpu/rllib/ppo.py``).

Role-equivalent to the reference's new-API-stack PPO
(reference: rllib/algorithms/ppo/ppo.py:444-520 training_step:
synchronous_parallel_sample over the EnvRunnerGroup ->
learner_group.update_from_episodes -> env_runner_group.sync_weights), with
the learner in the driver, on the card unless the config says
``device="cpu"`` (or sharded over a mesh).  The runners are actors granted
no card (their ``CUDA_VISIBLE_DEVICES`` is empty), so the driver builds
them with ``device="cpu"``: the JAX runner actors pin themselves to the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from .env import make_env
from .env_runner import EnvRunner
from .learner import PPOLearner, compute_gae

#: The runner as an actor (the JAX package's ``EnvRunner`` is one).
EnvRunnerActor = ray_tpu_torch.remote(EnvRunner)


def as_trainable_refused(cls) -> None:
    """``as_trainable`` needs ``ray_tpu_torch.tune``, which is not ported
    yet (ROADMAP.md Queue 1, the tune/ item)."""
    raise NotImplementedError(
        f"{cls.__name__}.as_trainable needs ray_tpu_torch.tune, which is not "
        "ported yet (ROADMAP.md Queue 1, the tune/ item); call train() in a "
        "loop until then")


class PPOConfig:
    """Fluent config (reference: algorithm_config.py AlgorithmConfig)."""

    def __init__(self):
        self.env_spec: Any = "CartPole-v1"
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 64
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 0.5
        self.num_epochs = 10
        self.minibatch_size = 256
        self.hidden = 64
        self.seed = 0
        self.mesh = None
        # Optional models.* instance; None = pick by obs shape (MLP for 1D,
        # CNN for image observations — reference: catalog.py dispatch).
        self.model_spec = None
        # The learner's device: the card unless "cpu".
        self.device = None
        # The learner's starting weights (its get_weights state, or a JAX
        # tree of numpy arrays), set before the runners first sample: a run
        # resumed from saved weights, or one held to another run.
        self.initial_weights = None

    def environment(self, env: Any) -> "PPOConfig":
        self.env_spec = env
        return self

    def env_runners(self, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 8,
                    rollout_fragment_length: int = 64) -> "PPOConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 lambda_: Optional[float] = None,
                 clip_param: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 num_epochs: Optional[int] = None,
                 minibatch_size: Optional[int] = None,
                 mesh=None, model=None, device=None,
                 initial_weights=None) -> "PPOConfig":
        for name, val in (("lr", lr), ("gamma", gamma), ("lambda_", lambda_),
                          ("clip_param", clip_param),
                          ("entropy_coeff", entropy_coeff),
                          ("num_epochs", num_epochs),
                          ("minibatch_size", minibatch_size),
                          ("mesh", mesh), ("model_spec", model),
                          ("device", device),
                          ("initial_weights", initial_weights)):
            if val is not None:
                setattr(self, name, val)
        return self

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    """The Algorithm (reference: algorithms/algorithm.py:227 — a Trainable
    whose step() is one sample/update/sync round)."""

    def __init__(self, config: PPOConfig):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.config = config
        # Driver-side env probe: obs/action spaces come from a local env
        # instance, not a throwaway actor (reference: the algorithm reads
        # spaces from the env spec before building the EnvRunnerGroup).
        probe_env = make_env(config.env_spec, seed=config.seed)
        info = {
            "observation_size": probe_env.observation_size,
            "observation_shape": tuple(getattr(
                probe_env, "observation_shape",
                (probe_env.observation_size,))),
            "num_actions": probe_env.num_actions,
        }
        del probe_env
        model = config.model_spec
        if model is None:
            from .models import default_model

            model = default_model(info["observation_shape"],
                                  info["num_actions"], config.hidden)
        self.learner = PPOLearner(
            info["observation_size"], info["num_actions"],
            lr=config.lr, clip_param=config.clip_param,
            vf_coeff=config.vf_coeff, entropy_coeff=config.entropy_coeff,
            grad_clip=config.grad_clip, hidden=config.hidden,
            seed=config.seed, mesh=config.mesh, model=model,
            device=config.device,
        )
        if config.initial_weights is not None:
            self.learner.set_weights(config.initial_weights)
        self.runners = [
            EnvRunnerActor.remote(config.env_spec, config.num_envs_per_runner,
                                  seed=config.seed + i, model=model,
                                  device="cpu")
            for i in range(config.num_env_runners)
        ]
        self._sync_weights()
        self.iteration = 0
        self.total_env_steps = 0
        self._recent_returns: List[float] = []

    def _sync_weights(self):
        """Broadcast learner weights once via the object store; every runner
        reads the same copy (reference: env_runner_group.sync_weights).
        Tensors on the card cross as CPU tensors."""
        ref = ray_tpu_torch.put(self.learner.get_weights())
        ray_tpu_torch.get([r.set_weights.remote(ref) for r in self.runners])

    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: ppo.py:444 training_step)."""
        cfg = self.config
        t0 = time.perf_counter()
        samples = ray_tpu_torch.get([
            r.sample.remote(cfg.rollout_fragment_length)
            for r in self.runners
        ])
        sample_time = time.perf_counter() - t0

        # Stitch runner fragments: GAE per runner (each has its own
        # last_values), then flatten [T, N] -> rows.
        flat: Dict[str, List[np.ndarray]] = {
            "obs": [], "actions": [], "logp_old": [],
            "advantages": [], "returns": [],
        }
        for s in samples:
            adv, ret = compute_gae(
                s["rewards"], s["values"], s["bootstrap_values"], s["dones"],
                cfg.gamma, cfg.lambda_,
            )
            T, N = s["rewards"].shape
            flat["obs"].append(s["obs"].reshape(T * N, *s["obs"].shape[2:]))
            flat["actions"].append(s["actions"].reshape(-1))
            flat["logp_old"].append(s["logp_old"].reshape(-1))
            flat["advantages"].append(adv.reshape(-1))
            flat["returns"].append(ret.reshape(-1))
            self._recent_returns.extend(s["episode_returns"].tolist())
        batch = {k: np.concatenate(v) for k, v in flat.items()}
        self._recent_returns = self._recent_returns[-100:]

        t1 = time.perf_counter()
        metrics = self.learner.update_from_batch(
            batch,
            num_epochs=cfg.num_epochs,
            minibatch_size=min(cfg.minibatch_size, len(batch["obs"])),
            seed=cfg.seed + self.iteration,
        )
        learn_time = time.perf_counter() - t1
        self._sync_weights()

        n_steps = len(batch["obs"])
        self.total_env_steps += n_steps
        self.iteration += 1
        wall = time.perf_counter() - t0
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": n_steps,
            "num_env_steps_sampled_lifetime": self.total_env_steps,
            "episode_return_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")
            ),
            "env_steps_per_sec": n_steps / max(wall, 1e-9),
            "time_sample_s": sample_time,
            "time_learn_s": learn_time,
            **metrics,
        }

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

    # -- Tune integration (Algorithm is a trainable) ------------------------

    @classmethod
    def as_trainable(cls, config: PPOConfig, stop_iters: int = 50,
                     stop_reward: Optional[float] = None):
        """A function trainable for tune (reference: Algorithm is a
        Trainable).  Refused until ``tune`` is ported."""
        as_trainable_refused(cls)
