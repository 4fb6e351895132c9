"""Multi-agent environments + runner (port of
``ray_tpu/rllib/multi_agent.py``).

Role-equivalent to the reference's multi-agent stack (reference:
rllib/env/multi_agent_env.py:31 MultiAgentEnv — dict obs/action/reward
keyed by agent id, per-agent termination plus the "__all__" flag;
rllib/env/multi_agent_env_runner.py — one env per runner, episodes routed
to policies via policy_mapping_fn).

Trajectories are tensorized per policy inside the runner (GAE computed
runner-side at fragment boundaries, so ragged per-agent episodes never
ship), and each policy is a (model, params) pair, so heterogeneous
architectures per policy work out of the box.  ``MultiAgentPPOConfig`` and
``MultiAgentPPO`` train one ``PPOLearner`` per policy in the driver (on
the card unless the config says ``device="cpu"``) from runner actors
granted no card (built with ``device="cpu"``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ..device import DeviceLike, resolve_device
from .env import CartPoleEnv
from .learner import compute_gae, is_state, sample_categorical


class MultiAgentEnv:
    """Protocol: subclasses define possible_agents and per-agent spaces.

    reset(seed) -> {agent_id: obs}
    step({agent_id: action}) -> (obs_d, reward_d, terminated_d, truncated_d)
      where terminated_d/truncated_d carry per-agent flags plus "__all__".
    Only agents present in the returned obs dict act next step; an agent
    absent from obs but present in reward_d receives its final reward
    (reference: multi_agent_env.py:96 step docs).
    """

    possible_agents: List[str] = []

    def observation_shape(self, agent_id: str) -> Tuple[int, ...]:
        raise NotImplementedError

    def num_actions(self, agent_id: str) -> int:
        raise NotImplementedError

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]):
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPoles, one per agent; agents terminate individually
    and the episode ends when all have (reference:
    rllib/examples/envs/classes/multi_agent.py MultiAgentCartPole)."""

    def __init__(self, num_agents: int = 2, seed: Optional[int] = None):
        self.possible_agents = [f"agent_{i}" for i in range(num_agents)]
        base = 0 if seed is None else seed
        self.envs = {
            a: CartPoleEnv(seed=base * 1000 + i)
            for i, a in enumerate(self.possible_agents)
        }
        self.done: Dict[str, bool] = {}

    def observation_shape(self, agent_id: str) -> Tuple[int, ...]:
        return (4,)

    def num_actions(self, agent_id: str) -> int:
        return 2

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        self.done = {a: False for a in self.possible_agents}
        return {
            a: env.reset(None if seed is None else seed + i)
            for i, (a, env) in enumerate(self.envs.items())
        }

    def step(self, actions: Dict[str, int]):
        obs, rew, term, trunc = {}, {}, {}, {}
        for a, act in actions.items():
            if self.done[a]:
                continue
            o, r, te, tr = self.envs[a].step(act)
            rew[a] = r
            term[a] = te
            trunc[a] = tr
            if te or tr:
                self.done[a] = True
            else:
                obs[a] = o
        term["__all__"] = all(self.done.values())
        trunc["__all__"] = False
        return obs, rew, term, trunc


MULTI_ENV_REGISTRY: Dict[str, Any] = {
    "MultiAgentCartPole": MultiAgentCartPole,
}


def make_multi_env(spec, **kwargs):
    if isinstance(spec, str):
        return MULTI_ENV_REGISTRY[spec](**kwargs)
    return spec(**kwargs)


class _AgentFragment:
    """Per-agent trajectory accumulator inside one runner fragment."""

    __slots__ = ("obs", "actions", "logp", "values", "rewards")

    def __init__(self):
        self.obs: List[np.ndarray] = []
        self.actions: List[int] = []
        self.logp: List[float] = []
        self.values: List[float] = []
        self.rewards: List[float] = []


class MultiAgentEnvRunner:
    """One multi-agent env per runner (reference:
    multi_agent_env_runner.py — multi-agent envs aren't vectorized; scale
    comes from more runner actors).  Emits per-POLICY training rows with
    GAE already applied, so ragged per-agent episodes never cross the wire.

    A plain in-process object: it becomes an actor with the port's runtime,
    whose algorithms pass ``device="cpu"`` (the JAX actor pins itself to
    the CPU with ``JAX_PLATFORMS``; the port copies no such default, so
    the policies run on the card unless ``device="cpu"``).
    """

    def __init__(self, env_spec, policy_mapping: Dict[str, str],
                 models: Dict[str, Any], *, gamma: float = 0.99,
                 lambda_: float = 0.95, seed: int = 0, env_kwargs=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.env = make_multi_env(env_spec, **(env_kwargs or {}))
        self.policy_mapping = dict(policy_mapping)
        self.models = models
        self.gamma = gamma
        self.lambda_ = lambda_
        self._rng = np.random.default_rng(seed + 1)
        self._seed = seed
        self._params: Dict[str, Any] = {}
        self.obs = self.env.reset(seed=seed)
        self._episode_return = {a: 0.0 for a in self.env.possible_agents}
        self.completed_returns: List[float] = []

    def set_weights(self, weights: Dict[str, Any]) -> bool:
        """Per policy, its learner's ``get_weights`` state or a JAX tree of
        numpy arrays (its model's ``from_jax`` layout)."""
        for pid, w in weights.items():
            model = self.models[pid]
            if not is_state(w):
                self._params[pid] = model.from_jax(w, self.device)
                continue
            if pid not in self._params:
                self._params[pid] = model.init(device=self.device)
            self._params[pid].load_state_dict(w)
        return True

    @torch.no_grad()
    def _forward(self, pid: str, obs: np.ndarray):
        """(logits, values) of policy ``pid`` on host obs, as numpy."""
        x = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)
        logits, value = self.models[pid].apply(self._params[pid], x)
        return logits.cpu().numpy(), value.cpu().numpy()

    def env_info(self) -> Dict[str, Any]:
        env = self.env
        return {
            "agents": list(env.possible_agents),
            "observation_shapes": {
                a: tuple(env.observation_shape(a))
                for a in env.possible_agents
            },
            "num_actions": {
                a: env.num_actions(a) for a in env.possible_agents
            },
        }

    def sample(self, num_steps: int) -> Dict[str, Dict[str, np.ndarray]]:
        """Run num_steps env steps; return {policy_id: rows} where rows are
        flat {obs, actions, logp_old, advantages, returns} plus metrics."""
        frags: Dict[str, _AgentFragment] = {}
        out: Dict[str, Dict[str, List]] = {
            pid: {"obs": [], "actions": [], "logp_old": [],
                  "advantages": [], "returns": []}
            for pid in self.models
        }

        def finish(agent: str, bootstrap: float):
            """Close an agent trajectory: GAE with the given bootstrap for
            the final step, then append rows to its policy's buffers."""
            fr = frags.pop(agent, None)
            if fr is None or not fr.actions:
                return
            T = len(fr.actions)
            rewards = np.asarray(fr.rewards, np.float32)[:, None]
            values = np.asarray(fr.values, np.float32)[:, None]
            # bootstrap_values[t] = V(s_{t+1}): next row's value inside the
            # fragment, the provided bootstrap for the last row.
            boot = np.empty((T, 1), np.float32)
            boot[:-1, 0] = values[1:, 0]
            boot[-1, 0] = bootstrap
            dones = np.zeros((T, 1), np.bool_)
            dones[-1, 0] = True  # cut the recursion at the fragment edge
            adv, ret = compute_gae(rewards, values, boot, dones,
                                   self.gamma, self.lambda_)
            pid = self.policy_mapping[agent]
            out[pid]["obs"].extend(fr.obs)
            out[pid]["actions"].extend(fr.actions)
            out[pid]["logp_old"].extend(fr.logp)
            out[pid]["advantages"].extend(adv[:, 0].tolist())
            out[pid]["returns"].extend(ret[:, 0].tolist())

        for _ in range(num_steps):
            if not self.obs:  # every agent done: episode rolls over
                self.obs = self.env.reset()
                for a in self._episode_return:
                    self._episode_return[a] = 0.0
            # Group live agents by policy for batched forward passes.
            by_policy: Dict[str, List[str]] = {}
            for a in self.obs:
                by_policy.setdefault(self.policy_mapping[a], []).append(a)
            actions: Dict[str, int] = {}
            step_info: Dict[str, Tuple[int, float, float]] = {}
            for pid, agents in by_policy.items():
                stack = np.stack([self.obs[a] for a in agents])
                logits, value = self._forward(pid, stack)
                acts, logps = sample_categorical(logits, self._rng)
                for i, a in enumerate(agents):
                    actions[a] = int(acts[i])
                    step_info[a] = (int(acts[i]), float(logps[i]),
                                    float(value[i]))
            prev_obs = self.obs
            next_obs, rewards, terms, truncs = self.env.step(actions)
            for a, (act, logp, val) in step_info.items():
                fr = frags.setdefault(a, _AgentFragment())
                fr.obs.append(prev_obs[a])
                fr.actions.append(act)
                fr.logp.append(logp)
                fr.values.append(val)
                fr.rewards.append(rewards.get(a, 0.0))
                self._episode_return[a] += rewards.get(a, 0.0)
                if terms.get(a):
                    self.completed_returns.append(self._episode_return[a])
                    finish(a, 0.0)
                elif truncs.get(a):
                    # Truncated without a successor obs in this protocol:
                    # bootstrap from the last value estimate.
                    self.completed_returns.append(self._episode_return[a])
                    finish(a, val)
            # Protocol: an agent absent from obs (it didn't act this step)
            # may still receive a (final) reward — e.g. turn-based envs
            # deliver it one step late.  Credit it to the agent's LAST
            # acted step (multi_agent_env.py:96 step docs).
            for a, r in rewards.items():
                if a in step_info:
                    continue
                fr = frags.get(a)
                if fr is not None and fr.rewards:
                    fr.rewards[-1] += r
                self._episode_return[a] = (
                    self._episode_return.get(a, 0.0) + r)
                if terms.get(a) or truncs.get(a):
                    self.completed_returns.append(self._episode_return[a])
                    finish(a, 0.0 if terms.get(a)
                           else (fr.values[-1] if fr and fr.values else 0.0))
            self.obs = next_obs

        # Fragment boundary: bootstrap live agents from V(current obs).
        for a in list(frags):
            pid = self.policy_mapping[a]
            if a in self.obs:
                _, v = self._forward(pid, self.obs[a][None])
                finish(a, float(v[0]))
            else:
                finish(a, 0.0)

        result: Dict[str, Any] = {}
        for pid, rows in out.items():
            if rows["actions"]:
                result[pid] = {
                    "obs": np.asarray(rows["obs"], np.float32),
                    "actions": np.asarray(rows["actions"], np.int32),
                    "logp_old": np.asarray(rows["logp_old"], np.float32),
                    "advantages": np.asarray(rows["advantages"], np.float32),
                    "returns": np.asarray(rows["returns"], np.float32),
                }
        drained, self.completed_returns = self.completed_returns, []
        result["__metrics__"] = {
            "episode_returns": np.asarray(drained, np.float64),
        }
        return result


#: The runner as an actor (the JAX package's ``MultiAgentEnvRunner`` is
#: one).
MultiAgentEnvRunnerActor = ray_tpu_torch.remote(MultiAgentEnvRunner)


class MultiAgentPPOConfig:
    """Fluent config for multi-agent PPO (reference: AlgorithmConfig
    .multi_agent(policies=..., policy_mapping_fn=...))."""

    def __init__(self):
        self.env_spec: Any = "MultiAgentCartPole"
        self.env_kwargs: Dict[str, Any] = {}
        self.num_env_runners = 2
        self.rollout_fragment_length = 256
        self.policies: List[str] = []
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.entropy_coeff = 0.01
        self.num_epochs = 10
        self.minibatch_size = 128
        self.hidden = 64
        self.seed = 0
        self.models: Dict[str, Any] = {}
        # The learners' device (the card unless "cpu") and their starting
        # weights ({policy: get_weights state or JAX tree}), as PPOConfig's.
        self.device = None
        self.initial_weights: Optional[Dict[str, Any]] = None

    def environment(self, env: Any, **env_kwargs) -> "MultiAgentPPOConfig":
        self.env_spec = env
        self.env_kwargs = env_kwargs
        return self

    def multi_agent(self, *, policies: List[str],
                    policy_mapping_fn: Callable[[str], str]
                    ) -> "MultiAgentPPOConfig":
        self.policies = list(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def env_runners(self, num_env_runners: int = 2,
                    rollout_fragment_length: int = 256
                    ) -> "MultiAgentPPOConfig":
        self.num_env_runners = num_env_runners
        self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "MultiAgentPPOConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """One PPOLearner per policy; runners route experience by
    policy_mapping_fn (reference: ppo.py training_step over a
    MultiAgentEpisode buffer + one Learner per module in the LearnerGroup).
    """

    def __init__(self, config: MultiAgentPPOConfig):
        from .learner import PPOLearner
        from .models import default_model

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.config = config
        probe_env = make_multi_env(config.env_spec, **config.env_kwargs)
        agents = list(probe_env.possible_agents)
        if not config.policies:
            config.policies = ["shared"]
        mapping_fn = config.policy_mapping_fn or (lambda a: config.policies[0])
        self.policy_mapping = {a: mapping_fn(a) for a in agents}
        unknown = set(self.policy_mapping.values()) - set(config.policies)
        assert not unknown, f"mapping produced unknown policies: {unknown}"

        # Per-policy spaces must agree across that policy's agents.
        self.models: Dict[str, Any] = {}
        self.learners: Dict[str, PPOLearner] = {}
        for pid in config.policies:
            pid_agents = [a for a, p in self.policy_mapping.items()
                          if p == pid]
            if not pid_agents:
                continue
            shapes = {tuple(probe_env.observation_shape(a))
                      for a in pid_agents}
            acts = {probe_env.num_actions(a) for a in pid_agents}
            assert len(shapes) == 1 and len(acts) == 1, (
                f"policy {pid!r} maps agents with mismatched spaces: "
                f"{shapes} / {acts}")
            obs_shape, n_actions = shapes.pop(), acts.pop()
            model = config.models.get(pid) or default_model(
                obs_shape, n_actions, config.hidden)
            self.models[pid] = model
            self.learners[pid] = PPOLearner(
                int(np.prod(obs_shape)), n_actions, lr=config.lr,
                clip_param=config.clip_param,
                entropy_coeff=config.entropy_coeff, hidden=config.hidden,
                # Stable per-policy seed: list position, not hash() (which
                # is salted per process and would break reproducibility).
                seed=config.seed + config.policies.index(pid), model=model,
                device=config.device,
            )
            if config.initial_weights and pid in config.initial_weights:
                self.learners[pid].set_weights(config.initial_weights[pid])

        self.runners = [
            MultiAgentEnvRunnerActor.remote(
                config.env_spec, self.policy_mapping, self.models,
                gamma=config.gamma, lambda_=config.lambda_,
                seed=config.seed + i, env_kwargs=config.env_kwargs,
                device="cpu",
            )
            for i in range(config.num_env_runners)
        ]
        self._sync_weights()
        self.iteration = 0
        self.total_env_steps = 0
        self._recent_returns: List[float] = []

    def _sync_weights(self):
        ref = ray_tpu_torch.put({
            pid: ln.get_weights() for pid, ln in self.learners.items()
        })
        ray_tpu_torch.get([r.set_weights.remote(ref) for r in self.runners])

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        samples = ray_tpu_torch.get([
            r.sample.remote(cfg.rollout_fragment_length)
            for r in self.runners
        ])
        metrics: Dict[str, Any] = {}
        n_rows = 0
        for pid, learner in self.learners.items():
            parts = [s[pid] for s in samples if pid in s]
            if not parts:
                continue
            batch = {
                k: np.concatenate([p[k] for p in parts])
                for k in parts[0]
            }
            n_rows += len(batch["actions"])
            pm = learner.update_from_batch(
                batch, num_epochs=cfg.num_epochs,
                minibatch_size=min(cfg.minibatch_size,
                                   len(batch["actions"])),
                seed=cfg.seed + self.iteration,
            )
            metrics[pid] = pm
        for s in samples:
            self._recent_returns.extend(
                s["__metrics__"]["episode_returns"].tolist())
        self._recent_returns = self._recent_returns[-200:]
        self._sync_weights()
        self.iteration += 1
        self.total_env_steps += n_rows
        wall = time.perf_counter() - t0
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": n_rows,
            "num_env_steps_sampled_lifetime": self.total_env_steps,
            "episode_return_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")
            ),
            "env_steps_per_sec": n_rows / max(wall, 1e-9),
            "policies": metrics,
        }

    def get_policy_weights(self, pid: str):
        return self.learners[pid].get_weights()

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
