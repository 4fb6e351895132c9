"""ray_tpu_torch.rllib: reinforcement learning on the port's runtime (port
of ``ray_tpu/rllib/``).

Role-equivalent to RLlib's new API stack (reference: rllib/ — EnvRunners
sample vectorized envs, a Learner updates the policy, weights sync between
them).  The algorithms (``PPO``, ``DQN``, ``Impala``, ``SAC``,
``MultiAgentPPO``, built from their configs) run their env runners as
actors granted no card (``device="cpu"`` in the runner) and keep the
learner in the driver: PyTorch on the card unless the config says
``device="cpu"``, sharded over a mesh's dp x fsdp when given one.  The
runners are also plain in-process objects.  JAX weights carry across
through the ``*_params_from_jax`` functions and each config's
``initial_weights``.  ``PPO.as_trainable`` and ``DQN.as_trainable`` give
``ray_tpu_torch.tune`` a function trainable.
"""

from .dqn import (DQN, DQNConfig, DQNLearner, QParams, init_q, q_forward,
                  q_params_from_jax)
from .env import CartPoleEnv, CatchEnv, VectorEnv, make_env, register_env
from .env_runner import EnvRunner
from .impala import Impala, ImpalaConfig, ImpalaEnvRunner, ImpalaLearner
from .learner import (PolicyParams, PPOLearner, compute_gae, init_policy,
                      policy_forward, policy_params_from_jax,
                      sample_categorical)
from .models import CNNModel, MLPModel, cnn_params_from_jax, default_model
from .multi_agent import (MultiAgentCartPole, MultiAgentEnv,
                          MultiAgentEnvRunner, MultiAgentPPO,
                          MultiAgentPPOConfig, make_multi_env)
from .offline import (BC, JsonReader, JsonWriter, collect_offline_dataset,
                      importance_sampling_estimate)
from .ppo import PPO, PPOConfig
from .replay import ReplayBuffer
from .sac import (SAC, ContinuousEnvRunner, PendulumEnv, SACConfig,
                  SACLearner, sac_params_from_jax)

__all__ = [
    "PPO", "PPOConfig", "PPOLearner", "EnvRunner",
    "Impala", "ImpalaConfig", "ImpalaEnvRunner", "ImpalaLearner",
    "DQN", "DQNConfig", "DQNLearner", "QParams", "init_q", "q_forward",
    "q_params_from_jax", "ReplayBuffer",
    "SAC", "SACConfig", "SACLearner", "ContinuousEnvRunner", "PendulumEnv",
    "sac_params_from_jax",
    "MultiAgentEnv", "MultiAgentCartPole", "MultiAgentEnvRunner",
    "MultiAgentPPO", "MultiAgentPPOConfig", "make_multi_env",
    "CNNModel", "MLPModel", "default_model", "cnn_params_from_jax",
    "BC", "JsonReader", "JsonWriter", "collect_offline_dataset",
    "importance_sampling_estimate",
    "CartPoleEnv", "CatchEnv", "VectorEnv", "make_env", "register_env",
    "PolicyParams", "compute_gae", "init_policy", "policy_forward",
    "policy_params_from_jax", "sample_categorical",
]
