"""ray_tpu_torch.rllib: reinforcement learning's device compute (port of
``ray_tpu/rllib/``).

Role-equivalent to RLlib's new API stack (reference: rllib/ — EnvRunners
sample vectorized envs, a Learner updates the policy, weights sync between
them).  The learners (PPO, DQN, IMPALA's V-trace, SAC, BC) are PyTorch on
the card unless ``device="cpu"``, sharded over a mesh's dp x fsdp when
given one; the env runners are plain in-process objects.  The algorithms
(``PPO``, ``DQN``, ``Impala``, ``SAC``, ``MultiAgentPPO``, their configs'
``build()`` and ``as_trainable``) run runners as actors and wait for the
port's runtime.  JAX weights carry across through the
``*_params_from_jax`` functions.
"""

from .dqn import DQNLearner, QParams, init_q, q_forward, q_params_from_jax
from .env import CartPoleEnv, CatchEnv, VectorEnv, make_env, register_env
from .env_runner import EnvRunner
from .impala import ImpalaEnvRunner, ImpalaLearner
from .learner import (PolicyParams, PPOLearner, compute_gae, init_policy,
                      policy_forward, policy_params_from_jax,
                      sample_categorical)
from .models import CNNModel, MLPModel, cnn_params_from_jax, default_model
from .multi_agent import (MultiAgentCartPole, MultiAgentEnv,
                          MultiAgentEnvRunner, make_multi_env)
from .offline import (BC, JsonReader, JsonWriter, collect_offline_dataset,
                      importance_sampling_estimate)
from .replay import ReplayBuffer
from .sac import (ContinuousEnvRunner, PendulumEnv, SACLearner,
                  sac_params_from_jax)

__all__ = [
    "PPOLearner", "EnvRunner", "ImpalaEnvRunner", "ImpalaLearner",
    "DQNLearner", "QParams", "init_q", "q_forward", "q_params_from_jax",
    "ReplayBuffer", "SACLearner", "ContinuousEnvRunner", "PendulumEnv",
    "sac_params_from_jax",
    "MultiAgentEnv", "MultiAgentCartPole", "MultiAgentEnvRunner",
    "make_multi_env",
    "CNNModel", "MLPModel", "default_model", "cnn_params_from_jax",
    "BC", "JsonReader", "JsonWriter", "collect_offline_dataset",
    "importance_sampling_estimate",
    "CartPoleEnv", "CatchEnv", "VectorEnv", "make_env", "register_env",
    "PolicyParams", "compute_gae", "init_policy", "policy_forward",
    "policy_params_from_jax", "sample_categorical",
]
