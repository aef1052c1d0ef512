"""ray_tpu_torch.rllib: the RL library in PyTorch (counterpart of
``ray_tpu/rllib``): PPO, IMPALA/APPO, DQN, SAC, BC/MARWIL and GRPO (LLM
RLHF on the port's Llama, through the flash kernels on the card).

Learners run on the card unless the algorithm is built with
``device="cpu"``. The env runners act on the CPU from host copies of the
weights, placed by a ``RunnerHooks`` (``build(hooks=...)``): in this
process by default, ``ray_tpu`` actors when the hooks are ``ray_tpu``'s
functions. ``rollout_dataset`` hands recorded rollouts to a Dataset
constructor of the caller's (``ray_tpu.data.from_items``)."""

from .env import CartPole, make_env
from .dqn import DQN, DQNConfig
from .grpo import GRPO, GRPOConfig
from .impala import IMPALA, IMPALAConfig
from .appo import APPO, APPOConfig
from .offline import (BC, BCConfig, MARWIL, MARWILConfig, record_rollouts,
                      rollout_dataset)
from .ppo import PPO, PPOConfig, EnvRunner
from .runners import LOCAL, RunnerHooks
from .sac import SAC, SACConfig

__all__ = ["PPO", "PPOConfig", "DQN", "DQNConfig", "SAC",
           "SACConfig", "IMPALA", "APPO", "APPOConfig",
           "IMPALAConfig", "BC", "BCConfig", "MARWIL", "MARWILConfig",
           "GRPO", "GRPOConfig", "EnvRunner", "CartPole", "make_env",
           "record_rollouts", "rollout_dataset", "RunnerHooks", "LOCAL"]
