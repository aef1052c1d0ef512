"""ray_tpu_torch.rllib: the RL library in PyTorch (counterpart of
``ray_tpu/rllib``): PPO, IMPALA/APPO, DQN, SAC, BC/MARWIL and GRPO (LLM
RLHF on the port's Llama, through the flash kernels on the card).

Learners run on the card unless the algorithm is built with
``device="cpu"``. The env runners are held in-process (the reference
places them as remote actors) and act on the CPU from host copies of the
weights. ``rollout_dataset`` (``ray_tpu.data``) is not ported."""

from .env import CartPole, make_env
from .dqn import DQN, DQNConfig
from .grpo import GRPO, GRPOConfig
from .impala import IMPALA, IMPALAConfig
from .appo import APPO, APPOConfig
from .offline import BC, BCConfig, MARWIL, MARWILConfig, record_rollouts
from .ppo import PPO, PPOConfig, EnvRunner
from .sac import SAC, SACConfig

__all__ = ["PPO", "PPOConfig", "DQN", "DQNConfig", "SAC",
           "SACConfig", "IMPALA", "APPO", "APPOConfig",
           "IMPALAConfig", "BC", "BCConfig", "MARWIL", "MARWILConfig",
           "GRPO", "GRPOConfig", "EnvRunner", "CartPole", "make_env",
           "record_rollouts"]
