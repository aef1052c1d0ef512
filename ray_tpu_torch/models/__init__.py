from .convert import (lora_from_jax, opt_state_from_jax, params_from_jax,
                      params_to_numpy)
from .._private.tree import unstack_layers
from .llama import LLAMA_CONFIGS, LlamaConfig, forward, init_params, lm_loss
from .mamba import (MAMBA_CONFIGS, MambaConfig, init_mamba, mamba_forward,
                    mamba_lm_loss)

__all__ = ["LLAMA_CONFIGS", "LlamaConfig", "MAMBA_CONFIGS", "MambaConfig",
           "forward", "init_mamba", "init_params", "lm_loss",
           "lora_from_jax", "mamba_forward", "mamba_lm_loss",
           "opt_state_from_jax", "params_from_jax", "params_to_numpy",
           "unstack_layers"]
