from .convert import (lora_from_jax, opt_state_from_jax, params_from_jax,
                      params_to_numpy)
from .llama import (LLAMA_CONFIGS, LlamaConfig, forward, init_params,
                    lm_loss, unstack_layers)

__all__ = ["LLAMA_CONFIGS", "LlamaConfig", "forward", "init_params",
           "lm_loss", "lora_from_jax", "opt_state_from_jax",
           "params_from_jax", "params_to_numpy", "unstack_layers"]
