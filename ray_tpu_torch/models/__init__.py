from .clip import (CLIP_CONFIGS, CLIPConfig, clip_loss, clip_outputs,
                   clip_param_axes, encode_image, encode_text, init_clip)
from .convert import (lora_from_jax, opt_state_from_jax, params_from_jax,
                      params_to_numpy)
from .._private.tree import unstack_layers
from .hf_interop import (config_from_hf, config_to_hf, load_hf_checkpoint,
                         save_hf_checkpoint)
from .llama import (LLAMA_CONFIGS, LlamaConfig, forward, init_params,
                    lm_loss, param_logical_axes)
from .mamba import (MAMBA_CONFIGS, MambaConfig, init_mamba, mamba_forward,
                    mamba_lm_loss, mamba_param_axes)
from .vision import (RESNET_CONFIGS, ResNetConfig, image_loss, init_resnet,
                     resnet_forward, resnet_param_axes)

__all__ = ["CLIPConfig", "CLIP_CONFIGS", "LLAMA_CONFIGS", "LlamaConfig",
           "MAMBA_CONFIGS", "MambaConfig", "RESNET_CONFIGS", "ResNetConfig",
           "clip_loss", "clip_outputs", "clip_param_axes", "config_from_hf",
           "config_to_hf",
           "encode_image", "encode_text", "forward", "image_loss",
           "init_clip", "init_mamba", "init_params", "init_resnet",
           "load_hf_checkpoint", "lm_loss", "lora_from_jax", "mamba_forward",
           "mamba_lm_loss", "mamba_param_axes", "opt_state_from_jax",
           "param_logical_axes", "params_from_jax", "params_to_numpy",
           "resnet_forward", "resnet_param_axes", "save_hf_checkpoint",
           "unstack_layers"]
