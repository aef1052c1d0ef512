"""Tensor ops of the port: plain PyTorch (norms, rotary, the MoE
mixture, the chunked SSD, weight-only int8 quantization, ring attention
over a mesh axis), plus the hand-written CUDA kernels behind
``flash_attention`` (forward), ``flash_bwd_dq`` and ``flash_bwd_dkv``
(backward) and ``paged_decode_attention``."""

from .attention import (FlashAttention, attention, blockwise_attention,
                        dkv_route, dq_route, flash_attention,
                        flash_attention_bwd, flash_attention_bwd_reference,
                        flash_attention_reference, flash_bwd_dkv,
                        flash_bwd_dkv_reference, flash_bwd_dq,
                        flash_bwd_dq_reference, fwd_route, naive_attention)
from .moe import moe_dispatch, moe_mlp, moe_mlp_dense, moe_mlp_oracle
from .norms import rms_norm
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_reference,
                              paged_decode_splits)
from .quant import (dequantize_weight, embed_lookup, init_params_quantized,
                    quantize_params, quantize_weight, weight_einsum)
from .ring_attention import ring_attention
from .rotary import apply_rotary, rope_frequencies
from .ssd import ssd_chunked, ssd_reference

__all__ = [
    "FlashAttention", "apply_rotary", "attention", "blockwise_attention",
    "dkv_route", "dq_route", "flash_attention", "flash_attention_bwd",
    "flash_attention_bwd_reference", "flash_attention_reference",
    "flash_bwd_dkv", "flash_bwd_dkv_reference", "flash_bwd_dq",
    "flash_bwd_dq_reference", "fwd_route", "moe_dispatch", "moe_mlp",
    "moe_mlp_dense", "moe_mlp_oracle", "naive_attention",
    "paged_decode_attention", "paged_decode_attention_reference",
    "paged_decode_splits", "ring_attention", "rms_norm", "rope_frequencies",
    "ssd_chunked", "ssd_reference",
    "quantize_weight", "dequantize_weight", "weight_einsum",
    "embed_lookup", "quantize_params", "init_params_quantized",
]
