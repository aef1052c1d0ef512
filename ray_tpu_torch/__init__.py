"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's device plane.

It sits beside ``ray_tpu`` (the JAX reference) and imports nothing of it,
nor of JAX. It serves Llama-3, dense or MoE, on one NVIDIA H100
(whole-prompt and chunked prefill, the fused K-step decode burst,
sampling, the
continuous-batching engine with prefix caching, multi-LoRA, speculative
decoding and the export/snapshot/inject KV plane) and trains it
(``lm_loss`` under ``train.make_train_step``), and trains Mamba-2 and the
Jamba hybrid (``models.mamba``), with hand-written CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, ``csrc/paged_decode.cu``)
in place of the repository's four Pallas kernels.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from ._private.device import resolve_device

__all__ = ["resolve_device"]
