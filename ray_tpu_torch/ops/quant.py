"""Weight-only int8 quantization (w8a16), counterpart of
``ray_tpu/ops/quant.py``.

A quantized weight is a dict ``{"q": int8[w.shape], "s": f32[output
dims]}``: symmetric per-output-channel scales, indexed by the dims a
matmul does NOT contract, so ``einsum(x, q) * s`` equals
dequantize-then-matmul. Embeddings are quantized per row. Every
projection of the serving path goes through :func:`weight_einsum`; the
products themselves are plain ``torch.einsum`` (the reference leaves
them to XLA).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

__all__ = [
    "quantize_weight", "dequantize_weight", "weight_einsum",
    "embed_lookup", "quantize_params", "init_params_quantized",
    "is_quantized",
]


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_weight(w: torch.Tensor,
                    contract_axes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8; ``contract_axes`` are the axes a
    matmul will contract (reduced out of the scale)."""
    wf = w.float()
    axes = tuple(contract_axes)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, one ulp off the reference's division for some scales
    s = wf.abs().amax(dim=axes).clamp_min(1e-8) / torch.full(
        (), 127.0, device=wf.device)
    s_b = s
    for a in sorted(axes):
        s_b = s_b.unsqueeze(a)
    q = torch.clamp(torch.round(wf / s_b), -127, 127).to(torch.int8)
    return {"q": q, "s": s.float()}


def dequantize_weight(w: Dict[str, torch.Tensor],
                      contract_axes: Sequence[int],
                      dtype=torch.bfloat16) -> torch.Tensor:
    s_b = w["s"]
    for a in sorted(contract_axes):
        s_b = s_b.unsqueeze(a)
    return (w["q"].float() * s_b).to(dtype)


def weight_einsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` for a raw or quantized ``w``, in x's
    dtype. For a quantized weight the scale multiplies the OUTPUT in f32
    (exact for per-output-channel scales). Every output dim of ``w`` must
    be a trailing suffix of the output spec, in the order of ``s``."""
    if not is_quantized(w):
        return torch.einsum(eq, x, w)
    out = torch.einsum(eq, x, w["q"].to(x.dtype))
    return (out.float() * w["s"]).to(out.dtype)


class _MatmulF32Out(torch.autograd.Function):
    """``x2 @ w`` in the operands' dtype with an f32 result (cuBLAS, f32
    accumulation). Its backward gives dX and dW in the operands' dtype,
    also accumulated in f32, from the gradient rounded to that dtype."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x2.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def logits_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x [..., d] @ w [d, V]`` (raw, or quantized with scales [V]) with
    operands in x's dtype, f32 accumulation and an f32 result: the
    reference's ``preferred_element_type=float32`` for the lm_head. On
    the card a bf16 product goes to cuBLAS with an f32 output (no f32
    copy of the weight), differentiable through :class:`_MatmulF32Out`;
    elsewhere the operands are upcast exactly and multiplied in f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    wm = w["q"].to(x.dtype) if is_quantized(w) else w.to(x.dtype)
    if x2.is_cuda and x2.dtype != torch.float32:
        out = _MatmulF32Out.apply(x2, wm)
    else:
        out = x2.float() @ wm.float()
    if is_quantized(w):
        out = out * w["s"]
    return out.reshape(*lead, out.shape[-1])


def embed_lookup(embed, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """Embedding row gather for raw or per-row-quantized tables."""
    idx = tokens.long()
    if not is_quantized(embed):
        x = embed[idx]
        return x if dtype is None else x.to(dtype)
    rows = embed["q"][idx].float()
    x = rows * embed["s"][idx][..., None]
    return x.to(dtype or torch.bfloat16)


# contract axes of the stacked Llama layer tree (leading "layers" axis
# is never contracted); matches models/llama.py init_params
_LLAMA_LAYER_CONTRACT = {
    "wq": (1,),      # (L, d, h, hd)   contract d
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),    # (L, h, hd, d)   contract h, hd
    "w_gate": (1,),  # (L, d, m)       contract d
    "w_up": (1,),
    "w_down": (1,),  # (L, m, d)       contract m
}


def quantize_params(params: Dict, cfg=None) -> Dict:
    """Quantize a dense-Llama tree for serving: projections, embedding
    (per row) and lm_head go int8; norms stay as they are."""
    if cfg is not None and getattr(cfg, "n_experts", 0):
        raise NotImplementedError(
            "int8 quantization for MoE expert weights is not wired up")
    layers = dict(params["layers"])
    for name, axes in _LLAMA_LAYER_CONTRACT.items():
        if name in layers:
            layers[name] = quantize_weight(layers[name], axes)
    return {
        "embed": quantize_weight(params["embed"], (1,)),
        "layers": layers,
        "final_norm": params["final_norm"],
        "lm_head": quantize_weight(params["lm_head"], (0,)),
    }


def init_params_quantized(cfg, seed: int = 0, device=None) -> Dict:
    """Random int8 params made directly on the device: uniform int8 bits
    with scales chosen so dequantized weights look like the 1/sqrt(fan_in)
    init (uniform int8 has RMS ~74, so s = fan_in**-0.5 / 74)."""
    from .._private.device import resolve_device

    if getattr(cfg, "n_experts", 0):
        raise NotImplementedError("quantized init for MoE not wired up")
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(dev)
    if gen is not None:
        gen.manual_seed(seed)
    L, d, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    h, hkv, m = cfg.n_heads, cfg.n_kv_heads, cfg.mlp_dim

    def qrand(shape, fan_in, out_dims):
        q = torch.empty(shape, dtype=torch.int8, device=dev)
        if gen is not None:
            q.random_(-128, 128, generator=gen)
        s_shape = tuple(shape[i] for i in out_dims)
        s = torch.full(s_shape, (fan_in ** -0.5) / 74.0,
                       dtype=torch.float32, device=dev)
        return {"q": q, "s": s}

    def ones(shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    return {
        "embed": qrand((cfg.vocab, d), d, (0,)),
        "layers": {
            "attn_norm": ones((L, d)),
            "wq": qrand((L, d, h, hd), d, (0, 2, 3)),
            "wk": qrand((L, d, hkv, hd), d, (0, 2, 3)),
            "wv": qrand((L, d, hkv, hd), d, (0, 2, 3)),
            "wo": qrand((L, h, hd, d), h * hd, (0, 3)),
            "mlp_norm": ones((L, d)),
            "w_gate": qrand((L, d, m), d, (0, 2)),
            "w_up": qrand((L, d, m), d, (0, 2)),
            "w_down": qrand((L, m, d), m, (0, 2)),
        },
        "final_norm": ones((d,)),
        "lm_head": qrand((d, cfg.vocab), d, (1,)),
    }
