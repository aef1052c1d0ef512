"""Mamba-2 family and the Jamba hybrid in PyTorch (counterpart of
``ray_tpu/models/mamba.py``).

A Mamba-2 block: one in_proj emits [z | x | B | C | dt], a short causal
depthwise conv warms x/B/C locally, the chunked SSD (ops/ssd.py) mixes
along the sequence, the gate z modulates, and out_proj returns to the
residual stream. The Jamba hybrid ends every ``attn_period`` layers with
one GQA attention layer, through ``ops.attention`` (the flash kernels and
their backward on the card).

Parameters are the reference's stacked tree, so a ``ray_tpu`` tree
converts leaf for leaf (models/convert.py); the forward also takes the
trainer's per-layer lists (``unstack_layers``). Remat is per layer, or
per period for Jamba, with ``torch.utils.checkpoint``.
``mamba_param_axes`` gives the params' logical axes for the multi-device
plane (``parallel``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._private.device import resolve_device
from .._private.tree import layer_params
from ..ops import apply_rotary, attention, rms_norm, rope_frequencies
from ..ops.ssd import ssd_chunked


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    vocab: int = 32768
    dim: int = 768
    n_layers: int = 24
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64
    dt_min: float = 0.001
    dt_max: float = 0.1
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    # Jamba hybrid: every attn_period-th layer is one attention layer
    # (n_layers must divide by attn_period); 0 = pure Mamba
    attn_period: int = 0
    attn_heads: int = 8
    attn_kv_heads: int = 4
    rope_theta: float = 10000.0

    def __post_init__(self):
        if self.attn_period:
            if self.n_layers % self.attn_period:
                raise ValueError(
                    f"n_layers={self.n_layers} must divide by "
                    f"attn_period={self.attn_period}")
            if self.dim % self.attn_heads:
                raise ValueError(
                    f"dim={self.dim} must divide by "
                    f"attn_heads={self.attn_heads}")
            if self.attn_heads % self.attn_kv_heads:
                raise ValueError(
                    f"attn_heads={self.attn_heads} must divide by "
                    f"attn_kv_heads={self.attn_kv_heads}")

    @property
    def inner(self) -> int:
        return self.expand * self.dim

    @property
    def n_heads(self) -> int:
        return self.inner // self.head_dim

    @property
    def n_attn_layers(self) -> int:
        return self.n_layers // self.attn_period if self.attn_period else 0

    @property
    def n_mamba_layers(self) -> int:
        return self.n_layers - self.n_attn_layers

    def n_params(self) -> int:
        d, di, H = self.dim, self.inner, self.n_heads
        # in_proj emits z(di) + x(di) + B(N) + C(N) + dt(H) per token
        proj_in = d * (2 * di + 2 * self.state_dim + H)
        conv = self.conv_width * (di + 2 * self.state_dim)
        per_layer = proj_in + conv + di * d + 3 * H + d
        hd = d // self.attn_heads if self.attn_period else 0
        per_attn = (d * (self.attn_heads + 2 * self.attn_kv_heads) * hd
                    + self.attn_heads * hd * d + d)
        return (self.vocab * d * 2 + self.n_mamba_layers * per_layer
                + self.n_attn_layers * per_attn + d)


MAMBA_CONFIGS: Dict[str, MambaConfig] = {
    "tiny": MambaConfig(vocab=256, dim=64, n_layers=2, state_dim=16,
                        head_dim=32, chunk=16, dtype=torch.float32,
                        remat=False),
    "130m": MambaConfig(vocab=32768, dim=768, n_layers=24),
    "1b": MambaConfig(vocab=32768, dim=2048, n_layers=48),
    # Jamba-style hybrid: 3 mamba layers then 1 attention layer a period
    "jamba_tiny": MambaConfig(vocab=256, dim=64, n_layers=4, state_dim=16,
                              head_dim=32, chunk=16, attn_period=4,
                              attn_heads=4, attn_kv_heads=2,
                              dtype=torch.float32, remat=False),
    "jamba_350m": MambaConfig(vocab=32768, dim=1024, n_layers=32,
                              attn_period=4, attn_heads=8,
                              attn_kv_heads=4),
}


def mamba_param_axes(cfg: MambaConfig):
    """Tree of logical-axis tuples mirroring init_mamba's structure."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "norm": ("layers", "embed"),
            "w_in": ("layers", "embed", "mlp"),
            "conv": ("layers", "conv", "mlp"),
            "dt_bias": ("layers", "heads"),
            "A_log": ("layers", "heads"),
            "Dp": ("layers", "heads"),
            "w_out": ("layers", "mlp", "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
        **({"attn_layers": {
            "norm": ("layers", "embed"),
            "wqkv": ("layers", "embed", "heads_qkv"),
            "wo": ("layers", "heads_qkv", "embed"),
        }} if cfg.attn_period else {}),
    }


def init_mamba(cfg: MambaConfig, seed: int = 0, device=None):
    """The reference's init from a seeded torch.Generator (other values
    than the JAX init; tests carry JAX weights over with
    models/convert.py): scaled normals in ``cfg.dtype``, drawn in f32;
    ``dt_bias``, ``A_log`` and ``Dp`` in f32. ``device=None`` is the
    CUDA card; ``device="meta"`` gives the shapes without allocating."""
    dev = resolve_device(device)
    d, di, N, H = cfg.dim, cfg.inner, cfg.state_dim, cfg.n_heads
    L, La = cfg.n_mamba_layers, cfg.n_attn_layers
    f32 = torch.float32
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(dev)
        gen.manual_seed(seed)

    def draw(shape, uniform=False):
        if gen is None:
            return torch.empty(shape, dtype=f32, device=dev)
        fn = torch.rand if uniform else torch.randn
        return fn(shape, generator=gen, device=dev, dtype=f32)

    def norm(shape, fan_in):
        return (draw(shape) * fan_in ** -0.5).to(cfg.dtype)

    def ones(shape, dtype=cfg.dtype):
        return torch.ones(shape, dtype=dtype, device=dev)

    # softplus(dt_bias) spans [dt_min, dt_max] log-uniformly; the decay
    # magnitude |A| in [1, 16) draws independently
    u, ua = draw((L, H), True), draw((L, H), True)
    dt_init = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                        + math.log(cfg.dt_min))
    params = {
        "embed": norm((cfg.vocab, d), d),
        "layers": {
            "norm": ones((L, d)),
            "w_in": norm((L, d, 2 * di + 2 * N + H), d),
            "conv": norm((L, cfg.conv_width, di + 2 * N), cfg.conv_width),
            # inverse softplus
            "dt_bias": dt_init + torch.log(-torch.expm1(-dt_init)),
            "A_log": torch.log(1.0 + ua * 15.0),
            "Dp": ones((L, H), f32),
            "w_out": norm((L, di, d), di),
        },
        "final_norm": ones((d,)),
        "lm_head": norm((d, cfg.vocab), d),
    }
    if cfg.attn_period:
        hd = d // cfg.attn_heads
        params["attn_layers"] = {
            "norm": ones((La, d)),
            "wqkv": norm((La, d, (cfg.attn_heads + 2 * cfg.attn_kv_heads)
                          * hd), d),
            "wo": norm((La, d, d), d),
        }
    return params


def _causal_depthwise_conv(x, w):
    """x: (B, S, C), w: (K, C): causal depthwise conv along S, as K
    shifted multiply-adds."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pad[:, k:k + S, :] * w[k][None, None, :]
    return out


def _block(x, lp, cfg: MambaConfig):
    B_, S, _ = x.shape
    di, N, H, P = cfg.inner, cfg.state_dim, cfg.n_heads, cfg.head_dim
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    z, xs, Bc, Cc, dt_raw = torch.split(h @ lp["w_in"], [di, di, N, N, H],
                                        dim=-1)
    # local conv over the SSD operands (x, B, C together)
    conv_out = F.silu(_causal_depthwise_conv(torch.cat([xs, Bc, Cc], -1),
                                             lp["conv"]))
    xs, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + lp["dt_bias"].float()[None, None, :])
    A = -torch.exp(lp["A_log"].float())
    # B/C shared by the heads (one group): the (B, S, 1, N) shape keeps
    # ssd_chunked from repeating them over heads
    y = ssd_chunked(xs.reshape(B_, S, H, P), dt, A, Bc[:, :, None, :],
                    Cc[:, :, None, :], lp["Dp"], cfg.chunk)
    y = y.reshape(B_, S, di) * F.silu(z)
    return x + (y @ lp["w_out"]).to(x.dtype)


def _attn_block(x, ap, cfg: MambaConfig, cos, sin):
    """The Jamba hybrid's GQA attention layer."""
    B_, S, d = x.shape
    hN, kvN = cfg.attn_heads, cfg.attn_kv_heads
    hd = d // hN
    h = rms_norm(x, ap["norm"], cfg.norm_eps)
    q, k, v = torch.split(h @ ap["wqkv"], [hN * hd, kvN * hd, kvN * hd],
                          dim=-1)
    q = apply_rotary(q.reshape(B_, S, hN, hd), cos, sin)
    k = apply_rotary(k.reshape(B_, S, kvN, hd), cos, sin)
    att = attention(q, k, v.reshape(B_, S, kvN, hd), causal=True)
    return x + (att.reshape(B_, S, hN * hd) @ ap["wo"]).to(x.dtype)


def _period(x, mamba_lps, ap, cfg: MambaConfig, cos, sin):
    for lp in mamba_lps:
        x = _block(x, lp, cfg)
    return _attn_block(x, ap, cfg, cos, sin)


def _remat(fn, cfg: MambaConfig):
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def mamba_forward(params, tokens: torch.Tensor, cfg: MambaConfig, *,
                  mesh: Any = None, rules=None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) in f32. The sequence is
    right-padded to a multiple of ``cfg.chunk`` (a causal model's outputs
    at real positions cannot see the pad) and cut back after the final
    norm. The lm_head product is in the model dtype, then cast to f32.
    ``mesh`` and ``rules`` are accepted for signature parity with the
    other families and ignored, as in the reference."""
    del mesh, rules
    S = tokens.shape[1]
    pad = (-S) % cfg.chunk
    if pad:
        tokens = F.pad(tokens, (0, pad))
    x = params["embed"][tokens.long()].to(cfg.dtype)
    layers = params["layers"]
    if cfg.attn_period:
        per = cfg.attn_period - 1
        cos, sin = rope_frequencies(cfg.dim // cfg.attn_heads,
                                    tokens.shape[1], cfg.rope_theta,
                                    device=tokens.device)
        body = _remat(_period, cfg)
        for p in range(cfg.n_attn_layers):
            mamba_lps = [layer_params(layers, p * per + i)
                         for i in range(per)]
            x = body(x, mamba_lps, layer_params(params["attn_layers"], p),
                     cfg, cos, sin)
    else:
        body = _remat(_block, cfg)
        for li in range(cfg.n_layers):
            x = body(x, layer_params(layers, li), cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if pad:
        x = x[:, :S]
    return (x @ params["lm_head"]).float()


def mamba_lm_loss(params, batch, cfg: MambaConfig, *, mesh: Any = None,
                  rules=None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32 (the trainer's loss_fn
    contract): the model reads tokens[:, :-1] and predicts tokens[:, 1:].
    ``mesh`` and ``rules`` are ignored, as in ``mamba_forward``."""
    del mesh, rules
    tokens = batch["tokens"]
    logits = mamba_forward(params, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    targets = tokens[:, 1:].long()
    return -logp.gather(-1, targets[..., None])[..., 0].mean()
