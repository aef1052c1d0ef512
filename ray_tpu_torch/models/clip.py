"""CLIP: contrastive image-text pretraining in PyTorch (counterpart of
``ray_tpu/models/clip.py``).

Two towers, a ViT image encoder (patchify is one reshape and one matmul)
and a pre-norm causal text encoder, meet in a shared embedding space under
the symmetric InfoNCE loss with a learnable temperature (Radford et al.
2021). The param tree is the reference's: each tower's layers are stacked
under ``"tower"`` (a layer group, ``_private.tree.is_layer_group``, which
the trainer splits into per-layer lists), so a ``ray_tpu`` tree converts
leaf for leaf (models/convert.py).

Attention is the port's ``ops.attention.attention``: exact softmax
attention, through the flash kernels on the card (forward, dQ and dK/dV;
head_dim 64 at ``vit_b16``, all three on the tensor cores) and their plain
versions on the CPU. The reference calls ``blockwise_attention`` (XLA, f32
probabilities); in f32 the two agree to rounding, in bf16 the kernel
rounds P to bf16 before PV, as the reference's own Pallas kernel does.
GELU is the tanh approximation, ``jax.nn.gelu``'s default. The towers run
as a loop over their layers, each under ``torch.utils.checkpoint`` when
``cfg.remat`` is set and grad is on (the reference's ``jax.checkpoint``
inside ``lax.scan``). ``clip_param_axes`` gives the logical axes the
multi-device plane (``parallel``) places the params by.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._private.device import DeviceLike, resolve_device
from .._private.tree import layer_params
from ..ops import attention, rms_norm


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    # vision tower
    image_size: int = 224
    patch: int = 16
    v_dim: int = 768
    v_layers: int = 12
    v_heads: int = 12
    # text tower
    vocab: int = 49408
    max_text: int = 77
    t_dim: int = 512
    t_layers: int = 12
    t_heads: int = 8
    # shared space
    embed_dim: int = 512
    mlp_ratio: int = 4
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    def n_params(self) -> int:
        def tower(dim, layers):
            attn = 4 * dim * dim
            mlp = 2 * dim * dim * self.mlp_ratio
            return layers * (attn + mlp + 2 * dim)
        v = (self.patch ** 2 * 3 * self.v_dim          # patch embed
             + (self.n_patches + 1) * self.v_dim       # pos + cls
             + tower(self.v_dim, self.v_layers)
             + self.v_dim * self.embed_dim)
        t = (self.vocab * self.t_dim
             + self.max_text * self.t_dim
             + tower(self.t_dim, self.t_layers)
             + self.t_dim * self.embed_dim)
        return v + t + 1


CLIP_CONFIGS: Dict[str, CLIPConfig] = {
    "tiny": CLIPConfig(image_size=32, patch=8, v_dim=64, v_layers=2,
                       v_heads=4, vocab=256, max_text=16, t_dim=64,
                       t_layers=2, t_heads=4, embed_dim=32,
                       dtype=torch.float32, remat=False),
    # ViT-B/16-class two-tower (the classic CLIP-B recipe)
    "vit_b16": CLIPConfig(),
}


def _tower_axes(prefix):
    return {
        "attn_norm": ("layers", prefix),
        "wqkv": ("layers", prefix, "heads_qkv"),
        "wo": ("layers", "heads_qkv", prefix),
        "mlp_norm": ("layers", prefix),
        "w_up": ("layers", prefix, "mlp"),
        "w_down": ("layers", "mlp", prefix),
    }


def clip_param_axes(cfg: CLIPConfig):
    """Tree of logical-axis tuples mirroring init_clip's structure."""
    return {
        "vision": {
            "patch_embed": (None, "embed"),
            "cls": (None, None, "embed"),
            "pos": (None, "embed"),
            "tower": _tower_axes("embed"),
            "norm": ("embed",),
            "proj": ("embed", "clip"),
        },
        "text": {
            "embed": ("vocab", "embed"),
            "pos": (None, "embed"),
            "tower": _tower_axes("embed"),
            "norm": ("embed",),
            "proj": ("embed", "clip"),
        },
        "logit_scale": (),
    }


def init_clip(cfg: CLIPConfig, seed: int = 0, device: DeviceLike = None):
    """Scaled-normal init (1/sqrt(fan_in)) from a seeded torch.Generator,
    stored in ``cfg.dtype``; ``logit_scale`` is an f32 scalar at
    log(1/0.07). ``device=None`` is the card; ``"meta"`` gives shapes
    only. The values differ from the JAX init (another generator); tests
    carry JAX weights over with models/convert.py."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(dev)
        gen.manual_seed(seed)

    def w(shape, fan_in):
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        if gen is not None:
            out.copy_(torch.randn(shape, generator=gen, device=dev,
                                  dtype=torch.float32) * fan_in ** -0.5)
        return out

    def fill(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=dev)

    def tower(dim, layers):
        mlp = dim * cfg.mlp_ratio
        return {"attn_norm": fill((layers, dim), 1.0),
                "wqkv": w((layers, dim, 3 * dim), dim),
                "wo": w((layers, dim, dim), dim),
                "mlp_norm": fill((layers, dim), 1.0),
                "w_up": w((layers, dim, mlp), dim),
                "w_down": w((layers, mlp, dim), mlp)}

    pd = cfg.patch * cfg.patch * 3
    vision = {"patch_embed": w((pd, cfg.v_dim), pd),
              "cls": fill((1, 1, cfg.v_dim), 0.0),
              "pos": w((cfg.n_patches + 1, cfg.v_dim), cfg.v_dim),
              "tower": tower(cfg.v_dim, cfg.v_layers),
              "norm": fill((cfg.v_dim,), 1.0),
              "proj": w((cfg.v_dim, cfg.embed_dim), cfg.v_dim)}
    text = {"embed": w((cfg.vocab, cfg.t_dim), cfg.t_dim),
            "pos": w((cfg.max_text, cfg.t_dim), cfg.t_dim),
            "tower": tower(cfg.t_dim, cfg.t_layers),
            "norm": fill((cfg.t_dim,), 1.0),
            "proj": w((cfg.t_dim, cfg.embed_dim), cfg.t_dim)}
    # exp(logit_scale) starts at 1/0.07, the CLIP-standard init
    scale = torch.log(torch.tensor(1.0 / 0.07, dtype=torch.float32))
    return {"vision": vision, "text": text, "logit_scale": scale.to(dev)}


def _layer(x, lp, heads: int, cfg: CLIPConfig, causal: bool):
    B, S, d = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    qkv = (h @ lp["wqkv"]).reshape(B, S, 3, heads, d // heads)
    att = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=causal)
    x = x + (att.reshape(B, S, d) @ lp["wo"]).to(x.dtype)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    up = F.gelu(h @ lp["w_up"], approximate="tanh")
    return x + (up @ lp["w_down"]).to(x.dtype)


def _run_tower(x, tower, heads: int, cfg: CLIPConfig, causal: bool):
    """The stacked ``tower`` (or the trainer's per-layer list) over x."""
    body = _layer
    if cfg.remat and torch.is_grad_enabled():
        body = functools.partial(checkpoint, _layer, use_reentrant=False,
                                 preserve_rng_state=False)
    n = len(tower) if isinstance(tower, list) else len(tower["wqkv"])
    for li in range(n):
        x = body(x, layer_params(tower, li), heads, cfg, causal)
    return x


def _normalize(emb):
    return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                  + 1e-8)


def encode_image(params, images, cfg: CLIPConfig):
    """images: (B, H, W, 3) -> L2-normalized (B, embed_dim) f32."""
    vp = params["vision"]
    B = images.shape[0]
    p, g = cfg.patch, cfg.image_size // cfg.patch
    # patchify as a reshape: (B, g, p, g, p, 3) -> (B, g*g, p*p*3)
    x = images.to(cfg.dtype).reshape(B, g, p, g, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, p * p * 3)
    x = x @ vp["patch_embed"]
    cls = vp["cls"].expand(B, 1, cfg.v_dim)
    x = torch.cat([cls, x], dim=1) + vp["pos"][None]
    x = _run_tower(x, vp["tower"], cfg.v_heads, cfg, causal=False)
    pooled = rms_norm(x[:, 0], vp["norm"], cfg.norm_eps)
    return _normalize((pooled @ vp["proj"]).float())


def encode_text(params, tokens, cfg: CLIPConfig):
    """tokens: (B, T) int, 0 = pad -> L2-normalized (B, embed_dim) f32.
    Pooling reads the LAST non-pad position (causal tower), CLIP's
    EOT-pooling shape."""
    tp = params["text"]
    T = tokens.shape[1]
    x = tp["embed"][tokens.long()].to(cfg.dtype) + tp["pos"][None, :T]
    x = _run_tower(x, tp["tower"], cfg.t_heads, cfg, causal=True)
    last = ((tokens != 0).sum(dim=1) - 1).clamp_min(0)
    pooled = x.gather(1, last[:, None, None].expand(-1, 1, x.shape[-1]))
    pooled = rms_norm(pooled[:, 0], tp["norm"], cfg.norm_eps)
    return _normalize((pooled @ tp["proj"]).float())


def clip_outputs(params, batch, cfg: CLIPConfig):
    """Symmetric InfoNCE over the batch's (image, text) pairs, with
    diagnostics: {"loss", "contrastive_acc", "logit_scale"}."""
    img = encode_image(params, batch["images"], cfg)
    txt = encode_text(params, batch["tokens"], cfg)
    scale = torch.exp(params["logit_scale"].clamp(-10.0, math.log(100.0)))
    logits = img @ txt.T * scale
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = -F.log_softmax(logits, dim=1).gather(1, labels[:, None]).mean()
    lt = -F.log_softmax(logits, dim=0).gather(0, labels[None, :]).mean()
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return {"loss": 0.5 * (li + lt), "contrastive_acc": acc,
            "logit_scale": scale}


def clip_loss(params, batch, cfg: CLIPConfig, **_):
    """Scalar loss: the make_train_step contract."""
    return clip_outputs(params, batch, cfg)["loss"]
