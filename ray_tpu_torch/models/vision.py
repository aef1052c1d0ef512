"""Vision models: a functional ResNet for the image-training path
(counterpart of ``ray_tpu/models/vision.py``).

The reference's choices are kept: GroupNorm instead of BatchNorm (no
running statistics), statistics in f32 with the population variance,
NHWC activations and HWIO weights (so a ``ray_tpu`` tree converts leaf
for leaf), and a head whose bf16 product has an f32 result
(``ops.quant.logits_matmul``). A bf16 convolution is
``torch.nn.functional.conv2d``, as the reference's is XLA's
``conv_general_dilated``; an f32 one is the padded input's patches
(``unfold``) times the weight in one matmul. So an f32 convolution
follows the same matmul precision setting as the port's other f32
matmuls, which is IEEE f32 at PyTorch's default; the library's f32
convolution on the card runs in TF32 at its own default.
``padding="SAME"`` is reckoned as XLA does and applied with ``F.pad``
first: at stride 2 on an even input it pads less before than after,
which ``conv2d``'s symmetric ``padding`` cannot express.
``resnet_param_axes`` replicates every leaf, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .._private.device import DeviceLike, resolve_device
from .._private.tree import tree_leaves, tree_map
from ..ops.quant import logits_matmul


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    # channels per stage; depths = residual blocks per stage
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    depths: Tuple[int, ...] = (2, 2, 2, 2)       # ResNet-18 shape
    groups: int = 8                              # GroupNorm groups
    stem_kernel: int = 3                         # 3 for CIFAR-size, 7 ImageNet
    dtype: Any = torch.bfloat16

    def n_params(self) -> int:
        return sum(t.numel() for t in tree_leaves(
            init_resnet(self, device="meta")))


RESNET_CONFIGS: Dict[str, ResNetConfig] = {
    "tiny": ResNetConfig(channels=(8, 16), depths=(1, 1), groups=4,
                         dtype=torch.float32),
    "resnet18": ResNetConfig(),
    "resnet34": ResNetConfig(depths=(3, 4, 6, 3)),
}


def resnet_param_axes(params):
    """Logical axes: every leaf replicated (models this size are pure
    data-parallel; the train step shards the batch)."""
    return tree_map(lambda _: (), params)


def init_resnet(cfg: ResNetConfig, seed: int = 0, in_channels: int = 3,
                device: DeviceLike = None):
    """He-normal convolutions (HWIO) and a 1/sqrt(fan_in) head from a
    seeded torch.Generator, in ``cfg.dtype``; GroupNorm scales of 1 and a
    zero head bias. A block whose width changes gets a 1x1 projection.
    ``device=None`` is the card; ``"meta"`` gives shapes only."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(dev)
        gen.manual_seed(seed)

    def normal(shape, std):
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        if gen is not None:
            out.copy_(torch.randn(shape, generator=gen, device=dev,
                                  dtype=torch.float32) * std)
        return out

    def conv(kh, kw, cin, cout):
        return normal((kh, kw, cin, cout), (2.0 / (kh * kw * cin)) ** 0.5)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=dev)

    params: Dict[str, Any] = {
        "stem": conv(cfg.stem_kernel, cfg.stem_kernel, in_channels,
                     cfg.channels[0]),
        "stem_scale": ones(cfg.channels[0]),
        "stages": [],
    }
    cin = cfg.channels[0]
    for cout, depth in zip(cfg.channels, cfg.depths):
        blocks: List[Dict[str, Any]] = []
        for _ in range(depth):
            block = {"conv1": conv(3, 3, cin, cout), "scale1": ones(cout),
                     "conv2": conv(3, 3, cout, cout), "scale2": ones(cout)}
            if cin != cout:
                block["proj"] = conv(1, 1, cin, cout)
            blocks.append(block)
            cin = cout
        params["stages"].append(blocks)
    params["head"] = normal((cfg.channels[-1], cfg.num_classes),
                            cfg.channels[-1] ** -0.5)
    params["head_b"] = torch.zeros(cfg.num_classes, dtype=cfg.dtype,
                                   device=dev)
    return params


def _group_norm(x, scale, groups: int):
    """GroupNorm over NHWC with f32 statistics (population variance) and
    the scale applied in f32 before the cast back."""
    B, H, W, C = x.shape
    g = min(groups, C)
    xf = x.float().reshape(B, H, W, g, C // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xf = (xf - mean) * torch.rsqrt(var + 1e-5)
    return (xf.reshape(B, H, W, C) * scale.float()).to(x.dtype)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` along one axis: (before, after) such that
    the output has ceil(size / stride) positions, the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """NHWC x, HWIO w -> NHWC, SAME padding: ``F.conv2d`` for bf16, the
    patches times the weight in one f32 matmul for f32 (see the module
    docstring)."""
    kh, kw, cin, cout = w.shape
    top, bottom = same_padding(x.shape[1], kh, stride)
    left, right = same_padding(x.shape[2], kw, stride)
    if x.dtype != torch.float32:
        xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
        out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
        return out.permute(0, 2, 3, 1)
    xp = F.pad(x, (0, 0, left, right, top, bottom))
    # (B, OH, OW, C, kh, kw) -> rows of (kh, kw, C), HWIO's order
    patches = xp.unfold(1, kh, stride).unfold(2, kw, stride)
    b, oh, ow = patches.shape[:3]
    rows = patches.permute(0, 1, 2, 4, 5, 3).reshape(b * oh * ow,
                                                     kh * kw * cin)
    return (rows @ w.reshape(kh * kw * cin, cout)).reshape(b, oh, ow, cout)


def resnet_forward(params, images, cfg: ResNetConfig):
    """images (B, H, W, C) float in [0,1] -> logits (B, num_classes) f32."""
    x = _conv(images.to(cfg.dtype), params["stem"])
    x = F.relu(_group_norm(x, params["stem_scale"], cfg.groups))
    for stage, blocks in enumerate(params["stages"]):
        for b, block in enumerate(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            h = _conv(x, block["conv1"], stride)
            h = F.relu(_group_norm(h, block["scale1"], cfg.groups))
            h = _conv(h, block["conv2"])
            h = _group_norm(h, block["scale2"], cfg.groups)
            shortcut = x
            if "proj" in block:
                shortcut = _conv(x, block["proj"], stride)
            elif stride != 1:
                shortcut = x[:, ::stride, ::stride, :]
            x = F.relu(h + shortcut)
    x = x.mean(dim=(1, 2))  # global average pool
    logits = logits_matmul(x.to(cfg.dtype), params["head"])
    return logits + params["head_b"].float()


def image_loss(params, batch, cfg: ResNetConfig, **_):
    """Cross-entropy over {"images": (B,H,W,C), "labels": (B,)}."""
    logits = resnet_forward(params, batch["images"], cfg)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels[:, None])[:, 0]
    return (logz - tgt).mean()
