"""The served or trained model as the program takes it: its ``LlamaConfig``
built from the configuration file, and weights made from the seed.

The weights are the benchmark's, made on the device from ``--seed`` with
one ``torch.Generator`` in a few large calls, in the dtype they are served
in, laid out as the program's parameter tree (stacked layers; projections
in einsum layouts ``wq (L, d, h, hd)``, ``wo (L, h, hd, d)``, ...). Every
projection is N(0, 1/fan_in); norm weights are 1 + N(0, 0.05^2), so a
path that skips a norm's weight shows. The reference reads the same
tensors, and :func:`checksum` shows that the program left them as they
were.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .spec import ModelSpec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def llama_config(spec: ModelSpec, *, remat: bool = False,
                 remat_policy: str = "full"):
    """The program's ``LlamaConfig`` for ``spec``."""
    from ray_tpu_torch.models.llama import LlamaConfig

    if spec.dim != spec.n_heads * spec.head_dim:
        raise ValueError("the program derives head_dim as dim / n_heads")
    kw: Dict[str, Any] = {}
    if spec.n_experts:
        kw = {"n_experts": spec.n_experts, "top_k": spec.top_k}
    return LlamaConfig(vocab=spec.vocab, dim=spec.dim,
                       n_layers=spec.n_layers, n_heads=spec.n_heads,
                       n_kv_heads=spec.n_kv_heads, mlp_dim=spec.mlp_dim,
                       max_seq=spec.max_positions,
                       rope_theta=spec.rope_theta, norm_eps=spec.norm_eps,
                       dtype=DTYPES[spec.dtype], remat=remat,
                       remat_policy=remat_policy, **kw)


def make_weights(spec: ModelSpec, seed: int, device) -> Dict[str, Any]:
    """The weight tree for ``seed``, on ``device``, in ``spec.dtype``."""
    dt = DTYPES[spec.dtype]
    gen = torch.Generator(device)
    gen.manual_seed(int(seed) % (1 << 63))
    L, d, m = spec.n_layers, spec.dim, spec.mlp_dim
    h, kvh, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return t.mul_(fan_in ** -0.5)

    def norm_w(shape):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return t.mul_(0.05).add_(1.0)

    if spec.n_experts:
        E = spec.n_experts
        mlp = {"router": normal((L, d, E), d),
               "w_gate": normal((L, E, d, m), d),
               "w_up": normal((L, E, d, m), d),
               "w_down": normal((L, E, m, d), m)}
    else:
        mlp = {"w_gate": normal((L, d, m), d),
               "w_up": normal((L, d, m), d),
               "w_down": normal((L, m, d), m)}
    return {
        "embed": normal((spec.vocab, d), d),
        "layers": {
            "attn_norm": norm_w((L, d)),
            "wq": normal((L, d, h, hd), d),
            "wk": normal((L, d, kvh, hd), d),
            "wv": normal((L, d, kvh, hd), d),
            "wo": normal((L, h, hd, d), h * hd),
            "mlp_norm": norm_w((L, d)),
            **mlp,
        },
        "final_norm": norm_w((d,)),
        "lm_head": normal((d, spec.vocab), d),
    }


def leaves(tree, prefix=""):
    """(path, tensor) of every leaf, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


@torch.no_grad()
def checksum(tree) -> Dict[str, int]:
    """An exact checksum of each leaf's bits (its 2- or 4-byte words read
    as integers, summed in int64)."""
    out = {}
    for path, t in leaves(tree):
        view = torch.int16 if t.element_size() == 2 else torch.int32
        flat = t.contiguous().view(-1).view(view)
        # in chunks: an int64 sum converts its input, 4x a bf16 leaf
        out[path] = sum(int(c.sum(dtype=torch.int64))
                        for c in flat.split(1 << 26))
    return out
