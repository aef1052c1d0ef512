"""Mistral-7B and Mixtral-8x7B in plain float32 PyTorch.

The decoder of Hugging Face's ``MistralForCausalLM`` and
``MixtralForCausalLM`` (and of Mistral's papers): RMSNorm before attention
and before the MLP, grouped-query causal attention with rotary embeddings
in the half-split layout (``rotate_half``), SwiGLU, and for Mixtral the
sparse mixture: a softmax router over all experts, the top ``k`` kept and
their weights renormalised to sum to 1, each token through its ``k``
experts only. No sliding window (Mistral-7B v0.2 and later, Mixtral).

It reads the benchmark's weight tree (stacked layers, einsum layouts: see
``gpubench/model.py``) one layer at a time, upcast to float32, with TF32
off, so that a layer of full width is the largest float32 copy it makes.
Attention runs in blocks of queries. Rotary angles are computed in
float64. It takes no cache, no padding and no batching: each sequence runs
whole, from its first token.

``weight_fn`` (default: none) transforms each float32 weight as it is read,
with the index of the axis a product contracts; the control passes a
lower precision's round trip through it.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..spec import ModelSpec

WeightFn = Callable[[torch.Tensor, int], torch.Tensor]


def strict_f32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(spec: ModelSpec, length: int, device):
    """cos, sin of position * theta^(-2i / head_dim), [length, hd/2]."""
    hd = spec.head_dim
    inv = spec.rope_theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                            device=device) / hd)
    ang = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [T, heads, hd] rotated by its position's angles (rotate_half)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd), causal) v over [T, heads, hd], the kv
    heads shared by groups of query heads; in blocks of queries."""
    T, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    scale = hd ** -0.5
    for a in range(0, T, block):
        b = min(a + block, T)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                v[:b])
    return out


def dense_mlp(h, wg, wu, wd):
    return (F.silu(h @ wg) * (h @ wu)) @ wd


def sparse_mlp(h, router, wg, wu, wd, top_k: int):
    """Mixtral's mixture: each token through its top-k experts, weighted by
    the renormalised softmax probabilities of the router."""
    probs = torch.softmax(h @ router, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(router.shape[-1]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = dense_mlp(h[rows], wg[e], wu[e], wd[e])
        out.index_add_(0, rows, y * top_p[rows, slot][:, None])
    return out


class Decoder:
    """The model over the benchmark's weight tree ``w`` (any dtype, on the
    device the reference runs on)."""

    def __init__(self, spec: ModelSpec, w, weight_fn: Optional[WeightFn] = None):
        self.spec, self.w = spec, w
        self.weight_fn = weight_fn

    def _f32(self, t: torch.Tensor, contract: int) -> torch.Tensor:
        t = t.float()
        return t if self.weight_fn is None else self.weight_fn(t, contract)

    def _layer(self, li: int):
        """Layer ``li``'s weights in float32, products as [in, out]."""
        s, lw = self.spec, self.w["layers"]
        d = s.dim
        out = {
            "attn_norm": lw["attn_norm"][li].float(),
            "mlp_norm": lw["mlp_norm"][li].float(),
            "wq": self._f32(lw["wq"][li].reshape(d, s.q_dim), 0),
            "wk": self._f32(lw["wk"][li].reshape(d, s.kv_dim), 0),
            "wv": self._f32(lw["wv"][li].reshape(d, s.kv_dim), 0),
            "wo": self._f32(lw["wo"][li].reshape(s.q_dim, d), 0),
        }
        if s.n_experts:
            out["router"] = lw["router"][li].float()
            for k in ("w_gate", "w_up", "w_down"):
                out[k] = self._f32(lw[k][li], 1)
        else:
            for k in ("w_gate", "w_up", "w_down"):
                out[k] = self._f32(lw[k][li], 0)
        return out

    def _block(self, x, p, cos, sin):
        s = self.spec
        T = x.shape[0]
        h = rms_norm(x, p["attn_norm"], s.norm_eps)
        q = rotate((h @ p["wq"]).view(T, s.n_heads, s.head_dim), cos, sin)
        k = rotate((h @ p["wk"]).view(T, s.n_kv_heads, s.head_dim), cos, sin)
        v = (h @ p["wv"]).view(T, s.n_kv_heads, s.head_dim)
        x = x + causal_attention(q, k, v).reshape(T, s.q_dim) @ p["wo"]
        h = rms_norm(x, p["mlp_norm"], s.norm_eps)
        if s.n_experts:
            return x + sparse_mlp(h, p["router"], p["w_gate"], p["w_up"],
                                  p["w_down"], s.top_k)
        return x + dense_mlp(h, p["w_gate"], p["w_up"], p["w_down"])

    @torch.no_grad()
    def logits_at(self, seqs: Sequence[Sequence[int]],
                  positions: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """For each token sequence, the float32 logits [len(pos), vocab]
        at its ``positions`` (the logits that predict the token after
        each). The sequences run layer by layer together, each whole."""
        strict_f32()
        s, w = self.spec, self.w
        dev = w["embed"].device
        embed = self._f32(w["embed"], 1)
        xs = [embed[torch.as_tensor(list(t), device=dev)] for t in seqs]
        del embed
        cos, sin = rope_tables(s, max(len(t) for t in seqs), dev)
        for li in range(s.n_layers):
            p = self._layer(li)
            xs = [self._block(x, p, cos[:len(x)], sin[:len(x)]) for x in xs]
            del p
        head = self._f32(w["lm_head"], 0)
        fn = w["final_norm"].float()
        out = []
        for x, pos in zip(xs, positions):
            idx = torch.as_tensor(list(pos), device=dev)
            out.append(rms_norm(x[idx], fn, s.norm_eps) @ head)
        return out
