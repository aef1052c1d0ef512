"""Ring attention: exact attention over a sequence-parallel mesh axis
(counterpart of ``ray_tpu/ops/ring_attention.py``).

Each rank holds a contiguous sequence block of q/k/v. K/V blocks rotate
around the ring with the differentiable shift (``parallel.send``) while
every rank accumulates online-softmax statistics for its local queries,
so a rank's memory stays O(seq / ring). Called inside a per-rank region
(``parallel.collectives.shard_map``) with ``axis`` a mesh axis. The
reference computes this in XLA, with no Pallas kernel; this plain
PyTorch version is the port's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import axis_index, axis_size, send
from .attention import NEG_INF


def ring_attention(q, k, v, *, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None, kv_block: int = 512):
    """Attention where q/k/v are sequence-sharded along mesh ``axis``.

    q: (B, Sq_local, Hq, D); k/v: (B, Skv_local, Hkv, D). Returns the
    local output block (B, Sq_local, Hq, D) in q's dtype, equal to full
    attention over the concatenated sequence. ``kv_block`` is accepted
    for the reference's signature; each rotating chunk is one block."""
    del kv_block
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    ring = axis_size(axis)
    rank = axis_index(axis)
    scale_ = scale if scale is not None else d ** -0.5
    q_pos = rank * sq + torch.arange(sq, device=q.device)
    qf = q.float() * scale_

    def one_chunk(kc, vc, src_rank):
        """(m, l, acc) of one rotating kv chunk."""
        n_rep = hq // kc.shape[2]
        kf = kc.float().repeat_interleave(n_rep, dim=2)
        vf = vc.float().repeat_interleave(n_rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        if causal:
            k_pos = src_rank * skv + torch.arange(skv, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])
        # zero fully masked rows (exp(NEG_INF - NEG_INF) is 1 otherwise)
        p = torch.where(logits > NEG_INF * 0.5, p, 0.0)
        return m, p.sum(dim=-1), torch.einsum("bhqk,bkhd->bhqd", p, vf)

    m, l, acc = one_chunk(k, v, rank)       # prologue: the local chunk
    kc, vc, src = k, v, rank
    for _ in range(ring - 1):
        # rotate first: the local chunk is folded in above, so no last
        # useless rotation
        kc = send(kc, axis, shift=1)
        vc = send(vc, axis, shift=1)
        src = (src - 1) % ring
        cm, cl, cacc = one_chunk(kc, vc, src)
        m_new = torch.maximum(m, cm)
        c_old, c_new = torch.exp(m - m_new), torch.exp(cm - m_new)
        l = l * c_old + cl * c_new
        acc = acc * c_old[..., None] + cacc * c_new[..., None]
        m = m_new
    out = acc / l[..., None].clamp_min(1e-30)
    return out.movedim(1, 2).to(q.dtype)
