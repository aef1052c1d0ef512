"""The operations and bytes a step needs, computed from shapes.

These count the work the algorithm needs for the tokens that were asked
for, never what a kernel happens to do: padding, recomputation and
re-reads are not counted, so a roofline share shows them as waste. A
multiply-add is 2 operations. Attention over a causal prompt of length P
has P (P + 1) / 2 (query, key) pairs a head; QK^T and PV take 2 head_dim
operations each a pair.
"""

from __future__ import annotations

import json
from pathlib import Path

from .spec import ModelSpec

_PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
PEAK_FLOPS = float(_PEAKS["bf16_flops_per_s"])     # dense bf16, H100 SXM
PEAK_BYTES = float(_PEAKS["hbm_bytes_per_s"])      # HBM3, H100 SXM


def layer_matmul_params(s: ModelSpec) -> int:
    """Weights a token's products read in one layer: the attention
    projections, and the MLP's (the ``top_k`` experts it is routed to,
    and the router, for a mixture)."""
    attn = s.dim * s.q_dim + 2 * s.dim * s.kv_dim + s.q_dim * s.dim
    mlp = 3 * s.dim * s.mlp_dim
    if s.n_experts:
        mlp = s.top_k * mlp + s.dim * s.n_experts
    return attn + mlp


def head_flops(s: ModelSpec) -> int:
    """The lm_head product for one position."""
    return 2 * s.dim * s.vocab


def causal_pairs(length: int) -> int:
    return length * (length + 1) // 2


def attn_flops(s: ModelSpec, pairs: int) -> int:
    """QK^T and PV over ``pairs`` (query, key) pairs in every head and
    layer."""
    return 4 * s.head_dim * s.n_heads * s.n_layers * pairs


def prefill_flops(s: ModelSpec, prompt: int) -> int:
    """A whole-prompt prefill: every position's products, causal
    attention, and the lm_head at the last position only (the one whose
    token is sampled)."""
    return (2 * layer_matmul_params(s) * s.n_layers * prompt
            + attn_flops(s, causal_pairs(prompt)) + head_flops(s))


def decode_flops(s: ModelSpec, context: int) -> int:
    """One decoded token that attends over ``context`` positions (its
    own included)."""
    return (2 * layer_matmul_params(s) * s.n_layers + head_flops(s)
            + attn_flops(s, context))


def paged_decode_bytes(s: ModelSpec, context: int, kv_bytes: int = 2,
                       q_bytes: int = 2) -> int:
    """What decode attention has to move for one token over ``context``
    cached positions: each position's K and V row of every layer read
    once, and the query read and the output written once a layer."""
    kv = 2 * context * s.kv_dim * kv_bytes
    qo = 2 * s.q_dim * q_bytes
    return s.n_layers * (kv + qo)
