"""Mixture-of-Experts MLP (counterpart of ``ray_tpu/ops/moe.py``).

Training routes with the reference's GShard/Switch dense dispatch: top-k
experts per token by iterative argmax, a static per-expert capacity, and
one-hot dispatch/combine tensors contracted by einsums, so tokens past an
expert's capacity are dropped (the residual stream carries them). Serving
takes ``moe_mlp_dense``, the exact drop-free mixture: every expert on
every token in f32, weighted by the renormalised top-k gates.

Plain PyTorch: the reference runs these einsums through XLA, with no
Pallas kernel. On a mesh (``x`` a DTensor) the routing runs on every
rank over all tokens, as a plain computation on the gathered inputs
(DTensor has no sharding rule for its one-hot and cumsum), and ``csl``
pins the expert-major buffers to the "expert" axis, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

__all__ = ["moe_dispatch", "moe_mlp", "moe_mlp_dense", "moe_mlp_oracle"]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row for an index outside [0, n), where
    ``torch.nn.functional.one_hot`` raises."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_mask(probs: torch.Tensor, k: int) -> torch.Tensor:
    """(T, E) probs -> (T, E) 0/1 mask of each token's top-k experts, by
    iterative argmax: a tie goes to the lowest index, as in the reference
    (``torch.topk`` orders ties otherwise)."""
    mask = torch.zeros_like(probs)
    remaining = probs
    for _ in range(k):
        one = _one_hot(remaining.argmax(dim=-1), probs.shape[-1],
                       probs.dtype)
        mask = mask + one
        remaining = remaining * (1.0 - one) - one  # never re-pick
    return mask


def moe_dispatch(gates: torch.Tensor, top_k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch/combine tensors from router probabilities.

    gates: (T, E) softmax router output. Returns (dispatch (T, E, C) 0/1,
    combine (T, E, C) weights, aux_loss scalar). A token's slot in an
    expert's buffer is its rank among the tokens routed there; slots at or
    past ``capacity`` and tokens not routed to the expert get a zero row.
    """
    E = gates.shape[1]
    mask = _top_k_mask(gates, top_k)                       # (T, E)
    position = torch.cumsum(mask, dim=0) - 1.0             # (T, E)
    in_capacity = (position < capacity) & (mask > 0)
    pos_hot = _one_hot(position.to(torch.int32), capacity, gates.dtype)
    dispatch = pos_hot * in_capacity[..., None].to(gates.dtype)
    # combine weights: renormalised top-k gate probs
    selected = gates * mask
    denom = selected.sum(-1, keepdim=True).clamp_min(1e-9)
    combine = dispatch * (selected / denom)[..., None]
    # Switch aux loss E * sum_e f_e * p_e, f divided by top_k so that
    # uniform load gives 1.0 whatever k
    f = mask.mean(dim=0) / top_k
    p = gates.mean(dim=0)
    aux = E * torch.sum(f * p)
    return dispatch, combine, aux


def _router_gates(xt: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """Router softmax in f32 (routing decisions are precision-sensitive)."""
    return torch.softmax(xt.float() @ router_w.float(), dim=-1)


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25, csl=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SwiGLU expert MLP over a routed, capacity-capped token subset.

    x (B, S, D); router_w (D, E); w_gate/w_up (E, D, M); w_down (E, M, D).
    ``csl``: optional sharding-constraint fn (tensor, logical_axes) ->
    tensor for the expert-major buffers.
    Returns (out (B, S, D) in x's dtype, aux_loss f32 scalar)."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    T = B * S
    xt = x.reshape(T, D)
    capacity = max(int(top_k * T / E * capacity_factor), 1)
    capacity = -(-capacity // 8) * 8
    if isinstance(xt, DTensor):
        mesh = xt.device_mesh
        gates = _router_gates(xt.full_tensor(), router_w.full_tensor())
        dispatch, combine, aux = (
            DTensor.from_local(t, mesh, [Replicate()] * mesh.mesh.ndim)
            for t in moe_dispatch(gates, top_k, capacity))
    else:
        gates = _router_gates(xt, router_w)
        dispatch, combine, aux = moe_dispatch(gates, top_k, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)

    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    if csl is not None:
        expert_in = csl(expert_in, ("expert", None, "embed"))
    g = torch.einsum("ecd,edm->ecm", expert_in, w_gate)
    u = torch.einsum("ecd,edm->ecm", expert_in, w_up)
    expert_out = torch.einsum("ecm,emd->ecd", F.silu(g) * u, w_down)
    if csl is not None:
        expert_out = csl(expert_out, ("expert", None, "embed"))
    if isinstance(expert_out, DTensor):
        # one product per expert, then the sum over the sharded experts:
        # torch 2.11's DTensor cannot view (e, c) as one dim when e is
        # sharded, which the fused contraction asks for
        out = torch.einsum("tec,ecd->ted", combine, expert_out).sum(1)
    else:
        out = torch.einsum("tec,ecd->td", combine, expert_out)
    return out.reshape(B, S, D), aux


def moe_mlp_oracle(x, router_w, w_gate, w_up, w_down, *, top_k: int = 2):
    """Exact (drop-free) mixture: for each token, the renormalised top-k
    gate weights times every expert's SwiGLU output, in f32 from the
    stored weights, cast to x's dtype at the end. Experts are computed one
    at a time, so no f32 copy of a weight is larger than one expert's
    matrix."""
    B, S, D = x.shape
    xt = x.reshape(-1, D).float()
    gates = _router_gates(xt, router_w)
    selected = gates * _top_k_mask(gates, top_k)
    weights = selected / selected.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(xt)
    for e in range(w_gate.shape[0]):
        h = F.silu(xt @ w_gate[e].float()) * (xt @ w_up[e].float())
        out = out + weights[:, e:e + 1] * (h @ w_down[e].float())
    return out.reshape(B, S, D).to(x.dtype)


# the serving path's exact mixture (drop-free: capacity-based dispatch
# would change generations with the batch)
moe_mlp_dense = moe_mlp_oracle
