"""SSD, the Mamba-2 state-space op, in chunked form (counterpart of
``ray_tpu/ops/ssd.py``).

The selective-scan recurrence

    h_t = a_t * h_{t-1} + (dt_t x_t) outer B_t
    y_t = C_t . h_t + D * x_t          (a_t = exp(dt_t * A), A < 0)

is rewritten by state-space duality as products: within a chunk the
output is an attention-like product (C B^T masked by the 1-semiseparable
decay L), and chunks hand on only a (head_dim x state) state, through a
loop over the seq/chunk chunks. ``ssd_reference`` is the literal
recurrence, kept as the test oracle. Plain PyTorch: the reference runs
both through XLA, with no Pallas kernel.

Shapes (B=batch, S=seq, H=heads, P=head_dim, N=state):
    x: (B, S, H, P)   dt: (B, S, H)   A: (H,)
    Bm/Cm: (B, S, H, N), or (B, S, 1, N) shared by the heads
    D: (H,)   -> y: (B, S, H, P)
"""

from __future__ import annotations

import torch

__all__ = ["ssd_chunked", "ssd_reference"]


def ssd_reference(x, dt, A, Bm, Cm, D):
    """Sequential recurrence oracle (f32 inside, x's dtype out)."""
    xf, dtf = x.float(), dt.float()
    a = torch.exp(dtf * A.float())                    # (B, S, H)
    Bf, Cf = Bm.float(), Cm.float()
    bx = torch.einsum("bsh,bshp,bshn->bshpn", dtf, xf, Bf)
    B_, S, H, P = x.shape
    h = torch.zeros((B_, H, P, Bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        h = a[:, t, :, None, None] * h + bx[:, t]
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1)
    return (y + xf * D.float()[None, None, :, None]).to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int = 64):
    """Chunked SSD; seq must be a multiple of ``chunk`` (pad upstream).

    Head-shared B/C (shape (B, S, 1, N)) compute the C.B^T scores and the
    state contractions once and broadcast them over heads, without
    materialising the repeat."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} not a multiple of chunk {chunk}")
    C_ = S // chunk
    shared_bc = Bm.shape[2] == 1 and Cm.shape[2] == 1 and H > 1
    Hbc = 1 if shared_bc else H
    xf = x.float().reshape(B_, C_, chunk, H, P)
    dtf = dt.float().reshape(B_, C_, chunk, H)
    Bf = Bm.float().reshape(B_, C_, chunk, Hbc, N)
    Cf = Cm.float().reshape(B_, C_, chunk, Hbc, N)

    # log-decay cumulative within each chunk (inclusive of own step)
    cum = torch.cumsum(dtf * A.float(), dim=2)        # (B, C, Q, H)
    # L[i, j] = exp(cum[i] - cum[j]) for j <= i. Every causal exponent is
    # <= 0 (A < 0), so the clamp changes nothing there; it keeps the
    # anti-causal branch that where() also evaluates finite, whose
    # overflow would turn into inf * 0 = NaN in the backward
    li = cum[:, :, :, None, :]                        # (B, C, Q, 1, H)
    lj = cum[:, :, None, :, :]                        # (B, C, 1, Q, H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    L = torch.where(causal, torch.exp(torch.clamp_max(li - lj, 0.0)), 0.0)

    dx = dtf[..., None] * xf                          # (B, C, Q, H, P)
    # intra-chunk: (C_i . B_j) * L[i, j] applied to dx_j
    if shared_bc:
        inner = torch.einsum("bcin,bcjn->bcij", Cf[:, :, :, 0],
                             Bf[:, :, :, 0])
        scores = inner[..., None] * L                 # broadcast over H
    else:
        scores = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf) * L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, dx)

    # per-chunk aggregate state and total decay
    last = cum[:, :, -1:, :]                          # (B, C, 1, H)
    decay_to_end = torch.exp(last - cum)              # (B, C, Q, H)
    if shared_bc:
        S_c = torch.einsum("bcjh,bcjhp,bcjn->bchpn", decay_to_end, dx,
                           Bf[:, :, :, 0])
    else:
        S_c = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", decay_to_end, dx,
                           Bf)
    chunk_decay = torch.exp(last[:, :, 0, :])         # (B, C, H)

    # inter-chunk: H_c = chunk_decay_c * H_{c-1} + S_c; chunk c reads
    # the state H_{c-1} left by the chunks before it
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(C_):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    h_prev = torch.stack(h_prevs, dim=1)              # (B, C, H, P, N)

    # carry-in at position i: exp(cum[i]) * C_i . H_{c-1}
    if shared_bc:
        y_inter = torch.einsum("bcih,bcin,bchpn->bcihp", torch.exp(cum),
                               Cf[:, :, :, 0], h_prev)
    else:
        y_inter = torch.einsum("bcih,bcihn,bchpn->bcihp", torch.exp(cum),
                               Cf, h_prev)

    y = (y_intra + y_inter).reshape(B_, S, H, P)
    return (y + x.float() * D.float()[None, None, :, None]).to(x.dtype)
