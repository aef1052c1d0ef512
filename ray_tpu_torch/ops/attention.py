"""Attention: naive and blockwise plain versions, and flash attention,
whose forward (``csrc/flash_fwd.cu``) and two backward kernels
(``csrc/flash_bwd.cu``, dQ and dK/dV) launch on CUDA tensors, while CPU
tensors run their plain versions. Each of the three has a tensor-core
kernel for bf16 at head dims 64 and 128 and a SIMT kernel for the rest
(f32, and bf16 at head dims 16 and 32); :func:`_route` picks one. The head dims the
kernels take are :data:`HEAD_DIMS`; any other raises on the card.

Counterpart of ``ray_tpu/ops/attention.py``. Layouts: q [B, Sq, Hq, D];
k/v [B, Skv, Hkv, D]; GQA maps q head h to kv head h // (Hq // Hkv).
Causal alignment is bottom-right (query i sees key j <= i + Skv - Sq),
and a fully masked row gives 0, not a uniform average, in the forward
and 0 gradients in the backward.

``attention`` is differentiable through :class:`FlashAttention`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _kernels

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    qi = torch.arange(sq, device=device)[:, None] + (skv - sq)
    return torch.arange(skv, device=device)[None, :] <= qi


def naive_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """O(S^2)-memory attention in f32 (the correctness oracle)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k, hq // hkv).float()
    v = _repeat_kv(v, hq // hkv).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    if causal:
        logits = torch.where(_causal_mask(sq, skv, q.device), logits,
                             NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(logits > NEG_INF * 0.5, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / denom, v)
    return out.to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None,
                        kv_block: int = 512):
    """The flash recurrence over kv blocks in plain PyTorch: (m, l, acc)
    carried across blocks in f32."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    kv_block = min(kv_block, skv)
    qf = q.float() * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    m = torch.full((b, hq, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq), device=q.device)
    acc = torch.zeros((b, hq, sq, d), device=q.device)
    for j0 in range(0, skv, kv_block):
        kb = k[:, j0:j0 + kv_block].float()
        vb = v[:, j0:j0 + kv_block].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        if causal:
            k_pos = torch.arange(j0, j0 + kb.shape[1], device=q.device)
            logits = torch.where(k_pos[None, :] <= q_pos, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(logits > NEG_INF * 0.5, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / l[..., None].clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None):
    """Plain version of the flash kernel with the Pallas kernel's
    semantics: f32 logits, masked entries exactly 0, P rounded to v's
    dtype before PV (the row sum uses the f32 P). Returns (O in q's
    dtype, LSE [B, Hq, Sq] f32)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kf = _repeat_kv(k, hq // hkv).float()
    vf = _repeat_kv(v, hq // hkv).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        logits = torch.where(_causal_mask(sq, skv, q.device), logits,
                             NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(logits > NEG_INF * 0.5, torch.exp(logits - m[..., None]),
                    0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf)
    out = (pv / l[..., None]).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(l)


_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = _kernels.HEAD_DIMS


def _check_flash_inputs(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, H, D]")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[2]:
        raise ValueError("flash_attention: Hq must be a multiple of Hkv")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v dtypes differ")


def _steps(t):
    """t's strides with 0 for each dimension of size 1: the kernels never
    step along one (autograd's dO at B=1 has batch stride 1)."""
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape, t.stride()))


# the head dims at which each wrapper's bf16 inputs take its tensor-core
# kernel (csrc/flash_fwd.cu flash_fwd_tc, csrc/flash_bwd.cu
# flash_bwd_dq_tc and flash_bwd_dkv_tc)
TC_HEAD_DIMS = {"flash_attention": (64, 128), "flash_bwd_dq": (64, 128),
                "flash_bwd_dkv": (64, 128)}


def _route(kernel: str, **tensors) -> str:
    """Which of ``kernel``'s two CUDA kernels takes these inputs (the
    first is q): ``"tc"``, the tensor-core kernel, for bf16 at a head_dim
    in ``TC_HEAD_DIMS[kernel]`` whose tensors start at 16-byte-aligned
    addresses and have (batch, seq, head) strides in multiples of 8
    elements (16 bytes; a dimension of size 1 is never stepped, so its
    stride does not count); ``"simt"`` for every other dtype and head_dim
    (f32; bf16 at the other head dims). Raises for bf16 at a tensor-core
    head_dim that is not so aligned: there is no fallback.
    Whether the kernels take the dtype and head_dim at all is the
    wrapper's check."""
    q = next(iter(tensors.values()))
    d = q.shape[-1]
    if q.dtype != torch.bfloat16 or d not in TC_HEAD_DIMS[kernel]:
        return "simt"
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(st % 8 for st in _steps(t)[:3]):
            raise ValueError(
                f"{kernel}: bf16 head_dim {d} needs {name} at a "
                f"16-byte-aligned address with strides in multiples of 8, "
                f"got offset {t.data_ptr() % 16} and strides {t.stride()}")
    return "tc"


def fwd_route(q, k, v) -> str:
    """The forward kernel :func:`flash_attention` launches (see
    :func:`_route`): tensor cores for bf16 at head_dim 64 and 128."""
    return _route("flash_attention", q=q, k=k, v=v)


def _strides(*tensors):
    """The (batch, seq, head) steps of each tensor, as the kernels' C
    array of long long."""
    steps = [st for t in tensors for st in _steps(t)[:3]]
    return (ctypes.c_longlong * len(steps))(*steps)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """Flash-attention forward. On a CUDA tensor it launches the kernel
    :func:`fwd_route` picks (the tensor-core kernel for bf16 with head_dim
    64 or 128, the SIMT kernel otherwise, both in ``csrc/flash_fwd.cu``),
    or raises for what neither takes (dtype other than f32/bf16, head_dim
    outside :data:`HEAD_DIMS`, a head_dim stride other than 1, misaligned
    bf16 with head_dim 64 or 128); on a CPU tensor it runs
    :func:`flash_attention_reference`. Returns O, or (O, LSE)."""
    _check_flash_inputs(q, k, v)
    if q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, causal=causal,
                                             scale=scale)
        return (out, lse) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _FLASH_DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes f32/bf16 with "
                         f"head_dim in {HEAD_DIMS}, got {q.dtype}, {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel needs head_dim stride 1")
    if b * hq > 65535:
        # one grid row per (batch, q head): CUDA caps gridDim.y
        raise ValueError(f"flash_attention kernel takes B * Hq <= 65535, "
                         f"got {b * hq}")
    route = fwd_route(q, k, v)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = _strides(q, k, v)
    lib = _kernels.lib("flash_fwd")
    fn = lib.flash_fwd_tc if route == "tc" else lib.flash_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, sq, skv, hq, hkv, d,
             ctypes.cast(strides, ctypes.c_void_p), float(scale),
             int(causal), _FLASH_DTYPES[q.dtype],
             _kernels.stream_ptr(q.device))
    _kernels.check("flash_fwd", err)
    with _kernels.COUNT_LOCK:
        flash_attention.launches += 1
        if route == "tc":
            flash_attention.launches_tc += 1
    return (out, lse) if return_lse else out


# every launch, and those of the tensor-core kernel alone
flash_attention.launches = 0
flash_attention.launches_tc = 0


# --- backward ---------------------------------------------------------------


def _bwd_probs(q, k, v, do, lse, dvec, causal, scale):
    """P and dS [B, Hq, Sq, Skv] in f32 as the backward kernels rebuild
    them from the LSE, with masked entries selected to exactly 0 (the
    Pallas kernels compute exp(-1e30 - lse) there, which is 1 on a row
    that sees no key); and k, v repeated to Hq heads in f32."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kf = _repeat_kv(k, hq // hkv).float()
    vf = _repeat_kv(v, hq // hkv).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(sq, skv, q.device), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    return p, p * (dp - dvec[..., None]), kf


def _fold_groups(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, S, Hq, D] per q head -> [B, S, Hkv, D], each GQA group summed."""
    b, s, hq, d = x.shape
    return x.reshape(b, s, hkv, hq // hkv, d).sum(dim=3)


def flash_bwd_dq_reference(q, k, v, do, lse, dvec, *, causal: bool = True,
                           scale: Optional[float] = None):
    """Plain version of the dQ kernel: dQ = scale * dS K, dS rounded to k's
    dtype before the product, f32 accumulation, dQ in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds, kf = _bwd_probs(q, k, v, do, lse, dvec, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, dvec, *, causal: bool = True,
                            scale: Optional[float] = None):
    """Plain version of the dK/dV kernel: dV = P^T dO with P rounded to
    dO's dtype, dK = scale * dS^T Q with dS rounded to q's dtype; each GQA
    group summed in f32, then rounded once to k's and v's dtypes."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    hkv = k.shape[2]
    p, ds, _ = _bwd_probs(q, k, v, do, lse, dvec, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    return (_fold_groups(dk, hkv).to(k.dtype),
            _fold_groups(dv, hkv).to(v.dtype))


def _dvec(o, do):
    """D = rowsum(dO * O) in f32, [B, Hq, Sq] (computed outside the
    kernels, as the reference does)."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, *,
                                  causal: bool = True,
                                  scale: Optional[float] = None):
    """Plain version of the flash backward: (dQ, dK, dV) from the saved O
    and LSE."""
    dvec = _dvec(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, dvec, causal=causal,
                                scale=scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, dvec, causal=causal,
                                     scale=scale)
    return dq, dk, dv


def _bwd_launch_args(q, k, v, do, lse, dvec, scale):
    """Checks what the backward kernels take and returns the shared tail
    of their C arguments, or raises."""
    _check_flash_inputs(q, k, v)
    b, sq, hq, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("flash backward: dO must match q in shape, dtype "
                         "and device")
    if q.dtype not in _FLASH_DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"flash backward kernels take f32/bf16 with "
                         f"head_dim in {HEAD_DIMS}, got {q.dtype}, {d}")
    if any(t.stride(3) != 1 for t in (q, k, v, do)):
        raise ValueError("flash backward kernels need head_dim stride 1")
    for name, t in (("lse", lse), ("dvec", dvec)):
        if (t.shape != (b, hq, sq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"flash backward: {name} must be contiguous "
                             f"f32 [B, Hq, Sq]")
    if b * hq > 65535:
        raise ValueError(f"flash backward kernels take B * Hq <= 65535, "
                         f"got {b * hq}")
    strides = _strides(q, k, v, do)
    return (b, sq, k.shape[1], hq, k.shape[2], d,
            ctypes.cast(strides, ctypes.c_void_p), float(scale)), strides


def dq_route(q, k, v, do) -> str:
    """The dQ kernel :func:`flash_bwd_dq` launches (see :func:`_route`):
    tensor cores for bf16 at head_dim 64 and 128."""
    return _route("flash_bwd_dq", q=q, k=k, v=v, dO=do)


def flash_bwd_dq(q, k, v, do, lse, dvec, *, causal: bool = True,
                 scale: Optional[float] = None):
    """dQ of flash attention. On a CUDA tensor it launches the dQ kernel
    that :func:`dq_route` picks (the tensor-core kernel for bf16 with
    head_dim 64 or 128, the SIMT kernel otherwise, both in
    ``csrc/flash_bwd.cu``) or raises for what neither takes (misaligned
    bf16 at head_dim 64 or 128 included); on a CPU tensor it runs
    :func:`flash_bwd_dq_reference`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, dvec, causal=causal,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: no kernel for {q.device}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    args, _keep = _bwd_launch_args(q, k, v, do, lse, dvec, scale)
    route = dq_route(q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    lib = _kernels.lib("flash_bwd")
    fn = lib.flash_bwd_dq_tc if route == "tc" else lib.flash_bwd_dq
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), *args,
             int(causal), _FLASH_DTYPES[q.dtype],
             _kernels.stream_ptr(q.device))
    _kernels.check("flash_bwd_dq", err)
    with _kernels.COUNT_LOCK:
        flash_bwd_dq.launches += 1
        if route == "tc":
            flash_bwd_dq.launches_tc += 1
    return dq


# every launch, and those of the tensor-core kernel alone
flash_bwd_dq.launches = 0
flash_bwd_dq.launches_tc = 0


def dkv_route(q, k, v, do) -> str:
    """The dK/dV kernel :func:`flash_bwd_dkv` launches (see
    :func:`_route`): tensor cores for bf16 at head_dim 64 and 128."""
    return _route("flash_bwd_dkv", q=q, k=k, v=v, dO=do)


def flash_bwd_dkv(q, k, v, do, lse, dvec, *, causal: bool = True,
                  scale: Optional[float] = None):
    """(dK, dV) of flash attention, each GQA group summed. On a CUDA tensor
    it launches the dK/dV kernel that :func:`dkv_route` picks (the
    tensor-core kernel for bf16 with head_dim 64 or 128, the SIMT kernel
    otherwise, both in ``csrc/flash_bwd.cu``) or raises for what neither
    takes; on a CPU tensor it runs :func:`flash_bwd_dkv_reference`."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, dvec, causal=causal,
                                       scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: no kernel for {q.device}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    args, _keep = _bwd_launch_args(q, k, v, do, lse, dvec, scale)
    route = dkv_route(q, k, v, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    lib = _kernels.lib("flash_bwd")
    fn = lib.flash_bwd_dkv_tc if route == "tc" else lib.flash_bwd_dkv
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *args, int(causal), _FLASH_DTYPES[q.dtype],
             _kernels.stream_ptr(q.device))
    _kernels.check("flash_bwd_dkv", err)
    with _kernels.COUNT_LOCK:
        flash_bwd_dkv.launches += 1
        if route == "tc":
            flash_bwd_dkv.launches_tc += 1
    return dk, dv


# every launch, and those of the tensor-core kernel alone
flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_tc = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None):
    """Flash-attention backward: (dQ, dK, dV) from the saved O and LSE.
    On CUDA tensors it launches the dQ and the dK/dV kernels (raising for
    what they do not take, never falling back); on CPU tensors it runs
    their plain versions."""
    dvec = _dvec(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, dvec, causal=causal, scale=scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dvec, causal=causal,
                           scale=scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, which saves
    q, k, v, O and the LSE, and the two backward kernels (the counterpart
    of the reference's ``custom_vjp`` around ``flash_attention_tpu``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None):
    """Attention for the model, the trainer and the prefill: the flash
    kernels on CUDA (any sequence length; raises for a shape they do not
    take, never falls back), their plain versions on the CPU.
    Differentiable through :class:`FlashAttention` when grad is on and an
    input requires it; otherwise (serving) it saves nothing."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)
