"""Paged decode attention: one query per head over the paged KV cache
plus the in-flight burst tail. On a CUDA tensor it launches the
hand-written kernel (``csrc/paged_decode.cu``, split-KV: the pages of a
sequence are split across CTAs, then merged); on a CPU tensor it runs
:func:`paged_decode_attention_reference`.

Counterpart of ``ray_tpu/ops/paged_attention.py``. Layout contract
(matches llm/cache.py):
  cache_k/cache_v (one layer): [P, page, kvh, hd]
  block_tables:                [B, n_pages] int32 (page 0 = dump page)
  q:                           [B, kvh, rep, hd]
  new_k/new_v:                 [B, K, kvh, hd] burst scratch
  ctx_len / new_len:           [B] int32 valid cached / burst positions
"""

from __future__ import annotations

import functools

import torch

from . import _kernels

_NEG_INF = -1e30
# CTAs the split rule aims for per SM, and the most pages one split takes
# (the kernel keeps a split's slice of the block table in shared memory)
_CTAS_PER_SM = 2
MAX_PAGES_PER_SPLIT = 512
MAX_SPLITS = 1536


def paged_decode_attention_reference(q, cache_k, cache_v, new_k, new_v,
                                     block_tables, ctx_len, new_len):
    """Plain version: gather the pages, mask, softmax in f32. Masked
    positions are selected away and their V zeroed, so a NaN on the dump
    page cannot reach the output; a row with no valid position gives 0
    (the kernel's semantics)."""
    B, kvh, rep, hd = q.shape
    page = cache_k.shape[1]
    Sold = block_tables.shape[1] * page
    bt = block_tables.long().clamp(0, cache_k.shape[0] - 1)
    ok = cache_k[bt].reshape(B, Sold, kvh, hd).float()
    ov = cache_v[bt].reshape(B, Sold, kvh, hd).float()
    old_mask = (torch.arange(Sold, device=q.device)[None, :]
                < ctx_len.long()[:, None])                       # [B, Sold]
    new_mask = (torch.arange(new_k.shape[1], device=q.device)[None, :]
                < new_len.long()[:, None])                       # [B, K]
    ok = torch.where(old_mask[:, :, None, None], ok, 0.0)
    ov = torch.where(old_mask[:, :, None, None], ov, 0.0)
    nk = torch.where(new_mask[:, :, None, None], new_k.float(), 0.0)
    nv = torch.where(new_mask[:, :, None, None], new_v.float(), 0.0)
    qf = q.float() * hd ** -0.5
    s = torch.cat([torch.einsum("bgrd,bsgd->bgrs", qf, ok),
                   torch.einsum("bgrd,bkgd->bgrk", qf, nk)], dim=-1)
    mask = torch.cat([old_mask, new_mask], dim=-1)[:, None, None, :]
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = (torch.einsum("bgrs,bsgd->bgrd", p[..., :Sold], ov)
         + torch.einsum("bgrk,bkgd->bgrd", p[..., Sold:], nv)) / l
    return o.to(q.dtype)


def paged_decode_splits(B, kvh, n_pages, num_sms):
    """``(pages_per_split, n_splits)`` of the kernel's grid, from the
    shapes and the SM count alone (never from ``ctx_len``, which lives on
    the device): about ``_CTAS_PER_SM`` CTAs per SM over the B * kvh
    (sequence, kv head) pairs, at most one split per page and at most
    ``MAX_PAGES_PER_SPLIT`` pages a split. Every page is covered, no split
    is empty by shape, and there is at least one split."""
    want = -(-_CTAS_PER_SM * num_sms // max(1, B * kvh))
    want = max(want, -(-n_pages // MAX_PAGES_PER_SPLIT))
    want = max(1, min(want, n_pages))
    pps = max(1, -(-n_pages // want))
    return pps, max(1, -(-n_pages // pps))


@functools.lru_cache(maxsize=None)
def _num_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = _kernels.HEAD_DIMS


def paged_decode_attention(q, cache_k, cache_v, new_k, new_v,
                           block_tables, ctx_len, new_len):
    """Decode attention over paged KV + a burst tail. Returns
    o [B, kvh, rep, hd] in q's dtype. On a CUDA tensor it launches the
    kernel or raises for what it does not take; on the CPU it runs the
    plain version."""
    B, kvh, rep, hd = q.shape
    P, page_size = cache_k.shape[0], cache_k.shape[1]
    n_pages, K = block_tables.shape[1], new_k.shape[1]
    if (cache_k.shape != (P, page_size, kvh, hd)
            or cache_v.shape != cache_k.shape
            or new_k.shape != (B, K, kvh, hd) or new_v.shape != new_k.shape
            or block_tables.shape != (B, n_pages)
            or ctx_len.shape != (B,) or new_len.shape != (B,)):
        raise ValueError("paged_decode_attention: inconsistent shapes")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, cache_k, cache_v, new_k, new_v, block_tables, ctx_len,
            new_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    tensors = (q, cache_k, cache_v, new_k, new_v, block_tables, ctx_len,
               new_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: tensors on different "
                         "devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: tensors must be "
                         "contiguous")
    if (q.dtype not in _DTYPES or hd not in HEAD_DIMS or not 1 <= rep <= 16
            or any(t.dtype != q.dtype for t in tensors[1:5])):
        raise ValueError(f"paged_decode_attention kernel takes f32/bf16, "
                         f"head_dim in {HEAD_DIMS}, rep <= 16; got "
                         f"{q.dtype}, {hd}, {rep}")
    if any(t.dtype != torch.int32 for t in tensors[5:]):
        raise ValueError("paged_decode_attention: block_tables, ctx_len "
                         "and new_len must be int32")
    if any(t.data_ptr() % 16 for t in tensors[1:5]):
        # K and V rows are copied 16 bytes at a time
        raise ValueError("paged_decode_attention: cache_k, cache_v, new_k "
                         "and new_v must start at a 16-byte boundary")
    pps, n_splits = paged_decode_splits(B, kvh, n_pages,
                                        _num_sms(q.device.index))
    if B > 65535 or n_splits > MAX_SPLITS:
        # one grid row per sequence (CUDA caps gridDim.y); the combine
        # keeps every split's weights in shared memory
        raise ValueError(f"paged_decode_attention kernel takes B <= 65535 "
                         f"and at most {MAX_SPLITS} splits, got {B}, "
                         f"{n_splits}")
    out = torch.empty_like(q)
    if B == 0 or kvh == 0:
        return out
    # the splits' partials: acc [.., rep, hd], then (m, l) [.., rep, 2]
    part = torch.empty(B * kvh * (n_splits + 1) * rep * (hd + 2),
                       dtype=torch.float32, device=q.device)
    fn = _kernels.lib("paged_decode").paged_decode
    err = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
             new_k.data_ptr(), new_v.data_ptr(), block_tables.data_ptr(),
             ctx_len.data_ptr(), new_len.data_ptr(), part.data_ptr(),
             out.data_ptr(), B, kvh, rep, hd, P, page_size, n_pages, K, pps,
             n_splits, float(hd) ** -0.5, _DTYPES[q.dtype],
             _kernels.stream_ptr(q.device))
    _kernels.check("paged_decode", err)
    with _kernels.COUNT_LOCK:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
