"""Model runner: prefill, chunked prefill, the fused K-step decode burst
(eager, or a greedy step captured as a CUDA graph, ``DecodeGraph``) and
the speculative verify window over the paged KV cache, for the Llama
family, with per-slot LoRA adapters on prefill and decode.

Counterpart of ``ray_tpu/llm/runner.py``. Where the JAX functions donated
the cache buffers and returned new ones, these update ``cache_k`` /
``cache_v`` IN PLACE and return the same tensors, so the signatures stay
the reference's. Layers run as a Python loop over the stacked "layers"
axis (the reference's lax.scan).

Precision follows the reference: projections run in the model dtype;
attention scores, softmax and the PV products accumulate in f32; the
lm_head takes model-dtype operands with f32 accumulation and an f32
result (``ops.quant.logits_matmul``). f32 models rely on PyTorch's
default ``torch.backends.cuda.matmul.allow_tf32 = False`` on the card:
with TF32 on, f32 products keep ~3 decimal digits and greedy streams
drift from the reference.

The entry points run under ``torch.inference_mode()``: params that come
from a trainer with ``requires_grad`` set build no graph, and attention
saves nothing for a backward.

Padding lanes and inactive slots write to the dump page 0 explicitly:
unlike JAX's clamping gathers and dropping scatters, an out-of-range
index in torch raises or corrupts, so every (page, offset) pair is
computed in range.

MoE configurations (``n_experts > 0``) serve on every entry point with
the exact drop-free mixture (``ops.moe.moe_mlp_dense``), as the
reference does: capacity-based dispatch would drop tokens depending on
the batch and change generations.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .._private.config import global_config
from .._private.tree import layer_params, tree_leaves
from ..models.llama import LlamaConfig
from ..ops import _kernels, apply_rotary, attention, rms_norm
from ..ops.moe import moe_mlp_dense
from ..ops.paged_attention import paged_decode_attention
from ..ops.quant import (embed_lookup, is_quantized, logits_matmul,
                         weight_einsum)
from ..util.tracing import device_spans_off, span
from .lora import lora_delta
from .sampling import sample_from_logits


def _mlp(h, lp, cfg: LlamaConfig):
    """Dense SwiGLU, or the exact top-k expert mixture for MoE (every
    expert on every token in f32, E times the dense MLP's work)."""
    with span("op.mlp", device=True):
        if cfg.n_experts:
            return moe_mlp_dense(h, lp["router"], lp["w_gate"], lp["w_up"],
                                 lp["w_down"], top_k=cfg.top_k)
        g = weight_einsum("bsd,dm->bsm", h, lp["w_gate"])
        u = weight_einsum("bsd,dm->bsm", h, lp["w_up"])
        return weight_einsum("bsm,md->bsd", F.silu(g) * u, lp["w_down"])


def _lm_logits(x_last, params, cfg: LlamaConfig):
    """Final-norm'd hidden -> f32 logits, raw or int8 lm_head; operands
    in the model dtype, f32 accumulation."""
    lm = params["lm_head"]
    if not is_quantized(lm):
        lm = lm.to(cfg.dtype)
    return logits_matmul(x_last.to(cfg.dtype), lm)


def _page_slots(block_tables, positions, page_size: int):
    """Flattened (page, offset) of each position; negative positions
    (padding, inactive lanes) map to the dump page (0, 0). Table columns
    are clamped into range, as JAX's gather clamps."""
    valid = positions >= 0
    pos = positions.clamp_min(0).long()
    col = (pos // page_size).clamp(max=block_tables.shape[1] - 1)
    page = torch.gather(block_tables.long(), 1, col)
    page = torch.where(valid, page, 0)
    offset = torch.where(valid, pos % page_size, 0)
    return page.reshape(-1), offset.reshape(-1)


def _write_pages(cache_layer, new, slots):
    """Scatter per-token K or V rows [B, S, kvh, hd] into their pages of
    ``cache_layer`` [P, page, kvh, hd], in place. ``slots`` is
    ``_page_slots`` of the rows' positions, computed once per call and
    shared by every layer."""
    fp, fo = slots
    cache_layer[fp, fo] = new.reshape(-1, *new.shape[2:]).to(
        cache_layer.dtype)


def _qkv(h, lp, cfg, lora=None, li: int = 0):
    """q, k, v of one layer; with a ``LoRAPool.select`` selection
    (``[B, L, ...]``), layer ``li``'s deltas are added to q and v before
    rotary. An empty or None selection is the base model."""
    q = weight_einsum("bsd,dhk->bshk", h, lp["wq"])
    k = weight_einsum("bsd,dhk->bshk", h, lp["wk"])
    v = weight_einsum("bsd,dhk->bshk", h, lp["wv"])
    if lora:
        q = q + lora_delta(h, lora["a_q"][:, li], lora["b_q"][:, li],
                           lora["scale"], cfg.n_heads, cfg.head_dim)
        v = v + lora_delta(h, lora["a_v"][:, li], lora["b_v"][:, li],
                           lora["scale"], cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _finish_layer(x, o, lp, cfg):
    x = x + weight_einsum("bshk,hkd->bsd", o, lp["wo"])
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp(h, lp, cfg)


@torch.inference_mode()
def prefill(params, cache_k, cache_v, tokens, prompt_lens, block_tables,
            cos, sin, lora=None, *, cfg: LlamaConfig):
    """Process whole right-padded prompts, fill their pages, return the
    last valid token's logits. tokens [B, S]; prompt_lens [B];
    block_tables [B, Pmax]. ``lora``: the per-row adapters of
    ``LoRAPool.select`` (None or empty: the base model). Attention is
    ``ops.attention`` (the flash kernel on the card). Returns (logits
    [B, vocab] f32, cache_k, cache_v), the caches updated in place."""
    B, S = tokens.shape
    dev = tokens.device
    page_size = cache_k.shape[2]
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    pos_grid = torch.arange(S, device=dev)[None, :].expand(B, S)
    write_pos = torch.where(pos_grid < prompt_lens[:, None], pos_grid, -1)
    slots = _page_slots(block_tables, write_pos, page_size)
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(h, lp, cfg, lora, li)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        _write_pages(cache_k[li], k, slots)
        _write_pages(cache_v[li], v, slots)
        # right padding is safe under the causal mask: a real position
        # only attends to earlier (real) positions
        o = attention(q, k, v, causal=True)
        x = _finish_layer(x, o, lp, cfg)
    last = (prompt_lens.long() - 1).clamp_min(0)
    x_last = x[torch.arange(B, device=dev), last]
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return _lm_logits(x_last, params, cfg), cache_k, cache_v


def prefill_bucket(seq_len: int, max_seq: int, floor: int = 16) -> int:
    """Power-of-2 padding bucket."""
    b = floor
    while b < seq_len:
        b *= 2
    return min(b, max_seq)


@torch.inference_mode()
def prefill_chunk(params, cache_k, cache_v, tokens, start_pos: int,
                  chunk_len: int, block_tables, cos, sin, *,
                  cfg: LlamaConfig):
    """One chunk of a long prompt: tokens [1, C] are positions
    [start_pos, start_pos + chunk_len); they attend causally within the
    chunk and over the pages earlier chunks wrote. Returns (logits
    [1, vocab] of the chunk's last valid token, cache_k, cache_v)."""
    B, C = tokens.shape
    dev = tokens.device
    n_pool, page_size = cache_k.shape[1], cache_k.shape[2]
    Spast = block_tables.shape[1] * page_size
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // kvh
    scale = hd ** -0.5
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    ar = torch.arange(C, device=dev)
    pos_grid = (start_pos + ar)[None, :].expand(B, C)
    valid = ar[None, :] < chunk_len
    write_pos = torch.where(valid, pos_grid, -1)
    past_mask = torch.arange(Spast, device=dev)[None, :] < start_pos
    chunk_mask = (ar[None, :, None] >= ar[None, None, :]) & valid[:, None, :]
    slots = _page_slots(block_tables, write_pos, page_size)
    bt = block_tables.long().clamp(0, n_pool - 1)
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(h, lp, cfg)
        q = apply_rotary(q, cos, sin, positions=pos_grid)
        k = apply_rotary(k, cos, sin, positions=pos_grid)
        ck, cv = cache_k[li], cache_v[li]
        _write_pages(ck, k, slots)
        _write_pages(cv, v, slots)
        pk = ck[bt].reshape(B, Spast, kvh, hd)
        pv = cv[bt].reshape(B, Spast, kvh, hd)
        qg = q.reshape(B, C, kvh, rep, hd).float()
        s_past = torch.einsum("bcgrd,bsgd->bcgrs", qg, pk.float())
        s_self = torch.einsum("bcgrd,btgd->bcgrt", qg, k.float())
        s_past = torch.where(past_mask[:, None, None, None, :],
                             s_past * scale, -torch.inf)
        s_self = torch.where(chunk_mask[:, :, None, None, :],
                             s_self * scale, -torch.inf)
        p = torch.softmax(torch.cat([s_past, s_self], dim=-1),
                          dim=-1).to(pk.dtype).float()
        o = (torch.einsum("bcgrs,bsgd->bcgrd", p[..., :Spast], pv.float())
             + torch.einsum("bcgrt,btgd->bcgrd", p[..., Spast:], v.float()))
        o = o.reshape(B, C, cfg.n_heads, hd).to(x.dtype)
        x = _finish_layer(x, o, lp, cfg)
    x_last = x[:, max(chunk_len - 1, 0)]
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return _lm_logits(x_last, params, cfg), cache_k, cache_v


@torch.inference_mode()
def verify_step(params, cache_k, cache_v, tokens, positions, block_tables,
                cos, sin, seed, temperature, top_k, top_p, *,
                cfg: LlamaConfig, greedy: bool = False):
    """Batched multi-token verification forward (speculative decoding):
    score a whole draft window in one forward over the paged cache.

    tokens [B, S] are the window tokens (a row is [last emitted, d_1 ..
    d_k]); positions [B, S] their absolute positions, -1 for padding
    (shorter windows, undrafted slots), whose writes go to the dump page.
    Every valid window token's K/V is written first; attention then
    gathers the row's pages and masks by key_pos <= query_pos, so the
    window sees its own keys through the pages, and stale rows of an
    earlier rejected window (positions above every query) never score.
    Table columns past a row's provisioned span point at page 0; their
    key positions too lie above every query.

    Returns (argmax tokens [B, S] (index j predicts the token after
    window position j), the position-0 token [B], sampled unless
    ``greedy``, cache_k, cache_v), the caches updated in place.
    """
    B, S = tokens.shape
    dev = tokens.device
    n_pool, page_size = cache_k.shape[1], cache_k.shape[2]
    Sall = block_tables.shape[1] * page_size
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // kvh
    scale = hd ** -0.5
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    qpos = positions.long().clamp_min(0)                       # [B, S]
    kmask = (torch.arange(Sall, device=dev)[None, None, :]
             <= qpos[:, :, None])                              # [B, S, Sall]
    slots = _page_slots(block_tables, positions, page_size)
    bt = block_tables.long().clamp(0, n_pool - 1)
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(h, lp, cfg)
        q = apply_rotary(q, cos, sin, positions=qpos)
        k = apply_rotary(k, cos, sin, positions=qpos)
        ck, cv = cache_k[li], cache_v[li]
        _write_pages(ck, k, slots)
        _write_pages(cv, v, slots)
        pk = ck[bt].reshape(B, Sall, kvh, hd)
        pv = cv[bt].reshape(B, Sall, kvh, hd)
        qg = q.reshape(B, S, kvh, rep, hd).float()
        s = torch.einsum("bsgrd,btgd->bsgrt", qg, pk.float())
        s = torch.where(kmask[:, :, None, None, :], s * scale, -torch.inf)
        p = torch.softmax(s, dim=-1).to(pk.dtype).float()
        o = torch.einsum("bsgrt,btgd->bsgrd", p, pv.float())
        o = o.reshape(B, S, cfg.n_heads, hd).to(x.dtype)
        x = _finish_layer(x, o, lp, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _lm_logits(x, params, cfg)                        # [B, S, V]
    tgt = logits.argmax(dim=-1)
    if greedy:
        samp0 = tgt[:, 0]
    else:
        samp0 = sample_from_logits(logits[:, 0], seed, temperature, top_k,
                                   top_p)
    return tgt, samp0, cache_k, cache_v


def sample_logits(logits, seed, temperature, top_k, top_p):
    """Standalone sampler (the chunked-prefill tail)."""
    return sample_from_logits(logits, seed, temperature, top_k, top_p)


@torch.inference_mode()
def prefill_sample(params, cache_k, cache_v, tokens, prompt_lens,
                   block_tables, cos, sin, seed, temperature, top_k,
                   top_p, lora=None, *, cfg: LlamaConfig,
                   greedy: bool = False):
    """``prefill`` then sampling; ``greedy=True`` takes the argmax."""
    logits, cache_k, cache_v = prefill(
        params, cache_k, cache_v, tokens, prompt_lens, block_tables, cos,
        sin, lora, cfg=cfg)
    if greedy:
        toks = logits.argmax(dim=-1)
    else:
        toks = sample_from_logits(logits, seed, temperature, top_k, top_p)
    return toks, cache_k, cache_v


def _attend_gathered(qg, ok, ov, nk, nv, old_mask, new_mask, hd):
    """Decode attention over pages gathered once per burst + the burst
    scratch: f32 scores, -inf masking, softmax, P in the cache dtype, f32
    PV (the reference's attend_gathered)."""
    scale = hd ** -0.5
    qf = qg.float()
    s_old = torch.einsum("bgrd,bsgd->bgrs", qf, ok.float())
    s_new = torch.einsum("bgrd,bkgd->bgrk", qf, nk.float())
    s_old = torch.where(old_mask[:, None, None, :], s_old * scale,
                        -torch.inf)
    s_new = torch.where(new_mask[None, None, :, :], s_new * scale,
                        -torch.inf)
    p = torch.softmax(torch.cat([s_old, s_new], dim=-1),
                      dim=-1).to(ok.dtype).float()
    Sold = ok.shape[1]
    return (torch.einsum("bgrs,bsgd->bgrd", p[..., :Sold], ov.float())
            + torch.einsum("bgrk,bkgd->bgrd", p[..., Sold:], nv.float()))


def _decode_step(params, cache_k, cache_v, toks, positions, block_tables,
                 active, cos, sin, step, scratch_k, scratch_v, out,
                 lora=None, gathered=None, seed=0, temperature=None,
                 top_k=None, top_p=None, *, cfg: LlamaConfig,
                 greedy: bool = False):
    """One step of a decode burst, at the step index ``step`` ([1] int32,
    on the device): the rows' tokens ``toks`` [B] int64 at positions
    ``positions + step``, attending over the cached context and columns
    0..step of the burst scratch [L, B, width, kvh, hd]. It writes the
    step's K and V into scratch column ``step``, feeds the new tokens
    back into ``toks`` (inactive rows keep theirs), writes them into row
    ``step`` of ``out`` [width, B] and increments ``step``, all in place
    and with no host read, so that a CUDA graph can capture it.
    ``gathered`` is (old_k, old_v, old_mask) of the gather path, None for
    the paged kernel; ``seed`` is this step's sampling seed."""
    B = toks.shape[0]
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // kvh
    idx = step.long()
    pos_i = (positions + step)[:, None]
    new_len = (step + 1).expand(B).contiguous()
    x = embed_lookup(params["embed"], toks, cfg.dtype)[:, None, :]
    for li in range(cfg.n_layers):
        lp = layer_params(params["layers"], li)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(h, lp, cfg, lora, li)
        q = apply_rotary(q, cos, sin, positions=pos_i)[:, 0]
        k = apply_rotary(k, cos, sin, positions=pos_i)
        scratch_k[li].index_copy_(1, idx, k.to(scratch_k.dtype))
        scratch_v[li].index_copy_(1, idx, v.to(scratch_v.dtype))
        qg = q.reshape(B, kvh, rep, hd)
        if gathered is None:
            o = paged_decode_attention(
                qg, cache_k[li], cache_v[li], scratch_k[li], scratch_v[li],
                block_tables, positions, new_len).float()
        else:
            old_k, old_v, old_mask = gathered
            new_mask = torch.arange(scratch_k.shape[2],
                                    device=idx.device)[None, :] <= step
            o = _attend_gathered(qg, old_k[li], old_v[li], scratch_k[li],
                                 scratch_v[li], old_mask, new_mask, hd)
        o = o.reshape(B, 1, cfg.n_heads, hd).to(x.dtype)
        x = _finish_layer(x, o, lp, cfg)
    h = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    logits = _lm_logits(h, params, cfg)
    if greedy:
        newt = logits.argmax(dim=-1)
    else:
        newt = sample_from_logits(logits, seed, temperature, top_k, top_p)
    toks.copy_(torch.where(active, newt, toks))
    out.index_copy_(0, idx, toks[None])
    step.add_(1)


def _scatter_burst(cache_k, cache_v, scratch_k, scratch_v, positions,
                   active, block_tables, n_steps: int):
    """One scatter of a burst's first ``n_steps`` scratch columns into the
    pages, in place; inactive slots land on dump page 0."""
    L, B = scratch_k.shape[:2]
    kvh, hd = scratch_k.shape[3:]
    ar_k = torch.arange(n_steps, device=positions.device)
    p_grid = positions.long()[:, None] + ar_k[None, :]          # [B, K]
    write_pos = torch.where(active[:, None], p_grid, -1)
    fp, fo = _page_slots(block_tables, write_pos, cache_k.shape[2])
    cache_k[:, fp, fo] = scratch_k[:, :, :n_steps].reshape(
        L, B * n_steps, kvh, hd)
    cache_v[:, fp, fo] = scratch_v[:, :, :n_steps].reshape(
        L, B * n_steps, kvh, hd)


@torch.inference_mode()
def decode_burst(params, cache_k, cache_v, tokens, positions,
                 block_tables, active, cos, sin, seed, temperature,
                 top_k, top_p, lora=None, *, cfg: LlamaConfig,
                 n_steps: int, paged_kernel: Optional[bool] = None,
                 greedy: bool = False):
    """``n_steps`` fused decode+sample steps with the sampled tokens fed
    back on the device; the host reads the [n_steps, B] tokens once.

    The cache is read-only during the burst: new K/V rows accumulate in a
    [L, B, K] scratch, attention runs over the cached context plus the
    scratch (masked per step), and the scratch is scattered into the
    pages once at the end, in place. Decode attention is the paged
    kernel (``paged_kernel``, default: the ``llm_paged_kernel`` flag),
    which streams pages through the block table, or the gather path,
    which gathers the context once per burst. Inactive slots write to
    dump page 0. The host must have provisioned pages for
    positions .. positions + n_steps - 1.

    ``lora`` is a ``LoRAPool.select`` selection for the B rows, on both
    attention paths.

    Returns (tokens [n_steps, B], cache_k, cache_v).
    """
    use_paged = (global_config().llm_paged_kernel if paged_kernel is None
                 else paged_kernel)
    B = tokens.shape[0]
    K, L = n_steps, cfg.n_layers
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    dev = tokens.device
    n_pool, page_size = cache_k.shape[1], cache_k.shape[2]
    Sold = block_tables.shape[1] * page_size
    positions = positions.to(torch.int32).contiguous()
    block_tables = block_tables.to(torch.int32).contiguous()
    gathered = None
    if not use_paged:
        bt = block_tables.long().clamp(0, n_pool - 1)
        gathered = (cache_k[:, bt].reshape(L, B, Sold, kvh, hd),
                    cache_v[:, bt].reshape(L, B, Sold, kvh, hd),
                    torch.arange(Sold, device=dev)[None, :]
                    < positions[:, None])                       # [B, Sold]
    scratch_k = torch.zeros((L, B, K, kvh, hd), dtype=cache_k.dtype,
                            device=dev)
    scratch_v = torch.zeros_like(scratch_k)
    out = torch.empty((K, B), dtype=torch.int64, device=dev)
    toks = tokens.to(torch.int64, copy=True)
    step = torch.zeros(1, dtype=torch.int32, device=dev)
    for i in range(K):
        _decode_step(params, cache_k, cache_v, toks, positions,
                     block_tables, active, cos, sin, step, scratch_k,
                     scratch_v, out, lora, gathered, seed + i, temperature,
                     top_k, top_p, cfg=cfg, greedy=greedy)
    _scatter_burst(cache_k, cache_v, scratch_k, scratch_v, positions, active,
                   block_tables, K)
    return out, cache_k, cache_v


class DecodeGraph:
    """A greedy decode step of the whole model on the paged kernel, over
    static buffers, captured once as a CUDA graph that a burst replays
    once a step: the host launches one graph a step instead of every op
    of every layer.

    The buffers are sized once: ``batch`` rows, a scratch of ``width``
    (the engine's ``decode_burst``) columns and the block table at its
    full ``n_pages`` columns (the columns past a row's pages point at
    dump page 0; the paged kernel's grid comes from the shapes alone).
    ``run`` loads a burst's tokens, positions, ``active`` rows and table
    into them, zeroes the step index, replays the graph ``n_steps`` times
    with no host work between replays, then scatters the scratch into the
    pages as ``decode_burst`` does. On the card its tokens equal
    ``decode_burst``'s with the same table, and so do the pages, bit for
    bit: the kernel reads only the scratch's steps so far.

    The graph holds the addresses of the parameters, the KV cache and the
    rotary tables; it is captured lazily, at the first ``run``, and again
    whenever one of those tensors is another than at the capture. It is
    captured under ``torch.inference_mode()``, after one warm-up step on
    the capture's side stream, on inputs where no row is active, with
    ``capture_error_mode="thread_local"`` (a server steps its engine on a
    worker thread), and with the tracer's device spans suspended, so that
    no span's CUDA events are baked into the graph. Its warm-up step and
    its capture decode nothing and are left out of the paged kernel's
    launch count; every replay adds ``n_layers`` to it.

    On a device other than CUDA there is nothing to capture: ``run``
    executes the same step, eagerly, ``n_steps`` times.
    """

    @torch.inference_mode()
    def __init__(self, cfg: LlamaConfig, batch: int, width: int,
                 n_pages: int, kv_dtype, device):
        self.cfg = cfg
        self.device = torch.device(device)
        shape = (cfg.n_layers, batch, width, cfg.n_kv_heads, cfg.head_dim)
        self.tokens = torch.zeros(batch, dtype=torch.int64, device=device)
        self.positions = torch.zeros(batch, dtype=torch.int32,
                                     device=device)
        self.active = torch.zeros(batch, dtype=torch.bool, device=device)
        self.block_tables = torch.zeros((batch, n_pages), dtype=torch.int32,
                                        device=device)
        self.step = torch.zeros(1, dtype=torch.int32, device=device)
        self.scratch_k = torch.zeros(shape, dtype=kv_dtype, device=device)
        self.scratch_v = torch.zeros_like(self.scratch_k)
        self.out = torch.zeros((width, batch), dtype=torch.int64,
                               device=device)
        self.graph = None
        self.captured_on = None
        self.captures = 0

    def _step(self, params, cache_k, cache_v, cos, sin):
        _decode_step(params, cache_k, cache_v, self.tokens, self.positions,
                     self.block_tables, self.active, cos, sin, self.step,
                     self.scratch_k, self.scratch_v, self.out,
                     cfg=self.cfg, greedy=True)

    def _capture(self, params, cache_k, cache_v, cos, sin, key):
        self.graph = None       # the old graph's pool goes first
        for t in (self.tokens, self.positions, self.active,
                  self.block_tables, self.step):
            t.zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        with device_spans_off():
            with torch.cuda.stream(side):
                self._step(params, cache_k, cache_v, cos, sin)
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                self._step(params, cache_k, cache_v, cos, sin)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with _kernels.COUNT_LOCK:
            paged_decode_attention.launches -= 2 * self.cfg.n_layers
        self.graph, self.captured_on = graph, key
        self.captures += 1

    @torch.inference_mode()
    def run(self, params, cache_k, cache_v, tokens, positions, block_tables,
            active, cos, sin, n_steps: int):
        """A greedy burst of ``n_steps`` (at most ``width``) over the
        paged cache, as ``decode_burst``; ``block_tables`` has the full
        ``n_pages`` columns. Returns the [n_steps, B] tokens, a view of
        the buffer that the next ``run`` overwrites."""
        if self.device.type == "cuda":
            key = tuple((t.data_ptr(), tuple(t.shape))
                        for t in (*tree_leaves(params), cache_k, cache_v,
                                  cos, sin))
            if key != self.captured_on:
                self._capture(params, cache_k, cache_v, cos, sin, key)
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        self.active.copy_(active)
        self.block_tables.copy_(block_tables)
        self.step.zero_()
        if self.graph is not None:
            for _ in range(n_steps):
                self.graph.replay()
            with _kernels.COUNT_LOCK:
                paged_decode_attention.launches += (n_steps
                                                    * self.cfg.n_layers)
        else:
            for _ in range(n_steps):
                self._step(params, cache_k, cache_v, cos, sin)
        _scatter_burst(cache_k, cache_v, self.scratch_k, self.scratch_v,
                       self.positions, self.active, self.block_tables,
                       n_steps)
        return self.out[:n_steps]
