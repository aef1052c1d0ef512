"""ray_tpu_torch ops against ray_tpu's on the same numpy inputs (CPU).

The port's wrappers run their plain PyTorch versions on CPU tensors; the
JAX side runs the Pallas kernels in interpret mode, as ray_tpu's own
tests do. The kernels themselves are tested on the card by
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import apply_rotary as j_rotary
from ray_tpu.ops import naive_attention as j_naive
from ray_tpu.ops import rms_norm as j_rms
from ray_tpu.ops import rope_frequencies as j_rope
from ray_tpu.ops import quant as jq
from ray_tpu.ops.attention import blockwise_attention as j_blockwise
from ray_tpu.ops.attention import flash_attention_tpu, flash_attention_tpu_bwd
from ray_tpu.ops.paged_attention import (
    paged_decode_attention as j_paged,
    paged_decode_attention_reference as j_paged_ref)

from ray_tpu_torch.ops import (FlashAttention, _kernels, apply_rotary,
                               attention, blockwise_attention, dkv_route,
                               dq_route, flash_attention,
                               flash_attention_bwd,
                               flash_attention_bwd_reference,
                               flash_attention_reference, flash_bwd_dkv,
                               flash_bwd_dq, fwd_route, naive_attention,
                               paged_decode_attention,
                               paged_decode_attention_reference,
                               paged_decode_splits, rms_norm,
                               rope_frequencies)
from ray_tpu_torch.ops.attention import TC_HEAD_DIMS
from ray_tpu_torch.ops.paged_attention import MAX_PAGES_PER_SPLIT
from ray_tpu_torch.ops import quant as tq

# six xdist workers share the machine's cores
torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    """numpy (f32) → torch CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    return x.detach().float().numpy()


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(j_rms(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = _np(rms_norm(_t(x), _t(w), 1e-5))
    np.testing.assert_allclose(got, want, **F32)


def test_rope_tables_match_jax():
    cos, sin = rope_frequencies(32, 100, 500000.0)
    jc, js = j_rope(32, 100, 500000.0)
    np.testing.assert_allclose(_np(cos), np.asarray(jc), **F32)
    np.testing.assert_allclose(_np(sin), np.asarray(js), **F32)


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rotary_matches_jax(with_positions):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    jc, js = j_rope(32, 64)
    cos, sin = rope_frequencies(32, 64)
    pos = None
    if with_positions:
        pos = rng.integers(0, 64, (2, 7)).astype(np.int32)
    want = j_rotary(jnp.asarray(x), jc, js,
                    None if pos is None else jnp.asarray(pos))
    got = apply_rotary(_t(x), cos, sin,
                       None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("eq,xs,ws,axes", [
    ("bsd,dhk->bshk", (2, 3, 16), (16, 4, 8), (0,)),
    ("bshk,hkd->bsd", (2, 3, 4, 8), (4, 8, 16), (0, 1)),
    ("bd,dv->bv", (3, 16), (16, 40), (0,)),
])
def test_quantize_and_weight_einsum_match_jax(eq, xs, ws, axes):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    jw = jq.quantize_weight(w, axes)                 # numpy path
    tw = tq.quantize_weight(_t(w), axes)
    np.testing.assert_array_equal(tw["q"].numpy(), jw["q"])
    np.testing.assert_allclose(_np(tw["s"]), jw["s"], **F32)
    np.testing.assert_allclose(
        _np(tq.dequantize_weight(tw, axes, torch.float32)),
        jq.dequantize_weight(jw, axes, np.float32), **F32)
    for jwt, twt in ((w, _t(w)), (jax.tree.map(jnp.asarray, jw), tw)):
        want = jq.weight_einsum(eq, jnp.asarray(x), jwt)
        got = tq.weight_einsum(eq, _t(x), twt)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=1e-4, rtol=1e-5)
    assert tq.is_quantized(tw) and not tq.is_quantized(_t(w))


def test_logits_matmul_is_f32_accumulation():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    want = jnp.einsum("bd,dv->bv", jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(w, jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    got = tq.logits_matmul(_t(x).bfloat16(), _t(w).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("quantized", [False, True])
def test_embed_lookup_matches_jax(quantized):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5)).astype(np.int32)
    jt, tt = table, _t(table)
    if quantized:
        jt = jax.tree.map(jnp.asarray, jq.quantize_weight(table, (1,)))
        tt = tq.quantize_weight(_t(table), (1,))
    want = jq.embed_lookup(jt if quantized else jnp.asarray(jt),
                           jnp.asarray(toks), jnp.float32)
    got = tq.embed_lookup(tt, torch.from_numpy(toks), torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_naive_and_blockwise_match_jax(causal, hkv):
    q, k, v = _qkv(5, 2, 48, 64, 4, hkv, 16)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    targs = [_t(a) for a in (q, k, v)]
    want = np.asarray(j_naive(*jargs, causal=causal))
    np.testing.assert_allclose(
        _np(naive_attention(*targs, causal=causal)), want, **F32)
    np.testing.assert_allclose(
        _np(blockwise_attention(*targs, causal=causal, kv_block=16)),
        np.asarray(j_blockwise(*jargs, causal=causal, kv_block=16)),
        **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_plain_matches_pallas_interpret(causal, hkv):
    """The cases of test_ops.py's interpret-mode flash tests: O and LSE."""
    q, k, v = _qkv(8, 2, 256, 256, 4, hkv, 128)
    out, lse = flash_attention_tpu(
        *[jnp.asarray(a) for a in (q, k, v)], causal=causal, block_q=128,
        block_k=128, interpret=True, return_lse=True)
    got, got_lse = flash_attention(*[_t(a) for a in (q, k, v)],
                                   causal=causal, return_lse=True)
    np.testing.assert_allclose(_np(got), np.asarray(out), **F32)
    np.testing.assert_allclose(_np(got_lse), np.asarray(lse), **F32)


def test_flash_plain_matches_pallas_interpret_bf16_sq_lt_skv():
    _check_flash_bf16_sq_lt_skv(128)


@pytest.mark.parametrize("d", [64])
def test_flash_plain_matches_pallas_interpret_bf16_sq_lt_skv_head_dim(d):
    """The same at CLIP's heads of 64 (the tensor-core forward's other
    head dim)."""
    _check_flash_bf16_sq_lt_skv(d)


def _check_flash_bf16_sq_lt_skv(d):
    q, k, v = _qkv(9, 1, 128, 256, 2, 1, d)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    out, lse = flash_attention_tpu(*jb, causal=True, block_q=128,
                                   block_k=128, interpret=True,
                                   return_lse=True)
    tb = [_t(np.asarray(a, np.float32)).bfloat16() for a in jb]
    got, got_lse = flash_attention(*tb, causal=True, return_lse=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(out, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(got_lse), np.asarray(lse),
                               atol=2e-2, rtol=2e-2)


def test_flash_plain_ragged_and_fully_masked_rows():
    """Shapes the Pallas kernel cannot take (S=100; Sq > Skv, whose first
    rows see no key) against the naive oracle: masked rows give 0."""
    for sq, skv in ((100, 100), (96, 64)):
        q, k, v = _qkv(10, 2, sq, skv, 4, 2, 64)
        want = np.asarray(j_naive(*[jnp.asarray(a) for a in (q, k, v)],
                                  causal=True))
        got, lse = flash_attention(*[_t(a) for a in (q, k, v)],
                                   causal=True, return_lse=True)
        np.testing.assert_allclose(_np(got), want, **F32)
        assert np.isfinite(_np(lse)).all()
    assert np.abs(_np(got)[:, :sq - skv]).max() == 0.0


def test_kernel_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
    qg = torch.empty((1, 1, 2, 64), device="meta")
    cache = torch.empty((3, 4, 1, 64), device="meta")
    new = torch.empty((1, 2, 1, 64), device="meta")
    ints = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        paged_decode_attention(qg, cache, cache, new, new,
                               torch.empty((1, 2), dtype=torch.int32,
                                           device="meta"), ints, ints)
    assert flash_attention.launches == 0
    assert paged_decode_attention.launches == 0


def _paged_case(rng, B, kvh, rep, hd, page, n_pages, P, K):
    q = rng.standard_normal((B, kvh, rep, hd)).astype(np.float32)
    ck = rng.standard_normal((P, page, kvh, hd)).astype(np.float32)
    cv = rng.standard_normal((P, page, kvh, hd)).astype(np.float32)
    nk = rng.standard_normal((B, K, kvh, hd)).astype(np.float32)
    nv = rng.standard_normal((B, K, kvh, hd)).astype(np.float32)
    bt = np.stack([rng.choice(P, size=n_pages, replace=False)
                   for _ in range(B)]).astype(np.int32)
    return [q, ck, cv, nk, nv, bt]


def _both_paged(args, ctx, new_len, page):
    jout = j_paged(*[jnp.asarray(a) for a in args], jnp.asarray(ctx),
                   jnp.asarray(new_len), page_size=page, interpret=True)
    targs = [_t(a) for a in args[:5]] + [torch.from_numpy(args[5])]
    tout = paged_decode_attention(*targs, torch.from_numpy(ctx),
                                  torch.from_numpy(new_len))
    return np.asarray(jout), _np(tout)


@pytest.mark.parametrize("B,kvh,rep,hd,page,n_pages,P,K", [
    (3, 2, 4, 64, 16, 4, 32, 8),     # GQA, mixed contexts
    (2, 1, 8, 128, 32, 2, 8, 4),     # MQA, big heads
    (4, 4, 1, 64, 16, 8, 64, 16),    # MHA (rep=1), long table
])
def test_paged_plain_matches_pallas_interpret(B, kvh, rep, hd, page,
                                              n_pages, P, K):
    rng = np.random.default_rng(B * 1000 + rep)
    args = _paged_case(rng, B, kvh, rep, hd, page, n_pages, P, K)
    ctx = rng.integers(0, page * n_pages + 1, B).astype(np.int32)
    new_len = np.maximum(rng.integers(0, K + 1, B), 1).astype(np.int32)
    want, got = _both_paged(args, ctx, new_len, page)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


def test_paged_plain_edge_contexts_and_empty_rows():
    """Tail only, full pages, page-boundary lengths; valid rows against
    the Pallas kernel (as test_paged_attention filters them), and the
    empty row is 0 (the kernel semantics the port keeps)."""
    rng = np.random.default_rng(7)
    B, kvh, rep, hd, page, n_pages, P, K = 4, 2, 2, 64, 16, 4, 16, 8
    args = _paged_case(rng, B, kvh, rep, hd, page, n_pages, P, K)
    ctx = np.asarray([0, page, page * n_pages, page + 1], np.int32)
    new_len = np.asarray([K, 1, 0, 3], np.int32)
    want, got = _both_paged(args, ctx, new_len, page)
    valid = ctx + new_len > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=3e-5,
                               rtol=3e-5)
    ctx[0], new_len[0] = 0, 0
    _, got = _both_paged(args, ctx, new_len, page)
    assert np.abs(got[0]).max() == 0.0


@pytest.mark.parametrize("poison", [1e4, float("nan")])
def test_paged_plain_ignores_dump_page_poison(poison):
    rng = np.random.default_rng(11)
    B, kvh, rep, hd, page, n_pages, P, K = 2, 2, 2, 64, 16, 4, 16, 4
    args = _paged_case(rng, B, kvh, rep, hd, page, n_pages, P, K)
    clean = [a.copy() for a in args]
    args[1][0] = poison
    args[2][0] = poison
    args[5] = clean[5] = np.asarray([[3, 0, 0, 0], [5, 6, 0, 0]], np.int32)
    ctx = np.asarray([10, 20], np.int32)
    new_len = np.asarray([2, 2], np.int32)
    want, _ = _both_paged(clean, ctx, new_len, page)
    targs = [_t(a) for a in args[:5]] + [torch.from_numpy(args[5])]
    got = _np(paged_decode_attention(*targs, torch.from_numpy(ctx),
                                     torch.from_numpy(new_len)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


# the kernel's masked score
NEG_INF = -1e30


def _partial(qf, k, v, mask):
    """One split's f32 state over positions ``mask`` [B, S]: the row max
    m, the sum l and the unnormalised P V, (m, l) [B, kvh, rep] and acc
    [B, kvh, rep, hd]; a split with no valid position gives (-1e30, 0,
    0)."""
    k = torch.where(mask[:, :, None, None], k, 0.0)
    v = torch.where(mask[:, :, None, None], v, 0.0)
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k)
    keep = mask[:, None, None, :]
    s = torch.where(keep, s, NEG_INF)
    m = (s.amax(dim=-1) if s.shape[-1] else
         torch.full(s.shape[:-1], NEG_INF, device=s.device))
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bgrs,bsgd->bgrd", p, v)


def paged_decode_split_reference(q, cache_k, cache_v, new_k, new_v,
                                 block_tables, ctx_len, new_len,
                                 pages_per_split):
    """Plain model of the kernel's algorithm: split z takes the positions
    of pages [z * pages_per_split, (z + 1) * pages_per_split), one more
    split the burst tail; each gives its partial (m, l, acc), and the
    partials are merged in split order, split i weighted by exp(m_i - m)
    and an empty one (l = 0) by exactly 0."""
    B, kvh, rep, hd = q.shape
    page = cache_k.shape[1]
    n_pages, K = block_tables.shape[1], new_k.shape[1]
    n_splits = max(1, -(-n_pages // pages_per_split))
    bt = block_tables.long().clamp(0, cache_k.shape[0] - 1)
    ok = cache_k[bt].reshape(B, n_pages * page, kvh, hd).float()
    ov = cache_v[bt].reshape(B, n_pages * page, kvh, hd).float()
    pos = torch.arange(n_pages * page, device=q.device)
    qf = q.float() * hd ** -0.5
    span = pages_per_split * page
    parts = []
    for z in range(n_splits):
        cut = slice(z * span, (z + 1) * span)
        parts.append(_partial(qf, ok[:, cut], ov[:, cut],
                              pos[None, cut] < ctx_len.long()[:, None]))
    tail = torch.arange(K, device=q.device)[None, :] < new_len.long()[:, None]
    parts.append(_partial(qf, new_k.float(), new_v.float(), tail))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L = torch.zeros_like(M)
    A = torch.zeros(B, kvh, rep, hd, device=q.device)
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - M), 0.0)
        L = L + w * l
        A = A + torch.where(l[..., None] > 0, w[..., None] * acc, 0.0)
    return (A / L.clamp_min(1e-20)[..., None]).to(q.dtype)



SPLIT_PAGES, SPLIT_PAGE, SPLIT_K = 6, 16, 4


@pytest.mark.parametrize("pps", [1, 2, 3, SPLIT_PAGES + 1])
def test_paged_split_model_matches_pallas_interpret(pps):
    """The kernel's split-and-combine (pages_per_split pages a split, the
    tail one more split, merged in split order) against the Pallas kernel
    in interpret mode: contexts one short of and one past a split
    boundary, a tail-only row, a full table, a row whose later splits are
    all empty, and an all-empty row, which gives exactly 0. The kernel's
    inputs carry NaN on the dump page (page 0, padding every table past
    its context); the Pallas kernel, which multiplies masked rows by a
    zero weight, gets a clean copy."""
    rng = np.random.default_rng(20 + pps)
    B, kvh, rep, hd, K = 6, 2, 4, 64, SPLIT_K
    page, n_pages = SPLIT_PAGE, SPLIT_PAGES
    total, span = n_pages * page, pps * page
    args = _paged_case(rng, B, kvh, rep, hd, page, n_pages, 1 + B * n_pages,
                       K)
    ctx = np.asarray([min(span, total) - 1, min(span + 1, total), 0, total,
                      5, 0], np.int32)
    new_len = np.asarray([2, 1, K, 3, 1, 0], np.int32)
    bt = 1 + np.arange(B * n_pages, dtype=np.int32).reshape(B, n_pages)
    for b in range(B):
        bt[b, -(-ctx[b] // page):] = 0
    args[5] = bt
    clean = [a.copy() for a in args]
    args[1][0] = float("nan")
    args[2][0] = float("nan")
    want, _ = _both_paged(clean, ctx, new_len, page)
    t = [_t(a) for a in args[:5]] + [torch.from_numpy(bt)]
    lens = torch.from_numpy(ctx), torch.from_numpy(new_len)
    got = _np(paged_decode_split_reference(*t, *lens, pps))
    valid = ctx + new_len > 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=3e-5, rtol=3e-5)
    assert np.abs(got[~valid]).max() == 0.0
    # and the plain version, which the wrapper runs on the CPU
    np.testing.assert_allclose(
        got, _np(paged_decode_attention_reference(*t, *lens)), atol=3e-5,
        rtol=3e-5)


@pytest.mark.parametrize("B,kvh,n_pages,sms", [
    (8, 8, 16, 132),        # the 8B decode shape
    (4, 8, 128, 132),       # the 8k shape
    (1, 1, 1, 132), (1, 1, 0, 132), (1, 8, 2049, 132),
    (64, 8, 16, 132),       # more pairs than CTAs wanted: one split
    (3, 2, 7, 1), (2, 1, 100000, 16), (5, 4, 33, 114),
])
def test_paged_split_rule_is_a_function_of_shapes(B, kvh, n_pages, sms):
    """(pages_per_split, n_splits) from B, kvh, the table width and the SM
    count: at least one split, every page covered, no split empty by
    shape, at most MAX_PAGES_PER_SPLIT pages a split; about two CTAs per
    SM where there are pages enough."""
    pps, n = paged_decode_splits(B, kvh, n_pages, sms)
    assert pps >= 1 and n >= 1
    assert pps * n >= n_pages and (n - 1) * pps < max(n_pages, 1)
    assert pps <= MAX_PAGES_PER_SPLIT
    if n_pages >= -(-2 * sms // (B * kvh)):
        assert B * kvh * (n + 1) >= 2 * sms
    assert paged_decode_splits(B, kvh, n_pages, sms) == (pps, n)


def _rel_err(got, want):
    """The reference test's measure (tests/test_ops.py): max abs error
    over the largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


def _pallas_bwd(q, k, v, do_seed, causal, dtype=jnp.float32):
    """The Pallas forward and backward (interpret mode) on numpy inputs:
    returns the inputs, O, LSE and dO as numpy, and (dQ, dK, dV)."""
    jq, jk, jv = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, lse = flash_attention_tpu(jq, jk, jv, causal=causal, block_q=128,
                                   block_k=128, interpret=True,
                                   return_lse=True)
    do = np.random.default_rng(do_seed).standard_normal(
        out.shape).astype(np.float32)
    jdo = jnp.asarray(do, dtype)
    grads = flash_attention_tpu_bwd(jq, jk, jv, out, lse, jdo, causal=causal,
                                    block_q=128, block_k=128, interpret=True)
    ins = [np.asarray(a, np.float32) for a in (jq, jk, jv, out, lse, jdo)]
    return ins, [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_bwd_plain_matches_pallas_interpret(causal, hkv):
    """The cases of test_ops.py's interpret-mode backward test, f32: the
    plain dQ, dK, dV from the same O and LSE at 1e-5."""
    q, k, v = _qkv(10, 2, 256, 256, 4, hkv, 128)
    ins, want = _pallas_bwd(q, k, v, 11, causal)
    got = flash_attention_bwd(*[_t(a) for a in ins], causal=causal)
    for g, w, t in zip(got, want, ins[:3]):
        assert g.dtype == torch.float32 and g.shape == t.shape
        np.testing.assert_allclose(_np(g), w, **F32)


@pytest.mark.parametrize("sq,skv,d,causal", [
    pytest.param(256, 256, 128, True, id="256-256"),
    pytest.param(128, 256, 128, True, id="128-256"),
    pytest.param(256, 256, 64, True, id="256-256-d64"),    # CLIP's heads
    pytest.param(128, 256, 64, True, id="128-256-d64"),
    # CLIP's vision attention is non-causal (S=197 is no block multiple
    # for the interpreted kernel: 256 stands in)
    pytest.param(256, 256, 64, False, id="256-256-d64-non-causal"),
])
def test_flash_bwd_plain_matches_pallas_interpret_bf16(sq, skv, d, causal):
    """bf16 at the reference's relative 2e-2, Sq < Skv included: P and
    dS are rounded to bf16 before their products on both sides."""
    q, k, v = _qkv(12, 1, sq, skv, 4, 2, d)
    ins, want = _pallas_bwd(q, k, v, 13, causal, jnp.bfloat16)
    t = [_t(a) for a in ins]
    t = [x.bfloat16() for x in t[:4]] + [t[4], t[5].bfloat16()]
    got = flash_attention_bwd(*t, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel_err(_np(g), w) < 2e-2


def _leaf_qkv(seed, b, sq, skv, hq, hkv, d):
    return [_t(a).requires_grad_() for a in _qkv(seed, b, sq, skv, hq, hkv,
                                                    d)]


@pytest.mark.parametrize("sq,skv,causal", [
    (100, 100, True),        # ragged: no 128-multiple
    (37, 90, True),          # Sq < Skv
    (96, 64, True),          # Sq > Skv: the first rows see no key
    (50, 70, False),
    (197, 197, False),       # CLIP ViT-B/16's vision attention, 4 heads
])
def test_attention_grads_match_autograd_through_naive(sq, skv, causal):
    """attention() is differentiable through FlashAttention: its
    gradients equal autograd's through naive_attention at 1e-5, on shapes
    the Pallas kernels cannot take; rows that see no key give dQ = 0."""
    q, k, v = _leaf_qkv(14, 2, sq, skv, 4, 2, 64)
    do = _t(np.random.default_rng(15).standard_normal((2, sq, 4, 64)))
    out = attention(q, k, v, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(naive_attention(q, k, v, causal=causal),
                               (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    if sq > skv:
        assert np.abs(_np(got[0])[:, :sq - skv]).max() == 0.0
    direct = torch.autograd.grad(FlashAttention.apply(q, k, v, causal, None),
                                 (q, k, v), do)
    for g, d in zip(got, direct):
        assert torch.equal(g, d)


def test_attention_without_grad_builds_no_graph():
    """Serving: under inference_mode (or with no input requiring grad) the
    flash forward runs alone and saves nothing."""
    q, k, v = _leaf_qkv(16, 1, 20, 20, 2, 1, 64)
    with torch.inference_mode():
        out = attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
    out = attention(q.detach(), k.detach(), v.detach())
    assert out.grad_fn is None
    np.testing.assert_array_equal(_np(out), _np(flash_attention(q, k, v)))


def test_bwd_wrappers_split_the_plain_backward_and_refuse_meta():
    q, k, v = [_t(a) for a in _qkv(17, 1, 40, 40, 4, 2, 64)]
    out, lse = flash_attention(q, k, v, return_lse=True)
    do = torch.ones_like(out)
    dvec = (do * out).sum(-1).transpose(1, 2).contiguous()
    want = flash_attention_bwd_reference(q, k, v, out, lse, do)
    got = (flash_bwd_dq(q, k, v, do, lse, dvec),
           *flash_bwd_dkv(q, k, v, do, lse, dvec))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    m = [torch.empty(x.shape, device="meta") for x in (q, k, v, do)]
    ml, md = (torch.empty(lse.shape, device="meta") for _ in range(2))
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError):
            fn(*m, ml, md)
    assert flash_bwd_dq.launches == 0 and flash_bwd_dkv.launches == 0


def _view(shape, dtype, *, offset=0, width=None):
    """A [B, S, H, D] CPU tensor whose storage starts ``offset`` elements
    into its buffer, its rows ``width`` elements apart (D when None)."""
    b, s, h, d = shape
    width = width or d
    flat = torch.zeros(b * s * h * width + offset, dtype=dtype)
    return flat[offset:].view(b, s, h, width)[..., :d]


# dtype, head_dim, base offset (elements), row width (head_dim when None),
# then the route of all three wrappers (None: raises): bf16 at head_dim 64
# and 128 takes the tensor cores, or raises where misaligned
ROUTE_CASES = [
    (torch.bfloat16, 128, 0, None, "tc"),    # the training path
    (torch.bfloat16, 128, 0, 136, "tc"),     # rows 272 bytes apart
    (torch.float32, 128, 0, None, "simt"),
    (torch.bfloat16, 64, 0, None, "tc"),     # CLIP's heads
    (torch.float32, 64, 1, None, "simt"),    # SIMT reads any alignment
    (torch.bfloat16, 128, 1, None, None),    # base 2 bytes off
    (torch.bfloat16, 128, 0, 130, None),     # rows 260 bytes apart
    (torch.bfloat16, 64, 0, 72, "tc"),       # rows 144 bytes apart
    (torch.bfloat16, 64, 1, None, None),     # base 2 bytes off
    (torch.bfloat16, 64, 0, 66, None),       # rows 132 bytes apart
]


@pytest.mark.parametrize("dtype,d,offset,width,want", ROUTE_CASES)
def test_dkv_route_picks_the_kernel_by_dtype_head_dim_and_alignment(
        dtype, d, offset, width, want):
    """The rule behind flash_bwd_dkv on a CUDA tensor, on CPU tensors."""
    q = _view((1, 8, 4, d), dtype, offset=offset, width=width)
    k = torch.zeros((1, 8, 2, d), dtype=dtype)
    if want is None:
        with pytest.raises(ValueError, match=f"head_dim {d} .*16-byte"):
            dkv_route(q, k, k, q)
        with pytest.raises(ValueError, match="16-byte"):
            dkv_route(k, q, k, k)
    else:
        assert dkv_route(q, k, k, q) == want
        assert dkv_route(k, q, q, k) == want


def test_dkv_route_ignores_the_stride_of_a_size_one_dimension():
    """autograd's dO at B=1 can carry batch stride 1; no row is ever
    addressed through it."""
    buf = torch.zeros(8 * 4 * 128 + 1, dtype=torch.bfloat16)
    do = buf.as_strided((1, 8, 4, 128), (1, 512, 128, 1))
    k = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    assert dkv_route(do, k, k, do) == "tc"
    two = buf.as_strided((2, 8, 4, 128), (1, 512, 128, 1))
    with pytest.raises(ValueError, match="16-byte"):
        dkv_route(two, k, k, two)


@pytest.mark.parametrize("dtype,d,offset,width,want", ROUTE_CASES)
def test_fwd_route_picks_the_kernel_by_dtype_head_dim_and_alignment(
        dtype, d, offset, width, want):
    """The rule behind flash_attention on a CUDA tensor, on CPU tensors:
    a misaligned q, k or v raises, naming the wrapper."""
    q = _view((1, 8, 4, d), dtype, offset=offset, width=width)
    k = torch.zeros((1, 8, 2, d), dtype=dtype)
    if want is None:
        with pytest.raises(ValueError, match="flash_attention: .*16-byte"):
            fwd_route(q, k, k)
        with pytest.raises(ValueError, match="needs v at a 16-byte"):
            fwd_route(k, k, q)
    else:
        assert fwd_route(q, k, k) == want
        assert fwd_route(k, q, q) == want


@pytest.mark.parametrize("dtype,d,offset,width,want", ROUTE_CASES)
def test_dq_route_picks_the_kernel_by_dtype_head_dim_and_alignment(
        dtype, d, offset, width, want):
    """The rule behind flash_bwd_dq on a CUDA tensor, on CPU tensors: a
    misaligned q, k, v or dO raises, naming the wrapper."""
    q = _view((1, 8, 4, d), dtype, offset=offset, width=width)
    k = torch.zeros((1, 8, 2, d), dtype=dtype)
    if want is None:
        with pytest.raises(ValueError,
                           match=f"flash_bwd_dq: bf16 head_dim {d} .*16-byte"):
            dq_route(q, k, k, q)
        with pytest.raises(ValueError, match="needs dO at a 16-byte"):
            dq_route(k, k, k, q)
    else:
        assert dq_route(q, k, k, q) == want
        assert dq_route(k, q, q, k) == want


@pytest.mark.parametrize("route", [fwd_route, dq_route])
def test_fwd_and_dq_routes_ignore_the_stride_of_a_size_one_dimension(route):
    buf = torch.zeros(8 * 4 * 128 + 1, dtype=torch.bfloat16)
    x = buf.as_strided((1, 8, 4, 128), (1, 512, 128, 1))
    k = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    two = buf.as_strided((2, 8, 4, 128), (1, 512, 128, 1))
    if route is fwd_route:
        assert route(x, k, k) == "tc"
        with pytest.raises(ValueError, match="16-byte"):
            route(two, k, k)
    else:
        assert route(x, k, k, x) == "tc"
        with pytest.raises(ValueError, match="16-byte"):
            route(two, k, k, two)


def test_the_three_wrappers_share_one_route_rule():
    """fwd_route, dq_route and dkv_route are one helper with one alignment
    rule, and differ only in their tensor-core head dims: for every case
    each wrapper takes the tensor cores where q is bf16 at one of its own
    head dims and aligned, raises (naming itself, the head dim and q) where
    it is such but misaligned, and takes SIMT everywhere else."""
    assert TC_HEAD_DIMS == {"flash_attention": (64, 128),
                            "flash_bwd_dq": (64, 128),
                            "flash_bwd_dkv": (64, 128)}
    for dtype, d, offset, width, want in ROUTE_CASES:
        q = _view((1, 8, 4, d), dtype, offset=offset, width=width)
        k = torch.zeros((1, 8, 2, d), dtype=dtype)
        aligned = offset == 0 and (width or d) % 8 == 0
        for name, route, args in (
                ("flash_attention", fwd_route, (q, k, k)),
                ("flash_bwd_dq", dq_route, (q, k, k, q)),
                ("flash_bwd_dkv", dkv_route, (q, k, k, q))):
            tc = dtype == torch.bfloat16 and d in TC_HEAD_DIMS[name]
            rule = "simt" if not tc else "tc" if aligned else None
            assert rule == want, (name, dtype, d, offset, width)
            if rule is None:
                with pytest.raises(ValueError) as e:
                    route(*args)
                assert str(e.value).startswith(
                    f"{name}: bf16 head_dim {d} needs q")
            else:
                assert route(*args) == rule


def test_kernel_library_name_follows_sources_headers_and_flags(
        tmp_path, monkeypatch):
    """An edited header (or source, or flag) names a new library, so a
    stale one is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _kernels.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    names = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    assert names == {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "// edited\n")
    edited = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    assert all(edited[n] != names[n] for n in names)
    (csrc / "flash_bwd.cu").write_text("// edited\n")
    assert _kernels._lib_path("flash_bwd") != edited["flash_bwd"]
    assert _kernels._lib_path("flash_fwd") == edited["flash_fwd"]
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-G",))
    assert _kernels._lib_path("flash_fwd") != edited["flash_fwd"]


def test_the_port_exports_every_op_of_the_reference():
    """Every name in ray_tpu.ops.__all__ is in the port's, but
    ``flash_attention_tpu``, the reference's Pallas kernel, whose
    counterpart is ``flash_attention``. The quant ops come along."""
    import ray_tpu.ops as jops
    import ray_tpu_torch.ops as tops

    not_ported = {"flash_attention_tpu": "flash_attention"}
    assert set(jops.__all__) - set(tops.__all__) == set(not_ported)
    for name in tops.__all__:
        assert hasattr(tops, name), name
    for counterpart in filter(None, not_ported.values()):
        assert counterpart in tops.__all__
    from ray_tpu_torch.ops import quantize_params, weight_einsum

    assert quantize_params is tq.quantize_params
    assert weight_einsum is tq.weight_einsum
