"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (the kernels have no CPU mode) and
skips elsewhere. The file imports neither JAX nor ``ray_tpu``, so it runs
on a machine that has only PyTorch for CUDA and the CUDA toolkit, from
the repository root and without the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import params_to_numpy
from ray_tpu_torch.models.llama import LlamaConfig, init_params, lm_loss
from ray_tpu_torch.ops import (attention, dkv_route, dq_route,
                               flash_attention,
                               flash_attention_reference, flash_bwd_dkv,
                               flash_bwd_dkv_reference, flash_bwd_dq,
                               flash_bwd_dq_reference, fwd_route,
                               naive_attention, paged_decode_attention,
                               paged_decode_attention_reference,
                               paged_decode_splits)
from ray_tpu_torch.ops.paged_attention import _num_sms
from ray_tpu_torch.train import adamw, make_train_step

pytestmark = pytest.mark.cuda

# six xdist workers share the machine's cores
torch.set_num_threads(2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _randn(gen, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _paged_args(gen, B, kvh, rep, hd, page, n_pages, K, dtype):
    P = 1 + B * n_pages
    q = _randn(gen, (B, kvh, rep, hd), dtype)
    cache = [_randn(gen, (P, page, kvh, hd), dtype) for _ in range(2)]
    new = [_randn(gen, (B, K, kvh, hd), dtype) for _ in range(2)]
    bt = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * n_pages]
          + 1).reshape(B, n_pages).to(torch.int32)
    ctx = torch.randint(0, page * n_pages + 1, (B,), generator=gen,
                        device="cuda", dtype=torch.int32)
    nl = torch.randint(1, K + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    return [q, *cache, *new, bt, ctx, nl]


def test_kernels_match_plain_versions_on_card(gen):
    """f32: each kernel against its plain version at 1e-4."""
    q = _randn(gen, (2, 100, 8, 128))
    k = _randn(gen, (2, 100, 2, 128))
    v = _randn(gen, (2, 100, 2, 128))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    args = _paged_args(gen, 3, 2, 4, 64, 16, 2, 4, torch.float32)
    args[6] = torch.tensor([0, 17, 32], dtype=torch.int32, device="cuda")
    args[7] = torch.tensor([0, 1, 4], dtype=torch.int32, device="cuda")
    got = paged_decode_attention(*args)
    torch.testing.assert_close(got, paged_decode_attention_reference(*args),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # empty row


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal", [
    (1, 512, 512, 32, 8, 128, True),      # Llama-3-8B prefill bucket
    (2, 100, 100, 4, 2, 128, True),       # ragged tiles
    (1, 128, 384, 8, 2, 128, True),       # Sq < Skv (chunk over a past)
    (2, 96, 64, 4, 2, 64, True),          # Sq > Skv: first rows see nothing
    (2, 200, 200, 8, 8, 64, False),
])
def test_flash_kernel_bf16_on_card(gen, B, Sq, Skv, Hq, Hkv, D, causal):
    """bf16: O within 2e-2 (P is rounded to bf16 before PV on both
    sides, the f32 sums differ in order), LSE within 5e-3."""
    q = _randn(gen, (B, Sq, Hq, D), torch.bfloat16)
    k = _randn(gen, (B, Skv, Hkv, D), torch.bfloat16)
    v = _randn(gen, (B, Skv, Hkv, D), torch.bfloat16)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=5e-3, rtol=5e-3)
    if Sq > Skv:
        assert out[:, :Sq - Skv].float().abs().max() == 0


def test_flash_kernel_reads_strided_views_on_card(gen):
    qkv = _randn(gen, (2, 96, 12, 128), torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert not q.is_contiguous()
    torch.testing.assert_close(
        flash_attention(q, k, v).float(),
        flash_attention_reference(q, k, v)[0].float(), atol=2e-2, rtol=2e-2)


def _assert_bf16_rounding_of_f32(got, args):
    """bf16 paged decode computes in f32 (P included) and rounds once at
    the end: within half a bf16 ulp, 2**-8 relative, of the plain version
    run on the f32 copies of the inputs (1e-5 for the f32 sums' order).
    P rounded to bf16 before P V fails this."""
    want = paged_decode_attention_reference(
        *[a.float() for a in args[:5]], *args[5:])
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, atol=1e-5, rtol=2 ** -8)


def test_paged_kernel_ignores_nan_dump_page_on_card(gen):
    args = _paged_args(gen, 8, 8, 4, 128, 64, 16, 8, torch.bfloat16)
    args[1][0] = float("nan")
    args[2][0] = float("nan")
    args[5][:, 3:] = 0                       # unused table slots: page 0
    args[6] = torch.randint(0, 3 * 64 + 1, (8,), generator=gen,
                            device="cuda", dtype=torch.int32)
    got = paged_decode_attention(*args)
    assert torch.isfinite(got.float()).all()
    _assert_bf16_rounding_of_f32(got, args)


def _split_span(args):
    """Positions per split of the grid the wrapper launches for args."""
    B, kvh = args[0].shape[:2]
    pps, _ = paged_decode_splits(B, kvh, args[5].shape[1], _num_sms(0))
    return pps * args[1].shape[1]


@pytest.mark.parametrize("case", ["8b_decode", "8k_context",
                                  "f32_split_edges", "bf16_split_edges"])
def test_split_paged_kernel_matches_plain_version_on_card(gen, case):
    """The split-KV kernel against its plain version: bf16 within one
    rounding of the f32 result at the 8B decode shape (B=8, kvh=8, rep=4,
    16-page tables), the 8k shape (B=4, 128-page tables, ctx 7650, K=32)
    and split edges; f32 within 1e-4 at contexts one short of, at and one
    past a split boundary, tail-only and empty rows. A second launch gives
    the same bits, and an empty row gives exactly 0."""
    i32 = dict(dtype=torch.int32, device="cuda")
    if case == "8b_decode":
        args = _paged_args(gen, 8, 8, 4, 128, 64, 16, 8, torch.bfloat16)
    elif case == "8k_context":
        args = _paged_args(gen, 4, 8, 4, 128, 64, 128, 32, torch.bfloat16)
        args[6] = torch.full((4,), 7650, **i32)
        args[7] = torch.full((4,), 32, **i32)
    else:
        dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
        args = _paged_args(gen, 6, 2, 3, 128, 16, 9, 4, dtype)
        span = _split_span(args)
        args[6] = torch.tensor([span - 1, span, span + 1, 0, 9 * 16, 0],
                               **i32)
        args[7] = torch.tensor([1, 2, 3, 4, 1, 0], **i32)
    got = paged_decode_attention(*args)
    again = paged_decode_attention(*args)
    assert got.dtype == args[0].dtype and torch.isfinite(got.float()).all()
    if got.dtype == torch.float32:
        torch.testing.assert_close(
            got, paged_decode_attention_reference(*args), atol=1e-4,
            rtol=1e-4)
    else:
        _assert_bf16_rounding_of_f32(got, args)
    assert torch.equal(got, again)
    empty = (args[6] + args[7]) == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


def test_kernels_count_launches_and_refuse_what_they_do_not_take(gen):
    f0, p0 = flash_attention.launches, paged_decode_attention.launches
    q = _randn(gen, (1, 16, 2, 96))
    with pytest.raises(ValueError):                     # head_dim 96
        flash_attention(q, q, q)
    with pytest.raises(ValueError):                     # head_dim stride
        x = _randn(gen, (1, 16, 128, 2)).transpose(2, 3)
        flash_attention(x, x, x)
    args = _paged_args(gen, 2, 2, 2, 64, 16, 2, 4, torch.float32)
    bad = list(args)
    bad[5] = args[5].long()
    with pytest.raises(ValueError):                     # int64 table
        paged_decode_attention(*bad)
    n = 16 * 2 * 128
    x = _randn(gen, (n + 8,), torch.bfloat16)[1:n + 1].view(1, 16, 2, 128)
    lse = torch.zeros((1, 2, 16), device="cuda")
    d0 = flash_bwd_dkv.launches
    with pytest.raises(ValueError):                     # 2-byte offset
        flash_bwd_dkv(x, x, x, x, lse, lse)
    assert flash_bwd_dkv.launches == d0
    assert (flash_attention.launches, paged_decode_attention.launches) == (
        f0, p0)
    q = _randn(gen, (1, 16, 2, 64))
    flash_attention(q, q, q)
    paged_decode_attention(*args)
    assert (flash_attention.launches, paged_decode_attention.launches) == (
        f0 + 1, p0 + 1)


def test_engine_on_card_matches_cpu(gen):
    """A 2-layer f32 model served on the card (both kernels) and on the
    CPU (their plain versions) from the same weights: identical greedy
    streams, whole-prompt and chunked prefill."""
    cfg = LlamaConfig(vocab=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, mlp_dim=512, max_seq=256,
                      dtype=torch.float32, remat=False)
    params = init_params(cfg, seed=1, device="cpu")
    on_card = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.cuda())
               for k, v in params.items()}
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in (3, 16, 41)]
    sp = SamplingParams(temperature=0.0, max_tokens=12)
    for chunk in (0, 16):
        ecfg = EngineConfig(max_num_seqs=2, page_size=16, num_pages=32,
                            max_seq_len=128, decode_burst=4,
                            prefill_chunk=chunk)
        f0 = flash_attention.launches
        p0 = paged_decode_attention.launches
        got = LLMEngine(on_card, cfg, ecfg, device="cuda").generate(
            prompts, sp)
        want = LLMEngine(params, cfg, ecfg, device="cpu").generate(
            prompts, sp)
        assert got == want
        assert paged_decode_attention.launches > p0
        assert (flash_attention.launches > f0) == (chunk == 0)


_GRAPH_CFG = LlamaConfig(vocab=512, dim=256, n_layers=3, n_heads=4,
                         n_kv_heads=1, mlp_dim=512, max_seq=256,
                         dtype=torch.bfloat16, remat=False)
# 8 usable pages of 16: three sequences of up to 110 tokens take turns
_GRAPH_ECFG = dict(max_num_seqs=3, page_size=16, num_pages=9,
                   max_seq_len=128, decode_burst=4)


def _graph_run(params, stop=(), graphed=True, swap_params_at=None):
    """Serve three prompts on the card, greedy, with the decode graph or
    with every burst eager; returns the streams, the engine and the
    allocated bytes after each step that followed the first capture."""
    eng = LLMEngine(params, _GRAPH_CFG, EngineConfig(**_GRAPH_ECFG),
                    device="cuda")
    if not graphed:
        eng._graph_eligible = lambda greedy, paged: False
    g = torch.Generator().manual_seed(4)
    # the stop token ends the first request only; the other two grow
    # past the pool together (13 pages of 8)
    sps = [SamplingParams(temperature=0.0, max_tokens=60,
                          stop_token_ids=stop if i == 0 else ())
           for i in range(3)]
    ids = [eng.add_request(torch.randint(0, _GRAPH_CFG.vocab, (n,),
                                         generator=g).tolist(), sp)
           for n, sp in zip((41, 50, 33), sps)]
    allocated, steps = [], 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        if steps == swap_params_at:
            eng.params = tree_map(lambda t: t.clone(), eng.params)
        torch.cuda.synchronize()
        if eng.stats()["decode_graph_captures"] == 1:
            allocated.append(torch.cuda.memory_allocated())
    return [eng.requests[i].output for i in ids], eng, allocated


def test_decode_graph_matches_eager_bursts_on_card(gen):
    """bf16 on the card: the engine's captured decode step against its
    eager bursts (decode_burst, the same full-width table): equal greedy
    streams and bit-equal KV pages (the dump page aside) through
    preemptions and a stop token inside a burst; every decode step
    replayed, the paged kernel's count n_layers a replayed step, and the
    allocated bytes flat across replays."""
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    params = init_params(_GRAPH_CFG, seed=3, device="cuda")
    first, _, _ = _graph_run(params, graphed=False)
    stop = (first[0][9],)
    want, eager, _ = _graph_run(params, stop, graphed=False)
    p0 = paged_decode_attention.launches
    got, eng, allocated = _graph_run(params, stop)
    launched = paged_decode_attention.launches - p0
    assert got == want
    assert len(got[0]) < 60
    st = eng.stats()
    assert st["preemptions"] > 0 and st["decode_graph_captures"] == 1
    assert st["decode_graph_steps"] == st["paged_decode_steps"] \
        == st["decode_steps"] > 0
    assert eager.stats()["decode_graph_steps"] == 0
    assert launched == _GRAPH_CFG.n_layers * st["paged_decode_steps"]
    # page 0 is the dump page, where inactive rows' writes land in any
    # order
    for got_c, want_c in ((eng.cache.k, eager.cache.k),
                          (eng.cache.v, eager.cache.v)):
        differ = (got_c[:, 1:] != want_c[:, 1:]).flatten(2).any(-1)
        assert not differ.any(), differ.nonzero().tolist()
    assert len(allocated) > 5 and len(set(allocated)) == 1, allocated


def test_decode_graph_is_rebuilt_for_new_params(gen):
    """Reassigning engine.params (a copy, at other addresses) captures the
    step again at the next burst; the streams stay the eager ones."""
    params = init_params(_GRAPH_CFG, seed=5, device="cuda")
    want, _, _ = _graph_run(params, graphed=False)
    got, eng, _ = _graph_run(params, swap_params_at=6)
    assert got == want
    st = eng.stats()
    assert st["decode_graph_captures"] == 2
    assert st["decode_graph_steps"] == st["decode_steps"]


_SERVE_CFG = LlamaConfig(vocab=512, dim=256, n_layers=2, n_heads=2,
                         n_kv_heads=1, mlp_dim=512, max_seq=256,
                         dtype=torch.float32, remat=False)


def _to(params, dev):
    return tree_map(lambda t: t.to(dev), params)


def test_verify_step_and_lora_burst_on_card_match_cpu(gen):
    """f32, the same weights and cache state on the card and the CPU:
    verify_step's argmax over a padded window batch, and a LoRA decode
    burst through the paged kernel, give the same tokens."""
    from ray_tpu_torch.llm import LoRAPool, init_lora_adapter, runner
    from ray_tpu_torch.ops import rope_frequencies

    cfg = _SERVE_CFG
    params = init_params(cfg, seed=2, device="cpu")
    g = torch.Generator().manual_seed(2)
    shape = (cfg.n_layers, 16, 16, cfg.n_kv_heads, cfg.head_dim)
    caches = [torch.randn(shape, generator=g) for _ in range(2)]
    bt = torch.tensor([[3, 7, 1, 9], [11, 2, 5, 0], [4, 0, 0, 0]],
                      dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab, (3, 4), generator=g)
    pos = torch.tensor([[30, 31, 32, 33], [40, 41, -1, -1],
                        [9, -1, -1, -1]], dtype=torch.int32)
    samp = (torch.zeros(3), torch.zeros(3, dtype=torch.int32),
            torch.ones(3))
    pool = LoRAPool(cfg, 4, 2, dtype=cfg.dtype, device="cpu")
    adapter = init_lora_adapter(cfg, 4, seed=3, dtype=cfg.dtype,
                                device="cpu")
    adapter["b_q"] = torch.randn(adapter["b_q"].shape, generator=g) * 0.3
    adapter["b_v"] = torch.randn(adapter["b_v"].shape, generator=g) * 0.3
    pool.add("a", adapter)
    sel = pool.select([pool.slot_of("a"), 0, pool.slot_of("a")])
    out = {}
    for dev in ("cpu", "cuda"):
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq,
                                    cfg.rope_theta, device=dev)
        p = _to(params, dev)
        ck, cv = (c.to(dev, copy=True) for c in caches)
        tgt, s0, _, _ = runner.verify_step(
            p, ck, cv, toks.to(dev), pos.to(dev), bt.to(dev), cos, sin, 0,
            *(x.to(dev) for x in samp), cfg=cfg, greedy=True)
        p0 = paged_decode_attention.launches
        burst, _, _ = runner.decode_burst(
            p, ck, cv, toks[:, 0].to(dev),
            torch.tensor([34, 42, 10], dtype=torch.int32, device=dev),
            bt.to(dev), torch.ones(3, dtype=torch.bool, device=dev), cos,
            sin, 0, *(x.to(dev) for x in samp), _to(sel, dev), cfg=cfg,
            n_steps=4, paged_kernel=True, greedy=True)
        if dev == "cuda":
            assert paged_decode_attention.launches == p0 + 4 * cfg.n_layers
        valid = pos >= 0
        out[dev] = (tgt.cpu()[valid].tolist(), s0.cpu().tolist(),
                    burst.cpu().tolist())
    assert out["cuda"] == out["cpu"]


def test_bf16_kv_payload_round_trips_bit_equal_on_card(gen):
    """snapshot_kv_request gives host bf16 tensors; inject_request lands
    them on another engine's card cache bit for bit, and the request
    joins decode with no prefill."""
    cfg = LlamaConfig(vocab=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, mlp_dim=512, max_seq=256,
                      dtype=torch.bfloat16, remat=False)
    params = init_params(cfg, seed=4, device="cuda")
    ecfg = EngineConfig(max_num_seqs=2, page_size=16, num_pages=32,
                        max_seq_len=128, decode_burst=4)
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    pre = LLMEngine(params, cfg, ecfg, device="cuda")
    rid = pre.add_request(list(range(1, 40)), sp)
    while not pre.step(skip_decode=True):
        pass
    pages = pre.seq_table.pages_of(pre.requests[rid].slot)[:3]
    want = (pre.cache.k[:, pages].cpu(), pre.cache.v[:, pages].cpu())
    payload = pre.export_kv_request(rid)
    assert payload["k"].device.type == "cpu"
    assert payload["k"].dtype == torch.bfloat16
    dec = LLMEngine(params, cfg, ecfg, device="cuda")
    new = dec.inject_request(payload, sp)
    got = dec.seq_table.pages_of(dec.requests[new].slot)[:3]
    assert torch.equal(dec.cache.k[:, got].cpu(), want[0])
    assert torch.equal(dec.cache.v[:, got].cpu(), want[1])
    while dec.has_unfinished():
        dec.step()
    assert len(dec.requests[new].output) == 6
    assert dec.stats()["prefills"] == 0 and dec.stats()["injected"] == 1


def _bwd_args(gen, B, Sq, Skv, Hq, Hkv, D, causal, dtype):
    q = _randn(gen, (B, Sq, Hq, D), dtype)
    k = _randn(gen, (B, Skv, Hkv, D), dtype)
    v = _randn(gen, (B, Skv, Hkv, D), dtype)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    do = _randn(gen, o.shape, dtype)
    dvec = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, dvec


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,dtype", [
    (2, 100, 100, 8, 2, 128, True, torch.float32),     # ragged tiles
    (2, 96, 64, 4, 2, 64, True, torch.float32),        # rows with no key
    (1, 70, 200, 4, 1, 64, False, torch.float32),
    (1, 512, 512, 32, 8, 128, True, torch.bfloat16),   # 8B heads
    (2, 96, 64, 4, 2, 128, True, torch.bfloat16),      # rows with no key
    (1, 128, 384, 8, 2, 64, True, torch.bfloat16),     # Sq < Skv, D=64
    # bf16, D=128: the tensor-core dK/dV kernel
    (1, 2048, 2048, 32, 8, 128, True, torch.bfloat16),  # 8B training shape
    (2, 100, 100, 4, 2, 128, True, torch.bfloat16),    # ragged Skv
    (1, 320, 320, 8, 2, 128, True, torch.bfloat16),    # odd tile count
    (1, 128, 384, 8, 2, 128, True, torch.bfloat16),    # Sq < Skv
    (2, 256, 256, 8, 8, 128, False, torch.bfloat16),   # non-causal
    (2, 192, 192, 4, 4, 128, True, torch.bfloat16),    # Hq == Hkv
])
def test_backward_kernels_match_plain_versions_on_card(
        gen, B, Sq, Skv, Hq, Hkv, D, causal, dtype):
    """f32 at 1e-4; bf16 within the reference's relative 2e-2 (max error
    over the largest magnitude). Rows that see no key give dQ = 0 (and add
    nothing to dK, dV: the plain version selects them to 0 too)."""
    args = _bwd_args(gen, B, Sq, Skv, Hq, Hkv, D, causal, dtype)
    got = (flash_bwd_dq(*args, causal=causal),
           *flash_bwd_dkv(*args, causal=causal))
    want = (flash_bwd_dq_reference(*args, causal=causal),
            *flash_bwd_dkv_reference(*args, causal=causal))
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        else:
            err = (g.float() - w.float()).abs().max() / w.float().abs().max()
            assert err < 2e-2, err
    if causal and Sq > Skv:
        assert got[0][:, :Sq - Skv].abs().max() == 0


def test_dkv_tensor_core_kernel_is_deterministic_on_card(gen):
    """No atomics: two launches on the same inputs give the same bits."""
    args = _bwd_args(gen, 1, 512, 512, 32, 8, 128, True, torch.bfloat16)
    first = flash_bwd_dkv(*args)
    for a, b in zip(first, flash_bwd_dkv(*args)):
        assert torch.equal(a, b)


def test_dkv_tensor_core_kernel_takes_autograds_do_at_b1_on_card(gen):
    """At B=1 autograd may hand dO with batch stride 1: the kernel never
    steps along that dimension and gives the same bits."""
    q, k, v, do, lse, dvec = _bwd_args(gen, 1, 256, 256, 8, 2, 128, True,
                                       torch.bfloat16)
    odd = do.as_strided(do.shape, (1,) + do.stride()[1:])
    for a, b in zip(flash_bwd_dkv(q, k, v, odd, lse, dvec),
                    flash_bwd_dkv(q, k, v, do, lse, dvec)):
        assert torch.equal(a, b)


def test_dkv_launches_tc_counts_only_the_tensor_core_kernel_on_card(gen):
    """bf16 with head_dim 128 or 64 takes the tensor-core kernel; f32
    stays on the SIMT kernel."""
    cases = [((1, 64, 64, 4, 2, 128, True, torch.bfloat16), 1),
             ((1, 64, 64, 4, 2, 128, True, torch.float32), 0),
             ((1, 64, 64, 4, 2, 64, True, torch.bfloat16), 1),
             ((1, 64, 64, 4, 2, 64, True, torch.float32), 0)]
    for shape, tc in cases:
        args = _bwd_args(gen, *shape)
        n0 = (flash_bwd_dkv.launches, flash_bwd_dkv.launches_tc)
        flash_bwd_dkv(*args)
        assert (flash_bwd_dkv.launches, flash_bwd_dkv.launches_tc) == (
            n0[0] + 1, n0[1] + tc)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,causal,strided", [
    (1, 512, 512, 32, 8, True, False),     # Llama-3-8B prefill
    (1, 2048, 2048, 32, 8, True, False),   # Llama-3-8B training shape
    (1, 128, 384, 8, 2, True, False),      # Sq < Skv
    (2, 96, 64, 4, 2, True, False),        # Sq > Skv: rows with no key
    (2, 100, 100, 4, 2, True, False),      # ragged tiles
    (1, 320, 320, 8, 2, True, False),      # odd tile count
    (2, 192, 192, 4, 4, True, False),      # Hq == Hkv
    (2, 256, 256, 8, 8, False, False),     # non-causal
    (2, 96, 96, 8, 2, True, True),         # views into a fused qkv
])
def test_flash_tensor_core_kernel_matches_plain_version_on_card(
        gen, B, Sq, Skv, Hq, Hkv, causal, strided):
    """bf16 with head_dim 128 takes the tensor-core forward: O within
    2e-2, LSE within 5e-3; a row that sees no key gives O = 0 exactly and
    LSE -1e30."""
    bf = torch.bfloat16
    if strided:
        qkv = _randn(gen, (B, Sq, Hq + 2 * Hkv, 128), bf)
        q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    else:
        q = _randn(gen, (B, Sq, Hq, 128), bf)
        k, v = (_randn(gen, (B, Skv, Hkv, 128), bf) for _ in range(2))
    assert fwd_route(q, k, v) == "tc"
    n0 = (flash_attention.launches, flash_attention.launches_tc)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    assert (flash_attention.launches, flash_attention.launches_tc) == (
        n0[0] + 1, n0[1] + 1)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
    assert out.dtype == bf and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=5e-3, rtol=5e-3)
    if causal and Sq > Skv:
        assert torch.equal(out[:, :Sq - Skv], torch.zeros_like(
            out[:, :Sq - Skv]))
        assert (lse[:, :, :Sq - Skv] == -1e30).all()


TC_BWD_CASES = [
    (1, 2048, 2048, 32, 8, True),   # Llama-3-8B training shape
    (1, 128, 384, 8, 2, True),      # Sq < Skv
    (2, 100, 100, 4, 2, True),      # ragged tiles
    (2, 96, 64, 4, 2, True),        # Sq > Skv: rows with no key
    (2, 256, 256, 8, 8, False),     # non-causal
    (1, 320, 320, 8, 2, True),      # odd tile count
    (2, 192, 192, 4, 4, True),      # Hq == Hkv
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,causal", TC_BWD_CASES)
def test_dq_tensor_core_kernel_matches_plain_version_on_card(
        gen, B, Sq, Skv, Hq, Hkv, causal):
    """bf16 with head_dim 128 takes the tensor-core dQ kernel: within the
    reference's relative 2e-2 (max error over the largest magnitude);
    rows that see no key give dQ = 0 exactly."""
    args = _bwd_args(gen, B, Sq, Skv, Hq, Hkv, 128, causal, torch.bfloat16)
    assert dq_route(*args[:4]) == "tc"
    n0 = (flash_bwd_dq.launches, flash_bwd_dq.launches_tc)
    got = flash_bwd_dq(*args, causal=causal)
    assert (flash_bwd_dq.launches, flash_bwd_dq.launches_tc) == (
        n0[0] + 1, n0[1] + 1)
    want = flash_bwd_dq_reference(*args, causal=causal)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err < 2e-2, err
    if causal and Sq > Skv:
        assert got[:, :Sq - Skv].abs().max() == 0


def test_dq_tensor_core_kernel_takes_autograds_do_at_b1_on_card(gen):
    """At B=1 autograd may hand dO with batch stride 1: the dQ kernel
    never steps along that dimension and gives the same bits."""
    q, k, v, do, lse, dvec = _bwd_args(gen, 1, 256, 256, 8, 2, 128, True,
                                       torch.bfloat16)
    odd = do.as_strided(do.shape, (1,) + do.stride()[1:])
    assert torch.equal(flash_bwd_dq(q, k, v, odd, lse, dvec),
                       flash_bwd_dq(q, k, v, do, lse, dvec))


def test_fwd_and_dq_tensor_core_kernels_are_deterministic_on_card(gen):
    """No atomics: two launches on the same inputs give the same bits."""
    args = _bwd_args(gen, 1, 512, 512, 32, 8, 128, True, torch.bfloat16)
    q, k, v = args[:3]
    first = flash_attention(q, k, v, return_lse=True)
    for a, b in zip(first, flash_attention(q, k, v, return_lse=True)):
        assert torch.equal(a, b)
    assert torch.equal(flash_bwd_dq(*args), flash_bwd_dq(*args))


def test_fwd_and_dq_launches_tc_count_only_the_tensor_core_kernels_on_card(
        gen):
    """bf16 with head_dim 128 or 64 takes the tensor-core kernels; f32
    stays on SIMT."""
    cases = [((1, 64, 64, 4, 2, 128, True, torch.bfloat16), 1, 1),
             ((1, 64, 64, 4, 2, 128, True, torch.float32), 0, 0),
             ((1, 64, 64, 4, 2, 64, True, torch.bfloat16), 1, 1),
             ((1, 64, 64, 4, 2, 64, True, torch.float32), 0, 0)]
    for shape, fwd_tc, dq_tc in cases:
        n0 = (flash_attention.launches, flash_attention.launches_tc)
        args = _bwd_args(gen, *shape)       # one forward launch
        assert (flash_attention.launches, flash_attention.launches_tc) == (
            n0[0] + 1, n0[1] + fwd_tc)
        n0 = (flash_bwd_dq.launches, flash_bwd_dq.launches_tc)
        flash_bwd_dq(*args)
        assert (flash_bwd_dq.launches, flash_bwd_dq.launches_tc) == (
            n0[0] + 1, n0[1] + dq_tc)


# bf16 at head_dim 64: the tensor-core forward, dQ and dK/dV
D64_CASES = [
    # B, Sq, Skv, Hq, Hkv, causal, strided
    (128, 197, 197, 12, 12, False, True),  # clip_b16_vision
    (128, 77, 77, 8, 8, True, True),       # clip_b16_text
    (2, 100, 100, 4, 2, True, False),      # ragged tiles, GQA
    (1, 200, 200, 8, 4, True, False),      # ragged tiles, GQA
    (1, 128, 384, 8, 2, True, False),      # Sq < Skv
    (2, 96, 64, 4, 2, True, False),        # Sq > Skv: rows with no key
    (2, 200, 200, 8, 8, False, False),     # non-causal
]


def _d64_qkv(gen, B, Sq, Skv, Hq, Hkv, strided, requires_grad=False):
    """bf16 q, k, v with heads of 64; strided: views of one (B, S, 3, H,
    64) projection, as CLIP's towers make them (Sq == Skv, Hq == Hkv).
    Returns (q, k, v) and the leaves they are views of."""
    bf = torch.bfloat16
    if strided:
        qkv = _randn(gen, (B, Sq, 3, Hq, 64), bf)
        leaves = [qkv.requires_grad_(requires_grad)]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        assert not q.is_contiguous()
        return (q, k, v), leaves
    leaves = [_randn(gen, (B, Sq, Hq, 64), bf).requires_grad_(requires_grad)]
    leaves += [_randn(gen, (B, Skv, Hkv, 64), bf).requires_grad_(
        requires_grad) for _ in range(2)]
    return tuple(leaves), leaves


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,causal,strided", D64_CASES)
def test_d64_tensor_core_forward_matches_plain_version_on_card(
        gen, B, Sq, Skv, Hq, Hkv, causal, strided):
    """bf16 with head_dim 64 takes the tensor-core forward: O within 2e-2,
    LSE within 5e-3 of the plain version; a row that sees no key gives O
    = 0 exactly and LSE -1e30; a relaunch gives the same bits."""
    (q, k, v), _ = _d64_qkv(gen, B, Sq, Skv, Hq, Hkv, strided)
    assert fwd_route(q, k, v) == "tc"
    n0 = (flash_attention.launches, flash_attention.launches_tc)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    assert (flash_attention.launches, flash_attention.launches_tc) == (
        n0[0] + 1, n0[1] + 1)
    again = flash_attention(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=5e-3, rtol=5e-3)
    if causal and Sq > Skv:
        assert torch.equal(out[:, :Sq - Skv], torch.zeros_like(
            out[:, :Sq - Skv]))
        assert (lse[:, :, :Sq - Skv] == -1e30).all()


def _d64_bwd_args(gen, B, Sq, Skv, Hq, Hkv, causal, strided):
    """q, k, v (see _d64_qkv), O and the LSE from the forward kernel, a
    random dO and D = rowsum(dO * O): the backward kernels' arguments."""
    (q, k, v), _ = _d64_qkv(gen, B, Sq, Skv, Hq, Hkv, strided)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    do = _randn(gen, o.shape, torch.bfloat16)
    dvec = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, dvec


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,causal,strided", D64_CASES)
def test_d64_tensor_core_dq_matches_plain_version_on_card(
        gen, B, Sq, Skv, Hq, Hkv, causal, strided):
    """bf16 with head_dim 64 takes the tensor-core dQ kernel, within the
    reference's relative 2e-2 of the plain version, bit-equal on a
    relaunch; a row that sees no key gets dQ = 0 exactly."""
    args = _d64_bwd_args(gen, B, Sq, Skv, Hq, Hkv, causal, strided)
    assert dq_route(*args[:4]) == "tc"
    n0 = (flash_bwd_dq.launches, flash_bwd_dq.launches_tc)
    got = flash_bwd_dq(*args, causal=causal)
    assert (flash_bwd_dq.launches, flash_bwd_dq.launches_tc) == (
        n0[0] + 1, n0[1] + 1)
    assert torch.equal(got, flash_bwd_dq(*args, causal=causal))
    want = flash_bwd_dq_reference(*args, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err < 2e-2, err
    if causal and Sq > Skv:
        assert torch.equal(got[:, :Sq - Skv],
                           torch.zeros_like(got[:, :Sq - Skv]))


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,causal,strided", D64_CASES)
def test_d64_tensor_core_dkv_matches_plain_version_on_card(
        gen, B, Sq, Skv, Hq, Hkv, causal, strided):
    """bf16 with head_dim 64 takes the tensor-core dK/dV kernel, within the
    reference's relative 2e-2 of the plain version, bit-equal on a
    relaunch."""
    args = _d64_bwd_args(gen, B, Sq, Skv, Hq, Hkv, causal, strided)
    assert dkv_route(*args[:4]) == "tc"
    n0 = (flash_bwd_dkv.launches, flash_bwd_dkv.launches_tc)
    got = flash_bwd_dkv(*args, causal=causal)
    assert (flash_bwd_dkv.launches, flash_bwd_dkv.launches_tc) == (
        n0[0] + 1, n0[1] + 1)
    for a, b in zip(got, flash_bwd_dkv(*args, causal=causal)):
        assert torch.equal(a, b)
    want = flash_bwd_dkv_reference(*args, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err < 2e-2, err


def test_flash_attention_autograd_at_clip_vision_shape_on_card(gen):
    """attention() at clip_b16_vision (B=128, S=197, 12 heads of 64,
    non-causal, q/k/v views of one projection): the tensor-core forward,
    and dQ and dK/dV from its LSE on the tensor cores; the projection's
    gradient
    within 2e-2 (relative to its largest magnitude) of autograd through
    naive_attention in f32 on the same values."""
    (q, k, v), (qkv,) = _d64_qkv(gen, 128, 197, 197, 12, 12, True,
                                 requires_grad=True)
    do = _randn(gen, q.shape, torch.bfloat16)
    n0 = (flash_attention.launches_tc, flash_bwd_dq.launches,
          flash_bwd_dq.launches_tc, flash_bwd_dkv.launches_tc)
    (got,) = torch.autograd.grad(attention(q, k, v, causal=False), qkv, do)
    assert (flash_attention.launches_tc, flash_bwd_dq.launches,
            flash_bwd_dq.launches_tc, flash_bwd_dkv.launches_tc) == (
        n0[0] + 1, n0[1] + 1, n0[2] + 1, n0[3] + 1)
    ref = qkv.detach().float().requires_grad_()
    out = naive_attention(ref[:, :, 0], ref[:, :, 1], ref[:, :, 2],
                          causal=False)
    (want,) = torch.autograd.grad(out, ref, do.float())
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    for i in range(3):      # dQ, dK, dV
        g, w = got[:, :, i].float(), want[:, :, i]
        err = (g - w).abs().max() / w.abs().max()
        assert err < 2e-2, (i, err)


def _probe_lib(tmp_path):
    """tests/sm90_probe.cu built with the port's nvcc flags."""
    import ctypes
    import subprocess
    from pathlib import Path

    from ray_tpu_torch.ops import _kernels

    so = tmp_path / "sm90_probe.so"
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I",
                    str(_kernels.CSRC), "-o", str(so),
                    str(Path(__file__).with_name("sm90_probe.cu"))],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sm90_probe.argtypes = [P, P, P, I, I, I, I, P]
    lib.sm90_probe.restype = I
    return lib


@pytest.mark.parametrize("mode", ["ss", "rs_bt"])
def test_sm90_head_dim_64_pieces_match_matmul_on_card(gen, tmp_path, mode):
    """sm90.cuh's 64-column swizzled tile read by wgmma, against
    torch.matmul on [64 x 64] bf16: K-major (m64n64k16_ss, the Q K^T form)
    and MN-major with A from registers (m64n64k16_rs_bt, the P V form).
    Controls that must fail: lbo and sbo swapped, and the tile written
    unswizzled. An MN-major B of 64 columns is one panel: its lbo is not
    read, so another lbo gives the same bits."""
    lib = _probe_lib(tmp_path)
    a = _randn(gen, (64, 64), torch.bfloat16)
    b = _randn(gen, (64, 64), torch.bfloat16)
    want = a.float() @ (b.float().T if mode == "ss" else b.float())

    def run(lbo, sbo, swizzle):
        d = torch.empty((64, 64), device="cuda")
        err = lib.sm90_probe(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                             int(mode == "rs_bt"), lbo, sbo, swizzle,
                             torch.cuda.current_stream().cuda_stream)
        assert err == 0
        torch.cuda.synchronize()
        return d

    got = run(16, 1024, 1)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    assert not torch.allclose(run(1024, 16, 1), want, atol=1e-1)
    assert not torch.allclose(run(16, 1024, 0), want, atol=1e-1)
    if mode == "rs_bt":
        assert torch.equal(run(8192, 1024, 1), got)


def test_attention_grads_on_card_match_autograd_through_naive(gen):
    """attention() on CUDA tensors: the backward launches both kernels
    and matches autograd through naive_attention in f32."""
    q, k, v = (_randn(gen, s).requires_grad_() for s in
               ((2, 77, 4, 64), (2, 77, 2, 64), (2, 77, 2, 64)))
    do = _randn(gen, (2, 77, 4, 64))
    n0 = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = torch.autograd.grad(attention(q, k, v), (q, k, v), do)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        n0[0] + 1, n0[1] + 1)
    want = torch.autograd.grad(naive_attention(q, k, v), (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _train_cfg(**kw):
    return LlamaConfig(**{**dict(vocab=512, dim=256, n_layers=2, n_heads=2,
                                 n_kv_heads=1, mlp_dim=512, max_seq=256,
                                 dtype=torch.float32, remat=False), **kw})


def _train_batch():
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 512, (2, 90), generator=g, dtype=torch.int32)
    mask = torch.ones_like(tokens)
    mask[0, 50:] = 0
    return {"tokens": tokens, "mask": mask}


def test_train_step_on_card_matches_cpu(gen):
    """One f32 step of a 2-layer model (remat "full") through the kernels
    on the card and through their plain versions on the CPU, from the
    same weights: loss and grad norm at 1e-4, params at 1e-4. Adam's eps
    is 1e-4 so that no element's step hangs on the sign of a gradient
    that is cancellation noise."""
    cfg = _train_cfg(remat=True)
    params = init_params(cfg, seed=1, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        init_fn, step_fn, place_batch = make_train_step(
            lambda p, b: lm_loss(p, b, cfg), adamw(1e-3, eps=1e-4),
            device=dev)
        state = init_fn(tree_map(lambda t: t.to(dev, copy=True), params))
        state, m = step_fn(state, place_batch(_train_batch()))
        out[dev] = (m["loss"].item(), m["grad_norm"].item(),
                    params_to_numpy(state.params))
    (l0, n0, p0), (l1, n1, p1) = out["cpu"], out["cuda"]
    assert abs(l1 - l0) <= 1e-4 * abs(l0)
    assert abs(n1 - n0) <= 1e-4 * abs(n0)
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        torch.testing.assert_close(torch.from_numpy(a), torch.from_numpy(b),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launch_counts_on_card(gen, remat):
    """Per step of L layers: flash_fwd 2L with remat (forward, then its
    recompute), L without; flash_bwd_dq and flash_bwd_dkv L each."""
    cfg = _train_cfg(remat=remat)
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: lm_loss(p, b, cfg), adamw(1e-3), device="cuda")
    state = init_fn(init_params(cfg, seed=1, device="cuda"))
    batch = place_batch(_train_batch())
    before = (flash_attention.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    state, m = step_fn(state, batch)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (flash_attention.launches - before[0],
            flash_bwd_dq.launches - before[1],
            flash_bwd_dkv.launches - before[2]) == (
        L * (2 if remat else 1), L, L)
    assert torch.isfinite(m["loss"]) and int(m["step"]) == 1


def test_moe_mlp_dense_bf16_at_mixtral_widths_on_card_matches_cpu_f32(gen):
    """The serving mixture (ops.moe.moe_mlp_dense) at Mixtral-8x7B widths,
    one layer (dim 4096, 8 experts of 14336, top-2), bf16 x and experts
    with an f32 router, on the card, against the same values in f32 on
    the CPU: within one bf16 rounding of the output (2^-8 relative) plus
    1e-5 of its largest entry (f32 sums in another order)."""
    from ray_tpu_torch.ops.moe import moe_mlp_dense

    D, M, E = 4096, 14336, 8
    x = _randn(gen, (2, 4, D), torch.bfloat16)
    router = _randn(gen, (D, E)) * D ** -0.5
    ws = [(_randn(gen, shape) * fan ** -0.5).to(torch.bfloat16)
          for shape, fan in (((E, D, M), D), ((E, D, M), D), ((E, M, D), M))]
    got = moe_mlp_dense(x, router, *ws, top_k=2)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = moe_mlp_dense(x.float().cpu(), router.cpu(),
                         *[w.float().cpu() for w in ws], top_k=2)
    err = (got.float().cpu() - want).abs()
    assert bool((err <= 2 ** -8 * want.abs()
                 + 1e-5 * float(want.abs().max())).all()), float(err.max())


def test_jamba_step_launches_flash_kernels_on_card(gen):
    """One training step of a bf16 Jamba hybrid whose attention has
    head_dim 128 (remat per period): its attention layer launches the
    forward twice (forward, recompute) and dQ and dK/dV once each, all
    on tensor cores, and every gradient is finite."""
    from ray_tpu_torch.models.mamba import (MambaConfig, init_mamba,
                                            mamba_lm_loss)

    cfg = MambaConfig(vocab=512, dim=512, n_layers=4, state_dim=16,
                      head_dim=64, chunk=64, attn_period=4, attn_heads=4,
                      attn_kv_heads=2, remat=True)
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: mamba_lm_loss(p, b, cfg), adamw(1e-3), device="cuda")
    state = init_fn(init_mamba(cfg, seed=1, device="cuda"))
    tokens = torch.randint(0, cfg.vocab, (2, 129), generator=gen,
                           device="cuda", dtype=torch.int32)
    before = {fn: (fn.launches, fn.launches_tc)
              for fn in (flash_attention, flash_bwd_dq, flash_bwd_dkv)}
    state, m = step_fn(state, place_batch({"tokens": tokens}))
    torch.cuda.synchronize()
    got = {fn.__name__: (fn.launches - n, fn.launches_tc - tc)
           for fn, (n, tc) in before.items()}
    assert got == {"flash_attention": (2, 2), "flash_bwd_dq": (1, 1),
                   "flash_bwd_dkv": (1, 1)}
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_head_dims_match_plain_versions_on_card(gen, D, dtype):
    """head_dim 16 (`tiny`, `jamba_tiny`) and 32 through the SIMT flash
    kernels and the paged kernel, f32 at 1e-4, bf16 as above: forward
    (rows that see no key give 0), dQ and dK/dV, and paged decode at rep 1,
    4 and 8 with a row that is empty and a ragged page."""
    tol = dict(atol=1e-4, rtol=1e-4)
    q, k, v = (_randn(gen, (2, 96, h, D), dtype) for h in (4, 2, 2))
    k, v = k[:, :64], v[:, :64]
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, **tol)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=5e-3, rtol=5e-3)
    assert out[:, :32].float().abs().max() == 0
    args = _bwd_args(gen, 2, 100, 100, 4, 2, D, True, dtype)
    got = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
    want = (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))
    for g, w in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, **tol)
        else:
            err = (g.float() - w.float()).abs().max() / w.float().abs().max()
            assert err < 2e-2, err
    for rep in (1, 4, 8):
        args = _paged_args(gen, 3, 2, rep, D, 16, 4, 4, dtype)
        args[6] = torch.tensor([0, 37, 64], dtype=torch.int32, device="cuda")
        args[7] = torch.tensor([0, 2, 4], dtype=torch.int32, device="cuda")
        got = paged_decode_attention(*args)
        if dtype == torch.float32:
            torch.testing.assert_close(
                got, paged_decode_attention_reference(*args), **tol)
        else:
            _assert_bf16_rounding_of_f32(got, args)
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        assert torch.equal(got, paged_decode_attention(*args))


@pytest.mark.parametrize("D", [8, 48, 256])
def test_head_dims_outside_the_kernels_raise_on_card(gen, D):
    q = _randn(gen, (1, 16, 2, D))
    f0, p0 = flash_attention.launches, paged_decode_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    lse = torch.zeros((1, 2, 16), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(*_paged_args(gen, 2, 2, 2, D, 16, 2, 4,
                                            torch.float32))
    assert (flash_attention.launches, paged_decode_attention.launches) == (
        f0, p0)


def test_grpo_update_on_card_matches_cpu(gen):
    """One GRPO update of `tiny` (f32, head_dim 16) on a batch of distinct
    rows, on the card through the flash kernels and on the CPU through
    their plain versions, from the same weights: losses at 1e-5, KL
    exactly 0 (the policy is the reference), the gradients at 1e-5 of
    their largest entry, and 2L forward, L dQ and L dK/dV launches."""
    from ray_tpu_torch.models import LLAMA_CONFIGS
    from ray_tpu_torch.rllib.grpo import _grpo_loss, _grpo_update

    cfg = LLAMA_CONFIGS["tiny"]
    params = init_params(cfg, seed=2, device="cpu")
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (6, 20), generator=g,
                                     dtype=torch.int32),
             "mask": (torch.rand(6, 20, generator=g) > 0.3).float(),
             "advantages": torch.randn(6, generator=g)}
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(),
                     params)
        ref = tree_map(lambda t: t.to(dev, copy=True), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = _grpo_loss(p, ref, b, 0.1, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        before = (flash_attention.launches, flash_bwd_dq.launches,
                  flash_bwd_dkv.launches)
        _, _, m = _grpo_update(p, ref, adamw(1e-3, weight_decay=0.0).init(p),
                               b, 1e-3, kl_coef=0.1, cfg=cfg)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [x.cpu() for x in grads],
                    (flash_attention.launches - before[0],
                     flash_bwd_dq.launches - before[1],
                     flash_bwd_dkv.launches - before[2]))
    (m0, g0, _), (m1, g1, n1) = out["cpu"], out["cuda"]
    assert m1["kl"] == m0["kl"] == 0.0
    for k in m0:
        assert abs(m1[k] - m0[k]) <= 1e-5 * max(1.0, abs(m0[k])), k
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()),
                                   rtol=0)
    L = cfg.n_layers
    assert n1 == (2 * L, L, L)


def test_ppo_update_on_card_matches_cpu(gen):
    """One PPO iteration (2 epochs of 2 minibatches, the shuffle from a CPU
    generator of the same seed) on the card and on the CPU from the same
    params and batch, f32 without TF32: losses and params at 1e-5."""
    from ray_tpu_torch.rllib import ppo
    from ray_tpu_torch.rllib.checkpoint import on_device, to_numpy

    params = ppo.init_policy(torch.Generator().manual_seed(0), 4, 2,
                             (64, 64))
    g = torch.Generator().manual_seed(1)
    batch = {"obs": torch.randn(256, 4, generator=g),
             "actions": torch.randint(0, 2, (256,), generator=g),
             "logp": torch.log(torch.rand(256, generator=g) * 0.4 + 0.3),
             "advantages": torch.randn(256, generator=g),
             "returns": torch.randn(256, generator=g)}
    out = {}
    for dev in ("cpu", "cuda"):
        p = on_device(params, torch.device(dev), grad=True)
        _, _, m = ppo.ppo_update(
            p, adamw(3e-4, weight_decay=0.0).init(p),
            {k: v.to(dev) for k, v in batch.items()},
            torch.Generator().manual_seed(5), 3e-4, clip=0.2, vf_coef=0.5,
            ent_coef=0.01, n_minibatches=2, n_epochs=2)
        out[dev] = ({k: float(v) for k, v in m.items()}, to_numpy(p))
    (m0, p0), (m1, p1) = out["cpu"], out["cuda"]
    for k in m0:
        assert abs(m1[k] - m0[k]) <= 1e-5 * max(1.0, abs(m0[k])), k
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        torch.testing.assert_close(torch.from_numpy(a), torch.from_numpy(b),
                                   atol=1e-5, rtol=1e-5)


# --- the checkpoint door and the vision families ------------------------------

def test_hf_round_trip_on_card_is_bit_equal(gen, tmp_path):
    """`tiny` in f32 and bf16 saved from the card and loaded back onto it:
    every leaf bit-equal, and equal to a load onto the CPU."""
    import dataclasses

    from ray_tpu_torch.models import (LLAMA_CONFIGS, load_hf_checkpoint,
                                      save_hf_checkpoint)

    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(LLAMA_CONFIGS["tiny"], dtype=dtype)
        params = init_params(cfg, seed=1, device="cuda")
        path = str(tmp_path / str(dtype))
        save_hf_checkpoint(params, cfg, path)
        got, _ = load_hf_checkpoint(path, dtype=dtype, device="cuda")
        cpu, _ = load_hf_checkpoint(path, dtype=dtype, device="cpu")
        for a, b, c in zip(tree_leaves(got), tree_leaves(params),
                           tree_leaves(cpu), strict=True):
            assert a.is_cuda and a.dtype == b.dtype == dtype
            assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_host_int8_load_equals_quantize_params_on_card(gen, tmp_path):
    """quantize="int8" rounds and quantizes on the host: every int8 value
    and scale equals quantize_params run on the card over the bf16 load."""
    import dataclasses

    from ray_tpu_torch.models import (LLAMA_CONFIGS, load_hf_checkpoint,
                                      save_hf_checkpoint)
    from ray_tpu_torch.ops.quant import quantize_params

    cfg = dataclasses.replace(LLAMA_CONFIGS["tiny"], dtype=torch.bfloat16)
    save_hf_checkpoint(init_params(cfg, seed=2, device="cuda"), cfg,
                       str(tmp_path))
    q8, _ = load_hf_checkpoint(str(tmp_path), quantize="int8",
                               device="cuda")
    bf16, _ = load_hf_checkpoint(str(tmp_path), device="cuda")
    want = quantize_params(bf16, cfg)
    for a, b in zip(tree_leaves(q8), tree_leaves(want), strict=True):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


def _vision_steps_card_vs_cpu(loss_fn, cfg, params, batch):
    """3 AdamW steps (eps 1e-4: no element's step hangs on the sign of a
    gradient that is cancellation noise) on the card and on the CPU from
    the same weights: losses and every param within 1e-5 abs + 1e-5 rel.
    Every TF32 flag stays at PyTorch's default: the port's f32
    convolutions are f32 matmuls, which run in IEEE f32 by default."""
    out = {}
    for dev in ("cpu", "cuda"):
        init_fn, step_fn, place_batch = make_train_step(
            lambda p, b: loss_fn(p, b, cfg),
            adamw(1e-3, eps=1e-4, weight_decay=0.0), device=dev)
        state = init_fn(tree_map(lambda t: t.to(dev, copy=True), params))
        placed = place_batch(batch)
        losses = []
        for _ in range(3):
            state, m = step_fn(state, placed)
            losses.append(m["loss"].item())
        out[dev] = losses, [t.detach().cpu()
                            for t in tree_leaves(state.params)]
    (l0, p0), (l1, p1) = out["cpu"], out["cuda"]
    torch.testing.assert_close(torch.tensor(l1), torch.tensor(l0),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(p1, p0, strict=True):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_clip_tiny_steps_on_card_match_cpu(gen):
    from ray_tpu_torch.models import CLIP_CONFIGS, clip_loss, init_clip

    cfg = CLIP_CONFIGS["tiny"]
    g = torch.Generator().manual_seed(3)
    batch = {"images": torch.rand(8, 32, 32, 3, generator=g),
             "tokens": torch.randint(1, cfg.vocab, (8, cfg.max_text),
                                     generator=g, dtype=torch.int32)}
    batch["tokens"][:, 10:] = 0
    _vision_steps_card_vs_cpu(clip_loss, cfg,
                              init_clip(cfg, seed=3, device="cpu"), batch)


def test_resnet_tiny_steps_on_card_match_cpu(gen):
    from ray_tpu_torch.models import (RESNET_CONFIGS, image_loss,
                                      init_resnet)

    cfg = RESNET_CONFIGS["tiny"]
    g = torch.Generator().manual_seed(4)
    batch = {"images": torch.rand(8, 15, 15, 3, generator=g),
             "labels": torch.randint(0, cfg.num_classes, (8,), generator=g,
                                     dtype=torch.int32)}
    _vision_steps_card_vs_cpu(image_loss, cfg,
                              init_resnet(cfg, seed=4, device="cpu"), batch)


# --- the data-to-card path, the channels and the device utilities ---

def test_prefetched_batches_equal_place_batch_under_consumer_kernels(gen):
    """iter_device_batches yields place_batch's bits, and they stay so
    while the consumer's kernels run on each batch after its reference is
    dropped (record_stream keeps the allocator from handing the memory
    to the next batch's copy early)."""
    import numpy as np

    from ray_tpu_torch.data import iter_device_batches

    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((64, 256, 256)).astype(np.float32),
                "y": rng.integers(0, 1000, 64).astype(np.int32)}
               for _ in range(12)]
    _, _, place_batch = make_train_step(lambda p, b: None, None,
                                        device="cuda")
    w = torch.randn(256, 256, generator=gen, device="cuda")
    sums = []
    for b in iter_device_batches(iter(batches)):
        x = b["x"]
        acc = x
        for _ in range(8):          # keep the consumer's stream busy
            acc = torch.tanh(acc @ w)
        # an exact checksum of the bits, taken after the slow chain
        sums.append((x.view(torch.int32).to(torch.int64).sum()
                     + b["y"].to(torch.int64).sum(), acc.sum()))
        del b, x, acc
    torch.cuda.synchronize()
    want = [int(b["x"].view(np.int32).astype(np.int64).sum()
                + b["y"].astype(np.int64).sum()) for b in batches]
    assert [int(s) for s, _ in sums] == want
    got = list(iter_device_batches(iter(batches)))
    for g, b in zip(got, batches, strict=True):
        p = place_batch(b)
        for k in b:
            assert g[k].device.type == "cuda" and g[k].dtype == p[k].dtype
            assert torch.equal(g[k], p[k])


def test_device_channel_over_ipc_to_a_spawned_reader(gen):
    """A bf16 tree through DeviceChannel to a spawned reader on the same
    card: bit-equal, every payload over CUDA IPC and no host-lane byte, on
    both sides; the writer's tensors are mutated after each write, and it
    keeps no staged block for a reader in its own process (there is none:
    the reader's mapping keeps each block alive)."""
    import multiprocessing

    import torch_channel_peer
    from ray_tpu_torch.experimental import DeviceChannel, device_channel

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    ch = DeviceChannel()
    DeviceChannel.ipc_transfers = DeviceChannel.host_lane_bytes = 0
    proc = ctx.Process(target=torch_channel_peer.read_trees,
                       args=(ch.path, 4, "cuda", out), daemon=True)
    proc.start()
    try:
        for i in range(4):
            t = torch_channel_peer.tree(i, "cuda")
            ch.write(t, timeout=60)
            for v in t.values():
                v.fill_(-7)          # the snapshot was taken at write
            assert not device_channel._staged
        ch.close_write()
        got = out.get(timeout=120)
        proc.join(timeout=30)
        assert not proc.is_alive()
    finally:
        if proc.is_alive():
            proc.terminate()
        ch.close()
        ch.unlink()
    assert "error" not in got, got
    assert got["equal"] == [True] * 4 and got["placed"] == [True] * 4
    assert got["dtypes"] == ["torch.bfloat16"] * 4 and got["closed"]
    assert (got["ipc_transfers"], got["host_lane_bytes"]) == (4, 0)
    assert (DeviceChannel.ipc_transfers, DeviceChannel.host_lane_bytes) == \
        (4, 0)


def test_device_channel_in_one_process_copies_directly(gen):
    """Writer and reader in one process (a handle cannot be opened by the
    process that made it): the staged block is copied directly, and what
    is read is the reader's own memory."""
    from ray_tpu_torch.experimental import DeviceChannel

    ch = DeviceChannel()
    reader = DeviceChannel(ch.path, device="cuda")
    try:
        for i in range(3):
            t = {"k": [_randn(gen, (5, 7), torch.bfloat16)],
                 "v": _randn(gen, (3,))}
            want = tree_map(lambda a: a.clone(), t)
            ch.write(t, timeout=30)
            t["v"].zero_()
            got = reader.read(timeout=30)
            assert torch.equal(got["k"][0], want["k"][0])
            assert torch.equal(got["v"], want["v"])
            assert got["v"].data_ptr() != t["v"].data_ptr()
    finally:
        reader.close()
        ch.close()
        ch.unlink()


def _tiny_bf16():
    import dataclasses

    from ray_tpu_torch.models import LLAMA_CONFIGS

    return dataclasses.replace(LLAMA_CONFIGS["tiny"], dtype=torch.bfloat16)


def _split_forward_want(cfg, batches):
    """One process's forward of the seeded (seed 7) params on the card:
    (argmax ids as int32, last-position logits) a batch."""
    from ray_tpu_torch.models.llama import forward

    params = init_params(cfg, seed=7, device="cuda")
    with torch.no_grad():
        out = [forward(params, b.cuda(), cfg) for b in batches]
    return [(o.argmax(-1).to(torch.int32), o[:, -1]) for o in out]


def _dag_batches(cfg, n, S=24):
    g = torch.Generator().manual_seed(18)
    return [torch.randint(0, cfg.vocab, (1, S), generator=g,
                          dtype=torch.int32) for _ in range(n)]


def test_dag_device_edge_between_two_spawned_processes_on_card(gen):
    """chip_smoke.py's dag pipeline on ``tiny`` in bf16: the two stages in
    spawned processes on the card, every hidden over CUDA IPC (none on the
    host lane) on both sides, the ids and last logits equal to one
    process's forward (the traced pass's too), the trace holds the edge's
    device copies, both processes exit 0 and no channel file is left."""
    import os
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    cfg = _tiny_bf16()
    batches = _dag_batches(cfg, 4)
    outs, _, _, stats, paths, exits, trace = chip_smoke.dag_pipeline(
        torch, cfg, 1, "cuda", batches, traced=2)
    want = _split_forward_want(cfg, batches)
    for o, (ids, last) in zip(outs + trace[0], want + want[:2]):
        assert torch.equal(o["ids"].cpu(), ids.cpu())
        assert torch.equal(o["last"].cpu(), last.cpu())
    # the traced pass: one marker a stage, and a device copy inside each
    # of the edge's two IPC writes and two reads
    for t, side in zip(trace[2], ("write", "read")):
        assert t["marks"] == 1 and t["busy_ms"] > 0
        assert len(t["edge_copy_ms"][side]) == 2
        assert all(ms > 0 for ms in t["edge_copy_ms"][side])
    assert [(s["ipc_transfers"], s["host_lane_bytes"]) for s in stats] == \
        [(4, 0), (4, 0)]
    assert [s["flash_fwd"] for s in stats] == [4, 4]
    assert [s["allocated_after"] - s["allocated_before"] for s in stats] \
        == [0, 0]
    assert exits == [0, 0]
    assert not any(os.path.exists(p) for p in paths)


def test_dag_device_edge_under_local_hooks_raises_on_card(gen):
    """The same split under the LOCAL hooks, compiled for the card: both
    stages would share this process, which cannot open its own CUDA IPC
    handles, so the compile raises before any loop starts, leaves no
    channel file, and every DeviceChannel end that this file's tests
    opened in this process is closed."""
    import os
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from ray_tpu_torch.dag import InputNode, actor
    from ray_tpu_torch.dag import compiled as dag_compiled
    from ray_tpu_torch.experimental import device_channel

    cfg = _tiny_bf16()
    stages = [chip_smoke.DagStage(cfg, s, 1, "cuda") for s in (0, 1)]
    with InputNode() as inp:
        dag = actor(stages[1]).forward.bind(
            actor(stages[0]).forward.bind(inp).with_device_transport())
    made = []
    channel = dag_compiled.Channel

    def recorded(*args, **kwargs):
        made.append(channel(*args, **kwargs))
        return made[-1]

    dag_compiled.Channel = recorded
    try:
        with pytest.raises(ValueError, match="cannot open its own IPC"):
            dag.experimental_compile(max_inflight=2)
    finally:
        dag_compiled.Channel = channel
    assert len(made) == 1 and not os.path.exists(made[0].path)
    assert not device_channel._open and not device_channel._staged


def test_channel_tensor_lane_carries_a_cuda_tensor(gen):
    from ray_tpu_torch.experimental import Channel

    ch = Channel(capacity=1 << 20)
    try:
        for dtype in (torch.bfloat16, torch.float32):
            x = _randn(gen, (33, 65), dtype)
            ch.write(x, timeout=10)
            got = ch.read(0, timeout=10)
            assert got.device.type == "cuda" and torch.equal(got, x)
    finally:
        ch.close()
        ch.unlink()


def test_hbm_stats_are_the_allocators_counters(gen):
    from ray_tpu_torch.util import collect_hbm_stats

    keep = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    (rec,) = collect_hbm_stats()
    assert rec["platform"] == "gpu" and rec["device"] == "0"
    assert rec["bytes_in_use"] == torch.cuda.memory_allocated()
    assert rec["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
    assert rec["bytes_limit"] == torch.cuda.get_device_properties(
        0).total_memory
    assert 0.0 <= rec["fragmentation"] <= 1.0
    del keep


def test_profile_on_card_names_its_span(gen, tmp_path):
    import glob

    from torch.autograd import DeviceType

    from ray_tpu_torch.util import profile, span

    a = _randn(gen, (512, 512))
    with profile(str(tmp_path)) as prof:
        with span("card.span.matmul"):
            (a @ a).sum().item()
    (trace,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert "card.span.matmul" in open(trace).read()
    assert any(e.device_type == DeviceType.CUDA for e in prof.events())


def test_tiny_server_on_card_equals_cpu(gen, tmp_path):
    """LLMServer on the card (its pump steps the engine on an executor
    thread) gives the CPU server's greedy f32 tokens from one pickle of
    weights, through the flash and paged kernels."""
    import asyncio
    import pickle

    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models import LLAMA_CONFIGS

    path = tmp_path / "tiny.pkl"
    with open(path, "wb") as f:
        pickle.dump(params_to_numpy(init_params(LLAMA_CONFIGS["tiny"],
                                                seed=3, device="cpu")), f)
    ecfg = dict(max_num_seqs=4, page_size=4, num_pages=64, max_seq_len=64)
    payloads = [{"prompt_ids": p, "temperature": 0.0, "max_tokens": n}
                for p, n in (([5, 17, 99, 3], 9), ([7, 8, 9], 5),
                             (list(range(20, 40)), 12))]
    outs = {}
    flash_attention.launches = paged_decode_attention.launches = 0
    for dev in ("cpu", "cuda"):
        server = LLMServer("tiny", params_path=str(path),
                           engine_config=ecfg, device=dev)

        async def go():
            return await asyncio.gather(
                *[server.completions(dict(p)) for p in payloads])

        outs[dev] = asyncio.run(go())
    assert outs["cuda"] == outs["cpu"]
    assert flash_attention.launches > 0 and paged_decode_attention.launches > 0


def test_world_one_nccl_collectives_on_card(gen, tmp_path):
    """build_mesh(MeshSpec()) in a process with no group makes a world-1
    NCCL group; every collective, symbolic and eager, f32 and bf16, is its
    input bit for bit (a spawned process keeps the group out of this
    one)."""
    import torch_parallel_peer

    got = torch_parallel_peer.run_once(
        1, tmp_path, torch_parallel_peer.card_collectives)[0]
    assert got["backend"] == "nccl" and got["world"] == 1
    assert len(got["equal"]) == 34
    assert [k for k, ok in got["equal"].items() if not ok] == []


def test_tiny_step_through_a_world_one_mesh_equals_no_mesh_on_card(
        gen, tmp_path):
    """A 2-layer f32 step through make_train_step(mesh=MeshSpec()) on the
    card gives the step without a mesh, bit for bit: at world size 1
    DTensor runs the same local ops."""
    import numpy as np

    import torch_parallel_peer
    from ray_tpu_torch._private.tree import tree_leaves

    got = torch_parallel_peer.run_once(
        1, tmp_path, torch_parallel_peer.card_mesh_train)[0]
    assert got["mesh"]["metrics"] == got["plain"]["metrics"]
    for a, b in zip(tree_leaves(got["mesh"]["params"]),
                    tree_leaves(got["plain"]["params"]), strict=True):
        assert np.array_equal(a, b)


def test_binding_at_world_one_leaves_the_current_card(gen):
    """init_torch_distributed at world size 1, or without an address,
    makes no group and binds no card: the current card (the last one
    here) stays current, and resolve_device() still gives it."""
    import types

    import torch.distributed as dist

    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.train import init_torch_distributed

    last = torch.cuda.device_count() - 1
    with torch.cuda.device(last):
        for world, addr in ((1, "127.0.0.1:1"), (2, "")):
            ctx = types.SimpleNamespace(coordinator_address=addr,
                                        world_size=world, rank=0)
            assert init_torch_distributed(ctx) is False
            assert torch.cuda.current_device() == last
        assert not dist.is_initialized()
        assert resolve_device(None) == torch.device("cuda", last)


def test_device_spans_lie_on_the_host_clock(gen):
    """A device span's interval, placed on the host clock by the anchor,
    starts no earlier than its host span opened and, for a span whose
    work is synced inside it, ends no later than the host span closed;
    a spin of known length reads its length."""
    import time

    from ray_tpu_torch.util import tracing

    x = _randn(gen, (2048, 2048))
    tracing.enable(device=True)
    try:
        for _ in range(5):
            with tracing.span("op.mlp", device=True):
                for _ in range(4):
                    x = torch.tanh(x @ x)
                torch.cuda.synchronize()
            time.sleep(0.002)
        with tracing.span("spin", device=True):
            torch.cuda._sleep(10_000_000)
        torch.cuda.synchronize()
    finally:
        tracing.disable()
    got = tracing.drain()
    host = {s.id: s for s in got["host"]}
    assert [s.name for s in got["device"]] == ["op.mlp"] * 5 + ["spin"]
    slack = 200e-6
    for d in got["device"]:
        h = host[d.id]
        assert d.t0 < d.t1
        assert d.t0 >= h.t0 - slack, (d, h)
        if d.name == "op.mlp":
            assert d.t1 <= h.t1 + slack, (d, h)
    spin = got["device"][-1]
    # the spin's cycles over the card's clock, read back by events
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    assert spin.t1 - spin.t0 == pytest.approx(
        start.elapsed_time(end) / 1e3, rel=0.1)
