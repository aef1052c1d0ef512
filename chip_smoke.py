#!/usr/bin/env python3
"""Drive ray_tpu_torch's serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. device  - requires CUDA; prints `nvidia-smi --query-gpu=name,power.limit`.
  2. build   - compiles the CUDA kernels from csrc/ (nvcc, in parallel).
  3. parity  - each kernel against its plain PyTorch version on the card,
               at the 8B shapes and edge cases, with stated tolerances.
  4. engine  - Llama-3-8B (full width and depth, bf16, random weights from
               seed 7) served by LLMEngine: 8 greedy requests at B=8, then a
               chunked-prefill engine serving one 511-token request; checks
               the kernels' launch counts, and paged vs gather decode on one
               cache state.
     engine_8k - the same weights at 8k context (bench.py's long-context
               family): four 7,650-token prompts, two timed 32-step bursts,
               every decode step through the paged kernel.
     spec    - the same model, configuration and 8 prompts, 32 greedy
               tokens each, speculatively decoded with 4 draft tokens: a
               drafter of the repo's 1b config (random, seed 11; reject regime)
               and the target as its own drafter (agree regime, acceptance
               at least 0.9).
     lora    - the same with lora_rank 16: two seeded adapters worn by 2
               requests each; the 4 base requests must give exactly the
               engine phase's streams.
     fleet   - a prefill engine exports the 4 longest prompts after their
               first token; a second engine injects them and decodes 32
               tokens each with no prefill.
     serve   - the same model through LLMServer (seed 7): the TTFT of a
               streamed 511-token completion, 8 concurrent 64-token
               completions in turns with the engine stepped directly on
               the same schedule (equal streams), the metrics' counts and
               the kernels' launches; then a prefill and a decode server
               in one process hand the 4 longest prompts' KV off in 8 MiB
               chunks (no retry, no decode-side prefill).
     hf      - the same weights written as an HF safetensors checkpoint
               (save_hf_checkpoint, Meta-Llama-3-8B's layout, 16.1 GB),
               loaded back bit-equal and served on the engine phase's
               schedule (the same 8 streams), then loaded as host-int8
               (equal to quantize_params on the card) and served: write
               and load GB/s, int8 TTFT, tok/s and peak memory.
  5. train   - Llama-3-8B (full width and depth, bf16, seed 7, remat
               "full") trained by make_train_step with AdamW at B=1,
               S=2048: one warm-up step, then 3 timed steps on one batch;
               checks the loss falls, the launch counts, the peak memory.
               Then 4 steps more through make_train_step(session=...) with
               a recording session: host_to_device, then "compile", then
               "compute" 3 times, each interval within 1 ms of the host
               clock's step ms, 2048 tokens and their flops a step; the
               MFU and the instrumented against the bare step ms.
     parallel - the multi-device plane over a world-1 NCCL group on the
               card: every collective, symbolic and eager, f32 and bf16,
               equal to its world-1 value (host µs a call, the NCCL
               kernels of a traced round); the train phase's 8B step
               through make_train_step(mesh=build_mesh(MeshSpec())),
               losses and grad norms against the train phase's (2**-8
               relative, bit-equal expected) and its step ms beside
               theirs; the 8B forward with mesh= and without, equal
               logits.
  6. moe     - Mixtral-8x7B widths (bf16, seed 7) at 16 of its 32 layers
               served like the engine phase, 32 tokens a request: launch
               counts, decode tokens against a fresh prefill of each prefix,
               paged vs gather decode.
     moe_train - the same widths at 2 layers trained 1+3 steps (B=1,
               S=2048): the loss falls, aux finite, routers stay f32.
     mamba   - Mamba-2 130m and Jamba 350m (full size, bf16) trained 1+3
               steps at B=4, S=2048: the loss falls, gradients finite,
               Jamba's attention through all three flash kernels.
     clip    - CLIP ViT-B/16 (bf16, remat) trained 1+3 steps on B=128 toy
               pairs: the loss falls, its 24 attention layers through the
               tensor-core D=64 forward, dQ and dK/dV; a traced step's
               busy share.
     resnet  - ResNet-18 (bf16) at 32x32, 10 classes, trained 1+3 steps at
               B=256: the loss falls (no kernel of the port runs).
     data    - the data-to-card path: 32 host batches at ResNet-18's and
               CLIP ViT-B/16's shapes through place_batch and
               iter_device_batches (GB/s, bit-equal); both models trained
               over 8 batches fed each way (step ms, the busy share of a
               window traced with util.tracing.profile and span);
               collect_hbm_stats against torch.cuda's counters.
     channel - a spawned reader on the same card takes the 8B KV export
               of a 511-token request (67.0 MB, bf16) and a 1 GiB tensor
               8 times each over DeviceChannel (CUDA IPC) and over the
               Channel's tensor lane (shm): bit-equal, GB/s, the IPC lane
               against the bound of its device copies.
     dag     - the compiled DAG with a device edge: Llama-3-8B (full width
               and depth, bf16, seed 7) split at layer 16 into two spawned
               processes on the card (DagStage, placed through DagHooks
               over multiprocessing), 8 seeded [1, 2048] batches with two
               in flight, each 16.8 MB hidden over DeviceChannel (CUDA
               IPC), ids and last logits back over shm: every id equal to
               one process's forward, the last logits within 1e-3, 8 IPC
               transfers and 0 host-lane bytes in each stage, 256 flash
               forward launches on tensor cores; ms per execution against
               one process's forward, the edge's host time, the peaks;
               then 6 executions traced in both stages (device busy ms,
               the edge copies' device ms, the stages' overlap).
     grpo    - GRPO RLHF: the default `tiny` config raises its reward on
               the token-7 objective in 13 iterations; Llama 1b (full
               width and depth, bf16, seed 7) 3 iterations of G=8 over 4
               prompts, 32 sampled tokens each: KL 0 then > 0, the
               reference params untouched, launches as derived, on
               tensor cores; the device-busy share of sampling and update.
     rl      - PPO, APPO, IMPALA, DQN, SAC, BC and MARWIL with the learner
               on the card and the runners in-process: finite losses,
               moved params, and each update card against CPU; then PPO,
               IMPALA, APPO, DQN and SAC with two runners in spawned
               processes through RunnerHooks over multiprocessing: PPO,
               DQN and SAC bit-equal to the in-process run, IMPALA and
               APPO (fragments in completion order) finite and moving,
               CUDA never initialised in a runner; iteration ms both ways.
  7. reference - a small f32 model served, then trained 3 steps, on the
               card and on the CPU from the same weights: identical greedy
               streams (plain, speculative in both regimes, LoRA, export ->
               inject), and the same losses and params; the same with 4
               experts (plain, chunked and gather streams, training), and
               a small f32 Jamba trained; `tiny` (head_dim 16) served and
               trained, `jamba_tiny` trained, and GRPO on `tiny`; `tiny`
               CLIP and ResNet trained 3 steps (every param within 1e-5),
               `tiny` saved, loaded and served from the checkpoint, and
               served through LLMServer, mono and pooled.
  8. timing  - kernel, plain-version and library times, and the bound;
               the three flash kernels also at CLIP's D=64 vision and text
               shapes.
  parallel4 (not in the default run; four cards, `python3 chip_smoke.py
     parallel4`) - the multi-device plane across four cards over NCCL,
               one spawned rank a card joined by init_torch_distributed,
               each on its own card: every collective against numpy from
               every rank's seeded inputs (integer-valued exactly, normal
               at 1e-5 in f32 and 2e-2 in bf16) and the bus bandwidth of
               all-reduce, all-gather and reduce-scatter from 1 MiB to 4
               GiB; Llama tiny (f32) under dp=4, fsdp=4, fsdp=2 tp=2 and
               sp=2 tp=2 against the same model unsharded on card 0
               (logits 2e-4, 2 steps' losses, grad norms and params 1e-5);
               MoE at ep=4 (1e-4) and the pipeline over 4 stages (1e-5,
               gradients 1e-4); Llama-3-8B trained 1+3 steps on 4 x 2048
               tokens under fsdp=4 and fsdp=2 tp=2 against the same step
               on card 0 a sequence at a time (relative: the first loss
               1e-4, the first grad norm 2e-3, the loss after one update
               1e-3), beside the one-card step, with a step traced on
               rank 0.
               Alone, it ends with the ok line (count: the cards seen).
A comma-separated list of phases runs only those and prints no result;
`profile`, `profile_train` and `profile_moe` (not in the default run)
trace, with torch.profiler, one 511-token prefill and a decode burst at
B=8 and at 8k context of the 8B engine, one 8B training step, and a
prefill and a decode burst of the moe phase's engine:

    python3 chip_smoke.py build,profile,profile_train,profile_moe
The line before the last is the `kernels` line; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --- phase 1 ---------------------------------------------------------------

def phase_device(torch):
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the convolutions' TF32 flag stays at PyTorch's default (on): the
    # port's f32 convolutions are f32 matmuls
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "conv_allow_tf32": torch.backends.cudnn.allow_tf32})
    return card


# --- phase 2 ---------------------------------------------------------------

def _ptxas(log):
    """Registers and spill bytes per kernel from nvcc's -Xptxas=-v log."""
    out, name = {}, None
    for line in log.splitlines():
        words = line.replace(",", " ").split()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            # the kernel's name and template arguments out of the mangling
            m = re.search(r"\d+((?:flash|paged)_[a-z_]+?_kernel)"
                          r"(I(?:f|13__nv_bfloat16)?(?:Li\d+E)+)?", name)
            if m:
                targs = m.group(2) or ""
                parts = re.findall(r"Li(\d+)E", targs)
                if targs.startswith(("If", "I13")):
                    parts.insert(0, "f32" if targs.startswith("If")
                                 else "bf16")
                name = m.group(1) + (f"<{','.join(parts)}>" if parts
                                     else "")
            out[name] = {}
        elif name and "spill" in words:
            # "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
            out[name]["spill_bytes"] = (int(words[words.index("spill") - 2])
                                        + int(words[-4]))
        elif name and "Used" in words and "registers" in words:
            out[name]["registers"] = int(words[words.index("registers") - 1])
    return out


TC_KERNELS = ("flash_fwd_tc_kernel<64>", "flash_fwd_tc_kernel<128>",
              "flash_bwd_dq_tc_kernel<64>", "flash_bwd_dq_tc_kernel<128>",
              "flash_bwd_dkv_tc_kernel<64>", "flash_bwd_dkv_tc_kernel<128>")


def phase_build():
    """Build every kernel; no flash or paged kernel may spill."""
    from ray_tpu_torch.ops import _kernels

    paths = _kernels.build_all()
    for name in paths:
        _kernels.lib(name)
    kernels = {}
    for name, log in _kernels.build_log.items():
        print(f"--- nvcc {name} ---\n{log}", file=sys.stderr, flush=True)
        kernels.update(_ptxas(log))
    emit({"phase": "build", "seconds": round(_kernels.build_seconds, 3),
          "libraries": sorted(p.name for p in paths.values()),
          "ptxas": kernels})
    if _kernels.build_log:    # a library already built has no log here
        for tc in TC_KERNELS:
            got = kernels.get(tc, {})
            require(got.get("spill_bytes") == 0,
                    f"{tc} spills or is missing: {got}")
        paged = {k: v for k, v in kernels.items()
                 if k.startswith("paged_decode_")}
        # 24 split kernels (<f32/bf16, hd 16/32/64/128, rep up to 4/8/16>)
        # and 8 combine kernels
        require(len(paged) == 32 and all(
            v.get("spill_bytes") == 0 for v in paged.values()),
            f"a paged decode kernel spills or is missing: {paged}")
        # every SIMT flash kernel: forward, dQ and dK/dV in f32 at head_dim
        # 16, 32, 64 and 128 and in bf16 at 16 and 32 (bf16 at 64 and 128
        # is the tensor cores' for all three)
        simt = {k: v for k, v in kernels.items() if k.startswith("flash_")
                and re.search(r"<(f32|bf16),\d+>$", k)}
        require(len(simt) == 18 and all(
            v.get("spill_bytes") == 0 for v in simt.values()),
            f"a SIMT flash kernel spills or is missing: {simt}")


# --- phase 3 ---------------------------------------------------------------

FLASH_CASES = [
    # name, B, Sq, Skv, Hq, Hkv, D, causal, dtype, strided
    ("8b_prefill", 1, 512, 512, 32, 8, 128, True, "bf16", False),
    ("8b_train", 1, 2048, 2048, 32, 8, 128, True, "bf16", False),
    ("8b_batched_prefill", 8, 512, 512, 32, 8, 128, True, "bf16", False),
    # the mamba phase's Jamba-350m step: 2,047 tokens padded to 2,048
    ("jamba_350m_train", 4, 2048, 2048, 8, 4, 128, True, "bf16", False),
    ("sq_lt_skv", 1, 128, 384, 8, 2, 128, True, "bf16", False),
    ("sq_gt_skv", 2, 96, 64, 4, 2, 128, True, "bf16", False),
    ("odd_tiles", 1, 320, 320, 8, 2, 128, True, "bf16", False),
    ("mha", 2, 192, 192, 4, 4, 128, True, "bf16", False),
    ("ragged_100", 2, 100, 100, 4, 2, 128, True, "bf16", False),
    ("non_causal", 2, 256, 256, 8, 8, 128, False, "bf16", False),
    ("d64", 1, 200, 200, 8, 4, 64, True, "bf16", False),
    ("strided_qkv", 2, 96, 96, 8, 2, 128, True, "bf16", True),
    ("f32", 1, 130, 130, 4, 1, 128, True, "f32", False),
    ("f32_sq_gt_skv", 2, 96, 64, 4, 2, 64, True, "f32", False),
    # head_dim 16 (`tiny`, `jamba_tiny`; the grpo phase's tiny update: 16
    # rows of 11 tokens) and 32, on the SIMT kernel
    ("d16_f32_grpo_tiny", 16, 11, 11, 4, 2, 16, True, "f32", False),
    ("d16_f32_sq_gt_skv", 2, 96, 64, 4, 2, 16, True, "f32", False),
    ("d16_bf16", 2, 130, 130, 4, 2, 16, True, "bf16", False),
    ("d32_f32", 1, 200, 200, 8, 2, 32, True, "f32", False),
    ("d32_bf16_non_causal", 2, 96, 96, 4, 4, 32, False, "bf16", False),
    # the grpo phase's 1b run: sampling forwards G=8 rows of the shortest
    # and the longest prompt plus 32 tokens, the update all 32 rows padded
    # to 48 (one partial 64-row tile)
    ("grpo_1b_sample_s37", 8, 37, 37, 16, 8, 128, True, "bf16", False),
    ("grpo_1b_sample_s48", 8, 48, 48, 16, 8, 128, True, "bf16", False),
    ("grpo_1b_update", 32, 48, 48, 16, 8, 128, True, "bf16", False),
    # the clip phase's ViT-B/16 towers (bf16, head_dim 64: all three on
    # the tensor cores): q, k and v are views of one projection output
    ("clip_b16_vision", 128, 197, 197, 12, 12, 64, False, "bf16", True),
    ("clip_b16_text", 128, 77, 77, 8, 8, 64, True, "bf16", True),
]

BWD_CASES = [
    # name, B, Sq, Skv, Hq, Hkv, D, causal, dtype
    ("8b_train", 1, 2048, 2048, 32, 8, 128, True, "bf16"),
    ("jamba_350m_train", 4, 2048, 2048, 8, 4, 128, True, "bf16"),
    ("sq_lt_skv", 1, 128, 384, 8, 2, 128, True, "bf16"),
    ("ragged_100", 2, 100, 100, 4, 2, 128, True, "bf16"),
    ("sq_gt_skv", 2, 96, 64, 4, 2, 128, True, "bf16"),
    ("non_causal", 2, 256, 256, 8, 8, 128, False, "bf16"),
    ("odd_tiles", 1, 320, 320, 8, 2, 128, True, "bf16"),
    ("mha", 2, 192, 192, 4, 4, 128, True, "bf16"),
    ("d64", 1, 200, 200, 8, 4, 64, True, "bf16"),
    ("f32", 2, 130, 100, 4, 1, 128, True, "f32"),
    ("d16_f32_grpo_tiny", 16, 11, 11, 4, 2, 16, True, "f32"),
    ("d16_f32_sq_gt_skv", 2, 96, 64, 4, 2, 16, True, "f32"),
    ("d16_bf16", 2, 130, 130, 4, 2, 16, True, "bf16"),
    ("d32_f32_non_causal", 1, 130, 200, 4, 1, 32, False, "f32"),
    ("d32_bf16", 2, 200, 200, 8, 2, 32, True, "bf16"),
    ("grpo_1b_update", 32, 48, 48, 16, 8, 128, True, "bf16"),
    ("clip_b16_vision", 128, 197, 197, 12, 12, 64, False, "bf16"),
    ("clip_b16_text", 128, 77, 77, 8, 8, 64, True, "bf16"),
]

# B, kvh, rep, hd, page, n_pages, K
PAGED_8B = (8, 8, 4, 128, 64, 16, 8)
# the 8k-context family of bench.py (_bench_long_context): B=4, 7,650
# cached positions in 128-page tables, a 32-step burst tail
PAGED_8K = (4, 8, 4, 128, 64, 128, 32)
CTX_8K = 7650

TRAIN_B, TRAIN_S = 1, 2048     # the 8B training batch


def _flash_inputs(torch, B, Sq, Skv, Hq, Hkv, D, dtype, strided, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    if strided:
        # q, k, v as views into one fused projection output
        qkv = rnd(B, Sq, Hq + 2 * Hkv, D)
        return (qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv],
                qkv[:, :, Hq + Hkv:])
    return rnd(B, Sq, Hq, D), rnd(B, Skv, Hkv, D), rnd(B, Skv, Hkv, D)


def _paged_inputs(torch, B, kvh, rep, hd, page, n_pages, K, dtype, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    P = 1 + B * n_pages

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    q = rnd(B, kvh, rep, hd)
    ck, cv = rnd(P, page, kvh, hd), rnd(P, page, kvh, hd)
    nk, nv = rnd(B, K, kvh, hd), rnd(B, K, kvh, hd)
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    bt = perm[:B * n_pages].reshape(B, n_pages).to(torch.int32).contiguous()
    ctx = torch.randint(1, page * n_pages + 1, (B,), generator=g,
                        device="cuda").to(torch.int32)
    new_len = torch.randint(1, K + 1, (B,), generator=g,
                            device="cuda").to(torch.int32)
    return [q, ck, cv, nk, nv, bt, ctx, new_len]


def _splits(args):
    """(pages_per_split, n_splits) the wrapper takes for these inputs."""
    from ray_tpu_torch.ops.paged_attention import _num_sms, paged_decode_splits

    B, kvh = args[0].shape[:2]
    return paged_decode_splits(B, kvh, args[5].shape[1],
                               _num_sms(args[0].device.index))


# bf16 paged decode computes in f32, its weights P included, and rounds
# once: within half a bf16 ulp (2**-8 relative, + 1e-5 for the f32 sums'
# order) of the plain version run on f32 copies of its inputs
BF16_ROUNDING = 2 ** -8


def _paged_cases(torch):
    """(name, args, tol): the 8B decode shape, the 8k shape, and edges of
    the split rule, the dump page and empty rows; tol is relative to the
    f32 result for bf16 (BF16_ROUNDING), atol = rtol for f32."""
    i32 = dict(device="cuda", dtype=torch.int32)
    cases = []
    B, kvh, rep, hd, page, n_pages, K = PAGED_8B
    args = _paged_inputs(torch, B, kvh, rep, hd, page, n_pages, K, "bf16")
    cases.append(("8b_decode", args, BF16_ROUNDING))
    args = _paged_inputs(torch, *PAGED_8K, "bf16", seed=4)
    args[6] = torch.full((PAGED_8K[0],), CTX_8K, **i32)
    args[7] = torch.full((PAGED_8K[0],), PAGED_8K[-1], **i32)
    cases.append(("8k_context", args, BF16_ROUNDING))
    # contexts one short of, at and one past a split boundary; a tail-only
    # row; the whole table; a row that ends inside the first page
    args = _paged_inputs(torch, B, kvh, rep, hd, page, n_pages, K, "bf16",
                         seed=5)
    span = _splits(args)[0] * page
    args[6] = torch.tensor([span - 1, span, span + 1, 2 * span - 1, 0,
                            n_pages * page, 1, 2 * span + 1], **i32)
    args[7] = torch.tensor([1, K, 3, 1, K, 2, 1, K], **i32)
    cases.append(("split_edges", args, BF16_ROUNDING))
    # NaN on the dump page, tables padded with 0, ctx inside real pages
    args = _paged_inputs(torch, B, kvh, rep, hd, page, n_pages, K, "bf16",
                         seed=1)
    args[1][0] = float("nan")
    args[2][0] = float("nan")
    bt = args[5].clone()
    bt[:, 3:] = 0
    args[5] = bt
    args[6] = torch.randint(0, 3 * page + 1, (B,), **i32)
    args[6][0] = 3 * page
    cases.append(("nan_dump_page", args, BF16_ROUNDING))
    # rows with no valid position give exactly 0
    args = _paged_inputs(torch, B, kvh, rep, hd, page, n_pages, K, "bf16",
                         seed=2)
    args[6][:3] = 0
    args[7][:2] = 0
    cases.append(("empty_rows", args, BF16_ROUNDING))
    args = _paged_inputs(torch, 3, 1, 8, 64, 16, 4, 4, "f32", seed=3)
    cases.append(("f32_mqa_d64", args, 1e-4))
    # f32 at split edges: single-page splits over a 6-page table
    args = _paged_inputs(torch, 4, 2, 3, 128, 16, 6, 4, "f32", seed=6)
    span = _splits(args)[0] * 16
    args[6] = torch.tensor([span - 1, span + 1, 0, 0], **i32)
    args[7] = torch.tensor([2, 1, 3, 0], **i32)
    cases.append(("f32_split_edges", args, 1e-4))
    args = _paged_inputs(torch, 2, 2, 16, 64, 32, 5, 4, "bf16", seed=7)
    cases.append(("bf16_rep16_d64", args, BF16_ROUNDING))
    # head_dim 16 (`tiny`: 2 kv heads, rep 2) and 32: the small-head lane
    # mapping, with an empty row and a ragged last page
    for name, shape, dtype, seed, tol in (
            ("f32_d16_tiny", (4, 2, 2, 16, 16, 8, 4), "f32", 8, 1e-4),
            ("bf16_d16_rep8", (4, 2, 8, 16, 16, 8, 4), "bf16", 9,
             BF16_ROUNDING),
            ("f32_d32_rep1", (3, 4, 1, 32, 16, 6, 4), "f32", 10, 1e-4),
            ("bf16_d32_rep16", (3, 2, 16, 32, 32, 5, 4), "bf16", 11,
             BF16_ROUNDING)):
        args = _paged_inputs(torch, *shape, dtype, seed=seed)
        args[6][0] = 0
        args[7][0] = 0
        args[6][1] = 37
        cases.append((name, args, tol))
    return cases


def _bwd_inputs(torch, B, Sq, Skv, Hq, Hkv, D, dtype, causal, seed=0):
    """q, k, v, O and LSE from the forward kernel, a seeded dO, and
    D = rowsum(dO * O) in f32 [B, Hq, Sq]."""
    from ray_tpu_torch.ops.attention import flash_attention

    q, k, v = _flash_inputs(torch, B, Sq, Skv, Hq, Hkv, D, dtype, False,
                            seed)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    g = torch.Generator("cuda").manual_seed(seed + 100)
    do = torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
    dvec = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, dvec


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _rel_err(a, b):
    """max |a - b| / max |b|: the reference's bf16 measure
    (tests/test_ops.py)."""
    return _max_err(a, b) / (float(b.float().abs().max()) + 1e-6)


def _close(torch, got, want, tol):
    return bool(torch.allclose(got.float(), want.float(), atol=tol,
                               rtol=tol))


# The route each flash wrapper must take for bf16, by head dim: the
# tensor cores at 64 and 128, SIMT for every other head dim and for f32.
TC_ROUTE_HEAD_DIMS = {"flash_fwd": (64, 128), "flash_bwd_dq": (64, 128),
                      "flash_bwd_dkv": (64, 128)}


def _want_route(kernel, D, dtype):
    return ("tc" if dtype == "bf16" and D in TC_ROUTE_HEAD_DIMS[kernel]
            else "simt")


def phase_parity(torch):
    from ray_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_reference,
                                             fwd_route)
    from ray_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    results = {}
    for (name, B, Sq, Skv, Hq, Hkv, D, causal, dtype,
         strided) in FLASH_CASES:
        q, k, v = _flash_inputs(torch, B, Sq, Skv, Hq, Hkv, D, dtype,
                                strided)
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        again = flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        # no atomics: a second launch gives the same bits
        deterministic = torch.equal(out, again[0]) and torch.equal(
            lse, again[1])
        ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
        tol = 2e-2 if dtype == "bf16" else 1e-4
        lse_tol = 5e-3 if dtype == "bf16" else 1e-4
        err, lse_err = _max_err(out, ref), _max_err(lse, ref_lse)
        route = fwd_route(q, k, v)
        ok = (_close(torch, out, ref, tol)
              and _close(torch, lse, ref_lse, lse_tol)
              and bool(torch.isfinite(out.float()).all()) and deterministic
              and route == _want_route("flash_fwd", D, dtype))
        masked_zero = None
        if causal and Sq > Skv:
            # rows that see no key give exactly 0
            masked_zero = bool((out[:, :Sq - Skv] == 0).all())
            ok = ok and masked_zero
        emit({"phase": "parity", "kernel": "flash_fwd", "case": name,
              "shape": [B, Sq, Skv, Hq, Hkv, D], "causal": causal,
              "dtype": dtype, "route": route,
              "max_abs_err": err, "lse_max_abs_err": lse_err,
              "tol": tol, "lse_tol": lse_tol,
              "masked_rows_zero": masked_zero,
              "deterministic": deterministic, "ok": ok})
        require(ok, f"flash_fwd parity failed: {name}")
        results.setdefault("flash_fwd", []).append(max(err, lse_err))

    for name, args, tol in _paged_cases(torch):
        out = paged_decode_attention(*args)
        again = paged_decode_attention(*args)
        torch.cuda.synchronize()
        # no atomics: a second launch gives the same bits
        deterministic = torch.equal(out, again)
        ref = paged_decode_attention_reference(*args)
        err = _max_err(out, ref)
        if out.dtype == torch.float32:
            close, err_f32 = _close(torch, out, ref, tol), err
        else:
            ref = paged_decode_attention_reference(
                *[a.float() for a in args[:5]], *args[5:])
            close = bool(torch.allclose(out.float(), ref, atol=1e-5,
                                        rtol=tol))
            err_f32 = _max_err(out, ref)
        ok = (close and deterministic
              and bool(torch.isfinite(out.float()).all()))
        empty = (args[6] + args[7]) == 0
        empty_zero = bool((out[empty] == 0).all()) if empty.any() else None
        ok = ok and empty_zero is not False
        emit({"phase": "parity", "kernel": "paged_decode", "case": name,
              "shape": list(args[0].shape) + [args[1].shape[1],
                                               args[5].shape[1],
                                               args[3].shape[1]],
              "dtype": str(args[0].dtype).split(".")[1],
              "splits": list(_splits(args)), "max_abs_err": err,
              "max_abs_err_vs_f32": err_f32, "tol": tol,
              "empty_rows_zero": empty_zero,
              "deterministic": deterministic, "ok": ok})
        require(ok, f"paged_decode parity failed: {name}")
        results.setdefault("paged_decode", []).append(err)

    for name, B, Sq, Skv, Hq, Hkv, D, causal, dtype in BWD_CASES:
        for kernel, err in _bwd_parity(torch, name, B, Sq, Skv, Hq, Hkv, D,
                                       causal, dtype).items():
            results.setdefault(kernel, []).append(err)
    return {k: max(v) for k, v in results.items()}


def _bwd_parity(torch, name, B, Sq, Skv, Hq, Hkv, D, causal, dtype):
    """Both backward kernels against their plain versions on one case:
    bf16 within the reference's relative 2e-2 (max error over the largest
    magnitude), f32 within 1e-4 abs/rel; rows that see no key (causal,
    Sq > Skv) must give exactly 0, and nothing may be NaN."""
    from ray_tpu_torch.ops.attention import (dkv_route, dq_route,
                                             flash_bwd_dkv,
                                             flash_bwd_dkv_reference,
                                             flash_bwd_dq,
                                             flash_bwd_dq_reference)

    args = _bwd_inputs(torch, B, Sq, Skv, Hq, Hkv, D, dtype, causal)
    outs = {"flash_bwd_dq": ((flash_bwd_dq(*args, causal=causal),),
                             (flash_bwd_dq_reference(*args, causal=causal),)),
            "flash_bwd_dkv": (flash_bwd_dkv(*args, causal=causal),
                              flash_bwd_dkv_reference(*args, causal=causal))}
    again = {"flash_bwd_dq": (flash_bwd_dq(*args, causal=causal),),
             "flash_bwd_dkv": flash_bwd_dkv(*args, causal=causal)}
    routes = {"flash_bwd_dq": dq_route(*args[:4]),
              "flash_bwd_dkv": dkv_route(*args[:4])}
    torch.cuda.synchronize()
    errs = {}
    for kernel, (got, want) in outs.items():
        # no atomics: a second launch gives the same bits
        deterministic = all(torch.equal(a, b)
                            for a, b in zip(again[kernel], got))
        require(deterministic, f"{kernel} is not deterministic: {name}")
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        if dtype == "bf16":
            err = max(_rel_err(g, w) for g, w in zip(got, want))
            tol, measure = 2e-2, "max_err_over_max"
            ok = err < tol
        else:
            err = max(_max_err(g, w) for g, w in zip(got, want))
            tol, measure = 1e-4, "max_abs_err"
            ok = all(_close(torch, g, w, tol) for g, w in zip(got, want))
        ok = (ok and finite and all(g.dtype == args[0].dtype for g in got)
              and routes[kernel] == _want_route(kernel, D, dtype))
        masked_zero = None
        if kernel == "flash_bwd_dq" and causal and Sq > Skv:
            masked_zero = bool((got[0][:, :Sq - Skv] == 0).all())
            ok = ok and masked_zero
        emit({"phase": "parity", "kernel": kernel, "case": name,
              "shape": [B, Sq, Skv, Hq, Hkv, D], "causal": causal,
              "dtype": dtype, "route": routes[kernel], measure: err,
              "tol": tol, "finite": finite, "masked_rows_zero": masked_zero,
              "deterministic": deterministic, "ok": ok})
        require(ok, f"{kernel} parity failed: {name}")
        errs[kernel] = max(_max_err(g, w) for g, w in zip(got, want))
    return errs


# --- phase 4 ---------------------------------------------------------------

_SERVING = {}


def _serving_params(torch):
    """Llama-3-8B (full width and depth, bf16, random weights from seed 7)
    on the card, made once for both engine phases; and the seconds it
    took."""
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS, init_params

    if "params" not in _SERVING:
        t0 = time.perf_counter()
        _SERVING["params"] = init_params(LLAMA_CONFIGS["8b"], seed=7,
                                         device="cuda")
        torch.cuda.synchronize()
        _SERVING["init_s"] = time.perf_counter() - t0
    return _SERVING["params"], _SERVING["init_s"]


# the engine phase's configuration, shared by the spec, lora and fleet
# phases: 8 slots of 1,024 positions in 64-token pages, 8-step bursts
SERVE_ECFG = dict(max_num_seqs=8, page_size=64, max_seq_len=1024,
                  num_pages=1 + 8 * 16, decode_burst=8)
SERVE_LENS = (17, 64, 100, 200, 300, 400, 480, 511)
SLICE_TOKENS = 32      # new tokens a request in the spec, lora, fleet phases


def _serving_prompts(torch, vocab):
    g = torch.Generator().manual_seed(7)
    return [torch.randint(0, vocab, (n,), generator=g).tolist()
            for n in SERVE_LENS]


def _serve(torch, cfg, params, n_tokens):
    """The engine phase's serving run of ``params`` under SERVE_ECFG: a
    warm-up request, the TTFT of the 511-token prompt on an idle engine,
    the other 7 prompts, timed full decode bursts at B=8, every request
    to ``n_tokens`` greedy tokens; then a chunked-prefill engine (chunk
    256) serving the 511-token prompt. Emits the `engine_counts` line
    and checks flash_fwd's and paged_decode's launch counts, zeroed
    before the run. Returns (the first engine, the prompts, the streams
    in prompt order, the launches, the metrics)."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    engine = LLMEngine(params, cfg, EngineConfig(**SERVE_ECFG),
                       device="cuda")
    prompts = _serving_prompts(torch, cfg.vocab)
    sp = SamplingParams(temperature=0.0, max_tokens=n_tokens)

    # warm-up request (cuBLAS handles, allocator), not counted
    engine.generate([prompts[0][:16]], SamplingParams(temperature=0.0,
                                                      max_tokens=9))
    torch.cuda.synchronize()

    _zero_serving_counts()
    before = engine.stats()
    # TTFT of the 511-token prompt on an idle engine (one prefill step)
    rid = engine.add_request(prompts[-1], sp)
    t0 = time.perf_counter()
    engine.step(skip_decode=True)
    torch.cuda.synchronize()
    ttft_s = time.perf_counter() - t0
    require(len(engine.requests[rid].output) == 1, "TTFT step gave no token")
    ids = [engine.add_request(p, sp) for p in prompts[:-1]] + [rid]
    while sum(s is not None and s.ctx_len > 0 for s in engine.slots) < 8:
        engine.step(skip_decode=True)
    torch.cuda.synchronize()
    # decode at B=8: time full bursts only
    tokens_before = sum(len(engine.requests[i].output) for i in ids)
    t0 = time.perf_counter()
    n_bursts = 0
    while all(s is not None for s in engine.slots) and n_bursts < 4:
        engine.step()
        n_bursts += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    decode_tokens = sum(len(engine.requests[i].output)
                        for i in ids) - tokens_before
    while engine.has_unfinished():
        engine.step()
    torch.cuda.synchronize()
    for i in ids:
        st = engine.requests[i]
        require(st.finished and len(st.output) == n_tokens
                and st.finish_reason == "length",
                f"request {i} did not finish with {n_tokens} tokens")
        require(all(0 <= t < cfg.vocab for t in st.output),
                f"request {i} produced out-of-range tokens")
    streams = [engine.requests[i].output for i in ids]

    # a second engine on the same params: chunked prefill, one request
    eng2 = LLMEngine(params, cfg, EngineConfig(**SERVE_ECFG,
                                               prefill_chunk=256),
                     device="cuda")
    out2 = eng2.generate([prompts[-1]], sp)[0]
    torch.cuda.synchronize()
    require(len(out2) == n_tokens, "chunked-prefill request did not finish")

    s1, s2 = engine.stats(), eng2.stats()
    counts = {k: s1[k] - before[k] + s2[k] for k in (
        "prefills", "prefill_chunks", "decode_bursts", "decode_steps",
        "paged_decode_steps", "preemptions")}
    L = cfg.n_layers
    want_flash = L * counts["prefills"]
    want_paged = L * counts["paged_decode_steps"]
    emit({"phase": "engine_counts", **counts,
          "flash_fwd_launches": flash_attention.launches,
          "flash_fwd_tc_launches": flash_attention.launches_tc,
          "paged_decode_launches": paged_decode_attention.launches,
          "expected_flash": want_flash, "expected_paged": want_paged})
    require(counts["prefills"] >= 8 and counts["prefill_chunks"] == 2,
            f"unexpected prefill counts {counts}")
    require(counts["paged_decode_steps"] == counts["decode_steps"],
            "a decode burst did not take the paged kernel")
    require(flash_attention.launches == want_flash,
            "flash_fwd launches differ from n_layers per prefill")
    # every bf16, head_dim-128 prefill on the tensor-core kernel
    require(flash_attention.launches_tc == want_flash,
            "a flash_fwd launch did not take the tensor-core kernel")
    require(paged_decode_attention.launches == want_paged > 0,
            "paged_decode launches differ from n_layers * K per burst")
    launches = {"flash_fwd": flash_attention.launches,
                "paged_decode": paged_decode_attention.launches}
    metrics = {"ttft_511_ms": ttft_s * 1e3,
               "decode_tok_s_b8": decode_tokens / dt,
               "decode_tokens": decode_tokens, "decode_bursts": n_bursts,
               "chunked_vs_whole_same_prefix": _same_prefix(
                   out2, engine.requests[rid].output)}
    del eng2
    return engine, prompts, streams, launches, metrics


def phase_engine(torch):
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS

    cfg = LLAMA_CONFIGS["8b"]
    params, init_s = _serving_params(torch)
    engine, prompts, streams, launches, metrics = _serve(torch, cfg, params,
                                                         64)
    # the greedy streams in prompt order, for the later serving phases
    _SERVING["streams"] = streams
    # paged vs gather decode: one identical cache state, first token
    first = _paged_vs_gather(torch, engine, params, cfg, prompts)
    emit({"phase": "engine", "model": "llama3-8b", "dtype": "bf16",
          "n_layers": cfg.n_layers, "requests": 9,
          "init_s": round(init_s, 3), **metrics,
          "paged_vs_gather_first_token": first,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del engine
    return launches


def _engine_8k(torch, params, cfg):
    """An engine after bench.py's 8k family with four 7,650-token greedy
    requests prefilled and one warm-up burst taken; and their ids."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams

    B, page = 4, 64
    engine = LLMEngine(params, cfg, EngineConfig(
        max_num_seqs=B, page_size=page, num_pages=1 + B * (8192 // page),
        max_seq_len=8192, decode_burst=32), device="cuda")
    g = torch.Generator().manual_seed(1)
    sp = SamplingParams(temperature=0.0, max_tokens=512)
    ids = [engine.add_request(
        torch.randint(1, cfg.vocab, (CTX_8K,), generator=g).tolist(), sp)
        for _ in range(B)]
    while sum(s is not None and s.ctx_len > 0 for s in engine.slots) < B:
        engine.step(skip_decode=True)
    engine.step()                           # warm-up burst
    torch.cuda.synchronize()
    return engine, ids


def phase_engine_8k(torch, card):
    """Long-context serving, after bench.py's 8k family
    (_bench_long_context): the 8B model with max_seq_len 8192, 64-token
    pages for 4 sequences of 8192, 4 slots and 32-step bursts, four greedy
    7,650-token prompts; after one warm-up burst, two timed bursts. Every
    decode step must take the paged kernel, L launches a step."""
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    cfg = LLAMA_CONFIGS["8b"]
    params, _ = _serving_params(torch)
    torch.cuda.reset_peak_memory_stats()
    B, burst = 4, 32
    engine, ids = _engine_8k(torch, params, cfg)

    paged_decode_attention.launches = 0
    before = engine.stats()
    tokens_before = sum(len(engine.requests[i].output) for i in ids)
    burst_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        burst_ms.append((time.perf_counter() - t0) * 1e3)
    tokens = sum(len(engine.requests[i].output) for i in ids) - tokens_before
    after = engine.stats()
    steps = after["decode_steps"] - before["decode_steps"]
    paged = after["paged_decode_steps"] - before["paged_decode_steps"]
    L = cfg.n_layers
    emit({"phase": "engine_8k", "model": "llama3-8b", "dtype": "bf16",
          "batch": B, "ctx": CTX_8K, "decode_burst": burst,
          "decode_tok_s": tokens / (sum(burst_ms) / 1e3),
          "decode_tokens": tokens, "burst_ms": burst_ms,
          "decode_steps": steps, "paged_decode_steps": paged,
          "paged_decode_launches": paged_decode_attention.launches,
          "expected_paged": L * steps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": card})
    require(tokens == B * 2 * burst, f"expected {B * 2 * burst} tokens, "
            f"got {tokens}")
    require(paged == steps > 0, "a decode step did not take the paged kernel")
    require(paged_decode_attention.launches == L * steps,
            "paged_decode launches differ from n_layers per decode step")
    for i in ids:
        require(all(0 <= t < cfg.vocab for t in engine.requests[i].output),
                f"request {i} produced out-of-range tokens")
    del engine
    return paged_decode_attention.launches


def _paged_vs_gather(torch, engine, params, cfg, prompts):
    """Prefill 8 prompts into one cache, then take one decode step per
    path from clones of the same cache state."""
    from ray_tpu_torch.llm import runner

    B = 8
    for i, p in enumerate(prompts):
        engine.add_request(p[:200 + i], None)
    # admit and prefill every request, no decode
    while sum(s is not None and s.ctx_len > 0 for s in engine.slots) < B:
        engine.step(skip_decode=True)
    slots = [s for s in engine.slots if s is not None]
    tokens = torch.zeros(B, dtype=torch.int32)
    positions = torch.zeros(B, dtype=torch.int32)
    for s in slots:
        engine._provision_pages(s, s.ctx_len + 1)
        tokens[s.slot] = s.output[-1]
        positions[s.slot] = s.ctx_len
    dev = engine.device
    bt = engine._bt(engine._active_span())
    args = (tokens.to(dev), positions.to(dev), bt,
            torch.ones(B, dtype=torch.bool, device=dev))
    samp = (torch.zeros(B, device=dev), torch.zeros(B, dtype=torch.int32,
                                                    device=dev),
            torch.ones(B, device=dev))
    outs = {}
    for paged in (True, False):
        ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
        toks, _, _ = runner.decode_burst(
            params, ck, cv, *args, engine.cos, engine.sin, 0, *samp,
            cfg=cfg, n_steps=1, paged_kernel=paged, greedy=True)
        outs[paged] = toks[0].tolist()
        del ck, cv
    require(outs[True] == outs[False],
            f"paged and gather decode disagree: {outs}")
    for s in slots:
        engine.abort_request(s.request_id)
    return outs[True]


def _lockstep(torch, engine, prompts, sp, model_ids=None):
    """The engine phase's schedule: the last prompt prefilled alone, then
    the others, then decode until every request finishes. Returns the
    streams in prompt order, the tokens emitted after the prefills and
    the host seconds that took (ending in synchronize())."""
    model_ids = model_ids or [None] * len(prompts)
    ids = [None] * len(prompts)
    ids[-1] = engine.add_request(prompts[-1], sp, model_id=model_ids[-1])
    engine.step(skip_decode=True)
    for i in range(len(prompts) - 1):
        ids[i] = engine.add_request(prompts[i], sp, model_id=model_ids[i])
    while sum(s is not None and s.ctx_len > 0
              for s in engine.slots) < len(prompts):
        engine.step(skip_decode=True)
    torch.cuda.synchronize()
    before = sum(len(engine.requests[i].output) for i in ids)
    t0 = time.perf_counter()
    while engine.has_unfinished():
        engine.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    streams = [engine.requests[i].output for i in ids]
    return streams, sum(map(len, streams)) - before, dt


def _base_streams(torch, params, cfg, prompts):
    """The engine phase's greedy streams, or, in a run without that
    phase, those of a plain engine on its schedule."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams

    if "streams" not in _SERVING:
        engine = LLMEngine(params, cfg, EngineConfig(**SERVE_ECFG),
                           device="cuda")
        _SERVING["streams"] = _lockstep(torch, engine, prompts,
                                        SamplingParams(
                                            temperature=0.0,
                                            max_tokens=SLICE_TOKENS))[0]
    return [s[:SLICE_TOKENS] for s in _SERVING["streams"]]


def _same_prefix(a, b):
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _zero_serving_counts():
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    flash_attention.launches = flash_attention.launches_tc = 0
    paged_decode_attention.launches = 0


def _serving_counts():
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    return {"flash_fwd": flash_attention.launches,
            "flash_fwd_tc": flash_attention.launches_tc,
            "paged_decode": paged_decode_attention.launches}


def _check_streams(streams, vocab, n, what):
    for i, out in enumerate(streams):
        require(len(out) == n and all(0 <= t < vocab for t in out),
                f"{what}: request {i} gave {len(out)} tokens or one out of "
                f"range")


def phase_spec(torch, card):
    """Speculative decoding at full width: the engine phase's model,
    configuration and 8 prompts, 32 greedy tokens each, with a drafter of
    the repo's 1b config (random, seed 11; reject regime) and with the
    target as its own drafter (agree regime), 4 draft tokens a round."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS

    cfg = LLAMA_CONFIGS["8b"]
    params, _ = _serving_params(torch)
    prompts = _serving_prompts(torch, cfg.vocab)
    base = _base_streams(torch, params, cfg, prompts)
    sp = SamplingParams(temperature=0.0, max_tokens=SLICE_TOKENS)
    launches = {"flash_fwd": 0, "paged_decode": 0}
    for regime, spec, draft_params in (
            ("reject", {"draft_config": "1b", "num_draft_tokens": 4,
                        "draft_seed": 11}, None),
            ("agree", {"draft_config": "8b", "num_draft_tokens": 4},
             params)):
        engine = LLMEngine(params, cfg, EngineConfig(**SERVE_ECFG),
                           device="cuda")
        engine.enable_speculation(spec, draft_params=draft_params)
        dcfg = engine.spec.dcfg
        draft_s = []
        draft = engine.spec.draft

        def timed_draft(*args, _draft=draft, _times=draft_s):
            t0 = time.perf_counter()
            out = _draft(*args)
            torch.cuda.synchronize()
            _times.append(time.perf_counter() - t0)
            return out

        engine.spec.draft = timed_draft
        torch.cuda.synchronize()
        _zero_serving_counts()
        streams, tokens, dt = _lockstep(torch, engine, prompts, sp)
        counts = _serving_counts()
        st = engine.stats()
        sst = st["spec"]
        want_flash = (cfg.n_layers * st["prefills"]
                      + dcfg.n_layers * st["draft_prefills"])
        emit({"phase": "spec", "regime": regime, "model": "llama3-8b",
              "drafter": spec["draft_config"], "dtype": "bf16",
              "num_draft_tokens": spec["num_draft_tokens"],
              "requests": len(prompts), "tokens_each": SLICE_TOKENS,
              "acceptance_ratio": sst["acceptance_ratio"],
              "rounds": sst["rounds"], "verify_steps": st["verify_steps"],
              "emitted_per_round": engine.spec.emitted_total / max(
                  1, sst["rounds"]),
              "draft_ms_per_round": 1e3 * sum(draft_s) / max(
                  1, len(draft_s)),
              "verify_ms_per_round": 1e3 * sum(engine.spec.verify_times)
              / max(1, len(engine.spec.verify_times)),
              "decode_tok_s": tokens / dt, "decode_tokens": tokens,
              "draft_prefills": st["draft_prefills"],
              "plain_decode_steps": st["decode_steps"],
              "matches_engine_stream": [_same_prefix(a, b) for a, b in
                                        zip(streams, base)],
              **{k + "_launches": v for k, v in counts.items()},
              "expected_flash": want_flash,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "nvidia_smi": card})
        _check_streams(streams, cfg.vocab, SLICE_TOKENS, f"spec {regime}")
        require(sst["rounds"] > 0 and st["draft_prefills"] >= len(prompts),
                f"spec {regime}: no drafted round or drafter warm-up")
        # every prefill, the drafter's warm-ups included, on the flash
        # kernel's tensor-core route
        require(counts["flash_fwd"] == counts["flash_fwd_tc"] == want_flash,
                f"spec {regime}: flash launches {counts}, expected "
                f"{want_flash}")
        require(counts["paged_decode"] == cfg.n_layers
                * st["paged_decode_steps"],
                f"spec {regime}: paged launches {counts}")
        if regime == "agree":
            require(sst["acceptance_ratio"] >= 0.9,
                    f"agree regime acceptance {sst['acceptance_ratio']}")
            require(sst["rounds"] < engine.spec.emitted_total,
                    "agree regime: no more tokens than rounds")
        launches["flash_fwd"] += counts["flash_fwd"]
        launches["paged_decode"] += counts["paged_decode"]
        del engine, draft, timed_draft
        torch.cuda.empty_cache()
    return launches


LORA_RANK = 16


def _lora_adapter(torch, cfg, seed, device, b_std):
    """A seeded adapter at LORA_RANK with a non-zero B (std ``b_std``),
    scale 1.0."""
    from ray_tpu_torch.llm import init_lora_adapter

    a = init_lora_adapter(cfg, LORA_RANK, seed=seed, dtype=cfg.dtype,
                          device=device)
    g = torch.Generator(device).manual_seed(seed + 1000)
    for name in ("b_q", "b_v"):
        a[name] = (torch.randn(a[name].shape, generator=g, device=device)
                   * b_std).to(cfg.dtype)
    return a


def phase_lora(torch, card):
    """Multi-LoRA at full width: the engine phase's model, configuration
    and 8 prompts (32 greedy tokens each) with lora_rank 16, max_loras 4;
    two adapters worn by 2 requests each, 4 requests on the base model,
    which must give exactly the engine phase's streams."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS

    cfg = LLAMA_CONFIGS["8b"]
    params, _ = _serving_params(torch)
    prompts = _serving_prompts(torch, cfg.vocab)
    base = _base_streams(torch, params, cfg, prompts)
    engine = LLMEngine(params, cfg, EngineConfig(
        **SERVE_ECFG, lora_rank=LORA_RANK, max_loras=4), device="cuda")
    for name, seed in (("a", 21), ("b", 22)):
        engine.add_lora(name, _lora_adapter(torch, cfg, seed, "cuda", 0.01))
    model_ids = ["a", None, "b", None, "a", None, "b", None]
    sp = SamplingParams(temperature=0.0, max_tokens=SLICE_TOKENS)
    torch.cuda.synchronize()
    _zero_serving_counts()
    streams, tokens, dt = _lockstep(torch, engine, prompts, sp, model_ids)
    counts = _serving_counts()
    st = engine.stats()
    L = cfg.n_layers
    same = [_same_prefix(a, b) for a, b in zip(streams, base)]
    emit({"phase": "lora", "model": "llama3-8b", "dtype": "bf16",
          "lora_rank": LORA_RANK, "max_loras": 4, "model_ids": model_ids,
          "requests": len(prompts), "tokens_each": SLICE_TOKENS,
          "decode_tok_s": tokens / dt, "decode_tokens": tokens,
          "matches_engine_stream": same, "prefills": st["prefills"],
          "decode_steps": st["decode_steps"],
          "paged_decode_steps": st["paged_decode_steps"],
          **{k + "_launches": v for k, v in counts.items()},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": card})
    _check_streams(streams, cfg.vocab, SLICE_TOKENS, "lora")
    for i, m in enumerate(model_ids):
        if m is None:
            require(streams[i] == base[i], f"lora: base request {i} differs "
                    f"from the engine phase's stream after {same[i]} tokens")
        else:
            require(streams[i] != base[i],
                    f"lora: adapter {m} did not change request {i}")
    require(st["paged_decode_steps"] == st["decode_steps"] > 0
            and counts["paged_decode"] == L * st["decode_steps"],
            f"lora: a decode step did not take the paged kernel {counts}")
    require(counts["flash_fwd"] == counts["flash_fwd_tc"]
            == L * st["prefills"] == L * len(prompts),
            f"lora: a prefill did not take flash_fwd_tc {counts}")
    del engine
    torch.cuda.empty_cache()
    return {"flash_fwd": counts["flash_fwd"],
            "paged_decode": counts["paged_decode"]}


def phase_fleet(torch, card):
    """The fleet KV plane at full width: a prefill engine takes the 4
    longest prompts to their first token and exports them; a second engine
    injects the payloads and decodes 32 tokens each."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS

    cfg = LLAMA_CONFIGS["8b"]
    params, _ = _serving_params(torch)
    prompts = _serving_prompts(torch, cfg.vocab)
    base = _base_streams(torch, params, cfg, prompts)
    sp = SamplingParams(temperature=0.0, max_tokens=SLICE_TOKENS)
    pre = LLMEngine(params, cfg, EngineConfig(**SERVE_ECFG), device="cuda")
    dec = LLMEngine(params, cfg, EngineConfig(**SERVE_ECFG), device="cuda")
    picks = list(range(4, 8))
    _zero_serving_counts()
    payloads = []
    for i in picks:
        rid = pre.add_request(prompts[i], sp)
        while pre.requests[rid].ctx_len <= 0:
            pre.step(skip_decode=True)
        payloads.append(pre.export_kv_request(rid))
    prefill_counts = _serving_counts()
    mb = [(p["k"].nbytes + p["v"].nbytes) / 1e6 for p in payloads]
    inject_ms, ids = [], []
    for p in payloads:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids.append(dec.inject_request(p, sp))
        torch.cuda.synchronize()
        inject_ms.append((time.perf_counter() - t0) * 1e3)
    joined = [dec.requests[r].ctx_len > 0 for r in ids]
    _zero_serving_counts()
    t0 = time.perf_counter()
    while dec.has_unfinished():
        dec.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _serving_counts()
    st = dec.stats()
    streams = [dec.requests[r].output for r in ids]
    same = [_same_prefix(s, base[i]) for s, i in zip(streams, picks)]
    L = cfg.n_layers
    emit({"phase": "fleet", "model": "llama3-8b", "dtype": "bf16",
          "requests": len(picks), "prompt_lens": [len(prompts[i])
                                                  for i in picks],
          "tokens_each": SLICE_TOKENS, "payload_mb": mb,
          "inject_ms": inject_ms, "joined_decode": joined,
          "decode_tok_s": (sum(map(len, streams)) - len(picks)) / dt,
          "matches_monolithic_stream": same,
          "decode_prefills": st["prefills"], "injected": st["injected"],
          "decode_steps": st["decode_steps"],
          "paged_decode_steps": st["paged_decode_steps"],
          "prefill_flash_launches": prefill_counts["flash_fwd"],
          "decode_paged_launches": counts["paged_decode"],
          "nvidia_smi": card})
    _check_streams(streams, cfg.vocab, SLICE_TOKENS, "fleet")
    require(all(joined) and st["injected"] == len(picks)
            and st["prefills"] == st["prefill_chunks"] == 0,
            "fleet: an injected request was recomputed")
    require(st["paged_decode_steps"] == st["decode_steps"] > 0
            and counts["paged_decode"] == L * st["decode_steps"],
            f"fleet: a decode step did not take the paged kernel {counts}")
    require(prefill_counts["flash_fwd"] == prefill_counts["flash_fwd_tc"]
            == L * len(picks), f"fleet: prefill launches {prefill_counts}")
    del pre, dec
    torch.cuda.empty_cache()
    return {"flash_fwd": prefill_counts["flash_fwd"],
            "paged_decode": counts["paged_decode"]}


SERVE_TOKENS = 64      # new tokens a request in the serve phase's mono runs


class _DecodePool:
    """The decode pool as a prefill server's handle sees it, in one
    process: route() hands the payload to the decode server directly and
    records its chunks and bytes. A handoff retry fails the phase: neither
    a retry nor a recompute may hide a fault on this path."""

    def __init__(self, server):
        self.server = server
        self.chunks = []
        self.nbytes = 0

    def route(self, payload, request_id=None, tenant_id=None):
        refs = payload["kv_refs"]
        self.chunks.append(len(refs))
        self.nbytes += sum(k.nbytes + v.nbytes for k, v in refs)
        return self.server.decode_from_kv(payload), self.server

    def _refresh(self, force=False):
        raise SmokeFailure("serve: a KV handoff was retried")


def _pooled_servers(make):
    """A prefill server and a decode server from ``make(hooks)``,
    configured as one pooled deployment's replicas through ServeHooks
    whose handle reaches the decode server in this process."""
    from ray_tpu_torch.llm import ServeHooks

    decode = make(None)
    decode_pool = _DecodePool(decode)
    prefill = make(ServeHooks(
        handle=lambda deployment, method, pool: decode_pool))
    prefill.configure_pool("prefill", "llm")
    decode.configure_pool("decode", "llm")
    return prefill, decode, decode_pool


def _completions(server, prompts, n_tokens, stream=False):
    """Concurrent greedy completions of ``prompts``: the bodies, or with
    ``stream`` the chunk lists."""
    import asyncio

    async def one(p):
        out = await server.completions({"prompt_ids": p, "temperature": 0.0,
                                        "max_tokens": n_tokens,
                                        "stream": stream})
        if stream:
            return [c async for c in out]
        return out

    async def go():
        return await asyncio.gather(*[one(p) for p in prompts])

    return asyncio.run(go())


def _stream_tokens(chunks):
    return [json.loads(c[len("data: "):])["token"] for c in chunks]


def _record_calls(obj, name):
    """Wrap the method ``name`` of ``obj`` to record (start, end) of each
    call on the host clock. The engine's step, export and inject end with
    their host copies, so their ends are synced."""
    calls = []
    method = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = method(*args, **kwargs)
        calls.append((t0, time.perf_counter()))
        return out

    setattr(obj, name, timed)
    return calls


def _step_times(steps, t0, t1):
    """The steps inside [t0, t1]: their count, their summed host ms, and
    the wall ms outside them a step (the pump's hops, the queues,
    asyncio; for the engine stepped directly, its loop)."""
    inside = [s for s in steps if s[0] >= t0 and s[1] <= t1]
    busy = sum(b - a for a, b in inside)
    return {"steps": len(inside), "step_ms": busy * 1e3,
            "outside_ms_per_step": ((t1 - t0) - busy) * 1e3
            / max(1, len(inside))}


def _direct_engine(engine, prompts, n_tokens):
    """The server's schedule without the server: every prompt added, then
    step() until done. The streams in prompt order."""
    from ray_tpu_torch.llm import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=n_tokens)
    ids = [engine.add_request(p, sp) for p in prompts]
    while engine.has_unfinished():
        engine.step()
    return [engine.requests.pop(i).output for i in ids]


def _serve_metrics():
    from ray_tpu_torch.util.metrics import snapshot_local

    return {k: v for k, v in snapshot_local().items()
            if (k.startswith("llm_") or k.startswith("serve_kv_handoff"))
            and ("__stat__" in k or k.split("{")[0].endswith("_total"))}


def phase_serve(torch, card):
    """LLMServer at full width: Llama-3-8B (bf16, seed 7, the engine
    phase's configuration and 8 prompts) served through the server's
    pump. Mono: a warm-up completion, the TTFT of a streamed 511-token
    completion on an idle server (equal to a non-streamed one), 8
    concurrent 64-token completions (host tok/s, the metrics' counts, the
    kernels' launches), and the same schedule stepped on the engine
    directly, in turns with the server. Pooled: a prefill and a decode
    server in one process, the 4 longest prompts, 32 tokens each, the KV
    handed off in 8 MiB chunks with no retry and no decode-side
    prefill."""
    import asyncio

    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS

    cfg = LLAMA_CONFIGS["8b"]
    L = cfg.n_layers
    prompts = _serving_prompts(torch, cfg.vocab)
    engine_streams = _SERVING.get("streams")
    # the server holds its own tree: the engine phases' copy goes
    _SERVING.pop("params", None)
    _fresh_phase(torch)

    def make(hooks):
        return LLMServer("8b", init="random", seed=7,
                         engine_config=SERVE_ECFG, device="cuda",
                         hooks=hooks)

    t0 = time.perf_counter()
    mono = make(None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = _record_calls(mono.engine, "step")
    _completions(mono, [prompts[0][:16]], 9)        # warm-up, not counted

    _zero_serving_counts()
    before = mono.engine.stats()
    m0 = _serve_metrics()

    async def ttft():
        t0 = time.perf_counter()
        gen = await mono.completions({"prompt_ids": prompts[-1],
                                      "temperature": 0.0,
                                      "max_tokens": SERVE_TOKENS,
                                      "stream": True})
        first = await gen.__anext__()
        dt = time.perf_counter() - t0
        return dt, [first] + [c async for c in gen]

    ttft_s, chunks = asyncio.run(ttft())
    m1 = _serve_metrics()
    streamed = _stream_tokens(chunks)
    whole = _completions(mono, [prompts[-1]], SERVE_TOKENS)[0]
    require(streamed == whole["choices"][0]["token_ids"],
            "serve: the streamed 511-token completion differs from the "
            "non-streamed one")
    # the timed run: 8 concurrent completions
    m2 = _serve_metrics()
    t0 = time.perf_counter()
    bodies = _completions(mono, prompts, SERVE_TOKENS)
    t1 = time.perf_counter()
    m3 = _serve_metrics()
    counts = _serving_counts()
    st = mono.engine.stats()
    delta = {k: st[k] - before[k] for k in ("prefills", "decode_steps",
                                            "paged_decode_steps",
                                            "decode_bursts")}
    streams = [b["choices"][0]["token_ids"] for b in bodies]
    for i, b in enumerate(bodies):
        require(len(streams[i]) == SERVE_TOKENS
                and b["choices"][0]["finish_reason"] == "length"
                and all(0 <= t < cfg.vocab for t in streams[i]),
                f"serve: request {i} gave {len(streams[i])} tokens, "
                f"{b['choices'][0]['finish_reason']}")
    turns = {"server": [{"tok_s": len(prompts) * SERVE_TOKENS / (t1 - t0),
                         **_step_times(steps, t0, t1)}], "direct": []}
    # in turns with the server, the same schedule on the engine directly
    same_schedule = []
    for kind in ("direct", "direct", "server", "server", "direct", "direct",
                 "server"):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if kind == "server":
            out = [b["choices"][0]["token_ids"] for b in
                   _completions(mono, prompts, SERVE_TOKENS)]
        else:
            out = _direct_engine(mono.engine, prompts, SERVE_TOKENS)
        t3 = time.perf_counter()
        turns[kind].append({"tok_s": len(prompts) * SERVE_TOKENS / (t3 - t2),
                            **_step_times(steps, t2, t3)})
        same_schedule.append(min(_same_prefix(a, b)
                                 for a, b in zip(out, streams)))

    def mdelta(a, b, name, stat="__stat__=count,"):
        key = f"{name}{{{stat}model=8b,pool=mono}}"
        return b.get(key, 0.0) - a.get(key, 0.0)

    obs = {n: mdelta(m2, m3, n) for n in (
        "llm_ttft_seconds", "llm_tpot_seconds", "llm_request_e2e_seconds")}
    generated = mdelta(m2, m3, "llm_generation_tokens_total", "")
    want_flash, want_paged = L * delta["prefills"], L * delta[
        "paged_decode_steps"]
    mono_line = {
        "phase": "serve", "mode": "mono", "model": "llama3-8b",
        "dtype": "bf16", "init_s": init_s, "requests": len(prompts),
        "tokens_each": SERVE_TOKENS,
        "ttft_511_ms": ttft_s * 1e3,
        "ttft_511_engine_ms": 1e3 * mdelta(m0, m1, "llm_ttft_seconds",
                                           "__stat__=sum,"),
        "wall_s": t1 - t0, "turns": turns,
        "turns_same_prefix_min": same_schedule,
        "engine_phase_same_prefix": (
            [_same_prefix(a, b) for a, b in zip(streams, engine_streams)]
            if engine_streams else None),
        "observations": obs, "generated_tokens": generated,
        **delta, "flash_fwd_launches": counts["flash_fwd"],
        "flash_fwd_tc_launches": counts["flash_fwd_tc"],
        "paged_decode_launches": counts["paged_decode"],
        "expected_flash": want_flash, "expected_paged": want_paged,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "nvidia_smi": card}
    emit(mono_line)
    require(all(v == len(prompts) for v in obs.values()),
            f"serve: metric observations {obs}, expected 8 each")
    require(generated == len(prompts) * SERVE_TOKENS,
            f"serve: {generated} generated tokens counted")
    require(counts["flash_fwd"] == counts["flash_fwd_tc"] == want_flash > 0,
            f"serve: flash launches {counts}, expected {want_flash} on "
            f"the tensor cores")
    require(counts["paged_decode"] == want_paged > 0
            and delta["paged_decode_steps"] == delta["decode_steps"],
            f"serve: paged launches {counts}, expected {want_paged}")
    require(same_schedule == [SERVE_TOKENS] * len(same_schedule),
            "serve: a run on the same schedule (the server's again, or the "
            "engine's) gave other streams")
    launches = {"flash_fwd": counts["flash_fwd"],
                "paged_decode": counts["paged_decode"]}
    del mono, bodies
    _fresh_phase(torch)

    # pooled: two trees, one cache each; streamed, so that a handoff's
    # seconds are its export, puts and inject, not the whole decode
    picks = list(range(4, 8))
    prefill, decode, pool = _pooled_servers(make)
    exports = _record_calls(prefill.engine, "export_kv_request")
    injects = _record_calls(decode.engine, "inject_request")
    _zero_serving_counts()
    m4 = _serve_metrics()
    t0 = time.perf_counter()
    pooled = _completions(prefill, [prompts[i] for i in picks],
                          SLICE_TOKENS, stream=True)
    pooled_s = time.perf_counter() - t0
    m5 = _serve_metrics()
    counts = _serving_counts()
    pst, dst = prefill.engine.stats(), decode.engine.stats()

    def hdelta(name, stat=""):
        key = f"{name}{{{stat}model=8b}}"
        return m5.get(key, 0.0) - m4.get(key, 0.0)

    handoff = {"bytes": hdelta("serve_kv_handoff_bytes_total"),
               "retries": hdelta("serve_kv_handoff_retries_total"),
               "count": hdelta("serve_kv_handoff_seconds", "__stat__=count,"),
               "seconds": hdelta("serve_kv_handoff_seconds",
                                 "__stat__=sum,")}
    pstreams = [_stream_tokens(c) for c in pooled]
    reasons = [json.loads(c[-1][len("data: "):]).get("finish_reason")
               for c in pooled]
    emit({"phase": "serve", "mode": "pooled", "model": "llama3-8b",
          "dtype": "bf16", "requests": len(picks), "stream": True,
          "prompt_lens": [len(prompts[i]) for i in picks],
          "tokens_each": SLICE_TOKENS, "wall_s": pooled_s,
          "chunks": pool.chunks, "payload_bytes": pool.nbytes,
          "handoff": handoff,
          "handoff_ms_each": 1e3 * handoff["seconds"] / max(
              1, handoff["count"]),
          "handoff_gb_s": pool.nbytes / max(1e-9, handoff["seconds"]) / 1e9,
          "export_ms": [(b - a) * 1e3 for a, b in exports],
          "inject_ms": [(b - a) * 1e3 for a, b in injects],
          "mono_same_prefix": [_same_prefix(a, streams[i]) for a, i in
                               zip(pstreams, picks)],
          "prefill_prefills": pst["prefills"],
          "prefill_decode_steps": pst["decode_steps"],
          "decode_prefills": dst["prefills"], "injected": dst["injected"],
          "decode_steps": dst["decode_steps"],
          "paged_decode_steps": dst["paged_decode_steps"],
          **{k + "_launches": v for k, v in counts.items()},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": card})
    _check_streams(pstreams, cfg.vocab, SLICE_TOKENS, "serve pooled")
    require(reasons == ["length"] * len(picks),
            f"serve pooled: finish reasons {reasons}")
    require(dst["prefills"] == dst["prefill_chunks"] == 0
            and dst["injected"] == len(picks),
            f"serve pooled: the decode server ran {dst['prefills']} "
            f"prefills and injected {dst['injected']}")
    require(handoff["retries"] == 0 and handoff["count"] == len(picks),
            f"serve pooled: handoffs {handoff}")
    require(handoff["bytes"] == pool.nbytes > 0,
            f"serve pooled: {handoff['bytes']} bytes counted, "
            f"{pool.nbytes} shipped")
    require(len(pool.chunks) == len(picks) and min(pool.chunks) > 1,
            f"serve pooled: chunks per request {pool.chunks}")
    require(pst["decode_steps"] == 0 and counts["flash_fwd"]
            == counts["flash_fwd_tc"] == L * pst["prefills"] == L * len(picks),
            f"serve pooled: prefill launches {counts}")
    require(counts["paged_decode"] == L * dst["paged_decode_steps"] > 0
            and dst["paged_decode_steps"] == dst["decode_steps"],
            f"serve pooled: paged launches {counts}")
    launches["flash_fwd"] += counts["flash_fwd"]
    launches["paged_decode"] += counts["paged_decode"]
    del prefill, decode, pool
    _fresh_phase(torch)
    return launches


def _reference_serve(torch):
    """`tiny` (f32, head_dim 16) LLMServer on the card and on the CPU from
    one pickle of weights: mono completions, and pooled ones through a
    prefill and a decode server handing off one page a chunk, give
    identical token ids on both devices and in both modes."""
    import os
    import pickle
    import shutil
    import tempfile

    from ray_tpu_torch._private.config import global_config
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models import params_to_numpy
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS, init_params

    cfg = LLAMA_CONFIGS["tiny"]
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in (4, 17, 40, 64)]
    ecfg = dict(max_num_seqs=4, page_size=16, num_pages=64, max_seq_len=128,
                decode_burst=4)
    flags = global_config()
    chunk_bytes = flags.serve_kv_handoff_chunk_bytes
    # one page a chunk: 2 layers of 16 positions x 2 kv heads x 16, k and v
    flags.serve_kv_handoff_chunk_bytes = 2 * 2 * 16 * 2 * 16 * 4
    tmp = tempfile.mkdtemp(prefix="serve-tiny-")
    out, chunks, stats = {}, {}, {}
    try:
        path = os.path.join(tmp, "tiny.pkl")
        with open(path, "wb") as f:
            pickle.dump(params_to_numpy(init_params(cfg, seed=5,
                                                    device="cpu")), f)
        _zero_serving_counts()
        for dev in ("cpu", "cuda"):
            def make(hooks, dev=dev):
                return LLMServer("tiny", params_path=path,
                                 engine_config=ecfg, device=dev,
                                 hooks=hooks)

            out[dev, "mono"] = [b["choices"][0]["token_ids"] for b in
                                _completions(make(None), prompts, 24)]
            prefill, decode, pool = _pooled_servers(make)
            out[dev, "pooled"] = [b["choices"][0]["token_ids"] for b in
                                  _completions(prefill, prompts, 24)]
            chunks[dev] = pool.chunks
            stats[dev] = {k: decode.engine.stats()[k]
                          for k in ("prefills", "injected")}
        torch.cuda.synchronize()
    finally:
        flags.serve_kv_handoff_chunk_bytes = chunk_bytes
        shutil.rmtree(tmp, ignore_errors=True)
    counts = _serving_counts()
    checks = {"mono_card_equals_cpu": out["cuda", "mono"] == out["cpu",
                                                                 "mono"],
              "pooled_card_equals_cpu": out["cuda", "pooled"]
              == out["cpu", "pooled"],
              "pooled_equals_mono": out["cuda", "pooled"]
              == out["cuda", "mono"]}
    emit({"phase": "reference_serve", "model": "tiny (f32, head_dim 16)",
          **checks, "chunks": chunks, "decode_stats": stats,
          "launches": counts})
    require(all(checks.values()), f"tiny LLMServer: {checks}")
    require(all(s == {"prefills": 0, "injected": len(prompts)}
                for s in stats.values()),
            f"tiny LLMServer: the decode server recomputed {stats}")
    require(counts["flash_fwd"] > 0 and counts["paged_decode"] > 0,
            f"tiny LLMServer did not take the kernels: {counts}")
    return {k: counts[k] for k in ("flash_fwd", "paged_decode")}


def _tree_bit_equal(torch, got, want):
    """Two trees of tensors: the same structure, dtypes and bits."""
    from ray_tpu_torch._private.tree import tree_leaves, tree_map

    try:
        tree_map(lambda a, b: None, got, want)
    except (KeyError, IndexError, TypeError):
        return False
    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _host_peak_gb():
    """The process's peak resident host memory so far (ru_maxrss, KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6 * 1.024


def phase_hf(torch, card):
    """The checkpoint door at full width and depth: the engine phase's
    Llama-3-8B weights (bf16, seed 7) written by save_hf_checkpoint in
    config_to_hf's layout (Meta-Llama-3-8B's config.json widths) into a
    temporary directory, loaded back by load_hf_checkpoint bit-equal and
    served on the engine phase's schedule (the 8 greedy streams must equal
    its own); then loaded with quantize="int8" (rounded and quantized on
    the host), every int8 value and scale bit-equal to quantize_params run
    on the card over the loaded bf16 tree, and served the same way (TTFT,
    decode tok/s at B=8, peak memory; the share of tokens equal to the bf16
    streams is reported, not required). The directory is deleted at the
    end; too little free disk fails the phase, naming the free bytes."""
    import os
    import shutil
    import tempfile

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.models.hf_interop import (load_hf_checkpoint,
                                                 save_hf_checkpoint)
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS
    from ray_tpu_torch.ops.quant import quantize_params

    cfg = LLAMA_CONFIGS["8b"]
    params, _ = _serving_params(torch)
    if "streams" not in _SERVING:     # a run without the engine phase
        _SERVING["streams"] = _serve(torch, cfg, params, 64)[2]
    want_streams = _SERVING["streams"]
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    tmp = tempfile.mkdtemp(prefix="hf-llama3-8b-")
    try:
        free = shutil.disk_usage(tmp).free
        emit({"phase": "hf_disk", "dir": tmp, "free_bytes": free,
              "checkpoint_bytes": nbytes})
        require(free > nbytes + 2 ** 30,
                f"hf: {free} bytes free in {tmp}, the 8B checkpoint needs "
                f"{nbytes}")
        t0 = time.perf_counter()
        save_hf_checkpoint(params, cfg, tmp)
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(os.path.join(tmp, "model.safetensors"))

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loaded, lcfg = load_hf_checkpoint(tmp, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = _tree_bit_equal(torch, loaded, params) and lcfg == cfg
        emit({"phase": "hf_load", "dtype": "bf16",
              "loaded_equals_saved": same})
        require(same, "hf: the loaded 8B tree differs from the saved one")
        # the loaded tree serves from here on: the engine phase's copy goes
        del params
        _SERVING.pop("params")
        _fresh_phase(torch)
        engine, _, streams, launches, bf16 = _serve(torch, cfg, loaded, 64)
        del engine
        n_same = sum(a == b for a, b in zip(streams, want_streams))
        require(n_same == len(want_streams) == 8,
                f"hf: {n_same} of 8 greedy streams from the loaded weights "
                f"equal the engine phase's")

        host_before = _host_peak_gb()
        t0 = time.perf_counter()
        q8, _ = load_hf_checkpoint(tmp, quantize="int8", device="cuda")
        torch.cuda.synchronize()
        int8_load_s = time.perf_counter() - t0
        host_peak = _host_peak_gb()
        on_card = quantize_params(loaded, cfg)
        q8_same = _tree_bit_equal(torch, q8, on_card)
        del on_card, loaded
        require(q8_same, "hf: the host-int8 tree differs from "
                "quantize_params on the card")
        _fresh_phase(torch)
        engine, _, q8_streams, q8_launches, int8 = _serve(torch, cfg, q8, 64)
        q8_peak = torch.cuda.max_memory_allocated() / 1e9
        del engine, q8
        equal = sum(x == y for a, b in zip(q8_streams, streams)
                    for x, y in zip(a, b))
        emit({"phase": "hf", "model": "llama3-8b", "layout": "config_to_hf "
              "(Meta-Llama-3-8B config.json widths)",
              "file_bytes": file_bytes, "write_s": write_s,
              "write_gb_s": file_bytes / write_s / 1e9,
              "load_s": load_s, "load_gb_s": file_bytes / load_s / 1e9,
              "int8_load_s": int8_load_s,
              "int8_load_gb_s": file_bytes / int8_load_s / 1e9,
              "host_peak_gb_before_int8": host_before,
              "host_peak_gb": host_peak,
              "bf16_streams_equal_engine": n_same,
              "int8_equals_card_quantize": q8_same,
              "bf16": bf16, "int8": int8, "int8_peak_mem_gb": q8_peak,
              "int8_tokens_equal_bf16_share": equal / sum(map(len, streams)),
              "launches": {k: launches[k] + q8_launches[k]
                           for k in launches},
              "nvidia_smi": card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: launches[k] + q8_launches[k] for k in launches}


def _train_wrappers():
    from ray_tpu_torch.ops.attention import (flash_attention, flash_bwd_dkv,
                                             flash_bwd_dq)

    return {"flash_fwd": flash_attention, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv}


def _zero_counts():
    for fn in _train_wrappers().values():
        fn.launches = fn.launches_tc = 0


def _train_counts():
    """Launches of the three training kernels; <name>_tc counts those of
    <name> that took the tensor-core kernel."""
    counts = {}
    for name, fn in _train_wrappers().items():
        counts[name] = fn.launches
        counts[name + "_tc"] = fn.launches_tc
    return counts


def _set_train_counts(counts):
    for name, fn in _train_wrappers().items():
        fn.launches, fn.launches_tc = counts[name], counts[name + "_tc"]


def _model_flops_per_token(cfg, seq):
    """bench.py's training FLOPs per token: 6 N + causal attention."""
    from ray_tpu_torch.train import estimate_flops_per_token

    return estimate_flops_per_token(cfg.n_params()) \
        + 6 * cfg.n_layers * seq * cfg.dim


def _8b_train_step(session=None):
    """make_train_step for Llama-3-8B (bf16, full width and depth, remat
    "full") with bench.py's optimizer, adamw(3e-4, weight_decay=0.1),
    reporting to ``session`` when one is given."""
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS, lm_loss
    from ray_tpu_torch.train import adamw, make_train_step

    cfg = LLAMA_CONFIGS["8b"]
    require(cfg.remat and cfg.remat_policy == "full", "8b remat is not full")
    return cfg, make_train_step(
        lambda p, b: lm_loss(p, b, cfg), adamw(3e-4, weight_decay=0.1),
        device="cuda",
        model_flops_per_token=_model_flops_per_token(cfg, TRAIN_S),
        session=session)


def _build_8b_trainer(torch):
    """The 8B trainer (``_8b_train_step``) on seed 7's weights; one seeded
    batch of B=1, S=2048."""
    from ray_tpu_torch.models.llama import init_params

    cfg, (init_fn, step_fn, place_batch) = _8b_train_step()
    state = init_fn(init_params(cfg, seed=7, device="cuda"))
    batch = place_batch(_train_batch(torch, cfg))
    return cfg, state, step_fn, batch


def _train_batch(torch, cfg):
    """The 8B training batch: B=1, S=2048 tokens from seed 7."""
    g = torch.Generator().manual_seed(7)
    return {"tokens": torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S),
                                    generator=g, dtype=torch.int32)}


# the train phase's numbers, which the parallel phase's mesh step is held
# against in the same call
_TRAIN = {}


def _timed_steps(torch, step_fn, state, batch, tokens_per_step):
    """One warm-up step, then the launch counts zeroed and 3 timed steps
    on the same batch. Returns (state, losses and grad norms of all 4
    steps, step ms, tok/s, the 3 steps' launches, the last metrics)."""
    state, m = step_fn(state, batch)
    torch.cuda.synchronize()
    losses, norms = [m["loss"].item()], [m["grad_norm"].item()]
    _zero_counts()
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    counts = _train_counts()
    mean_ms = sum(step_ms) / len(step_ms)
    return (state, losses, norms, step_ms,
            tokens_per_step / (mean_ms / 1e3), counts, m)


def _want_train_counts(n_attn, tc=True, steps=3, remat=True):
    """Launches of ``steps`` steps of ``n_attn`` attention layers: the
    forward twice under remat (forward, recompute), else once, each
    backward once; on tensor cores every kernel (``tc`` True) or none
    (False)."""
    per_run = {"flash_fwd": (2 if remat else 1) * n_attn * steps,
               "flash_bwd_dq": n_attn * steps,
               "flash_bwd_dkv": n_attn * steps}
    return {**per_run, **{k + "_tc": n if tc else 0
                          for k, n in per_run.items()}}


def _check_training(torch, losses, norms, counts, want, m):
    """The loss falls, every loss and grad norm is finite (a NaN or inf in
    any gradient makes the norm non-finite), the launches are as
    expected, the peak fits the card and 4 steps were taken."""
    require(all(math.isfinite(x) for x in losses + norms),
            "a loss or grad norm is not finite")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    require(counts == want, f"train launches {counts}, expected {want}")
    require(torch.cuda.max_memory_allocated()
            < torch.cuda.get_device_properties(0).total_memory,
            "peak memory exceeds the card")
    require(int(m["step"]) == 4, "the step counter is not 4")


class _RecordingTimeline:
    def __init__(self):
        self.intervals = []

    def record_interval(self, name, t0, t1):
        self.intervals.append((name, t0, t1))


class _RecordingSession:
    """A training session as ray_tpu.train's step reports to one
    (``telemetry_on``, ``timeline.record_interval``, ``note_step``),
    recording what it is given."""

    telemetry_on = True

    def __init__(self):
        self.timeline = _RecordingTimeline()
        self.notes = []

    def note_step(self, **kw):
        self.notes.append(kw)


def _session_steps(torch, cfg, state, bare_ms, card):
    """The 8B step under a recording session, on the train phase's state:
    the host batch through the instrumented place_batch, then 4 steps.
    Step 1 must be "compile", steps 2-4 "compute", each compute interval
    within 1 ms of the host clock's step ms, and every note the batch's
    2048 tokens and model_flops_per_token x 2048 flops. Returns (state,
    the 4 steps' launches)."""
    sess = _RecordingSession()
    _, (_, step_fn, place_batch) = _8b_train_step(lambda: sess)
    fpt = step_fn.model_flops_per_token
    batch = place_batch(_train_batch(torch, cfg))
    _zero_counts()
    host_ms, losses = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    counts = _train_counts()
    phases = [name for name, _, _ in sess.timeline.intervals]
    steps = [(t1 - t0) * 1e3 for name, t0, t1 in sess.timeline.intervals
             if name != "host_to_device"]
    compute_ms = steps[1:]
    mean_ms = sum(compute_ms) / len(compute_ms)
    tokens = TRAIN_B * TRAIN_S
    mfu = fpt * tokens / (mean_ms / 1e3) / BF16_FLOPS
    want = _want_train_counts(cfg.n_layers, steps=4)
    emit({"phase": "train_session", "model": "llama3-8b", "batch": TRAIN_B,
          "seq": TRAIN_S, "phases": phases, "interval_ms": steps,
          "host_ms": host_ms, "host_minus_interval_ms": [
              h - i for h, i in zip(host_ms, steps)],
          "compile_kind": sess.notes[0]["compile_kind"],
          "notes": sess.notes, "loss": losses,
          "mean_compute_ms": mean_ms, "bare_mean_step_ms": bare_ms,
          "instrumented_minus_bare_ms": mean_ms - bare_ms,
          "mfu": mfu, "launches": counts, "expected_launches": want,
          "nvidia_smi": card})
    require(phases == ["host_to_device", "compile", "compute", "compute",
                       "compute"], f"session phases {phases}")
    # the compile step's host time also holds the kernel cache's probes
    require(all(abs(a - b) <= 1.0 for a, b in zip(compute_ms, host_ms[1:])),
            f"session compute intervals {compute_ms} ms against host "
            f"{host_ms[1:]} ms")
    require([n["tokens"] for n in sess.notes] == [tokens] * 4
            and [n["flops"] for n in sess.notes] == [fpt * tokens] * 4
            and [n["chips"] for n in sess.notes] == [1] * 4
            and [n["batch_shape"] for n in sess.notes]
            == [f"({TRAIN_B}, {TRAIN_S})/int32"] * 4
            and not any(n["recompile"] for n in sess.notes)
            and sess.notes[0]["compile_kind"] in ("cold", "cache_hit")
            and [n["compile_kind"] for n in sess.notes[1:]] == [""] * 3,
            f"session notes {sess.notes}")
    require(all(math.isfinite(x) for x in losses),
            f"a session step's loss is not finite: {losses}")
    require(counts == want, f"session launches {counts}, expected {want}")
    require(int(m["step"]) == 8, "the step counter is not 8")
    return state, counts


def phase_train(torch, card):
    """The training path at full width and depth: 1 warm-up step, then 3
    timed steps on the same batch; then 4 steps more under a recording
    training session (``_session_steps``)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, state, step_fn, batch = _build_8b_trainer(torch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state, losses, norms, step_ms, tok_s, counts, m = _timed_steps(
        torch, step_fn, state, batch, TRAIN_B * TRAIN_S)
    L = cfg.n_layers
    # every launch of the bf16, head_dim-128 step on tensor cores
    want = _want_train_counts(L)
    flops_per_token = step_fn.model_flops_per_token
    emit({"phase": "train", "model": "llama3-8b", "dtype": "bf16",
          "n_layers": L, "remat": cfg.remat_policy, "batch": TRAIN_B,
          "seq": TRAIN_S, "optimizer": "adamw(3e-4, weight_decay=0.1)",
          "init_s": init_s, "loss": losses, "grad_norm": norms,
          "step_ms": step_ms, "mean_step_ms": sum(step_ms) / 3,
          "tok_s": tok_s, "model_flops_per_token": flops_per_token,
          "mfu": flops_per_token * tok_s / BF16_FLOPS,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card_mem_gb":
              torch.cuda.get_device_properties(0).total_memory / 1e9,
          "launches": counts, "expected_launches": want,
          "step": int(m["step"])})
    _check_training(torch, losses, norms, counts, want, m)
    _TRAIN.update(loss=losses, grad_norm=norms, step_ms=step_ms,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    state, session_counts = _session_steps(torch, cfg, state,
                                           sum(step_ms) / 3, card)
    return {k: counts[k] + session_counts[k] for k in counts}


# --- the multi-device plane at world size 1 --------------------------------

PAR_REPS = 50       # timed calls of each collective


def _world_one_ops(par, x):
    """Every symbolic op of parallel/collectives.py on ``x`` (inside a
    rank region), each beside its value at world size 1:
    (name, call, expected)."""
    ops = [(f"allreduce_{op}", lambda op=op: par.allreduce(x, "dp", op), x)
           for op in ("sum", "mean", "max", "min", "prod")]
    return ops + [
        ("allreduce_sum_tuple", lambda: par.allreduce(x, ("dp", "tp")), x),
        ("allgather", lambda: par.allgather(x, "dp"), x),
        ("allgather_untiled", lambda: par.allgather(x, "dp", tiled=False),
         x[None]),
        ("reducescatter_sum", lambda: par.reducescatter(x, "dp"), x),
        ("reducescatter_mean",
         lambda: par.reducescatter(x, "dp", op="mean"), x),
        ("broadcast", lambda: par.broadcast(x, "dp", root=0), x),
        ("alltoall", lambda: par.alltoall(x, "dp", split_axis=1,
                                          concat_axis=0), x),
        ("send", lambda: par.send(x, "dp", shift=1), x),
        ("recv", lambda: par.recv(x, "dp", shift=1), x),
    ]


def _collectives_world_one(torch, mesh):
    """(a): every op, symbolic and eager, on f32 and bf16 card tensors,
    bit-equal to its world-1 value; host µs a call; the NCCL kernels a
    traced round launches."""
    import ray_tpu_torch.parallel as par
    from ray_tpu_torch.parallel.collectives import rank_region

    g = torch.Generator("cuda").manual_seed(7)
    group = par.pgroup(mesh, "dp")
    results, host_us = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((8, 256), generator=g, device="cuda").to(dtype)
        dt = str(dtype).split(".")[-1]
        with rank_region(mesh):
            for name, call, want in _world_one_ops(par, x):
                got = call()
                results[f"{name}_{dt}"] = bool(torch.equal(got, want))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(PAR_REPS):
                    call()
                torch.cuda.synchronize()
                host_us[f"{name}_{dt}"] = ((time.perf_counter() - t0)
                                           / PAR_REPS * 1e6)
        eager = {"allreduce_" + op: (lambda op=op: group.allreduce(x, op), x)
                 for op in ("sum", "mean", "max", "min", "prod")}
        eager.update({
            "allgather": (lambda: group.allgather(x), x),
            "reducescatter": (lambda: group.reducescatter(x), x),
            "broadcast": (lambda: group.broadcast(x, root=0), x),
            "shift": (lambda: group.shift(x, shift=1), x)})
        for name, (call, want) in eager.items():
            results[f"pgroup_{name}_{dt}"] = bool(torch.equal(call(), want))
    group.barrier()
    group.barrier(timeout_s=30)
    par.barrier(mesh, "dp", timeout_s=30)
    from torch.autograd import DeviceType

    with rank_region(mesh):
        x = torch.randn((8, 256), generator=g, device="cuda")
        ops = _world_one_ops(par, x)
        trace, prof = _profile_window(torch,
                                      lambda: [c() for _, c, _ in ops])
    nccl = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and "nccl" in ev.name.lower():
            us, n = nccl.get(ev.name, (0.0, 0))
            nccl[ev.name] = (us + ev.time_range.end - ev.time_range.start,
                             n + 1)
    failed = [k for k, ok in results.items() if not ok]
    require(not failed, f"world-1 collectives differ: {failed}")
    return {"ops_checked": len(results), "host_us": host_us,
            "traced_round": {k: trace[k] for k in trace if k != "top"},
            "nccl_kernels": [{"name": k[:80], "us": us, "count": n}
                             for k, (us, n) in sorted(nccl.items())]}


def phase_parallel(torch, card):
    """The multi-device plane on one card over a world-1 NCCL group:
    (a) every collective in both modes against its world-1 value; (b)
    Llama-3-8B trained 1+3 steps through make_train_step(mesh=
    build_mesh(MeshSpec()), param_axes=param_logical_axes(cfg)) on the
    train phase's seed and batch, its losses and grad norms against the
    train phase's (bf16 rounding, 2**-8 relative; bit-equal expected),
    its step ms beside the train phase's; (c) the 8B forward with mesh=
    and without on the same weights, equal logits."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import (LLAMA_CONFIGS, forward,
                                            init_params, lm_loss,
                                            param_logical_axes)
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import distribute_pytree
    from ray_tpu_torch.train import adamw, make_train_step

    _fresh_phase(torch)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    mesh = build_mesh(MeshSpec())
    mesh_s = time.perf_counter() - t0
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            "the mesh's group is not a world-1 NCCL group")
    coll = _collectives_world_one(torch, mesh)
    emit({"phase": "parallel", "part": "collectives", "mesh_s": mesh_s,
          "backend": dist.get_backend(), **coll, "nvidia_smi": card})

    # (b) the 8B step through the mesh
    cfg = LLAMA_CONFIGS["8b"]
    _fresh_phase(torch)
    t0 = time.perf_counter()
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: lm_loss(p, b, cfg, mesh=mesh),
        adamw(3e-4, weight_decay=0.1), device="cuda",
        model_flops_per_token=_model_flops_per_token(cfg, TRAIN_S),
        mesh=mesh, param_axes=param_logical_axes(cfg))
    state = init_fn(init_params(cfg, seed=7, device="cuda"))
    batch = place_batch(_train_batch(torch, cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state, losses, norms, step_ms, tok_s, counts, m = _timed_steps(
        torch, step_fn, state, batch, TRAIN_B * TRAIN_S)
    want = _want_train_counts(cfg.n_layers)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rel = lambda a, b: abs(a - b) / abs(b)
    train = _TRAIN or {}
    line = {"phase": "parallel", "part": "train_8b_mesh",
            "mesh": "MeshSpec() (world 1, NCCL)", "init_s": init_s,
            "loss": losses, "grad_norm": norms, "step_ms": step_ms,
            "mean_step_ms": sum(step_ms) / 3, "tok_s": tok_s,
            "peak_mem_gb": peak, "launches": counts,
            "expected_launches": want, "nvidia_smi": card}
    if train:
        line.update({
            "train_phase_loss": train["loss"],
            "train_phase_grad_norm": train["grad_norm"],
            "train_phase_step_ms": train["step_ms"],
            "train_phase_mean_step_ms": sum(train["step_ms"]) / 3,
            "train_phase_peak_mem_gb": train["peak_mem_gb"],
            "loss_bit_equal": losses == train["loss"],
            "grad_norm_bit_equal": norms == train["grad_norm"],
            "max_rel_loss": max(map(rel, losses, train["loss"])),
            "max_rel_grad_norm": max(map(rel, norms, train["grad_norm"]))})
    emit(line)
    _check_training(torch, losses, norms, counts, want, m)
    if train:
        require(line["max_rel_loss"] <= 2 ** -8
                and line["max_rel_grad_norm"] <= 2 ** -8,
                "the mesh step's losses or grad norms part from the train "
                f"phase's: {losses} {norms} against {train['loss']} "
                f"{train['grad_norm']}")
    del state, batch, m
    _fresh_phase(torch)

    # (c) the forward with mesh= and without, on the same weights
    params = init_params(cfg, seed=7, device="cuda")
    tokens = _train_batch(torch, cfg)["tokens"].cuda()
    fwd_before = _train_counts()
    with torch.no_grad():
        plain = forward(params, tokens, cfg)
        placed = distribute_pytree(params, param_logical_axes(cfg), mesh)
        meshed = forward(placed, tokens, cfg, mesh=mesh).full_tensor()
    torch.cuda.synchronize()
    fwd_counts = {k: v - fwd_before[k] for k, v in _train_counts().items()}
    equal = bool(torch.equal(plain, meshed))
    emit({"phase": "parallel", "part": "forward_8b",
          "logits_equal": equal,
          "max_abs_diff": (plain - meshed).abs().max().item(),
          "launches": fwd_counts,
          "seconds": time.perf_counter() - t_phase})
    require(equal, "the 8B logits with mesh= differ from those without")
    require(fwd_counts["flash_fwd"] == 2 * cfg.n_layers
            == fwd_counts["flash_fwd_tc"],
            f"forward launches {fwd_counts}")
    del params, placed, plain, meshed
    _fresh_phase(torch)
    dist.destroy_process_group()
    return _train_counts()


# --- the multi-device plane across four cards (parallel4) -------------------
#
# The rank bodies run on the card (NCCL, one card a rank) in the parallel4
# phase and on the CPU (gloo) in tests/test_torch_parallel4.py, at a tiny
# size, through the same functions: p4_run spawns the ranks, each joins
# through init_torch_distributed and runs the named jobs in order.

P4_WORLD = 4
P4_COLL_SHAPE = (4, 8)          # both dims divide by the group sizes 2 and 4
P4_F32 = dict(rtol=1e-5, atol=1e-5)    # the gloo tests' tolerances
P4_BF16 = dict(rtol=2e-2, atol=2e-2)
P4_GRAD = dict(rtol=1e-4, atol=1e-4)
P4_LOGITS = dict(rtol=2e-4, atol=2e-4)
P4_LAYOUTS = ({"dp": 4}, {"fsdp": 4}, {"fsdp": 2, "tp": 2},
              {"sp": 2, "tp": 2})
P4_TRAIN_LAYOUTS = ({"fsdp": 4}, {"fsdp": 2, "tp": 2})
P4_BW_SIZES = tuple(1 << s for s in (20, 24, 28, 30, 32))  # 1 MiB..4 GiB
P4_TRAIN_B = 4                  # the 8B step's global batch on four cards
# the 8B step on four cards against the same step on one card, relative:
# the first loss, the first gradient's norm, the loss after one update
P4_TRAIN_TOL = {"loss": 1e-4, "grad_norm": 2e-3, "loss2": 1e-3}


def _p4_sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def p4_free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p4_run(world, device, jobs, timeouts):
    """Spawn ``world`` ranks joined by ``init_torch_distributed`` over
    ``tcp://127.0.0.1:<free port>`` (NCCL on ``device="cuda"``, gloo on
    "cpu") that run ``jobs`` ((name, kwargs) of P4_JOBS) in order. Yields
    (name, per-rank results) as each job ends on every rank, the first
    being ("init", ...). A rank that fails, or a job that outlasts its
    timeout (``timeouts[name]``, s), kills every rank and raises
    SmokeFailure."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    address = f"127.0.0.1:{p4_free_port()}"
    procs = [ctx.Process(target=_p4_rank, daemon=True, args=(
        r, world, address, device, jobs, out))
        for r in range(world)]
    for p in procs:
        p.start()
    done = False
    try:
        for name, _ in [("init", None)] + list(jobs):
            got = [None] * world
            deadline = time.monotonic() + timeouts.get(name, 300)
            for _ in range(world):
                try:
                    rank, job, ok, value = out.get(
                        timeout=max(deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    raise SmokeFailure(
                        f"parallel4 {name}: a rank did not answer within "
                        f"{timeouts.get(name, 300)} s") from None
                if not ok:
                    raise SmokeFailure(
                        f"parallel4 {job} failed on rank {rank}:\n{value}")
                got[rank] = value
            yield name, got
        done = True
    finally:
        for p in procs:
            if done:
                p.join(60)
            if p.is_alive():
                p.kill()
            p.join(10)


def _p4_rank(rank, world, address, device, jobs, out):
    import traceback
    import types

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    job = "init"
    try:
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.train import init_torch_distributed

        ctx = types.SimpleNamespace(coordinator_address=address,
                                    world_size=world, rank=rank)
        made = init_torch_distributed(ctx, device=device, timeout_s=300)
        where = {"made": made, "backend": dist.get_backend(),
                 "world": dist.get_world_size(),
                 "device": str(resolve_device(device))}
        if device == "cuda":
            # one host: the local rank is the rank
            where["current"] = torch.cuda.current_device()
            if where["current"] != rank or where["device"] != f"cuda:{rank}":
                raise RuntimeError(f"rank {rank} is on {where}, not "
                                   f"cuda:{rank}")
        out.put((rank, job, True, where))
        for job, kwargs in jobs:
            out.put((rank, job, True, P4_JOBS[job](torch, device,
                                                   **kwargs)))
    except Exception:
        out.put((rank, job, False, traceback.format_exc()))
        return
    dist.destroy_process_group()


def _p4_np(torch, t):
    from torch.distributed.tensor import DTensor

    if isinstance(t, dict):
        return {k: _p4_np(torch, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_p4_np(torch, v) for v in t)
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return t


# (a) collectives ------------------------------------------------------------

def p4_coll_input(rank, kind):
    """Rank ``rank``'s (4, 8) input: integer-valued in [-3, 3] (every
    reduction of four exact in bf16 and f32) or standard normal."""
    import numpy as np

    rng = np.random.default_rng(1000 + rank + (0 if kind == "int" else 100))
    if kind == "int":
        return rng.integers(-3, 4, P4_COLL_SHAPE).astype(np.float32)
    return rng.standard_normal(P4_COLL_SHAPE).astype(np.float32)


# (mesh spec, axis, the ranks of each group in group order); rank r's
# group is the one holding r
P4_COLL_MESHES = (
    ({"dp": 4}, "dp", ((0, 1, 2, 3),)),
    ({"dp": 2, "tp": 2}, "tp", ((0, 1), (2, 3))),
    ({"dp": 2, "tp": 2}, ("dp", "tp"), ((0, 1, 2, 3),)),
)
P4_SYMBOLIC = ("allreduce_sum", "allreduce_mean", "allreduce_max",
               "allreduce_min", "allreduce_prod", "allgather",
               "allgather_untiled_1", "reducescatter_sum_1",
               "reducescatter_mean_1", "broadcast_last", "alltoall_1_0",
               "send_1", "recv_1")
P4_EAGER = ("allreduce_sum", "allreduce_mean", "allreduce_max",
            "allreduce_min", "allreduce_prod", "allgather",
            "reducescatter_sum", "reducescatter_mean", "broadcast_last",
            "shift_1")


def _p4_symbolic(par, axis, n):
    return {
        "allreduce_sum": lambda s: par.allreduce(s, axis, "sum"),
        "allreduce_mean": lambda s: par.allreduce(s, axis, "mean"),
        "allreduce_max": lambda s: par.allreduce(s, axis, "max"),
        "allreduce_min": lambda s: par.allreduce(s, axis, "min"),
        "allreduce_prod": lambda s: par.allreduce(s, axis, "prod"),
        "allgather": lambda s: par.allgather(s, axis),
        "allgather_untiled_1": lambda s: par.allgather(
            s, axis, concat_axis=1, tiled=False),
        "reducescatter_sum_1": lambda s: par.reducescatter(
            s, axis, scatter_axis=1),
        "reducescatter_mean_1": lambda s: par.reducescatter(
            s, axis, scatter_axis=1, op="mean"),
        "broadcast_last": lambda s: par.broadcast(s, axis, root=n - 1),
        "alltoall_1_0": lambda s: par.alltoall(s, axis, split_axis=1,
                                               concat_axis=0),
        "send_1": lambda s: par.send(s, axis, shift=1),
        "recv_1": lambda s: par.recv(s, axis, shift=1)}


def _p4_eager(group, n):
    return {
        **{f"allreduce_{op}": (lambda s, op=op: group.allreduce(s, op))
           for op in ("sum", "mean", "max", "min", "prod")},
        "allgather": group.allgather,
        "reducescatter_sum": group.reducescatter,
        "reducescatter_mean": lambda s: group.reducescatter(s, op="mean"),
        "broadcast_last": lambda s: group.broadcast(s, root=n - 1),
        "shift_1": lambda s: group.shift(s, shift=1)}


def p4_collectives(torch, device):
    """Every symbolic op (in rank_region) over each P4_COLL_MESHES axis,
    and every eager op (pgroup) over dp=4, on this rank's inputs of both
    kinds in f32 and bf16: {key: result as f32 numpy}, key
    "<mode>|<mesh>|<axis>|<op>|<dtype>|<kind>"."""
    import ray_tpu_torch.parallel as par
    from ray_tpu_torch.parallel.collectives import rank_region

    import torch.distributed as dist

    rank = dist.get_rank()
    out = {}
    for spec, axis, groups in P4_COLL_MESHES:
        mesh = par.build_mesh(par.MeshSpec(**spec), device=device)
        n = len(groups[0])
        eager = par.pgroup(mesh, axis) if isinstance(axis, str) and \
            spec == {"dp": 4} else None
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("int", "normal"):
                x = torch.from_numpy(p4_coll_input(rank, kind)).to(
                    device=device, dtype=dtype)
                tag = f"{_p4_spec_name(spec)}|{axis}|"
                dt = str(dtype).split(".")[-1]
                with rank_region(mesh):
                    for name, fn in _p4_symbolic(par, axis, n).items():
                        out[f"symbolic|{tag}{name}|{dt}|{kind}"] = _p4_np(
                            torch, fn(x))
                if eager is not None:
                    for name, fn in _p4_eager(eager, n).items():
                        out[f"eager|{tag}{name}|{dt}|{kind}"] = _p4_np(
                            torch, fn(x))
        if eager is not None:
            eager.barrier()
            eager.barrier(timeout_s=60)
            par.barrier(mesh, timeout_s=60)
    _p4_sync(torch, device)
    return out


def _p4_spec_name(spec):
    return ",".join(f"{k}={v}" for k, v in spec.items())


def _p4_round(x, dtype):
    import numpy as np
    import torch

    if dtype == "float32":
        return x.astype(np.float64)
    return torch.from_numpy(x).bfloat16().double().numpy()


def p4_collectives_expected(world=P4_WORLD):
    """What each rank's p4_collectives must give, computed with numpy in
    f64 from every rank's inputs (rounded to the dtype first): {rank:
    {key: array}}."""
    import numpy as np

    want = {r: {} for r in range(world)}
    for spec, axis, groups in P4_COLL_MESHES:
        for dt in ("float32", "bfloat16"):
            for kind in ("int", "normal"):
                xs = [_p4_round(p4_coll_input(r, kind), dt)
                      for r in range(world)]
                tag = f"{_p4_spec_name(spec)}|{axis}|"
                for g in groups:
                    n = len(g)
                    mine = [xs[r] for r in g]
                    total = np.sum(mine, axis=0)
                    for i, r in enumerate(g):
                        red = {"allreduce_sum": total,
                               "allreduce_mean": total / n,
                               "allreduce_max": np.max(mine, axis=0),
                               "allreduce_min": np.min(mine, axis=0),
                               "allreduce_prod": np.prod(mine, axis=0),
                               "allgather": np.concatenate(mine, 0),
                               "broadcast_last": mine[n - 1]}
                        sym = dict(red)
                        sym.update({
                            "allgather_untiled_1": np.stack(mine, 1),
                            "reducescatter_sum_1":
                                np.split(total, n, 1)[i],
                            "reducescatter_mean_1":
                                np.split(total, n, 1)[i] / n,
                            "alltoall_1_0": np.concatenate(
                                [np.split(m, n, 1)[i] for m in mine], 0),
                            "send_1": mine[(i - 1) % n],
                            "recv_1": mine[(i + 1) % n]})
                        for name in P4_SYMBOLIC:
                            want[r][f"symbolic|{tag}{name}|{dt}|{kind}"] = \
                                sym[name]
                        if spec != {"dp": 4}:
                            continue
                        eag = dict(red)
                        eag.update({
                            "reducescatter_sum": np.split(total, n, 0)[i],
                            "reducescatter_mean":
                                np.split(total, n, 0)[i] / n,
                            "shift_1": mine[(i - 1) % n]})
                        for name in P4_EAGER:
                            want[r][f"eager|{tag}{name}|{dt}|{kind}"] = \
                                eag[name]
    return want


def p4_collectives_errors(got, want):
    """Checks of every rank's results: integer-valued inputs exactly,
    normal ones at P4_F32 / P4_BF16. Returns (checked, failures)."""
    import numpy as np

    failures, checked = [], 0
    for r, res in enumerate(got):
        if set(res) != set(want[r]):
            failures.append((r, "keys", sorted(set(res) ^ set(want[r]))))
            continue
        for key, w in want[r].items():
            g = np.asarray(res[key], np.float64)
            checked += 1
            if g.shape != w.shape:
                failures.append((r, key, "shape", g.shape, w.shape))
            elif key.endswith("|int"):
                if not np.array_equal(g, w):
                    failures.append((r, key, float(np.abs(g - w).max())))
            else:
                tol = P4_F32 if "|float32|" in key else P4_BF16
                if not np.allclose(g, w, **tol):
                    failures.append((r, key, float(np.abs(g - w).max())))
    return checked, failures


def p4_bandwidth(torch, device, sizes=P4_BW_SIZES, iters=(20, 5)):
    """Bus bandwidth of all-reduce, all-gather and reduce-scatter of bf16
    over dp=4, by NCCL's own convention (size: the all-reduce's buffer,
    the all-gather's output, the reduce-scatter's input; bus bytes:
    2(n-1)/n of it for all-reduce, (n-1)/n for the others), each through
    the mesh's process group directly and through the port's pgroup
    (which adds its copies). Device time by CUDA events on the card; the
    host clock on the CPU. ``iters``: timed calls below 256 MiB and from
    it."""
    import ray_tpu_torch.parallel as par

    import torch.distributed as dist

    mesh = par.build_mesh(par.MeshSpec(dp=P4_WORLD), device=device)
    group, eager = mesh.get_group("dp"), par.pgroup(mesh, "dp")
    n = P4_WORLD
    cuda = torch.device(device).type == "cuda"
    rows = []
    for size in sizes:
        reps = iters[0] if size < (1 << 28) else iters[1]
        elems = size // 2
        full = torch.ones(elems, dtype=torch.bfloat16, device=device)
        part = torch.ones(elems // n, dtype=torch.bfloat16, device=device)
        calls = {
            "allreduce": (lambda: dist.all_reduce(full, group=group),
                          lambda: eager.allreduce(full), 2 * (n - 1) / n),
            "allgather": (lambda: dist.all_gather_into_tensor(
                full, part, group=group), lambda: eager.allgather(part),
                (n - 1) / n),
            "reducescatter": (lambda: dist.reduce_scatter_tensor(
                part, full, group=group), lambda: eager.reducescatter(full),
                (n - 1) / n)}
        for op, (raw, port, bus) in calls.items():
            row = {"op": op, "bytes": size, "reps": reps}
            for which, fn in (("nccl", raw), ("port", port)):
                fn()
                _p4_sync(torch, device)
                dist.barrier(group=group)
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(reps):
                        fn()
                    end.record()
                    torch.cuda.synchronize()
                    ms = start.elapsed_time(end) / reps
                else:
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn()
                    ms = (time.perf_counter() - t0) * 1e3 / reps
                row[f"{which}_ms"] = ms
                row[f"{which}_busbw_gbs"] = size * bus / (ms / 1e3) / 1e9
            rows.append(row)
        del full, part
        if cuda:
            torch.cuda.empty_cache()
    return rows


# (b) the four-rank layouts of a small f32 Llama ----------------------------

def p4_tiny_data(torch):
    """The layouts' tokens (B=4, S=32) and two training batches (B=4,
    S=24, the second masked), from seeds."""
    import numpy as np

    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, (4, 32)).astype(np.int64)
    batches = []
    for i in range(2):
        b = {"tokens": np.random.default_rng(36 + i).integers(
            0, 256, (4, 24)).astype(np.int64)}
        if i == 1:
            mask = np.ones((4, 24), np.int64)
            mask[0, 14:] = 0
            b["mask"] = mask
        batches.append(b)
    return tokens, batches


def p4_layout(torch, device, spec=None):
    """Llama ``tiny`` (f32, seed 0) under ``spec`` (unsharded with None):
    its logits on p4_tiny_data's tokens, then 2 steps of adamw(1e-3):
    the losses and grad norms, and the params after; unsharded, also the
    first step's gradients."""
    from ray_tpu_torch._private.tree import tree_map
    from ray_tpu_torch.models import (LLAMA_CONFIGS, forward, init_params,
                                      lm_loss, param_logical_axes,
                                      params_to_numpy)
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import distribute_pytree
    from ray_tpu_torch.train import adamw, make_train_step

    cfg = LLAMA_CONFIGS["tiny"]
    tokens, batches = p4_tiny_data(torch)
    # drawn on the CPU: a card's generator draws other values
    params = tree_map(lambda t: t.to(device),
                      init_params(cfg, seed=0, device="cpu"))
    mesh = (build_mesh(MeshSpec(**spec), device=device) if spec else None)
    tok = torch.from_numpy(tokens).to(device)
    with torch.no_grad():
        if mesh is None:
            logits = forward(params, tok, cfg)
        else:
            logits = forward(distribute_pytree(
                params, param_logical_axes(cfg), mesh), tok, cfg, mesh=mesh)
    grad1 = None
    if mesh is None:
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        lm_loss(p, {k: torch.from_numpy(v).to(device)
                    for k, v in batches[0].items()}, cfg).backward()
        grad1 = params_to_numpy(tree_map(lambda t: t.grad, p))
    kw = ({} if mesh is None else
          {"mesh": mesh, "param_axes": param_logical_axes(cfg)})
    init_fn, step_fn, place = make_train_step(
        lambda p, b: lm_loss(p, b, cfg, mesh=mesh), adamw(1e-3),
        device=device, **kw)
    state = init_fn(params)
    metrics = []
    for b in batches:
        state, m = step_fn(state, place(b))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    full = tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                    else t, state.params)
    return {"logits": _p4_np(torch, logits), "metrics": metrics,
            "params": params_to_numpy(full), "grad1": grad1}


# (c) MoE at ep=4 and the pipeline over four stages --------------------------

def p4_moe_weights():
    """x (4, 16, 8), router (8, 4), gate, up (4, 8, 16), down (4, 16, 8):
    4 experts, one a rank at ep=4."""
    import numpy as np

    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(4, 16, 8), f(8, 4) * 0.1, f(4, 8, 16) * 0.2,
            f(4, 8, 16) * 0.2, f(4, 16, 8) * 0.2)


def p4_moe(torch, device, sharded=True):
    """moe_mlp on MeshSpec(ep=4) (experts over ep, tokens replicated,
    ``csl`` the constraint), or unsharded; and moe_mlp_oracle."""
    import functools

    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.ops.moe import moe_mlp, moe_mlp_oracle
    from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                        with_sharding_constraint_logical)
    from ray_tpu_torch.parallel.mesh import active_mesh
    from ray_tpu_torch.parallel.sharding import placements_for

    arrays = [torch.from_numpy(a).to(device) for a in p4_moe_weights()]
    kw = {"top_k": 2, "capacity_factor": 8.0}
    if not sharded:
        out, aux = moe_mlp(*arrays, **kw)
        return {"out": _p4_np(torch, out), "aux": float(aux),
                "oracle": _p4_np(torch, moe_mlp_oracle(*arrays, top_k=2))}
    mesh = build_mesh(MeshSpec(ep=P4_WORLD), device=device)
    axes = (("batch", "seq", "embed"), ("embed", "expert"),
            ("expert", "embed", "mlp"), ("expert", "embed", "mlp"),
            ("expert", "mlp", "embed"))
    placed = [distribute_tensor(t, active_mesh(mesh),
                                placements_for(t.shape, ax, mesh))
              for t, ax in zip(arrays, axes)]
    csl = functools.partial(with_sharding_constraint_logical, mesh=mesh)
    out, aux = moe_mlp(*placed, csl=csl, **kw)
    return {"out": _p4_np(torch, out), "aux": float(_p4_np(torch, aux)),
            "w_gate": str(tuple(placed[2].placements))}


def p4_pipeline_data():
    """An 8-layer tanh stack of width 16 and x (16, 16)."""
    import numpy as np

    rng = np.random.default_rng(7)
    w = (rng.standard_normal((8, 16, 16)) * 16 ** -0.5).astype(np.float32)
    return ({"w": w, "b": np.zeros((8, 16), np.float32)},
            rng.standard_normal((16, 16)).astype(np.float32))


def _p4_tanh(params, x):
    import torch

    for i in range(params["w"].shape[0]):
        x = torch.tanh(x @ params["w"][i] + params["b"][i])
    return x


def p4_pipeline(torch, device, sharded=True):
    """The stack over pp=4 stages, 8 microbatches (or serially): the
    output and the gradients of sum(out ** 2) for the stacked params."""
    from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                        pipeline_apply, split_stages)

    params, x = p4_pipeline_data()
    p = {k: torch.from_numpy(v).to(device).requires_grad_()
         for k, v in params.items()}
    xt = torch.from_numpy(x).to(device)
    if sharded:
        mesh = build_mesh(MeshSpec(pp=P4_WORLD), device=device)
        out = pipeline_apply(mesh, _p4_tanh, split_stages(p, P4_WORLD), xt,
                             microbatches=8)
    else:
        out = _p4_tanh(p, xt)
    (out ** 2).sum().backward()
    return {"out": _p4_np(torch, out),
            "grad": {k: _p4_np(torch, t.grad) for k, t in p.items()}}


# (d) a Llama trained 1+3 steps under a four-card layout ---------------------

def p4_llama_cfg(name, **overrides):
    import dataclasses

    from ray_tpu_torch.models import LLAMA_CONFIGS

    return dataclasses.replace(LLAMA_CONFIGS[name], **overrides)


def p4_train_tokens(torch, vocab, B, S, seed=7):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (B, S), generator=g, dtype=torch.int32)


def p4_sequence_losses(torch, params, cfg, tokens):
    """The one-device lm_loss of each sequence of ``tokens`` alone."""
    from ray_tpu_torch.models import lm_loss

    with torch.no_grad():
        return [lm_loss(params, {"tokens": tokens[i:i + 1]}, cfg).item()
                for i in range(tokens.shape[0])]


def p4_one_device_step(torch, device, cfg, B, S, seed=7):
    """The sharded trainer's first step on one device, a sequence at a
    time: ``cfg`` from ``seed`` under make_train_step with
    adamw(3e-4, weight_decay=0.1), the gradients of the mean of the B
    sequences' losses summed in the params' dtype, one update. Returns
    the sequences' losses before the update, the batch loss before and
    after it, and the first gradient's norm (as step_fn takes it)."""
    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.models import init_params, lm_loss
    from ray_tpu_torch.train import adamw, make_train_step

    opt = adamw(3e-4, weight_decay=0.1)
    init_fn, _, _ = make_train_step(lambda p, b: lm_loss(p, b, cfg), opt,
                                    device=device)
    state = init_fn(init_params(cfg, seed=seed, device=device))
    tokens = p4_train_tokens(torch, cfg.vocab, B, S, seed).to(device)
    seq_losses = []
    for i in range(B):
        loss = lm_loss(state.params, {"tokens": tokens[i:i + 1]}, cfg)
        (loss / B).backward()
        seq_losses.append(loss.item())
    leaves = tree_leaves(state.params)
    grads = [p.grad for p in leaves]
    with torch.no_grad():
        norm = torch.stack([
            torch.linalg.vector_norm(g, dtype=torch.float32).square()
            for g in grads]).sum().sqrt().item()
        opt.update_(state.params, grads, state.opt_state)
    for p in leaves:
        p.grad = None
    after = p4_sequence_losses(torch, state.params, cfg, tokens)
    del state, grads, leaves
    return {"sequence_losses": seq_losses,
            "loss": [sum(seq_losses) / B, sum(after) / B],
            "grad_norm": norm}


def p4_train_errors(got, ref, tol):
    """Every rank's first loss, first grad norm and second loss (after one
    update) against ``ref`` (p4_one_device_step's), each relative to the
    reference's and within ``tol``'s "loss", "grad_norm" and "loss2";
    every loss and grad norm finite, the loss falling, 4 steps taken and
    the ranks' losses equal. Returns (ok, the largest relative errors)."""
    errs = {"loss": 0.0, "grad_norm": 0.0, "loss2": 0.0}
    ok = True
    for r in got:
        for key, g, w in (("loss", r["loss"][0], ref["loss"][0]),
                          ("grad_norm", r["grad_norm"][0], ref["grad_norm"]),
                          ("loss2", r["loss"][1], ref["loss"][1])):
            rel = abs(g - w) / abs(w)
            errs[key] = max(errs[key], rel)
            ok = ok and rel <= tol[key]
        ok = (ok and all(math.isfinite(x) for x in r["loss"] + r["grad_norm"])
              and r["loss"][-1] < r["loss"][0] and r["step"] == 4
              and r["loss"] == got[0]["loss"])
    return ok, errs


def p4_train(torch, device, spec, cfg_name, cfg_overrides, B, S, seed=7):
    """``cfg_name`` (with ``cfg_overrides``) from ``seed``, trained by
    make_train_step(mesh=build_mesh(MeshSpec(**spec))) with
    adamw(3e-4, weight_decay=0.1) on a global batch of B sequences of S
    tokens: one warm-up step and 3 timed ones (step ms), the launches of
    the timed steps, the peak; on the card, one more step, traced on rank
    0 (device time split by kernel family, busy share)."""
    import torch.distributed as dist

    from ray_tpu_torch.models import init_params, lm_loss, param_logical_axes
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train import adamw, make_train_step

    cuda = torch.device(device).type == "cuda"
    cfg = p4_llama_cfg(cfg_name, **cfg_overrides)
    if cuda:
        _fresh_phase(torch)
    t0 = time.perf_counter()
    mesh = build_mesh(MeshSpec(**spec), device=device)
    init_fn, step_fn, place = make_train_step(
        lambda p, b: lm_loss(p, b, cfg, mesh=mesh),
        adamw(3e-4, weight_decay=0.1), device=device, mesh=mesh,
        param_axes=param_logical_axes(cfg))
    state = init_fn(init_params(cfg, seed=seed, device=device))
    batch = place({"tokens": p4_train_tokens(torch, cfg.vocab, B, S, seed)})
    _p4_sync(torch, device)
    init_s = time.perf_counter() - t0
    state, m = step_fn(state, batch)
    losses, norms = [m["loss"].item()], [m["grad_norm"].item()]
    _zero_counts()
    step_ms = []
    for _ in range(3):
        _p4_sync(torch, device)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        _p4_sync(torch, device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    out = {"spec": spec, "init_s": init_s, "loss": losses,
           "grad_norm": norms, "step_ms": step_ms, "launches": _train_counts(),
           "step": int(m["step"])}
    if cuda:
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["card_mem_gb"] = (torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory / 1e9)

        def one():
            nonlocal state
            state, _ = step_fn(state, batch)

        if dist.get_rank() == 0:
            window, prof = _profile_window(torch, one)
            out["trace"] = {**window, "split_ms": _p4_split(prof),
                            "flash": _flash_split(prof)}
        else:
            one()
            _p4_sync(torch, device)
    del state, batch, m
    return out


def _p4_split(prof):
    """A traced window's device ms by family: NCCL kernels, GEMMs, the
    three flash kernels, the rest. The device-side ``nccl:*`` ranges
    (one a collective, spanning its kernel) and the trainer's ranges are
    not kernels and are left out."""
    from torch.autograd import DeviceType

    flash = tuple(n for names in KERNEL_NAMES.values() for n in names)
    split = {"nccl": 0.0, "gemm": 0.0, "flash": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith(
                ("train.", "grpo.", "nccl:")):
            continue
        name = e.name.lower()
        fam = ("nccl" if "nccl" in name else
               "flash" if any(f in e.name for f in flash) else
               "gemm" if any(w in name for w in GEMM_WORDS) else "other")
        split[fam] += (e.time_range.end - e.time_range.start) / 1e3
    return split


P4_JOBS = {"collectives": p4_collectives, "bandwidth": p4_bandwidth,
           "layout": p4_layout, "moe": p4_moe, "pipeline": p4_pipeline,
           "train": p4_train}


P4_TIMEOUTS = {"init": 240, "collectives": 240, "bandwidth": 240,
               "layout": 300, "moe": 180, "pipeline": 180, "train": 600}


def _p4_max_err(got, want):
    """The largest |got - want| over two equal trees of arrays, or inf
    where their structure or a shape differs."""
    import numpy as np

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return math.inf
        return max([_p4_max_err(got[k], want[k]) for k in want] or [0.0])
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape:
        return math.inf
    return float(np.abs(g - w).max()) if g.size else 0.0


def _p4_close(got, want, tol):
    """Whether two equal trees of arrays agree within ``tol``."""
    import numpy as np

    if isinstance(want, dict):
        return (isinstance(got, dict) and set(got) == set(want)
                and all(_p4_close(got[k], want[k], tol) for k in want))
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return g.shape == w.shape and bool(np.allclose(g, w, **tol))


# Adam's first update of an element is lr * g / (|g| + eps): lr * sign(g)
# wherever |g| is well above eps = 1e-8, so there the params after two
# steps hold the gloo tests' 1e-5. Where the unsharded gradient is at the
# rounding level of its sum (below P4_GRAD_FLOOR), another summation order
# (the sharded one) moves the element by another fraction of lr; there the
# bound is Adam's step, P4_ADAM_MOVE. ray_tpu's own sharded step parts from
# its unsharded one the same way (sp=2, tp=2: one element of tiny, 3.2e-5).
P4_GRAD_FLOOR = 1e-6
P4_ADAM_MOVE = 4e-3             # 2 steps of at most 2 lr (lr 1e-3)


def _p4_params_check(got, want, grad1):
    """(ok, max error where |grad| >= P4_GRAD_FLOOR, elements below the
    floor that part by more than 1e-5, their largest difference)."""
    import numpy as np

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return False, math.inf, 0, math.inf
        parts = [_p4_params_check(got[k], want[k], grad1[k]) for k in want]
        return (all(p[0] for p in parts), max(p[1] for p in parts),
                sum(p[2] for p in parts), max(p[3] for p in parts))
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape:
        return False, math.inf, 0, math.inf
    big = np.abs(np.asarray(grad1)) >= P4_GRAD_FLOOR
    diff = np.abs(g - w)
    held = np.isclose(g, w, **P4_F32)
    noisy = ~big & ~held
    ok = bool(held[big].all()) and bool((diff[~big] <= P4_ADAM_MOVE).all())
    return (ok, float(diff[big].max()) if big.any() else 0.0,
            int(noisy.sum()), float(diff[noisy].max()) if noisy.any() else 0.0)


def p4_layout_errors(got, want):
    """Each rank's logits (P4_LOGITS), losses and grad norms (P4_F32) and
    params after 2 steps (P4_F32 where the first gradient is above the
    rounding floor, P4_ADAM_MOVE below it) against the unsharded run:
    (ok, max errors and the count of elements at the floor that part)."""
    errs = {"logits": 0.0, "metrics": 0.0, "params": 0.0,
            "params_at_grad_floor": 0, "params_at_grad_floor_max": 0.0}
    ok = True
    for r in got:
        p_ok, p_err, n_noisy, noisy_err = _p4_params_check(
            r["params"], want["params"], want["grad1"])
        errs["logits"] = max(errs["logits"],
                             _p4_max_err(r["logits"], want["logits"]))
        errs["metrics"] = max(errs["metrics"],
                              _p4_max_err(r["metrics"], want["metrics"]))
        errs["params"] = max(errs["params"], p_err)
        errs["params_at_grad_floor"] = max(errs["params_at_grad_floor"],
                                           n_noisy)
        errs["params_at_grad_floor_max"] = max(
            errs["params_at_grad_floor_max"], noisy_err)
        ok = ok and p_ok \
            and _p4_close(r["logits"], want["logits"], P4_LOGITS) \
            and _p4_close(r["metrics"], want["metrics"], P4_F32)
    return ok, errs


def p4_moe_errors(got, want):
    """Each rank's output against the unsharded moe_mlp and the oracle
    (P4_GRAD, the gloo tests' 1e-4), its aux loss at 1e-5 relative."""
    ok = all(_p4_close(r["out"], want["out"], P4_GRAD)
             and _p4_close(r["out"], want["oracle"], P4_GRAD)
             and abs(r["aux"] - want["aux"]) <= 1e-5 * abs(want["aux"])
             for r in got)
    return ok, {"out": max(_p4_max_err(r["out"], want["out"]) for r in got),
                "aux": max(abs(r["aux"] - want["aux"]) for r in got)}


def p4_pipeline_errors(got, want):
    """Each rank's output (P4_F32) and gradients (P4_GRAD) against the
    serial stack's."""
    ok = all(_p4_close(r["out"], want["out"], P4_F32)
             and _p4_close(r["grad"], want["grad"], P4_GRAD) for r in got)
    return ok, {"out": max(_p4_max_err(r["out"], want["out"]) for r in got),
                "grad": max(_p4_max_err(r["grad"], want["grad"])
                            for r in got)}


def _p4_cards():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()


def phase_parallel4(torch, card):
    """The multi-device plane across four cards over NCCL, one rank a
    card: (a) every collective against numpy, and the bus bandwidth of
    all-reduce, all-gather and reduce-scatter from 1 MiB to 4 GiB; (b)
    Llama tiny (f32) under dp=4, fsdp=4, fsdp=2 tp=2 and sp=2 tp=2
    against the same model unsharded on card 0; (c) MoE at ep=4 and the
    pipeline over 4 stages against their unsharded runs; (d) Llama-3-8B
    (bf16, seed 7, remat full, adamw(3e-4, weight_decay=0.1)) trained 1+3
    steps on a global batch of 4 x 2048 tokens under fsdp=4 and fsdp=2
    tp=2, against the same first step on card 0 a sequence at a time
    (p4_one_device_step), beside the one-card step (the train phase's,
    run here)."""
    from ray_tpu_torch.ops import _kernels

    n = torch.cuda.device_count()
    require(n >= P4_WORLD,
            f"parallel4 needs {P4_WORLD} cards, this machine has {n}")
    cards = _p4_cards()
    # how the cards are joined: nvidia-smi's matrix and link status where
    # the machine lets it read them, and CUDA's peer access
    links = {}
    for args in (("topo", "-m"), ("nvlink", "--status")):
        r = subprocess.run(["nvidia-smi", *args], capture_output=True,
                           text=True, timeout=60)
        links[" ".join(args)] = (r.stdout + r.stderr).strip().splitlines()
    emit({"phase": "parallel4", "part": "topology", "cards": n,
          "nvidia_smi": cards, "links": links,
          "peer_access": [[i == j or torch.cuda.can_device_access_peer(i, j)
                           for j in range(n)] for i in range(n)]})
    # every rank loads the libraries this builds
    for name in _kernels.build_all():
        _kernels.lib(name)

    # the unsharded runs on card 0
    t0 = time.perf_counter()
    want_coll = p4_collectives_expected()
    ref_layout = p4_layout(torch, "cuda")
    ref_moe = p4_moe(torch, "cuda", sharded=False)
    ref_pipe = p4_pipeline(torch, "cuda", sharded=False)
    _fresh_phase(torch)
    ref_step = p4_one_device_step(torch, "cuda", p4_llama_cfg("8b"),
                                  P4_TRAIN_B, TRAIN_S)
    _fresh_phase(torch)
    cfg, state, step_fn, batch = _build_8b_trainer(torch)
    state, losses, norms, step_ms, tok_s, counts, m = _timed_steps(
        torch, step_fn, state, batch, TRAIN_B * TRAIN_S)
    _check_training(torch, losses, norms, counts,
                    _want_train_counts(cfg.n_layers), m)
    one_card = {"loss": losses, "grad_norm": norms, "step_ms": step_ms,
                "mean_step_ms": sum(step_ms) / 3, "tok_s": tok_s,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit({"phase": "parallel4", "part": "one_card", "model": "llama3-8b",
          "batch": TRAIN_B, "seq": TRAIN_S, **one_card,
          "one_card_step": {"batch": P4_TRAIN_B, **ref_step},
          "seconds": time.perf_counter() - t0, "nvidia_smi": cards})
    del state, batch, m, step_fn
    _fresh_phase(torch)

    jobs = ([("collectives", {}), ("bandwidth", {})]
            + [("layout", {"spec": s}) for s in P4_LAYOUTS]
            + [("moe", {}), ("pipeline", {})]
            + [("train", {"spec": s, "cfg_name": "8b", "cfg_overrides": {},
                          "B": P4_TRAIN_B, "S": TRAIN_S})
               for s in P4_TRAIN_LAYOUTS])
    layouts = iter(P4_LAYOUTS)
    t_gang = time.perf_counter()
    gang = p4_run(P4_WORLD, "cuda", jobs, P4_TIMEOUTS)
    try:
        for name, got in gang:
            line = {"phase": "parallel4", "part": name, "nvidia_smi": cards,
                    "seconds": time.perf_counter() - t_gang}
            if name == "init":
                emit({**line, "ranks": got})
            elif name == "collectives":
                checked, failures = p4_collectives_errors(got, want_coll)
                emit({**line, "checked": checked, "failures": failures[:20],
                      "tolerance": {"int": "exact", "float32": P4_F32,
                                    "bfloat16": P4_BF16}})
                require(not failures and checked,
                        f"collectives differ: {failures[:5]}")
            elif name == "bandwidth":
                emit({**line, "rank0": got[0],
                      "min_nccl_busbw_gbs": {
                          f"{row['op']}_{row['bytes']}": min(
                              r[i]["nccl_busbw_gbs"] for r in got)
                          for i, row in enumerate(got[0])}})
            elif name == "layout":
                spec = next(layouts)
                ok, errs = p4_layout_errors(got, ref_layout)
                emit({**line, "spec": spec, "ok": ok, "max_abs_err": errs,
                      "loss": got[0]["metrics"],
                      "unsharded_loss": ref_layout["metrics"],
                      "tolerance": {"logits": P4_LOGITS, "step": P4_F32}})
                require(ok, f"layout {spec} differs from unsharded: {errs}")
            elif name == "moe":
                ok, errs = p4_moe_errors(got, ref_moe)
                emit({**line, "ok": ok, "max_abs_err": errs,
                      "w_gate": got[0]["w_gate"],
                      "tolerance": {"out": P4_GRAD, "aux_rel": 1e-5}})
                require(ok, f"MoE at ep=4 differs: {errs}")
            elif name == "pipeline":
                ok, errs = p4_pipeline_errors(got, ref_pipe)
                emit({**line, "ok": ok, "max_abs_err": errs,
                      "tolerance": {"out": P4_F32, "grad": P4_GRAD}})
                require(ok, f"the pipeline differs: {errs}")
            elif name == "train":
                _p4_check_train(got, ref_step, one_card, cfg, line)
    finally:
        gang.close()


def _p4_check_train(got, ref_step, one_card, cfg, line):
    r0 = got[0]
    mean_ms = sum(r0["step_ms"]) / 3
    tok_s = P4_TRAIN_B * TRAIN_S / (mean_ms / 1e3)
    ok, errs = p4_train_errors(got, ref_step, P4_TRAIN_TOL)
    want = _want_train_counts(cfg.n_layers)
    emit({**line, "spec": r0["spec"], "model": "llama3-8b",
          "global_batch": P4_TRAIN_B, "seq": TRAIN_S,
          "loss": r0["loss"], "grad_norm": r0["grad_norm"],
          "rel_err_to_one_card_step": errs, "tolerance": P4_TRAIN_TOL,
          "one_card_step": {k: ref_step[k] for k in ("loss", "grad_norm")},
          "step_ms": r0["step_ms"], "mean_step_ms": mean_ms,
          "max_rank_mean_step_ms": max(sum(r["step_ms"]) / 3 for r in got),
          "one_card_mean_step_ms": one_card["mean_step_ms"],
          "tok_s": tok_s, "one_card_tok_s": one_card["tok_s"],
          "scaling": tok_s / (P4_WORLD * one_card["tok_s"]),
          "init_s": [r["init_s"] for r in got],
          "peak_mem_gb": [r.get("peak_mem_gb") for r in got],
          "launches": [r["launches"] for r in got],
          "expected_launches": want, "trace": r0.get("trace")})
    for r in got:
        require(r["launches"] == want,
                f"{r['spec']}: launches {r['launches']}, expected {want}")
        require(r.get("peak_mem_gb", 0) < r.get("card_mem_gb", math.inf),
                "peak exceeds the card")
    require(ok, f"{r0['spec']}: the step differs from the one-card step "
                f"(relative {errs}, tolerance {P4_TRAIN_TOL}), or a loss "
                f"is not finite, does not fall or differs between ranks: "
                f"{[r['loss'] for r in got]}")


# --- the other single-device families: MoE Llama, Mamba-2, Jamba ------------

MOE_SERVE_LAYERS = 16     # of Mixtral-8x7B's 32: bf16 full depth is 93.4 GB
MOE_TRAIN_LAYERS = 2
MAMBA_B, MAMBA_S = 4, 2048


def _mixtral_cfg(torch, n_layers):
    """Mixtral-8x7B's widths, from mistralai/Mixtral-8x7B-v0.1's
    config.json (vocab_size 32000, hidden_size 4096, 32 attention heads,
    8 key-value heads, intermediate_size 14336, 8 local experts, 2 per
    token, rope_theta 1e6, rms_norm_eps 1e-5, max_position_embeddings
    32768), in bf16, at ``n_layers`` of its 32 layers; remat "full" and
    capacity factor 2.0 (the config's defaults) for training."""
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab=32000, dim=4096, n_layers=n_layers, n_heads=32,
                       n_kv_heads=8, mlp_dim=14336, max_seq=32768,
                       rope_theta=1e6, norm_eps=1e-5, dtype=torch.bfloat16,
                       n_experts=8, top_k=2)


def _fresh_phase(torch):
    """Free what earlier phases left (an engine in a reference cycle keeps
    its weights until the collector runs) and cached, and start a new
    peak."""
    import gc

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _decode_vs_prefill(torch, engine, params, cfg, prompts, streams,
                       picks=(0, 7), n=8):
    """tests/test_llm.py's MoE oracle at full width: for each picked
    request, its first ``n`` burst-path tokens (the stream after the
    prefill's token) against a fresh whole-prompt prefill of each prefix
    (prompt + stream so far), in a cache of its own. A disagreement is
    accepted only where the prefill's top-2 logit gap is below 0.05."""
    from ray_tpu_torch.llm import init_kv_cache, runner

    page, max_len = SERVE_ECFG["page_size"], SERVE_ECFG["max_seq_len"]
    cache = init_kv_cache(cfg, 1 + max_len // page, page, device="cuda")
    bt = torch.arange(1, 1 + max_len // page, dtype=torch.int32,
                      device="cuda")[None]
    out = []
    for i in picks:
        stream = streams[i]
        row = {"request": i, "prompt_len": len(prompts[i]),
               "agree_prefix": None, "disagreements": []}
        for j in range(1, n + 1):
            prefix = prompts[i] + stream[:j]
            S = runner.prefill_bucket(len(prefix), max_len)
            toks = torch.zeros((1, S), dtype=torch.int32)
            toks[0, :len(prefix)] = torch.tensor(prefix)
            logits, _, _ = runner.prefill(
                params, cache.k, cache.v, toks.cuda(),
                torch.tensor([len(prefix)], dtype=torch.int32,
                             device="cuda"), bt, engine.cos, engine.sin,
                cfg=cfg)
            top = logits[0].topk(2).values
            gap = float(top[0] - top[1])
            if int(logits[0].argmax()) != stream[j]:
                if row["agree_prefix"] is None:
                    row["agree_prefix"] = j - 1
                row["disagreements"].append({"token": j, "top2_gap": gap})
                require(gap < 0.05, f"request {i}: decode token {j} differs "
                        f"from the prefill's at a top-2 gap of {gap}")
        if row["agree_prefix"] is None:
            row["agree_prefix"] = n
        out.append(row)
    del cache
    return out


def phase_moe(torch, card):
    """Mixtral-8x7B widths at 16 layers (bf16, random weights from seed 7)
    served by LLMEngine on the engine phase's configuration and schedule,
    32 greedy tokens a request: launch counts, the decode-vs-prefill
    oracle, and paged vs gather decode on one cache state."""
    from ray_tpu_torch.models.llama import init_params

    _fresh_phase(torch)
    cfg = _mixtral_cfg(torch, MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=7, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine, prompts, streams, launches, metrics = _serve(
        torch, cfg, params, SLICE_TOKENS)
    oracle = _decode_vs_prefill(torch, engine, params, cfg, prompts,
                                streams)
    first = _paged_vs_gather(torch, engine, params, cfg, prompts)
    emit({"phase": "moe", "model": "mixtral-8x7b widths", "dtype": "bf16",
          "n_layers": cfg.n_layers, "n_params": cfg.n_params(),
          "experts": cfg.n_experts, "top_k": cfg.top_k, "requests": 9,
          "init_s": init_s, **metrics,
          "note": "16 of 32 layers: host time weighs more than at full "
                  "depth",
          "decode_vs_prefill": oracle,
          "paged_vs_gather_first_token": first,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": card})
    del engine, params
    return launches


def phase_moe_train(torch, card):
    """Mixtral-8x7B widths at 2 layers (bf16, seed 7, remat "full",
    capacity factor 2.0) under make_train_step with adamw(3e-4,
    weight_decay=0.1), one seeded batch of B=1, S=2048: one warm-up step,
    3 timed steps. The loss falls, the aux loss is finite, the routers
    stay f32 and move, and the three flash kernels are launched."""
    from ray_tpu_torch.models.llama import forward, init_params, lm_loss
    from ray_tpu_torch.train import adamw, make_train_step

    _fresh_phase(torch)
    cfg = _mixtral_cfg(torch, MOE_TRAIN_LAYERS)
    require(cfg.remat and cfg.remat_policy == "full"
            and cfg.capacity_factor == 2.0, "unexpected MoE train config")
    t0 = time.perf_counter()
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: lm_loss(p, b, cfg), adamw(3e-4, weight_decay=0.1),
        device="cuda")
    state = init_fn(init_params(cfg, seed=7, device="cuda"))
    g = torch.Generator().manual_seed(7)
    batch = place_batch({"tokens": torch.randint(
        0, cfg.vocab, (TRAIN_B, TRAIN_S), generator=g, dtype=torch.int32)})
    routers = [lp["router"].detach().clone() for lp in state.params["layers"]]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state, losses, norms, step_ms, tok_s, counts, m = _timed_steps(
        torch, step_fn, state, batch, TRAIN_B * TRAIN_S)
    want = _want_train_counts(cfg.n_layers)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        _, aux = forward(state.params, batch["tokens"], cfg, return_aux=True)
    after = [lp["router"] for lp in state.params["layers"]]
    router_f32 = all(r.dtype == torch.float32 for r in after)
    router_moved = all(not torch.equal(a.detach(), b)
                       for a, b in zip(after, routers))
    emit({"phase": "moe_train", "model": "mixtral-8x7b widths",
          "dtype": "bf16", "n_layers": cfg.n_layers,
          "n_params": cfg.n_params(), "remat": cfg.remat_policy,
          "capacity_factor": cfg.capacity_factor, "batch": TRAIN_B,
          "seq": TRAIN_S, "optimizer": "adamw(3e-4, weight_decay=0.1)",
          "init_s": init_s, "loss": losses, "grad_norm": norms,
          "aux_loss": float(aux), "router_f32": router_f32,
          "router_moved": router_moved, "step_ms": step_ms,
          "mean_step_ms": sum(step_ms) / 3, "tok_s": tok_s,
          "peak_mem_gb": peak / 1e9, "launches": counts,
          "expected_launches": want, "nvidia_smi": card})
    _check_training(torch, losses, norms, counts, want, m)
    require(math.isfinite(float(aux)), "the MoE aux loss is not finite")
    require(router_f32 and router_moved,
            "a router is not f32 or did not move")
    return counts


def phase_mamba(torch, card):
    """Mamba-2 130m and the Jamba 350m hybrid (MAMBA_CONFIGS, full width
    and depth, bf16, seed 7) under make_train_step with adamw(3e-4,
    weight_decay=0.1), one seeded batch of B=4, S=2048 (the model reads
    2,047 tokens, padded to 2,048): one warm-up step, 3 timed steps. The
    loss falls and every gradient is finite; Jamba's 8 attention layers
    launch the forward (twice: remat per period) and both backward
    kernels on tensor cores."""
    from ray_tpu_torch.models.mamba import (MAMBA_CONFIGS, init_mamba,
                                            mamba_lm_loss)
    from ray_tpu_torch.train import adamw, make_train_step

    launches = {}
    for name in ("130m", "jamba_350m"):
        _fresh_phase(torch)
        cfg = MAMBA_CONFIGS[name]
        t0 = time.perf_counter()
        init_fn, step_fn, place_batch = make_train_step(
            lambda p, b, cfg=cfg: mamba_lm_loss(p, b, cfg),
            adamw(3e-4, weight_decay=0.1), device="cuda")
        state = init_fn(init_mamba(cfg, seed=7, device="cuda"))
        g = torch.Generator().manual_seed(7)
        batch = place_batch({"tokens": torch.randint(
            0, cfg.vocab, (MAMBA_B, MAMBA_S), generator=g,
            dtype=torch.int32)})
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state, losses, norms, step_ms, tok_s, counts, m = _timed_steps(
            torch, step_fn, state, batch, MAMBA_B * MAMBA_S)
        want = _want_train_counts(cfg.n_attn_layers)
        emit({"phase": "mamba", "model": name, "dtype": "bf16",
              "n_layers": cfg.n_layers, "attn_layers": cfg.n_attn_layers,
              "n_params": cfg.n_params(), "batch": MAMBA_B, "seq": MAMBA_S,
              "optimizer": "adamw(3e-4, weight_decay=0.1)",
              "init_s": init_s, "loss": losses, "grad_norm": norms,
              "step_ms": step_ms, "mean_step_ms": sum(step_ms) / 3,
              "tok_s": tok_s,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": counts, "expected_launches": want,
              "nvidia_smi": card})
        _check_training(torch, losses, norms, counts, want, m)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        del state
    require(launches["flash_bwd_dkv_tc"] > 0,
            "Jamba launched no flash backward")
    return launches


# --- the vision families: CLIP ViT-B/16 and ResNet-18 -----------------------

CLIP_B, RESNET_B, RESNET_SIZE = 128, 256, 32


def _clip_batch(torch, cfg, B, seed=7):
    """B toy (image, text) pairs after tests/test_mamba_clip.py's
    test_clip_contrastive_learning, seeded: each image a faint random
    colour with a bright 4-row block (its row set by the index, in one of
    3 channels); each text a distinct caption token and a colour token,
    padded with 0 to cfg.max_text."""
    g = torch.Generator().manual_seed(seed)
    s = cfg.image_size
    images = (torch.randn(B, 1, 1, 3, generator=g) * 0.1).expand(
        B, s, s, 3).clone()
    tokens = torch.zeros(B, cfg.max_text, dtype=torch.int32)
    for i in range(B):
        row = (i * 4) % s
        images[i, row:row + 4, :, i % 3] = 1.0
        tokens[i, 0] = 1 + i % (cfg.vocab - 1)
        tokens[i, 1] = 2 + i % 3
    return {"images": images, "tokens": tokens}


def _resnet_batch(torch, cfg, B, size, seed=7):
    """tests/test_vision.py's separable task, seeded: uniform noise in
    [0, 0.2) plus a zero-mean stripe whose frequency encodes the class
    (GroupNorm removes per-sample shifts, not stripes)."""
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, cfg.num_classes, (B,), generator=g)
    xx = torch.arange(size)[None, :, None, None]
    images = (torch.rand(B, size, size, 3, generator=g) * 0.2
              + 0.5 * torch.sin(2 * math.pi * (labels[:, None, None, None]
                                               + 1) * xx / size))
    return {"images": images.float(), "labels": labels.to(torch.int32)}


def _train_vision(torch, card, phase, model, cfg, params, loss_fn, batch,
                  n_attn, n_items, lr, tc):
    """``model`` under make_train_step with adamw(lr, weight_decay=0.0)
    on one batch of ``n_items``: 1 warm-up step, 3 timed steps, then one
    step traced for the device-busy share. The loss falls, every gradient
    is finite, and ``n_attn`` attention layers launch the forward twice
    (remat) and each backward once, all on tensor cores if ``tc`` (see
    _want_train_counts)."""
    from ray_tpu_torch.train import adamw, make_train_step

    t0 = time.perf_counter()
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: loss_fn(p, b, cfg), adamw(lr, weight_decay=0.0),
        device="cuda")
    state = init_fn(params)
    placed = place_batch(batch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state, losses, norms, step_ms, rate, counts, m = _timed_steps(
        torch, step_fn, state, placed, n_items)
    want = _want_train_counts(n_attn, tc=tc)
    peak = torch.cuda.max_memory_allocated() / 1e9
    window, prof = _profile_window(torch, lambda: step_fn(state, placed))
    _set_train_counts(counts)
    emit({"phase": phase, "model": model, "dtype": "bf16",
          "batch": n_items,
          "optimizer": f"adamw({lr}, weight_decay=0.0)",
          "init_s": init_s, "loss": losses, "grad_norm": norms,
          "step_ms": step_ms, "mean_step_ms": sum(step_ms) / 3,
          "images_s": rate, "peak_mem_gb": peak, "traced_step": window,
          "traced_flash": _flash_split(prof),
          "launches": counts, "expected_launches": want,
          "nvidia_smi": card})
    _check_training(torch, losses, norms, counts, want, m)
    return counts


def phase_clip(torch, card):
    """CLIP ViT-B/16 (CLIP_CONFIGS["vit_b16"]: a 12-layer 768-wide vision
    tower and a 12-layer 512-wide causal text tower, heads of 64; bf16,
    remat, seed 7) trained on B=128 toy pairs with adamw(1e-4). Its 24
    attention layers (heads of 64) run the tensor-core forward, dQ and
    dK/dV: per step 48 forwards (remat) and 24 of each backward. At the
    `tiny` config's
    1e-3 the loss of these widths rises over the first steps, in the
    reference as in the port (tests/test_torch_clip.py::
    test_vit_b16_widths_track_the_reference_under_adamw)."""
    from ray_tpu_torch.models.clip import CLIP_CONFIGS, clip_loss, init_clip

    _fresh_phase(torch)
    cfg = CLIP_CONFIGS["vit_b16"]
    require(cfg.remat and cfg.dtype == torch.bfloat16,
            "vit_b16 is not bf16 with remat")
    return _train_vision(
        torch, card, "clip", "CLIP ViT-B/16 (n_params "
        f"{cfg.n_params()})", cfg, init_clip(cfg, seed=7, device="cuda"),
        clip_loss, _clip_batch(torch, cfg, CLIP_B),
        cfg.v_layers + cfg.t_layers, CLIP_B, 1e-4, tc=True)


def phase_resnet(torch, card):
    """ResNet-18 (RESNET_CONFIGS["resnet18"], bf16, seed 7) at CIFAR size,
    32x32x3 and 10 classes, trained on B=256 separable images with
    adamw(1e-4): at 1e-3 its loss rises over the first steps, in the
    reference as in the port (tests/test_torch_vision.py::
    test_resnet18_tracks_the_reference_under_adamw). No kernel of the
    port runs (bf16 convolutions are the library's)."""
    from ray_tpu_torch.models.vision import (RESNET_CONFIGS, image_loss,
                                             init_resnet)

    _fresh_phase(torch)
    cfg = RESNET_CONFIGS["resnet18"]
    return _train_vision(
        torch, card, "resnet", f"ResNet-18 (n_params {cfg.n_params()})",
        cfg, init_resnet(cfg, seed=7, device="cuda"), image_loss,
        _resnet_batch(torch, cfg, RESNET_B, RESNET_SIZE), 0, RESNET_B,
        1e-4, tc=False)


# --- the data-to-card path and the channels --------------------------------

DATA_BATCHES, DATA_STEPS = 32, 8


def _union_us(spans):
    """Microseconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _host_batches(torch, shapes, n, seed):
    """``n`` distinct seeded batches of float32 images and int32 columns
    (``shapes``: name -> (shape, high) with high None for images), made on
    the card in bulk and copied to host numpy arrays once."""
    g = torch.Generator("cuda").manual_seed(seed)
    cols = {}
    for k, (shape, high) in shapes.items():
        t = (torch.rand((n, *shape), generator=g, device="cuda")
             if high is None else
             torch.randint(0, high, (n, *shape), generator=g, device="cuda",
                           dtype=torch.int32))
        cols[k] = t.cpu().numpy()
        del t
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _feed_pass(torch, feed, batches):
    """All ``batches`` onto the card through ``feed`` (a list of dicts in,
    an iterator of placed dicts out); the placed batches and host GB/s."""
    nbytes = sum(v.nbytes for b in batches for v in b.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(feed(batches))
    torch.cuda.synchronize()
    return out, nbytes / (time.perf_counter() - t0) / 1e9


# the marker between a trace's warm-up and its window: torch.cuda._sleep's
# kernel, which nothing else launches
TRACE_MARK_KERNEL = "spin_kernel"
TRACE_MARK_CYCLES = 1000


def _trace_mark(torch, device=None):
    """The trace window's edge on the card's clock: a marker kernel alone,
    synced on both sides."""
    torch.cuda.synchronize(device)
    torch.cuda._sleep(TRACE_MARK_CYCLES)
    torch.cuda.synchronize(device)


def _traced_steps(torch, step_fn, state, next_batch, log_dir, n=2):
    """1 + ``n`` steps, each in a ``data.step`` span, under the port's
    profile. The first is a warm-up, synchronized before the window of
    the other ``n`` opens (a ``data.window`` span): the profiler may lose
    device events at its start. The window's host ms, device busy ms and
    share, its host-to-device copies' ms and count (2 a step: the busy
    share is reported only when the trace holds them all), the warm-up's
    copy count, and whether the trace file names the step's span; beside
    them, the copies that the host clock's edge would count and how far
    that edge lies after the marker's end on the trace's time line.

    The window's edge is taken on the card's clock: the trace puts host
    and device events on one time line, but the two clocks may disagree
    by more than the fraction of a millisecond between the window's
    opening and its first copy, which then reads as the warm-up's. So a marker kernel (``torch.cuda._sleep``) runs
    alone, with a sync before and after it, between the warm-up and the
    window: the window's device events start after its end, the
    warm-up's end before its start."""
    import glob

    from torch.autograd import DeviceType
    from ray_tpu_torch.util import profile, span

    torch.cuda.synchronize()
    with profile(log_dir, device="cuda") as prof:
        with span("data.step"):
            state, m = step_fn(state, next_batch())
        _trace_mark(torch)
        t0 = time.perf_counter()
        with span("data.window"):
            for _ in range(n):
                with span("data.step"):
                    state, m = step_fn(state, next_batch())
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(("train.", "data."))]
    marks = [e for e in dev if TRACE_MARK_KERNEL in e.name]
    require(len(marks) == 1, f"data: the trace holds {len(marks)} "
            f"{TRACE_MARK_KERNEL} markers, not 1")
    mark = marks[0].time_range
    window = [e for e in dev if e.time_range.start >= mark.end]
    h2d = [e.time_range.end - e.time_range.start for e in window
           if "HtoD" in e.name]
    warm_h2d = sum(1 for e in dev if e.time_range.end <= mark.start
                   and "HtoD" in e.name)
    require(len(h2d) == 2 * n, f"data: the trace holds {len(h2d)} of the "
            f"window's {2 * n} host-to-device copies ({warm_h2d} in the "
            "warm-up)")
    # what the host clock's edge (the window span's start) would count
    start = min(e.time_range.start for e in events
                if e.name == "data.window"
                and e.device_type == DeviceType.CPU)
    host_edge_h2d = sum(1 for e in dev if e.time_range.start >= start
                        and "HtoD" in e.name)
    busy = _union_us((e.time_range.start, e.time_range.end)
                     for e in window) / 1e3
    named = any("data.step" in open(f).read()
                for f in glob.glob(f"{log_dir}/*.pt.trace.json"))
    return state, m, {"wall_ms": wall_ms, "device_busy_ms": busy,
                      "device_busy_share": busy / wall_ms,
                      "h2d_ms": sum(h2d) / 1e3, "h2d_copies": len(h2d),
                      "warmup_h2d_copies": warm_h2d,
                      "h2d_copies_by_host_edge": host_edge_h2d,
                      "host_edge_after_mark_us": start - mark.end,
                      "span_in_trace": named}


def _feeds(place_batch):
    """The two ways onto the card: a list of host batches in, an iterator
    of placed batches out."""
    from ray_tpu_torch.data import iter_device_batches

    return {"place_batch": lambda bs: map(place_batch, bs),
            "iter_device_batches": lambda bs: iter_device_batches(
                iter(bs), device="cuda")}


def _data_model(torch, name, init, loss_fn, cfg, lr, batches, log_dir):
    """One model fed ``batches`` by place_batch and by
    iter_device_batches in turns (place, prefetch, prefetch, place), each
    turn DATA_STEPS steps after one warm-up step; then 2 traced steps a
    feed, after a warm-up step. After each step of a turn an exact
    checksum of the batch's bits (its 4-byte columns read as int32,
    summed in int64) runs on the consumer's stream, before the batch is
    let go; each must equal the host batch's. Returns the emitted
    record."""
    from ray_tpu_torch.train import adamw, make_train_step

    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: loss_fn(p, b, cfg), adamw(lr, weight_decay=0.0),
        device="cuda")
    state = init_fn(init(cfg, seed=7, device="cuda"))
    state, m = step_fn(state, place_batch(batches[0]))
    losses = [m["loss"]]
    want = [sum(int(v.view("int32").sum(dtype="int64")) for v in b.values())
            for b in batches]
    feeds = _feeds(place_batch)
    turns = []
    for feed in ("place_batch", "iter_device_batches",
                 "iter_device_batches", "place_batch"):
        sums = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in feeds[feed](batches):
            state, m = step_fn(state, batch)
            losses.append(m["loss"])
            sums.append(sum(v.view(torch.int32).sum(dtype=torch.int64)
                            for v in batch.values()))
        torch.cuda.synchronize()
        turns.append({"feed": feed, "step_ms": (time.perf_counter() - t0)
                      * 1e3 / len(batches)})
        require([int(x) for x in sums] == want,
                f"data: {name}: a {feed} batch's bits changed under its "
                "step")
    traced = {}
    for feed, fn in feeds.items():
        it = fn(batches[:4])
        state, m, traced[feed] = _traced_steps(
            torch, step_fn, state, lambda: next(it), f"{log_dir}/{feed}")
        losses.append(m["loss"])
        require(traced[feed]["span_in_trace"],
                f"data: {name}: the span is not in the {feed} trace")
    losses = [x.item() for x in losses]
    require(all(math.isfinite(x) for x in losses),
            f"data: {name}: a loss is not finite: {losses}")
    return {"model": name, "turns": turns, "checksums_equal": True,
            "traced": traced, "loss": losses}


def phase_data(torch, card):
    """The data-to-card path. (a) The iterator alone: 32 distinct seeded
    host batches at ResNet-18's shape (B=256, 32x32x3 f32, int32 labels)
    and at CLIP ViT-B/16's (128x224x224x3 f32, 128x77 int32 tokens),
    through place_batch (pageable, synchronous) and iter_device_batches
    (pinned, a side stream, one batch ahead) in turns: host-to-device
    GB/s, every yielded tensor bit-equal to place_batch's. (b) The resnet
    and clip phases' models and optimizers (bf16, seed 7) trained over 8
    distinct seeded batches fed each way in turns: step ms, and the busy
    share of 2 steps traced with util.tracing.profile, each step in a
    util.tracing.span whose name the trace must hold; finite losses, and
    CLIP's flash launches all on the tensor cores. (c) collect_hbm_stats:
    the peak equals max_memory_allocated, the limit the card's memory."""
    import tempfile

    from ray_tpu_torch.models.clip import CLIP_CONFIGS, clip_loss, init_clip
    from ray_tpu_torch.models.vision import (RESNET_CONFIGS, image_loss,
                                             init_resnet)
    from ray_tpu_torch.train import make_train_step
    from ray_tpu_torch.util import collect_hbm_stats

    t_phase = time.perf_counter()
    _fresh_phase(torch)
    ccfg, rcfg = CLIP_CONFIGS["vit_b16"], RESNET_CONFIGS["resnet18"]
    s = ccfg.image_size
    feeds = _feeds(make_train_step(lambda p, b: None, None,
                                   device="cuda")[2])
    alone = []
    for name, shapes in (
            ("resnet18", {"images": ((RESNET_B, RESNET_SIZE, RESNET_SIZE,
                                      3), None),
                          "labels": ((RESNET_B,), rcfg.num_classes)}),
            ("clip_vit_b16", {"images": ((CLIP_B, s, s, 3), None),
                              "tokens": ((CLIP_B, ccfg.max_text),
                                         ccfg.vocab)})):
        batches = _host_batches(torch, shapes, DATA_BATCHES, seed=11)
        gbps, kept = [], {}
        for feed in ("place_batch", "iter_device_batches",
                     "iter_device_batches", "place_batch"):
            out, rate = _feed_pass(torch, feeds[feed], batches)
            gbps.append({"feed": feed, "gb_s": rate})
            kept.setdefault(feed, out)
        same = all(torch.equal(a[k], b[k])
                   for a, b in zip(kept["place_batch"],
                                   kept["iter_device_batches"], strict=True)
                   for k in a)
        require(same, f"data: {name}: a prefetched batch differs from "
                "place_batch's")
        alone.append({"shape": name, "batches": DATA_BATCHES,
                      "bytes": sum(v.nbytes for b in batches
                                   for v in b.values()),
                      "turns": gbps, "bit_equal": same})
        del batches, kept, out
    _fresh_phase(torch)
    with tempfile.TemporaryDirectory() as log_dir:
        resnet = _data_model(
            torch, "ResNet-18", init_resnet, image_loss, rcfg, 1e-4,
            [{k: v.numpy() for k, v in _resnet_batch(
                torch, rcfg, RESNET_B, RESNET_SIZE, seed=s).items()}
             for s in range(DATA_STEPS)], f"{log_dir}/resnet")
        _zero_counts()
        clip = _data_model(
            torch, "CLIP ViT-B/16", init_clip, clip_loss, ccfg, 1e-4,
            [{k: v.numpy() for k, v in _clip_batch(
                torch, ccfg, CLIP_B, seed=s).items()}
             for s in range(DATA_STEPS)], f"{log_dir}/clip")
        counts = _train_counts()
    n_steps = 1 + 4 * DATA_STEPS + 2 * 3
    want = _want_train_counts(ccfg.v_layers + ccfg.t_layers, steps=n_steps)
    require(counts == want, f"data: CLIP launches {counts} != {want}")
    stats = collect_hbm_stats()
    require(len(stats) == 1, f"data: collect_hbm_stats gave {stats}")
    require(stats[0]["peak_bytes_in_use"] == torch.cuda.max_memory_allocated(),
            "data: HBM peak != max_memory_allocated")
    require(stats[0]["bytes_limit"]
            == torch.cuda.get_device_properties(0).total_memory,
            "data: HBM limit != the card's memory")
    emit({"phase": "data", "iterator_alone": alone,
          "training": [resnet, clip], "clip_launches": counts,
          "hbm": stats, "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": card})
    return counts


CHANNEL_ROUNDS = 8
# payload name -> {leaf: shape}, bf16: the 8B KV export of one 511-token
# request (32 layers, 8 kv heads of 128: 67.0 MB), and 1 GiB
CHANNEL_PAYLOADS = {"kv_8b_511": {"k": (32, 511, 8, 128),
                                  "v": (32, 511, 8, 128)},
                    "1gib": {"x": (1 << 29,)}}
CHANNEL_LANES = ("ipc", "shm")


def _channel_payload(torch, name, i):
    g = torch.Generator("cuda").manual_seed(
        1000 * list(CHANNEL_PAYLOADS).index(name) + i)
    return {k: torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)
            for k, shape in CHANNEL_PAYLOADS[name].items()}


def _channel_reader(dc_path, ch_path, out):
    """The channel phase's reader, a spawned process on the same card: for
    each payload and lane it regenerates the CHANNEL_ROUNDS payloads from
    their seeds, reports ready, reads them (over DeviceChannel, or leaf by
    leaf over the Channel's tensor lane), and reports the time each read
    ended, bit-equality and its counters."""
    import traceback

    import torch

    from ray_tpu_torch.experimental import Channel, DeviceChannel

    try:
        dc = DeviceChannel(dc_path, device="cuda")
        ch = Channel(ch_path, device="cuda")
        for name in CHANNEL_PAYLOADS:
            for lane in CHANNEL_LANES:
                want = [_channel_payload(torch, name, i)
                        for i in range(CHANNEL_ROUNDS)]
                torch.cuda.synchronize()
                out.put(("ready", name, lane))
                got, ends = [], []
                for _ in range(CHANNEL_ROUNDS):
                    got.append(dc.read(timeout=300) if lane == "ipc" else
                               {k: ch.read(0, timeout=300)
                                for k in sorted(CHANNEL_PAYLOADS[name])})
                    torch.cuda.synchronize()
                    ends.append(time.perf_counter())
                equal = all(torch.equal(g[k], w[k])
                            for g, w in zip(got, want) for k in w)
                out.put({"ends": ends, "equal": equal})
                del got, want
                torch.cuda.empty_cache()
        out.put({"ipc_transfers": DeviceChannel.ipc_transfers,
                 "host_lane_bytes": DeviceChannel.host_lane_bytes})
        dc.close()
        ch.close()
    except Exception:
        out.put({"error": traceback.format_exc()})


def phase_channel(torch, card):
    """Tensors between two processes on the one card: a reader spawned on
    the same card takes each payload of CHANNEL_PAYLOADS CHANNEL_ROUNDS
    times over DeviceChannel (CUDA IPC) and over the Channel's tensor
    lane (device to shm to device), regenerates each from its seed and
    requires it bit-equal. Every DeviceChannel payload crosses over IPC
    and none over the host lane, on both sides. GB/s of each lane, and the
    IPC lane's bound: the bytes its device copies (the writer's snapshot,
    the reader's copy) read and write, over 3.35 TB/s."""
    import multiprocessing
    import os
    import tempfile

    from ray_tpu_torch.experimental import Channel, DeviceChannel

    t_phase = time.perf_counter()
    _fresh_phase(torch)
    biggest = max(2 * math.prod(s) for p in CHANNEL_PAYLOADS.values()
                  for s in p.values())
    capacity = biggest + 4096
    # the tensor lane's file where the machine has room for it
    shm_free = (os.statvfs("/dev/shm").f_bavail * os.statvfs(
        "/dev/shm").f_frsize if os.path.isdir("/dev/shm") else 0)
    tmp = tempfile.mkdtemp(dir="/dev/shm" if shm_free > 2 * capacity
                           else None)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    dc = DeviceChannel(os.path.join(tmp, "dc"), create=True)
    ch = Channel(os.path.join(tmp, "ch"), create=True, capacity=capacity)
    DeviceChannel.ipc_transfers = DeviceChannel.host_lane_bytes = 0
    proc = ctx.Process(target=_channel_reader, args=(dc.path, ch.path, out),
                       daemon=True)
    proc.start()

    def take(timeout):
        msg = out.get(timeout=timeout)
        require(not (isinstance(msg, dict) and "error" in msg),
                f"channel: the reader failed: {msg}")
        return msg

    lanes = []
    try:
        for name, leaves in CHANNEL_PAYLOADS.items():
            nbytes = sum(2 * math.prod(s) for s in leaves.values())
            for lane in CHANNEL_LANES:
                sends = [_channel_payload(torch, name, i)
                         for i in range(CHANNEL_ROUNDS)]
                torch.cuda.synchronize()
                require(take(300) == ("ready", name, lane),
                        "channel: the reader is out of step")
                t0 = time.perf_counter()
                for tree in sends:
                    if lane == "ipc":
                        dc.write(tree, timeout=300)
                    else:
                        for k in sorted(tree):
                            ch.write(tree[k], timeout=300)
                got = take(600)
                require(got["equal"], f"channel: {lane} {name}: a payload "
                        "differs from its seed's")
                total = got["ends"][-1] - t0
                rounds = [(b - a) * 1e3 for a, b in
                          zip([t0] + got["ends"][:-1], got["ends"])]
                lanes.append({"lane": lane, "payload": name,
                              "bytes": nbytes, "rounds": CHANNEL_ROUNDS,
                              "round_ms": rounds,
                              "gb_s": CHANNEL_ROUNDS * nbytes / total / 1e9,
                              "bit_equal": True})
                if lane == "ipc":
                    # the writer's snapshot and the reader's copy, each
                    # reading and writing the payload once
                    bound_ms = 4 * nbytes / HBM_BYTES_PER_S * 1e3
                    lanes[-1].update({"bound_ms": bound_ms,
                                      "bound_gb_s": nbytes / bound_ms / 1e6})
                del sends
                torch.cuda.empty_cache()
        counts = take(120)
        proc.join(timeout=60)
        require(not proc.is_alive(), "channel: the reader did not exit")
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=30)
        dc.close()
        ch.close()
        for p in (dc.path, ch.path):
            if os.path.exists(p):
                os.unlink(p)
        os.rmdir(tmp)
    writes = len(CHANNEL_PAYLOADS) * CHANNEL_ROUNDS
    mine = {"ipc_transfers": DeviceChannel.ipc_transfers,
            "host_lane_bytes": DeviceChannel.host_lane_bytes}
    emit({"phase": "channel", "lanes": lanes, "writer_counts": mine,
          "reader_counts": counts, "ipc_writes": writes,
          "shm_dir": os.path.dirname(tmp), "shm_free_gb": shm_free / 1e9,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": card})
    for side, c in (("writer", mine), ("reader", counts)):
        require(c == {"ipc_transfers": writes, "host_lane_bytes": 0},
                f"channel: the {side}'s counters {c}: want {writes} IPC "
                "transfers and 0 host-lane bytes")
    return {}


# --- the dag phase: Llama-3-8B split across two processes on one card ------

DAG_SPLIT = 16          # stage 0: the embedding and layers [0, 16)
DAG_EXECUTIONS = 8
DAG_S = 2048
DAG_SEED = 18           # the token batches' seed
DAG_BUFFER = 1 << 21    # the shm channels' capacity (the output row: 0.5 MB)
DAG_LOGIT_TOL = 1e-3    # last-position f32 logits, split against one
                        # process; the same kernels on the same shapes: 0
DAG_CALL_TIMEOUT_S = 300.0
DAG_TRACED = 6          # executions of the traced pass, after the measured run


def _after_mark(prof, skip=()):
    """A trace's marker count and its device events (kernels and copies,
    less the ranges whose names start with ``skip``) after the marker."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith(skip)]
    marks = [e for e in dev if TRACE_MARK_KERNEL in e.name]
    if len(marks) != 1:
        return len(marks), []
    edge = marks[0].time_range.end
    return 1, [e for e in dev if e.time_range.start >= edge]


class DagStage:
    """One stage of a Llama (``cfg``: a LlamaConfig or a name in
    LLAMA_CONFIGS) split at layer ``split``, the actor of the dag phase: stage 0 holds the embedding and layers [0, split), stage 1
    layers [split, L), the final norm and the lm_head. ``forward`` runs
    them as models/llama.py's ``forward`` runs them: stage 0 takes tokens
    and returns the hidden, stage 1 takes the hidden and returns the
    argmax id at every position (int32) and the last position's f32
    logits. ``run_fn(fn, *args)`` runs ``fn(self, *args)``, the compiled
    DAG's entry (``DagHooks.run``) in a spawned process."""

    def __init__(self, cfg, stage, split, device):
        import torch

        from ray_tpu_torch.models.llama import LLAMA_CONFIGS

        self.cfg = LLAMA_CONFIGS[cfg] if isinstance(cfg, str) else cfg
        self.stage, self.split = stage, split
        self.device = torch.device(device)
        self.params = None
        self.edge_ms = {"write": [], "read": []}
        self._prof = None   # the traced pass's torch.profiler
        if self.device.type == "cuda":
            torch.zeros(1, device=self.device)   # the context, made early

    def run_fn(self, fn, *args):
        return fn(self, *args)

    def _layers(self):
        if self.stage == 0:
            return slice(0, self.split)
        return slice(self.split, self.cfg.n_layers)

    def build(self, params=None):
        """Keep this stage's part of ``params`` (a torch tree), or of the
        seeded init (seed 7, the serving weights) on the stage's device,
        one leaf at a time; the rest is freed. Returns the bytes kept and
        the peak while building."""
        import torch

        from ray_tpu_torch.models.llama import init_params

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        # shallow copies, popped leaf by leaf: the caller's tree stays
        # whole, and a seeded tree's leaves are freed as they are sliced
        full = dict(params if params is not None
                    else init_params(self.cfg, seed=7, device=self.device))
        layers = dict(full.pop("layers"))
        keep = self._layers()
        self.params = {"layers": {k: layers.pop(k)[keep].clone()
                                  for k in sorted(layers)}}
        names = (("embed",) if self.stage == 0
                 else ("final_norm", "lm_head"))
        self.params.update({k: full[k] for k in names})
        del full, layers
        nbytes = sum(t.nbytes for t in self.params["layers"].values()) + sum(
            self.params[k].nbytes for k in names)
        peak = None
        if cuda:
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.empty_cache()
        return {"bytes": nbytes, "build_peak_bytes": peak}

    def forward(self, x):
        import torch

        from ray_tpu_torch._private.tree import layer_params
        from ray_tpu_torch.models.llama import _layer_body
        from ray_tpu_torch.ops import rms_norm, rope_frequencies
        from ray_tpu_torch.ops.quant import logits_matmul
        from ray_tpu_torch.parallel.sharding import DEFAULT_RULES

        cfg, p = self.cfg, self.params
        with torch.no_grad():
            if self.stage == 0:
                x = p["embed"][x.to(self.device).long()]
            cos, sin = rope_frequencies(cfg.head_dim, x.shape[1],
                                        cfg.rope_theta, device=x.device)
            body = _layer_body(cfg)
            n = self._layers().indices(cfg.n_layers)
            for li in range(n[1] - n[0]):
                x, _ = body(x, layer_params(p["layers"], li), cfg, cos, sin,
                            None, DEFAULT_RULES)
            if self.stage == 0:
                return x
            x = rms_norm(x, p["final_norm"], cfg.norm_eps)
            logits = logits_matmul(x.to(cfg.dtype), p["lm_head"].to(cfg.dtype))
            # the last row as a tensor of its own: a view would carry the
            # whole logits through the output channel
            return {"ids": logits.argmax(-1).to(torch.int32),
                    "last": logits[:, -1].clone()}

    def _warm(self, S):
        """A forward of zeros at the phase's shape."""
        import torch

        cfg = self.cfg
        self.forward(
            torch.zeros((1, S), dtype=torch.int32, device=self.device)
            if self.stage == 0 else
            torch.zeros((1, S, cfg.dim), dtype=cfg.dtype, device=self.device))

    def prepare(self, S):
        """A warm-up forward at the phase's shape, then every count of
        this process set to 0, the peak reset, and the DeviceChannel's
        IPC write and read host times recorded from here on."""
        import torch

        from ray_tpu_torch.experimental import DeviceChannel

        self._warm(S)
        _zero_counts()
        DeviceChannel.ipc_transfers = DeviceChannel.host_lane_bytes = 0
        for name, side in (("_write_ipc", "write"), ("_read_ipc", "read")):
            orig = getattr(DeviceChannel, name)

            def timed(ch, *args, _orig=orig, _side=side):
                if self._prof is not None:
                    # the traced pass: the edge's device copies by range
                    with torch.profiler.record_function(f"dag.edge_{_side}"):
                        return _orig(ch, *args)
                t0 = time.perf_counter()
                try:
                    return _orig(ch, *args)
                finally:
                    self.edge_ms[_side].append(
                        (time.perf_counter() - t0) * 1e3)

            setattr(DeviceChannel, name, timed)
        self.allocated_before = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self.allocated_before = torch.cuda.memory_allocated(self.device)
        return True

    def trace_begin(self, S):
        """Start torch.profiler (CPU and CUDA) in this process, run a
        warm-up forward at the phase's shape ``S`` under it (the profiler
        may lose events, and take its own time, at its start), then a
        marker alone, synced on both sides (_trace_mark): the traced
        window's device events are those after the marker. Counts are
        not reset: stats() has read them. Returns True."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._warm(S)
        _trace_mark(torch, self.device)
        self._host_ns = [time.time_ns()]
        return True

    def trace_end(self):
        """Stop the profiler and read the window after the marker: its
        device busy ms (the union of kernel and copy intervals), the device
        ms of the copies launched inside the edge's IPC write and read
        (each op's kernels, by the trace's correlation), every
        device-to-device copy's ms, and the window's merged busy intervals
        in absolute microseconds of the trace's clock, with the host's
        unix-clock edges of the window beside them, so that the driver can
        intersect the two stages' intervals once both clocks agree."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        self._host_ns.append(time.time_ns())
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        events = prof.events()
        base_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
        marks, dev = _after_mark(prof, skip=("dag.",))
        if marks != 1:
            return {"marks": marks}
        window = sorted((e.time_range.start, e.time_range.end) for e in dev)
        merged = []
        for a, b in window:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        copies = {side: [sum(k.duration for e in cpu
                             if e is not r and e.thread == r.thread
                             and r.time_range.start <= e.time_range.start
                             and e.time_range.end <= r.time_range.end
                             for k in e.kernels) / 1e3
                         for r in cpu if r.name == f"dag.edge_{side}"]
                  for side in ("write", "read")}
        return {"marks": 1, "events": len(window),
                "busy_ms": _union_us(window) / 1e3,
                "host_us": [t / 1e3 for t in self._host_ns],
                "intervals_us": [(base_us + a, base_us + b)
                                 for a, b in merged],
                "edge_copy_ms": copies,
                "dtod_ms": sorted((e.time_range.end - e.time_range.start)
                                  / 1e3 for e in dev if "DtoD" in e.name)}

    def stats(self):
        """This process's counts since ``prepare``, the edge's host times,
        its run peak, and the bytes it holds now against those it held
        after ``prepare`` (a staged block not freed shows here)."""
        import os

        import torch

        from ray_tpu_torch.experimental import DeviceChannel

        out = {"pid": os.getpid(), **_train_counts(),
               "ipc_transfers": DeviceChannel.ipc_transfers,
               "host_lane_bytes": DeviceChannel.host_lane_bytes,
               "edge_ms": self.edge_ms,
               "allocated_before": self.allocated_before,
               "allocated_after": None, "run_peak_bytes": None}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            out["allocated_after"] = torch.cuda.memory_allocated(self.device)
            out["run_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        return out


def _dag_run(compiled, batches):
    """``batches`` through ``compiled`` with two in flight: the outputs and
    the host ms between successive results."""
    outs, ms = [], []
    t = time.perf_counter()
    refs = [compiled.execute(batches[0])]
    for i in range(1, len(batches) + 1):
        if i < len(batches):
            refs.append(compiled.execute(batches[i]))
        outs.append(refs[i - 1].get(timeout=DAG_CALL_TIMEOUT_S))
        now = time.perf_counter()
        ms.append((now - t) * 1e3)
        t = now
    return outs, ms


def dag_pipeline(torch, cfg, split, device, batches, params=None, traced=0):
    """Llama ``cfg`` split at ``split`` into two DagStage processes
    (spawned, on ``device``), ``stage1.forward.bind(stage0.forward.bind(
    inp).with_device_transport())`` compiled over MpRunners' DagHooks with
    max_inflight=2, and ``batches`` executed with two in flight. The
    stages keep their parts of ``params`` (a torch tree; None: the seeded
    init, seed 7). With ``traced`` > 0 (the card only), a second compile
    then runs the first ``traced`` batches under torch.profiler in both
    stages. Returns the outputs, the host ms between successive results,
    the stages' build and run stats, the channels' paths, the processes'
    exit codes, and the traced pass (None without one): its outputs, its
    host ms and each stage's ``trace_end``."""
    from ray_tpu_torch.dag import InputNode, actor

    pool = MpRunners()
    stages = [pool._spawn(DagStage, (cfg, s, split, device))
              for s in (0, 1)]

    def compile_dag():
        with InputNode() as inp:
            dag = actor(stages[1]).forward.bind(
                actor(stages[0]).forward.bind(inp).with_device_transport())
        compiled = dag.experimental_compile(
            hooks=pool.dag_hooks(), device=device,
            buffer_size_bytes=DAG_BUFFER, max_inflight=2)
        paths.extend(ch.path for ch in compiled._channels)
        return compiled

    paths, trace = [], None
    try:
        built = pool.get([s.build.remote(params) for s in stages],
                         DAG_CALL_TIMEOUT_S)
        pool.get([s.prepare.remote(batches[0].shape[1]) for s in stages],
                 DAG_CALL_TIMEOUT_S)
        compiled = compile_dag()
        try:
            outs, ms = _dag_run(compiled, batches)
        finally:
            compiled.teardown()
        stats = pool.get([s.stats.remote() for s in stages],
                         DAG_CALL_TIMEOUT_S)
        if traced:
            pool.get([s.trace_begin.remote(batches[0].shape[1])
                      for s in stages], DAG_CALL_TIMEOUT_S)
            compiled = compile_dag()
            try:
                t_outs, t_ms = _dag_run(compiled, batches[:traced])
            finally:
                compiled.teardown()
            trace = (t_outs, t_ms, pool.get(
                [s.trace_end.remote() for s in stages], DAG_CALL_TIMEOUT_S))
    finally:
        for s in stages:
            pool.kill(s)
    exits = [s.proc.exitcode for s in stages]
    return outs, ms, built, stats, paths, exits, trace


def _dag_trace_summary(traces, n):
    """The traced pass's two stages (``trace_end``'s dicts, ``n``
    executions): each stage's device busy ms an execution and its edge
    copies' device ms; then, where both stages' device events lie within
    their host windows on the unix clock (1 ms of slack), the card's busy
    ms an execution over both processes (the union of their intervals),
    the ms in which the two stages' intervals intersect, and the idle
    share of the span from the first device event to the last. Without
    MPS the card runs one process's context at a time, and a kernel
    switched out mid-run keeps its interval open meanwhile: the
    intersection bounds the stages' concurrency from above, and the
    union against one process's busy ms is the test of it."""
    out = {"executions": n, "stages": []}
    for i, t in enumerate(traces):
        if t.get("marks") != 1:
            out["stages"].append({"marks": t.get("marks")})
            continue
        iv = t["intervals_us"]
        lo, hi = t["host_us"]
        out["stages"].append({
            "events": t["events"], "busy_ms_per_execution": t["busy_ms"] / n,
            "edge_copy_ms": t["edge_copy_ms"],
            "dtod_copies": len(t["dtod_ms"]),
            "dtod_ms_largest": t["dtod_ms"][-2 * n:],
            "device_in_host_window": bool(iv) and (
                iv[0][0] >= lo - 1e3 and iv[-1][1] <= hi + 1e3),
            "device_first_after_host_us": iv[0][0] - lo if iv else None})
    if not all(s.get("device_in_host_window") for s in out["stages"]):
        out["overlap"] = ("not measured: a stage's trace lacks its marker, "
                          "or its device events lie outside its host window")
        return out
    both = [iv for t in traces for iv in t["intervals_us"]]
    busy0, busy1 = (_union_us(t["intervals_us"]) for t in traces)
    union = _union_us(both)
    span = max(b for _, b in both) - min(a for a, _ in both)
    out.update({"card_busy_ms_per_execution": union / 1e3 / n,
                "intersection_ms_per_execution":
                    (busy0 + busy1 - union) / 1e3 / n,
                "span_ms": span / 1e3, "idle_share": 1 - union / span})
    return out


def phase_dag(torch, card):
    """The compiled DAG with a device edge: Llama-3-8B (full width and
    depth, bf16, seed 7) split at layer 16 into two spawned processes on
    the card, the 16.8 MB bf16 hidden of each of 8 seeded [1, 2048] token
    batches over DeviceChannel (CUDA IPC), the ids and last logits back
    to this process over shm. Held against one process's ``forward`` on
    the same card and params: every id equal, the last logits within
    DAG_LOGIT_TOL; every hidden over IPC in both stages, none on the host
    lane; 256 flash forward launches, all tensor-core; both processes exit
    0, no channel file left, and each stage's memory back after
    teardown. ms per execution against one process's forward, the edge's
    host time, and each process's peak. Then DAG_TRACED more executions
    under torch.profiler in both stages (the ``dag_trace`` line): each
    stage's device busy ms, the edge copies' device ms, and the card's
    busy ms and the stages' overlap over both processes."""
    import os

    from ray_tpu_torch.models.llama import LLAMA_CONFIGS, forward, init_params

    t_phase = time.perf_counter()
    _fresh_phase(torch)
    cfg = LLAMA_CONFIGS["8b"]
    g = torch.Generator().manual_seed(DAG_SEED)
    batches = [torch.randint(0, cfg.vocab, (1, DAG_S), generator=g,
                             dtype=torch.int32)
               for _ in range(DAG_EXECUTIONS)]
    # the one-process forward on the same card and params
    params = init_params(cfg, seed=7, device="cuda")
    want, ref_ms = [], []
    with torch.no_grad():
        forward(params, batches[0].cuda(), cfg)          # warm-up
        torch.cuda.synchronize()
        _zero_counts()
        for tokens in batches:
            t0 = time.perf_counter()
            logits = forward(params, tokens.cuda(), cfg)
            want.append((logits.argmax(-1).to(torch.int32),
                         logits[:, -1].clone()))
            del logits
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t0) * 1e3)
    ref_counts = _train_counts()
    driver_peak = torch.cuda.max_memory_allocated()
    # the same forward's device busy ms, traced as the stages are: a
    # warm-up forward under the profiler, the marker, then one forward
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            torch.no_grad():
        for mark in (True, False):
            forward(params, batches[0].cuda(), cfg)
            if mark:
                _trace_mark(torch)
        torch.cuda.synchronize()
    marks, dev = _after_mark(prof)
    ref_busy_ms = (_union_us((e.time_range.start, e.time_range.end)
                             for e in dev) / 1e3
                   if marks == 1 else "not measured")
    del params, prof, dev
    _fresh_phase(torch)

    outs, ms, built, stats, paths, exits, trace = dag_pipeline(
        torch, "8b", DAG_SPLIT, "cuda", batches, traced=DAG_TRACED)
    t_outs, t_ms, traces = trace
    traced_ids_equal = sum(int((o["ids"].cpu() == w[0].cpu()).sum())
                           for o, w in zip(t_outs, want))
    ids_equal = sum(int((o["ids"].cpu() == w[0].cpu()).sum())
                    for o, w in zip(outs, want))
    logit_err = max(_max_err(o["last"].float(), w[1].float())
                    for o, w in zip(outs, want))
    hidden_bytes = DAG_S * cfg.dim * 2
    peaks = [driver_peak] + [max(b["build_peak_bytes"], s["run_peak_bytes"])
                             for b, s in zip(built, stats)]
    leftover = [s["allocated_after"] - s["allocated_before"] for s in stats]
    launches = {k: sum(s[k] for s in stats)
                for k in ("flash_fwd", "flash_fwd_tc")}
    emit({"phase": "dag", "model": "8b", "split_at_layer": DAG_SPLIT,
          "executions": DAG_EXECUTIONS, "tokens": [1, DAG_S],
          "hidden_bytes": hidden_bytes,
          "ms_per_execution": {"median": sorted(ms)[len(ms) // 2],
                               "min": min(ms), "max": max(ms), "all": ms},
          "one_process_forward_ms": {
              "median": sorted(ref_ms)[len(ref_ms) // 2],
              "min": min(ref_ms), "max": max(ref_ms), "all": ref_ms},
          "edge_host_ms": {f"stage{i}": {side: {
              "median": sorted(v)[len(v) // 2] if v else None,
              "max": max(v, default=None), "n": len(v)}
              for side, v in s["edge_ms"].items()}
              for i, s in enumerate(stats)},
          "ids_equal": ids_equal, "ids_total": DAG_EXECUTIONS * DAG_S,
          "last_logit_max_abs_err": logit_err,
          "last_logit_tol": DAG_LOGIT_TOL,
          "stage_counts": [{k: s[k] for k in (
              "pid", "ipc_transfers", "host_lane_bytes", "flash_fwd",
              "flash_fwd_tc")} for s in stats],
          "flash_fwd_launches": launches,
          "one_process_flash_fwd_launches": ref_counts["flash_fwd"],
          "peak_gb": {"driver": peaks[0] / 1e9, "stage0": peaks[1] / 1e9,
                      "stage1": peaks[2] / 1e9, "sum": sum(peaks) / 1e9},
          "stage_run_peak_gb": [s["run_peak_bytes"] / 1e9 for s in stats],
          "stage_bytes_gb": [b["bytes"] / 1e9 for b in built],
          "leftover_after_teardown_bytes": leftover,
          "exit_codes": exits,
          "channel_files_left": [p for p in paths if os.path.exists(p)],
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": card})
    emit({"phase": "dag_trace", "model": "8b",
          "traced_ms_per_execution": t_ms,
          "one_process_forward_device_busy_ms": ref_busy_ms,
          **_dag_trace_summary(traces, DAG_TRACED),
          "traced_ids_equal": traced_ids_equal, "nvidia_smi": card})
    require(ids_equal == DAG_EXECUTIONS * DAG_S,
            f"dag: {DAG_EXECUTIONS * DAG_S - ids_equal} argmax ids differ "
            "from one process's forward")
    require(logit_err <= DAG_LOGIT_TOL,
            f"dag: last logits {logit_err} from one process's, over "
            f"{DAG_LOGIT_TOL}")
    for i, s in enumerate(stats):
        require(s["ipc_transfers"] == DAG_EXECUTIONS
                and s["host_lane_bytes"] == 0,
                f"dag: stage {i} counted {s['ipc_transfers']} IPC transfers "
                f"and {s['host_lane_bytes']} host-lane bytes: want "
                f"{DAG_EXECUTIONS} and 0")
    want_fwd = 2 * DAG_SPLIT * DAG_EXECUTIONS
    require(launches == {"flash_fwd": want_fwd, "flash_fwd_tc": want_fwd},
            f"dag: flash launches {launches}: want {want_fwd}, all "
            "tensor-core")
    require(exits == [0, 0], f"dag: the stages exited {exits}")
    require(not any(os.path.exists(p) for p in paths),
            "dag: a channel file outlived teardown")
    require(leftover == [0, 0],
            f"dag: a stage holds {leftover} bytes more after teardown than "
            "before the run")
    require(traced_ids_equal == DAG_TRACED * DAG_S,
            f"dag: {DAG_TRACED * DAG_S - traced_ids_equal} argmax ids of the "
            "traced pass differ from one process's forward")
    require(sum(peaks) < 80e9, f"dag: the processes' peaks sum to "
            f"{sum(peaks) / 1e9:.1f} GB")
    return launches


def phase_reference(torch):
    """End to end against the CPU on a small input: a 2-layer f32 model
    (head_dim 128, GQA), dense and with 4 experts, served, then trained,
    and a small f32 Jamba trained, on the card, through the kernels, and
    on the CPU, through their plain versions, from the same weights. f32
    matmuls on the card run without TF32, so greedy streams must be
    identical. Then the head_dim-16 configurations and GRPO
    (_reference_small_heads), `tiny` CLIP and ResNet trained
    (_reference_vision), `tiny` served from a checkpoint
    (_reference_hf_tiny) and through LLMServer (_reference_serve), whose
    launches it returns."""
    import dataclasses

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, lm_loss

    cfg = LlamaConfig(vocab=1024, dim=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, mlp_dim=1024, max_seq=256,
                      dtype=torch.float32, remat=False)
    params = init_params(cfg, seed=3, device="cpu")
    on_card = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.cuda())
               for k, v in params.items()}
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in (5, 16, 33, 70)]
    sp = SamplingParams(temperature=0.0, max_tokens=24)
    streams = {}
    _zero_counts()
    for dev, p in (("cpu", params), ("cuda", on_card)):
        for chunk in (0, 32):
            ecfg = EngineConfig(max_num_seqs=4, page_size=16, num_pages=64,
                                max_seq_len=128, decode_burst=4,
                                prefill_chunk=chunk)
            streams[dev, chunk] = LLMEngine(p, cfg, ecfg,
                                            device=dev).generate(prompts, sp)
    torch.cuda.synchronize()
    same = {chunk: streams["cuda", chunk] == streams["cpu", chunk]
            for chunk in (0, 32)}
    counts = _train_counts()
    emit({"phase": "reference", "model": "2-layer f32, head_dim 128",
          "requests": len(prompts), "tokens_each": sp.max_tokens,
          "card_equals_cpu": same[0],
          "card_equals_cpu_chunked": same[32],
          "flash_fwd_launches": counts["flash_fwd"],
          "flash_fwd_tc_launches": counts["flash_fwd_tc"]})
    require(all(same.values()),
            "greedy streams on the card differ from the CPU's")
    # f32 serves through the SIMT forward kernel
    require(counts["flash_fwd"] > 0 and counts["flash_fwd_tc"] == 0,
            f"reference serving launches {counts}")
    _reference_paths(torch, cfg, params, prompts, sp, streams["cpu", 0])
    _reference_train(torch, dataclasses.replace(cfg, remat=True,
                                                remat_policy="full"),
                     params, lm_loss, cfg.n_layers, "reference_train",
                     "2-layer f32, head_dim 128")
    _reference_moe(torch, cfg, prompts, sp)
    _reference_jamba(torch)
    launches = _reference_small_heads(torch)
    for run in (_reference_vision, _reference_hf_tiny, _reference_serve):
        for k, n in run(torch).items():
            launches[k] = launches.get(k, 0) + n
    return launches


def _reference_small_heads(torch):
    """The head_dim-16 configurations through the D=16 kernels, card
    against CPU from the same weights: `tiny` served (greedy f32 streams
    identical, every decode step through paged_decode) and trained 3
    steps, `jamba_tiny` trained 3 steps (_reference_train's tolerances),
    and GRPO on `tiny` (_reference_grpo). Returns the launches of these
    runs."""
    from ray_tpu_torch._private.tree import tree_map
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS, init_params, lm_loss
    from ray_tpu_torch.models.mamba import (MAMBA_CONFIGS, init_mamba,
                                            mamba_lm_loss)

    cfg = LLAMA_CONFIGS["tiny"]
    params = init_params(cfg, seed=3, device="cpu")
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in (3, 16, 33, 70)]
    sp = SamplingParams(temperature=0.0, max_tokens=24)
    launches = {}
    _zero_serving_counts()
    got, stats = {}, {}
    for dev in ("cpu", "cuda"):
        eng = LLMEngine(tree_map(lambda t: t.to(dev), params), cfg,
                        EngineConfig(max_num_seqs=4, page_size=16,
                                     num_pages=64, max_seq_len=128,
                                     decode_burst=4), device=dev)
        got[dev] = eng.generate(prompts, sp)
        stats[dev] = eng.stats()
    torch.cuda.synchronize()
    counts = _serving_counts()
    card = stats["cuda"]
    emit({"phase": "reference_tiny", "model": "tiny (f32, head_dim 16)",
          "requests": len(prompts), "tokens_each": sp.max_tokens,
          "card_equals_cpu": got["cuda"] == got["cpu"],
          "paged_decode_steps": card["paged_decode_steps"],
          "decode_steps": card["decode_steps"], "launches": counts})
    require(got["cuda"] == got["cpu"],
            "tiny: greedy streams on the card differ from the CPU's")
    require(card["paged_decode_steps"] == card["decode_steps"] > 0
            and counts["paged_decode"] > 0 and counts["flash_fwd"] > 0
            and counts["flash_fwd_tc"] == 0,
            f"tiny serving did not take the kernels: {counts}")
    for k in ("flash_fwd", "paged_decode"):
        launches[k] = counts[k]
    for args in ((cfg, params, lm_loss, cfg.n_layers,
                  "reference_tiny_train", "tiny (f32, head_dim 16)"),
                 (MAMBA_CONFIGS["jamba_tiny"],
                  init_mamba(MAMBA_CONFIGS["jamba_tiny"], seed=8,
                             device="cpu"), mamba_lm_loss,
                  MAMBA_CONFIGS["jamba_tiny"].n_attn_layers,
                  "reference_jamba_tiny_train",
                  "jamba_tiny (f32, attention head_dim 16)")):
        for k, n in _reference_train(torch, *args).items():
            launches[k] = launches.get(k, 0) + n
    for k, n in _reference_grpo(torch, cfg, params).items():
        launches[k] = launches.get(k, 0) + n
    return launches


def _reference_vision(torch):
    """`tiny` CLIP (f32, head_dim 16) and `tiny` ResNet (f32) trained 3
    steps by make_train_step on the card (the flash kernels; f32
    convolutions as f32 matmuls, every TF32 flag at PyTorch's default)
    and on the CPU (the kernels' plain versions) from the same weights
    and batch: every loss, and every
    param afterwards, within 1e-5 abs + 1e-5 rel (_params_close). Adam's
    eps is 1e-4: with 1e-8 an element whose gradient is cancellation noise
    would move by up to lr either way. CLIP's 4 attention layers launch
    the forward once (no remat) and each backward once a step, on SIMT."""
    from ray_tpu_torch._private.tree import tree_leaves, tree_map
    from ray_tpu_torch.models.clip import CLIP_CONFIGS, clip_loss, init_clip
    from ray_tpu_torch.models.vision import (RESNET_CONFIGS, image_loss,
                                             init_resnet)
    from ray_tpu_torch.train import adamw, make_train_step

    clip_cfg, resnet_cfg = CLIP_CONFIGS["tiny"], RESNET_CONFIGS["tiny"]
    cases = (("reference_clip_tiny_train", "CLIP tiny (f32, head_dim 16)",
              clip_cfg, init_clip(clip_cfg, seed=3, device="cpu"),
              clip_loss, _clip_batch(torch, clip_cfg, 8),
              clip_cfg.v_layers + clip_cfg.t_layers),
             ("reference_resnet_tiny_train", "ResNet tiny (f32)",
              resnet_cfg, init_resnet(resnet_cfg, seed=3, device="cpu"),
              image_loss, _resnet_batch(torch, resnet_cfg, 16, 16), 0))
    launches = {}
    for phase, model, cfg, params, loss_fn, batch, n_attn in cases:
        _zero_counts()
        runs = {}
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
            runs[dev] = (losses, [t.detach().cpu()
                                  for t in tree_leaves(state.params)])
        counts = _train_counts()
        (l_cpu, p_cpu), (l_card, p_card) = runs["cpu"], runs["cuda"]
        p_ok, p_err = _params_close(p_card, p_cpu)
        loss_ok = all(abs(a - b) <= 1e-5 + 1e-5 * abs(b)
                      for a, b in zip(l_card, l_cpu))
        want = _want_train_counts(n_attn, tc=False,
                                  remat=getattr(cfg, "remat", False))
        emit({"phase": phase, "model": model, "steps": 3,
              "loss_card": l_card, "loss_cpu": l_cpu, "losses_ok": loss_ok,
              "params_max_abs_err": p_err, "params_ok": p_ok,
              "card_launches": counts, "expected_launches": want})
        require(loss_ok, f"{phase}: card and CPU losses differ")
        require(p_ok, f"{phase}: card and CPU params differ after 3 steps")
        require(counts == want, f"{phase}: launches {counts}, expected "
                f"{want}")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    return launches


def _reference_hf_tiny(torch):
    """`tiny` (f32, head_dim 16) saved by save_hf_checkpoint from the card
    and loaded back onto it (bit-equal), and onto the CPU: the loaded
    trees' greedy streams on the card and on the CPU are identical."""
    import shutil
    import tempfile

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.hf_interop import (load_hf_checkpoint,
                                                 save_hf_checkpoint)
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS, init_params

    cfg = LLAMA_CONFIGS["tiny"]
    params = init_params(cfg, seed=9, device="cuda")
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in (4, 17, 40, 64)]
    sp = SamplingParams(temperature=0.0, max_tokens=24)
    tmp = tempfile.mkdtemp(prefix="hf-tiny-")
    try:
        save_hf_checkpoint(params, cfg, tmp)
        loaded = {dev: load_hf_checkpoint(tmp, dtype=torch.float32,
                                          device=dev)[0]
                  for dev in ("cuda", "cpu")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = _tree_bit_equal(torch, loaded["cuda"], params)
    _zero_serving_counts()
    streams = {dev: LLMEngine(p, cfg, EngineConfig(
        max_num_seqs=4, page_size=16, num_pages=64, max_seq_len=128,
        decode_burst=4), device=dev).generate(prompts, sp)
        for dev, p in loaded.items()}
    torch.cuda.synchronize()
    counts = _serving_counts()
    emit({"phase": "reference_hf_tiny", "model": "tiny (f32, head_dim 16)",
          "loaded_equals_saved": same,
          "card_equals_cpu": streams["cuda"] == streams["cpu"],
          "launches": counts})
    require(same, "tiny: the checkpoint loaded on the card differs")
    require(streams["cuda"] == streams["cpu"],
            "tiny: greedy streams from the loaded tree differ card vs CPU")
    require(counts["flash_fwd"] > 0 and counts["paged_decode"] > 0,
            f"tiny from a checkpoint did not take the kernels: {counts}")
    return {k: counts[k] for k in ("flash_fwd", "paged_decode")}


def _reference_grpo(torch, cfg, params):
    """GRPO on `tiny` (f32, head_dim 16) on the card and on the CPU from
    the same weights. GRPO.train at temperature 0 with the group-position
    reward, 2 iterations: identical completions in both, the first
    iteration's KL exactly 0 and its mean log-prob within 1e-5. (At
    temperature 0 a group's rows are equal, so the policy gradient is 0 up
    to rounding, which Adam turns into moves of up to lr that differ by
    device: the params after it are not comparable.) Then one update on a
    batch of distinct rows: losses within 1e-5, the gradients within 1e-5
    of their largest entry, every param within 1e-5 abs + 1e-5 rel."""
    from ray_tpu_torch._private.tree import tree_leaves, tree_map
    from ray_tpu_torch.rllib import GRPO, GRPOConfig
    from ray_tpu_torch.rllib.grpo import _grpo_loss, _grpo_update
    from ray_tpu_torch.train import adamw

    kw = dict(model="tiny", group_size=4, max_tokens=6, temperature=0.0,
              lr=1e-4, kl_coef=0.1, seed=0)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9]]
    runs = {}
    _zero_counts()
    for dev in ("cpu", "cuda"):
        seen = []

        def reward(completions, seen=seen):
            seen.append(completions)
            return [float(i % 8) for i in range(len(completions))]

        algo = GRPO(GRPOConfig(**kw), params=params, device=dev)
        runs[dev] = ([algo.train(prompts, reward) for _ in range(2)], seen)
    torch.cuda.synchronize()
    counts = _train_counts()
    (r_cpu, s_cpu), (r_card, s_card) = runs["cpu"], runs["cuda"]
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (6, 20), generator=g,
                                     dtype=torch.int32),
             "mask": (torch.rand(6, 20, generator=g) > 0.3).float(),
             "advantages": torch.randn(6, generator=g)}
    upd = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(),
                     params)
        ref = tree_map(lambda t: t.to(dev, copy=True), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = _grpo_loss(p, ref, b, 0.1, cfg)
        grads = [x.cpu() for x in torch.autograd.grad(loss, tree_leaves(p))]
        _, _, m = _grpo_update(p, ref, adamw(1e-3, weight_decay=0.0).init(p),
                               b, 1e-3, kl_coef=0.1, cfg=cfg)
        upd[dev] = ({k: float(v) for k, v in m.items()}, grads,
                    [t.detach().cpu() for t in tree_leaves(p)])
    (m0, g0, p0), (m1, g1, p1) = upd["cpu"], upd["cuda"]
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(g1, g0))
    loss_err = max(abs(m1[k] - m0[k]) / max(1.0, abs(m0[k])) for k in m0)
    p_ok, p_err = _params_close(p1, p0)
    checks = {
        "completions_identical": s_card == s_cpu,
        "kl_0_in_iteration_1": r_card[0]["kl"] == r_cpu[0]["kl"] == 0.0,
        "mean_logp_it1": abs(r_card[0]["mean_logp"] - r_cpu[0]["mean_logp"])
        <= 1e-5 * max(1.0, abs(r_cpu[0]["mean_logp"])),
        "update_losses": loss_err <= 1e-5 and m1["kl"] == m0["kl"] == 0.0,
        "update_grads": grad_err <= 1e-5,
        "update_params": p_ok}
    emit({"phase": "reference_grpo", "model": "tiny (f32, head_dim 16)",
          "train_card": [{k: r[k] for k in ("reward_mean", "kl", "pg_loss",
                                            "mean_logp")} for r in r_card],
          "train_cpu": [{k: r[k] for k in ("reward_mean", "kl", "pg_loss",
                                           "mean_logp")} for r in r_cpu],
          "update_loss_max_rel_err": loss_err,
          "update_grad_max_err_over_max": grad_err,
          "update_params_max_abs_err": p_err, **checks,
          "train_launches": counts})
    require(all(checks.values()), f"reference GRPO failed: {checks}")
    want = {k: 2 * n for k, n in _want_grpo_counts(
        len(prompts), kw["max_tokens"], cfg, tc=False).items()}
    require(counts == want, f"reference GRPO launches {counts}, "
            f"expected {want}")
    return counts


def _reference_moe(torch, dense_cfg, prompts, sp):
    """The reference model with 4 experts, top-2 (f32, head_dim 128):
    greedy streams of the plain,
    the chunked-prefill and the gather-decode engine identical on the
    card and on the CPU, then 3 training steps."""
    import dataclasses

    from ray_tpu_torch._private.tree import tree_map
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.llama import init_params, lm_loss
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    cfg = dataclasses.replace(dense_cfg, n_experts=4, top_k=2)
    params = init_params(cfg, seed=6, device="cpu")
    got = {}
    _zero_serving_counts()
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        for path, chunk, paged in (("plain", 0, True), ("chunked", 32, True),
                                   ("gather", 0, False)):
            eng = LLMEngine(p, cfg, EngineConfig(
                max_num_seqs=4, page_size=16, num_pages=64, max_seq_len=128,
                decode_burst=4, prefill_chunk=chunk), device=dev)
            eng._paged_kernel = paged
            got[dev, path] = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    counts = _serving_counts()
    same = {path: got["cuda", path] == got["cpu", path]
            for path in ("plain", "chunked", "gather")}
    emit({"phase": "reference_moe", "model": "2-layer f32, head_dim 128, "
          "4 experts, top-2", "requests": len(prompts),
          "tokens_each": sp.max_tokens,
          **{f"card_equals_cpu_{k}": v for k, v in same.items()},
          "paged_equals_gather": got["cuda", "plain"] == got["cuda", "gather"],
          "launches": counts})
    require(all(same.values()),
            f"MoE greedy streams on the card differ from the CPU's: {same}")
    require(counts["flash_fwd"] > 0 and counts["flash_fwd_tc"] == 0
            and paged_decode_attention.launches > 0,
            f"reference MoE serving launches {counts}")
    _reference_train(torch, dataclasses.replace(cfg, remat=True,
                                                remat_policy="full"),
                     params, lm_loss, cfg.n_layers, "reference_moe_train",
                     "2-layer f32, head_dim 128, 4 experts, top-2")


def _reference_jamba(torch):
    """A Jamba hybrid in f32 (`jamba_tiny` widened to dim 256: attention
    head_dim 64; remat per period): 3 training steps on the card and on
    the CPU. `jamba_tiny` itself (head_dim 16) is _reference_small_heads'."""
    from ray_tpu_torch.models.mamba import (MambaConfig, init_mamba,
                                            mamba_lm_loss)

    cfg = MambaConfig(vocab=1024, dim=256, n_layers=4, state_dim=16,
                      head_dim=32, chunk=16, attn_period=4, attn_heads=4,
                      attn_kv_heads=2, dtype=torch.float32, remat=True)
    _reference_train(torch, cfg, init_mamba(cfg, seed=8, device="cpu"),
                     mamba_lm_loss, cfg.n_attn_layers, "reference_jamba_train",
                     "4-layer f32 Jamba (3 Mamba-2, 1 attention, head_dim 64)")


def _reference_paths(torch, cfg, params, prompts, sp, want):
    """The slice's serving paths on the same f32 model, on the card and
    on the CPU: a drafter that agrees (the target) and one that rejects
    (seed 5), two LoRA adapters beside base requests, and export ->
    inject into a second engine. Each gives greedy streams identical on
    both devices, and the speculative and handed-off ones (and the LoRA
    engine's base requests) identical to the plain engine's."""
    from ray_tpu_torch._private.tree import tree_map
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.llama import init_params

    ecfg = dict(max_num_seqs=4, page_size=16, num_pages=64, max_seq_len=128,
                decode_burst=4)
    drafter = init_params(cfg, seed=5, device="cpu")
    adapters = {name: _lora_adapter(torch, cfg, seed, "cpu", 0.05)
                for name, seed in (("a", 31), ("b", 32))}
    model_ids = ["a", None, "b", "a"]
    got = {}
    for dev in ("cpu", "cuda"):
        def on(tree, dev=dev):
            return tree_map(lambda t: t.to(dev) if isinstance(
                t, torch.Tensor) else t, tree)

        p = on(params)
        for regime, dp in (("agree", p), ("reject", on(drafter))):
            eng = LLMEngine(p, cfg, EngineConfig(**ecfg), device=dev)
            eng.enable_speculation({"draft_config": cfg,
                                    "num_draft_tokens": 3}, draft_params=dp)
            got[dev, regime] = eng.generate(prompts, sp)
            got[dev, regime + "_acceptance"] = eng.stats()["spec"][
                "acceptance_ratio"]
        eng = LLMEngine(p, cfg, EngineConfig(**ecfg, lora_rank=LORA_RANK),
                        device=dev)
        for name, a in adapters.items():
            eng.add_lora(name, on(a))
        ids = [eng.add_request(q, sp, model_id=m)
               for q, m in zip(prompts, model_ids)]
        while eng.has_unfinished():
            eng.step()
        got[dev, "lora"] = [eng.requests[i].output for i in ids]
        pre = LLMEngine(p, cfg, EngineConfig(**ecfg), device=dev)
        dec = LLMEngine(p, cfg, EngineConfig(**ecfg), device=dev)
        ids = []
        for q in prompts:
            rid = pre.add_request(q, sp)
            while pre.requests[rid].ctx_len <= 0:
                pre.step(skip_decode=True)
            ids.append(dec.inject_request(pre.export_kv_request(rid), sp))
        while dec.has_unfinished():
            dec.step()
        got[dev, "inject"] = [dec.requests[i].output for i in ids]
        got[dev, "inject_prefills"] = dec.stats()["prefills"]
    torch.cuda.synchronize()
    checks = {
        "spec_agree": got["cuda", "agree"] == got["cpu", "agree"] == want,
        "spec_reject": got["cuda", "reject"] == got["cpu", "reject"] == want,
        "lora_card_equals_cpu": got["cuda", "lora"] == got["cpu", "lora"],
        "lora_base_equals_plain": all(
            got["cuda", "lora"][i] == want[i]
            for i, m in enumerate(model_ids) if m is None),
        "lora_adapters_act": all(
            got["cuda", "lora"][i] != want[i]
            for i, m in enumerate(model_ids) if m is not None),
        "inject": got["cuda", "inject"] == got["cpu", "inject"] == want,
        "inject_without_prefill": got["cuda", "inject_prefills"]
        == got["cpu", "inject_prefills"] == 0,
    }
    emit({"phase": "reference_paths", "model": "2-layer f32, head_dim 128",
          "acceptance": {f"{dev}_{key}": v for (dev, key), v in got.items()
                         if key.endswith("_acceptance")},
          **checks})
    require(all(checks.values()), f"reference paths failed: {checks}")


def _reference_train(torch, cfg, params, loss_fn, n_attn, phase, model):
    """3 training steps of ``loss_fn`` (a ragged S=100 batch with a mask,
    which the Mamba loss ignores) on the card and on the CPU from the
    same weights: per-step losses and grad norms within 1e-4 relative,
    params afterwards within 1e-4; ``n_attn`` attention layers' launches,
    none on tensor cores (f32). Adam's eps is 1e-4 here: with optax's
    1e-8 an element whose gradient is cancellation noise (|g| ~ 1e-8,
    either sign on the card and on the CPU) would move by up to lr
    either way."""
    import numpy as np

    from ray_tpu_torch._private.tree import tree_leaves, tree_map
    from ray_tpu_torch.models import params_to_numpy
    from ray_tpu_torch.train import adamw, make_train_step

    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (2, 100), generator=g,
                           dtype=torch.int32)
    mask = torch.ones_like(tokens)
    mask[1, 60:] = 0
    batch = {"tokens": tokens, "mask": mask}
    runs = {}
    _zero_counts()
    for dev in ("cpu", "cuda"):
        init_fn, step_fn, place_batch = make_train_step(
            lambda p, b: loss_fn(p, b, cfg), adamw(1e-3, eps=1e-4),
            device=dev)
        state = init_fn(tree_map(lambda t: t.to(dev, copy=True), params))
        placed = place_batch(batch)
        metrics = []
        for _ in range(3):
            state, m = step_fn(state, placed)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        runs[dev] = (metrics, params_to_numpy(state.params))
    counts = _train_counts()
    (m_cpu, p_cpu), (m_card, p_card) = runs["cpu"], runs["cuda"]
    rel = max(abs(a - b) / abs(b) for x, y in zip(m_card, m_cpu)
              for a, b in zip(x, y))
    p_err = max(float(np.abs(a - b).max()) for a, b in zip(
        tree_leaves(p_card), tree_leaves(p_cpu)))
    p_ok = all(np.allclose(a, b, atol=1e-4, rtol=1e-4) for a, b in zip(
        tree_leaves(p_card), tree_leaves(p_cpu)))
    emit({"phase": phase, "model": model, "steps": 3, "loss_grad_norm_card": m_card,
          "loss_grad_norm_cpu": m_cpu, "max_rel_err": rel,
          "params_max_abs_err": p_err, "params_ok": p_ok,
          "card_launches": counts})
    require(rel < 1e-4, f"{phase}: card and CPU training losses differ")
    require(p_ok, f"{phase}: card and CPU params differ after 3 steps")
    # f32 stays on the SIMT kernels: no tensor-core launch
    want = _want_train_counts(n_attn, tc=False,
                              remat=getattr(cfg, "remat", True))
    require(counts == want, f"{phase}: launches {counts}, expected {want}")
    return counts



# --- RLlib: GRPO RLHF on Llama, the MLP learners ---------------------------

GRPO_1B = dict(group_size=8, max_tokens=32, temperature=1.0, kl_coef=0.02,
               seed=7)
GRPO_PROMPT_LENS = (5, 9, 12, 16)
GRPO_ITERS = 3


def _want_grpo_counts(n_prompts, n_tokens, cfg, tc):
    """Launches of one GRPO iteration: sampling runs one forward of
    n_layers attention layers per prompt and new token; the update runs
    the policy forward, its remat recompute (when cfg.remat is set, as
    _want_train_counts counts it) and the reference forward, and each
    backward kernel once a layer."""
    L = cfg.n_layers
    upd = _want_train_counts(L, tc=tc, steps=1, remat=cfg.remat)
    fwd = n_prompts * n_tokens * L + upd["flash_fwd"] + L
    return {"flash_fwd": fwd, "flash_fwd_tc": fwd if tc else 0,
            "flash_bwd_dq": L, "flash_bwd_dq_tc": L if tc else 0,
            "flash_bwd_dkv": L, "flash_bwd_dkv_tc": L if tc else 0}


def _range_busy(prof, name):
    """The host milliseconds of the record_function range ``name`` (which
    ends in a sync) and the device busy time (the union of kernel
    intervals) of the kernels that ran inside it."""
    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.name == name
           and e.device_type == DeviceType.CPU]
    if not cpu:
        return {"host_ms": "not measured", "device_busy_ms": "not measured"}
    lo, hi = cpu[0].time_range.start, cpu[0].time_range.end
    spans = [(e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("train.", "grpo."))
             and lo <= e.time_range.start <= hi]
    busy = _union_us(spans)
    return {"host_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (hi - lo), "kernels": len(spans)}


def _grpo_tiny_default(torch):
    """GRPO's default model (`tiny`, f32, head_dim 16) with
    tests/test_rllib.py's objective (the count of token 7 in a
    completion), 13 iterations: the reward must rise by 0.5."""
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS
    from ray_tpu_torch.rllib import GRPOConfig

    def reward_fn(completions):
        return [float(sum(1 for t in c if t == 7)) for c in completions]

    _zero_counts()
    algo = GRPOConfig(model="tiny", group_size=8, max_tokens=8, lr=5e-3,
                      kl_coef=0.0, seed=3).build(device="cuda")
    prompts = [[1, 2, 3], [4, 5, 6]]
    results = [algo.train(prompts, reward_fn) for _ in range(13)]
    torch.cuda.synchronize()
    counts = _train_counts()
    rewards = [r["reward_mean"] for r in results]
    per_iter = _want_grpo_counts(len(prompts), 8, LLAMA_CONFIGS["tiny"],
                                 tc=False)
    want = {k: 13 * n for k, n in per_iter.items()}
    emit({"phase": "grpo", "case": "tiny default (f32, head_dim 16)",
          "iterations": 13, "reward_mean": rewards,
          "total_loss": [r["total_loss"] for r in results],
          "launches": counts, "expected_launches": want})
    require(all(math.isfinite(r["total_loss"]) for r in results),
            "tiny GRPO: a loss is not finite")
    require(max(rewards[-4:]) > rewards[0] + 0.5,
            f"tiny GRPO did not raise its reward: {rewards}")
    require(counts == want, f"tiny GRPO launches {counts}, expected {want}")
    return counts


def phase_grpo(torch, card):
    """GRPO on the card: (a) the default `tiny` config learns the token-7
    objective; (b) LLAMA_CONFIGS["1b"] at full width and depth, bf16,
    random weights from seed 7: G=8 over 4 prompts of 5-16 tokens, 32
    new tokens at temperature 1, kl_coef 0.02, 3 iterations, rewarded by
    the share of even token ids. The KL is exactly 0 in the first
    iteration and positive after; the reference policy keeps the initial
    bits; the policy moves; every launch is as derived from the shapes,
    on tensor cores. Then one iteration is traced for the device-busy
    share of sampling and of the update."""
    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS
    from ray_tpu_torch.rllib import GRPOConfig

    launches = _grpo_tiny_default(torch)
    _fresh_phase(torch)
    cfg = LLAMA_CONFIGS["1b"]
    require(cfg.dtype == torch.bfloat16 and cfg.head_dim == 128
            and cfg.remat, "unexpected 1b config")
    t0 = time.perf_counter()
    algo = GRPOConfig(model="1b", **GRPO_1B).build(device="cuda")
    init = [t.clone() for t in tree_leaves(algo.ref_params)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in GRPO_PROMPT_LENS]

    def even_share(completions):
        return [sum(1 for t in c if t % 2 == 0) / len(c)
                for c in completions]

    want = _want_grpo_counts(len(prompts), GRPO_1B["max_tokens"], cfg,
                             tc=True)
    n_sampled = len(prompts) * GRPO_1B["group_size"] * GRPO_1B["max_tokens"]
    iters = []
    for it in range(GRPO_ITERS):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        r = algo.train(prompts, even_share)
        torch.cuda.synchronize()
        counts = _train_counts()
        iters.append({
            "iteration": it + 1, "sample_ms": r["timers"]["sample_ms"],
            "sampled_tok_s": n_sampled / (r["timers"]["sample_ms"] / 1e3),
            "update_ms": r["timers"]["update_ms"],
            "reward_mean": r["reward_mean"], "reward_std": r["reward_std"],
            "kl": r["kl"], "pg_loss": r["pg_loss"],
            "total_loss": r["total_loss"], "mean_logp": r["mean_logp"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts})
        require(counts == want, f"1b GRPO iteration {it + 1}: launches "
                f"{counts}, expected {want}")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    ref_leaves = tree_leaves(algo.ref_params)
    ref_intact = len(ref_leaves) == len(init) and all(
        torch.equal(a, b) for a, b in zip(ref_leaves, init))
    # the policy's per-layer leaves stacked again, leaf for leaf with init
    layers = algo.params["layers"]
    policy = tree_leaves({**algo.params, "layers": {
        k: torch.stack([lp[k].detach() for lp in layers])
        for k in layers[0]}})
    require(len(policy) == len(init), "policy and init trees differ")
    moved = sum(int((a != b).sum()) for a, b in zip(policy, init))
    n_elems = sum(t.numel() for t in init)
    del init, policy
    saved = _train_counts()
    window, prof = _profile_window(torch, lambda: algo.train(prompts,
                                                             even_share))
    _set_train_counts(saved)
    emit({"phase": "grpo",
          "case": "the repo's 1b (16 x 128 heads, untied), full depth, bf16",
          "n_params": cfg.n_params(), "n_layers": cfg.n_layers,
          "config": GRPO_1B, "lr": algo.config.lr,
          "prompt_lens": list(GRPO_PROMPT_LENS), "init_s": init_s,
          "iterations": iters, "expected_launches_per_iteration": want,
          "ref_params_bit_equal_to_init": ref_intact,
          "policy_elements_moved": moved,
          "policy_elements_moved_share": moved / n_elems,
          "profiled_iteration": {"wall_ms": window["wall_ms"],
                                 "sample": _range_busy(prof, "grpo.sample"),
                                 "update": _range_busy(prof, "grpo.update")},
          "nvidia_smi": card})
    require(iters[0]["kl"] == 0.0, f"1b GRPO: iteration 1 KL "
            f"{iters[0]['kl']}, not 0 (the policy is the reference)")
    require(all(x["kl"] > 0 and math.isfinite(x["kl"]) for x in iters[1:]),
            "1b GRPO: the KL is not positive and finite after iteration 1")
    require(all(math.isfinite(x[k]) for x in iters
                for k in ("total_loss", "pg_loss", "mean_logp")),
            "1b GRPO: a loss is not finite")
    require(ref_intact, "1b GRPO: the reference params moved")
    require(moved > 0, "1b GRPO: the policy params did not move")
    del algo, prof
    return launches


def _params_close(got, want):
    """Params card against CPU, leaf for leaf: (every element within
    1e-5 abs + 1e-5 rel; the largest difference)."""
    ok, worst = True, 0.0
    for a, b in zip(got, want):
        d = (a - b).abs()
        ok = ok and bool((d <= 1e-5 + 1e-5 * b.abs()).all())
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return ok, worst


def _update_on_both(torch, fn, params, extra):
    """``fn(params_tree, extra)`` on CPU copies and on card copies of the
    same params (and of ``extra``, a dict of tensors or trees); returns
    {device: (params after, metrics as floats)}."""
    from ray_tpu_torch._private.tree import tree_leaves, tree_map
    from ray_tpu_torch.rllib.checkpoint import on_device

    out = {}
    for dev in ("cpu", "cuda"):
        p = on_device(params, torch.device(dev), grad=True)
        e = tree_map(lambda t: t.to(dev, copy=True), extra)
        m = fn(p, e)
        out[dev] = ([t.detach().cpu() for t in tree_leaves(p)],
                    {k: float(v) for k, v in m.items()})
    return out


# --- RL runners in spawned processes ---------------------------------------
# A second implementation of ray_tpu_torch.rllib.RunnerHooks, over
# multiprocessing (spawn): ray_tpu's runtime is not on the card's machine.

RL_CALL_TIMEOUT_S = 300.0


def _mp_runner_main(conn, cls, args):
    """A runner process: ``cls(*args)``, then (call id, method, args)
    messages served in order until None; each reply is (call id, ok,
    value or error text). The method ``cuda_initialized`` reports
    whether this process has initialised CUDA."""
    import pickle

    import torch

    torch.set_num_threads(1)
    runner = cls(*args)
    while True:
        msg = pickle.loads(conn.recv_bytes())
        if msg is None:
            break
        cid, name, call_args = msg
        try:
            value = (torch.cuda.is_initialized() if name == "cuda_initialized"
                     else getattr(runner, name)(*call_args))
            reply = (cid, True, value)
        except Exception as e:  # sent to the caller's get()
            reply = (cid, False, f"{type(e).__name__}: {e}")
        conn.send_bytes(pickle.dumps(reply))
    conn.close()


class _MpRef:
    __slots__ = ("handle", "cid")

    def __init__(self, handle, cid):
        self.handle, self.cid = handle, cid


class _MpMethod:
    def __init__(self, handle, name):
        self._handle, self._name = handle, name

    def remote(self, *args):
        return self._handle.call(self._name, args)


class _MpHandle:
    """A runner in a spawned process: ``handle.method.remote(*args)``
    sends the call and returns a ref; replies are kept by call id with
    their arrival number."""

    def __init__(self, pool, cls, args):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_mp_runner_main,
                                args=(child, cls, args), daemon=True)
        self.proc.start()
        child.close()
        self.pool = pool
        self.replies = {}
        self._next = 0

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MpMethod(self, name)

    def call(self, name, args):
        import pickle

        cid, self._next = self._next, self._next + 1
        self.conn.send_bytes(pickle.dumps((cid, name, args)))
        return _MpRef(self, cid)

    def receive(self):
        import pickle

        cid, ok, value = pickle.loads(self.conn.recv_bytes())
        self.replies[cid] = (ok, value, self.pool.arrived())


class MpRunners:
    """Runner placement over spawned processes: ``hooks()`` is a
    RunnerHooks whose remote, get, wait and kill are this object's, and
    ``dag_hooks()`` a compiled DAG's DagHooks over the same processes."""

    def __init__(self):
        self.handles = []
        self._arrivals = 0

    def arrived(self) -> int:
        self._arrivals += 1
        return self._arrivals

    def hooks(self):
        import types

        from ray_tpu_torch.rllib import RunnerHooks

        def remote(cls):
            return types.SimpleNamespace(remote=lambda *args: self._spawn(
                cls, args))

        return RunnerHooks(remote=remote, get=self.get, wait=self.wait,
                           kill=self.kill)

    def dag_hooks(self):
        """A DagHooks over the same processes: each handle's object runs
        ``fn(self, *args)`` through its ``run_fn`` method (DagStage's)."""
        from ray_tpu_torch.dag import DagHooks

        return DagHooks(actor_key=lambda h: str(h.proc.pid),
                        run=lambda h, fn, *a: h.call("run_fn", (fn, *a)),
                        get=self.get)

    def _spawn(self, cls, args):
        handle = _MpHandle(self, cls, args)
        self.handles.append(handle)
        return handle

    @staticmethod
    def _await(ref, deadline):
        while ref.cid not in ref.handle.replies:
            left = deadline - time.monotonic()
            if left <= 0 or not ref.handle.conn.poll(left):
                raise TimeoutError(f"no reply from runner pid "
                                   f"{ref.handle.proc.pid} in time")
            ref.handle.receive()

    def get(self, refs, timeout):
        deadline = time.monotonic() + timeout
        one = isinstance(refs, _MpRef)
        out = []
        for ref in [refs] if one else refs:
            self._await(ref, deadline)
            ok, value, _ = ref.handle.replies.pop(ref.cid)
            if not ok:
                raise RuntimeError(f"runner pid {ref.handle.proc.pid}: "
                                   f"{value}")
            out.append(value)
        return out[0] if one else out

    def wait(self, refs, num_returns, timeout):
        from multiprocessing.connection import wait as conn_wait

        refs = list(refs)
        deadline = time.monotonic() + timeout
        while True:
            done = [r for r in refs if r.cid in r.handle.replies]
            left = deadline - time.monotonic()
            if len(done) >= num_returns or left <= 0:
                break
            pending = {r.handle.conn: r.handle for r in refs
                       if r.cid not in r.handle.replies}
            for conn in conn_wait(list(pending), timeout=left):
                pending[conn].receive()
        done.sort(key=lambda r: r.handle.replies[r.cid][2])
        ready = done[:num_returns]
        return ready, [r for r in refs if r not in ready]

    def kill(self, handle):
        import pickle

        if handle.proc.is_alive():
            handle.conn.send_bytes(pickle.dumps(None))
            handle.proc.join(10)
        if handle.proc.is_alive():
            handle.proc.terminate()
            handle.proc.join(10)
        handle.conn.close()

    def cuda_initialized(self):
        """Whether each live runner process has initialised CUDA."""
        refs = [h.call("cuda_initialized", ()) for h in self.handles
                if h.proc.is_alive()]
        return self.get(refs, RL_CALL_TIMEOUT_S)


def rl_remote_configs():
    """PPO, IMPALA, APPO, DQN and SAC at their default widths with two
    runners each (DQN and SAC learn from their first fragments), and the
    iterations each runs."""
    from ray_tpu_torch.rllib import (APPOConfig, DQNConfig, IMPALAConfig,
                                     PPOConfig, SACConfig)

    two = dict(num_env_runners=2)
    return [("ppo", PPOConfig().env_runners(**two), 2),
            ("impala", IMPALAConfig().env_runners(**two), 2),
            ("appo", APPOConfig().env_runners(**two), 2),
            ("dqn", DQNConfig().env_runners(**two).training(
                learning_starts=128), 2),
            ("sac", SACConfig().env_runners(**two).training(
                learning_starts=200), 2)]


def rl_in_process_and_spawned(torch, config, n_iter, device):
    """``config`` built twice on ``device``: runners in this process, then
    in spawned processes (MpRunners), each trained ``n_iter`` iterations.
    Returns {"in_process"|"spawned": (metrics a step, params as CPU
    tensors, iteration ms, params before)} and, for the spawned runners,
    whether each process initialised CUDA."""
    from ray_tpu_torch._private.tree import tree_leaves

    out, cuda_flags = {}, None
    for where in ("in_process", "spawned"):
        pool = MpRunners() if where == "spawned" else None
        algo = config.build(device=device,
                            hooks=pool.hooks() if pool else None)
        try:
            before = [t.detach().cpu().clone()
                      for t in tree_leaves(algo.params)]
            metrics, ms = [], []
            for _ in range(n_iter):
                t0 = time.perf_counter()
                metrics.append(algo.train())
                if device != "cpu":
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            if pool:
                cuda_flags = pool.cuda_initialized()
            out[where] = (metrics, [t.detach().cpu().clone()
                                    for t in tree_leaves(algo.params)],
                          ms, before)
        finally:
            algo.stop()
        if pool:
            require(not any(h.proc.is_alive() for h in pool.handles),
                    "a runner process outlived stop()")
    return out, cuda_flags


def rl_same_run(torch, a, b):
    """Two runs' metrics (NaN equal to NaN) and params bit for bit."""
    (ma, pa, _, _), (mb, pb, _, _) = a, b
    same_metrics = all(
        x.keys() == y.keys() and all(
            x[k] == y[k] or (isinstance(x[k], float) and math.isnan(x[k])
                             and math.isnan(y[k])) for k in x)
        for x, y in zip(ma, mb))
    return same_metrics and all(torch.equal(s, t) for s, t in zip(pa, pb))


def _rl_spawned_runners(torch, card):
    """The five runner-based learners with two runners in spawned
    processes against the same learners with their runners in this
    process; the learner on the card in both."""
    for name, config, n_iter in rl_remote_configs():
        t0 = time.perf_counter()
        runs, cuda_flags = rl_in_process_and_spawned(torch, config, n_iter,
                                                     "cuda")
        (m_loc, p_loc, ms_loc, _), (m_sp, p_sp, ms_sp, before) = (
            runs["in_process"], runs["spawned"])
        losses = {k: v for k, v in m_sp[-1].items() if "loss" in k}
        moved = any(not torch.equal(a, b) for a, b in zip(p_sp, before))
        same = rl_same_run(torch, runs["in_process"], runs["spawned"])
        emit({"phase": "rl_runners", "algorithm": name, "runners": 2,
              "iterations": n_iter, "iteration_ms": {
                  "in_process": ms_loc, "spawned": ms_sp},
              "wall_s": time.perf_counter() - t0,
              "losses_spawned": losses, "params_moved": moved,
              "bit_equal_to_in_process": same,
              "runner_cuda_initialized": cuda_flags, "nvidia_smi": card})
        require(cuda_flags == [False, False],
                f"rl {name}: a runner process initialised CUDA "
                f"({cuda_flags})")
        require(losses and all(math.isfinite(v) for v in losses.values()),
                f"rl {name} (spawned runners): a loss is missing or not "
                f"finite: {losses}")
        require(moved, f"rl {name} (spawned runners): the params did not "
                "move")
        if name in ("ppo", "dqn", "sac"):
            require(same, f"rl {name}: spawned runners differ from "
                    "in-process ones")


def phase_rl(torch, card):
    """The MLP learners with the learner on the card and the runners
    in-process: PPO and APPO on CartPole 3 iterations, IMPALA and DQN 2,
    SAC on Pendulum 2, BC and MARWIL 2 on rollouts recorded in a temp dir.
    Each must give finite losses and move its params; then each update is
    run on the card and on the CPU from the algorithm's params and a batch
    of its own data (SAC with the same noise), f32 with TF32 off: metrics
    within 1e-4 relative, every param within 1e-5 abs + 1e-5 rel. Then
    PPO, IMPALA, APPO, DQN and SAC with two runners each, in this process
    and in spawned processes (``MpRunners``): PPO, DQN and SAC equal to
    the bit, IMPALA and APPO (fragments in completion order) finite and
    moving, no runner process with CUDA initialised."""
    import tempfile

    import numpy as np

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.rllib import (APPOConfig, BCConfig, DQNConfig,
                                     IMPALAConfig, MARWILConfig, PPOConfig,
                                     SACConfig, record_rollouts)
    from ray_tpu_torch.rllib import dqn, impala, offline, ppo, sac
    from ray_tpu_torch.rllib.checkpoint import host_copy, to_numpy
    from ray_tpu_torch.train import adamw

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rl_")
    record_rollouts("CartPole-v1", tmp, num_steps=4096, seed=1)
    runs = [
        ("ppo", PPOConfig(), 3), ("appo", APPOConfig(), 3),
        ("impala", IMPALAConfig(), 2),
        # learning starts after one 128-step fragment, not 500 steps, so
        # that both iterations update
        ("dqn", DQNConfig().training(learning_starts=128), 2),
        ("sac", SACConfig().training(learning_starts=200), 2),
        ("bc", BCConfig().offline_data(tmp), 2),
        ("marwil", MARWILConfig().offline_data(tmp), 2)]
    np_rng = np.random.default_rng(0)
    for name, config, n_iter in runs:
        t0 = time.perf_counter()
        algo = config.build(device="cuda")
        before = [t.detach().clone() for t in tree_leaves(algo.params)]
        results = []
        for _ in range(n_iter):
            t1 = time.perf_counter()
            r = algo.train()
            torch.cuda.synchronize()
            results.append((r, (time.perf_counter() - t1) * 1e3))
        losses = {k: v for k, v in results[-1][0].items()
                  if "loss" in k}
        moved = any(not torch.equal(a.detach(), b) for a, b in zip(
            tree_leaves(algo.params), before))
        cfg = algo.config
        params = to_numpy(algo.params)
        if name in ("ppo", "appo", "impala"):
            frag = algo.runners[0].sample(256)
            if name == "ppo":
                adv, ret = ppo._gae(frag["rewards"], frag["values"],
                                    frag["dones"], frag["bootstrap_value"],
                                    cfg.gamma, cfg.lambda_)
                batch = ppo.batch_to({"obs": frag["obs"],
                                      "actions": frag["actions"],
                                      "logp": frag["logp"],
                                      "advantages": adv, "returns": ret},
                                     "cpu")
                steps = cfg.num_epochs * cfg.num_minibatches

                def fn(p, e, cfg=cfg):
                    return ppo.ppo_update(
                        p, adamw(cfg.lr, weight_decay=0.0).init(p),
                        e["batch"], torch.Generator().manual_seed(9), cfg.lr,
                        clip=cfg.clip_param, vf_coef=cfg.vf_loss_coeff,
                        ent_coef=cfg.entropy_coeff,
                        n_minibatches=cfg.num_minibatches,
                        n_epochs=cfg.num_epochs)[2]
            else:
                batch = ppo.batch_to({k: frag[k] for k in (
                    "obs", "actions", "rewards", "dones", "logp",
                    "bootstrap_value")}, "cpu")
                steps = 1

                def fn(p, e, cfg=cfg):
                    return impala.impala_update(
                        p, adamw(cfg.lr, weight_decay=0.0).init(p),
                        e["batch"], cfg.lr, gamma=cfg.gamma,
                        vf_coef=cfg.vf_loss_coeff,
                        ent_coef=cfg.entropy_coeff,
                        rho_bar=cfg.vtrace_rho_clip,
                        c_bar=cfg.vtrace_c_clip,
                        clip_param=cfg.clip_param)[2]
            extra = {"batch": batch}
        elif name == "dqn":
            steps = cfg.updates_per_iter
            extra = {"batch": ppo.batch_to(algo.buffer.sample(
                np_rng, cfg.train_batch_size * steps), "cpu"),
                     "target": host_copy(algo.target_params)}

            def fn(p, e, cfg=cfg):
                return dqn.dqn_update(
                    p, e["target"], adamw(cfg.lr, weight_decay=0.0).init(p),
                    e["batch"], cfg.lr, gamma=cfg.gamma,
                    n_updates=cfg.updates_per_iter)[2]
        elif name == "sac":
            steps = cfg.updates_per_iter
            mb = cfg.train_batch_size
            extra = {"batch": ppo.batch_to(algo.buffer.sample(
                np_rng, mb * steps), "cpu"),
                     "target": host_copy(algo.target),
                     "noise": torch.randn((steps, 2, mb, algo.act_dim),
                                          generator=torch.Generator()
                                          .manual_seed(9))}

            def fn(p, e, cfg=cfg, algo=algo):
                return sac.sac_update_with_noise(
                    p, e["target"], adamw(cfg.lr, weight_decay=0.0).init(p),
                    e["batch"], e["noise"], lr=cfg.lr, gamma=cfg.gamma,
                    tau=cfg.tau, target_entropy=algo.target_entropy)[3]
        else:
            steps = 1
            idx = np_rng.integers(0, len(algo._data["actions"]),
                                  cfg.train_batch_size)
            extra = {"batch": ppo.batch_to(
                {k: v[idx] for k, v in algo._data.items()}, "cpu")}

            def fn(p, e, cfg=cfg):
                return offline._marwil_update(
                    p, adamw(cfg.lr, weight_decay=0.0).init(p), e["batch"],
                    cfg.lr, beta=cfg.beta, vf_coef=cfg.vf_loss_coeff)[2]
        both = _update_on_both(torch, fn, params, extra)
        (p_cpu, m_cpu), (p_card, m_card) = both["cpu"], both["cuda"]
        m_err = max(abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k]))
                    for k in m_cpu)
        p_ok, p_err = _params_close(p_card, p_cpu)
        emit({"phase": "rl", "algorithm": name, "env": cfg.env,
              "iterations": n_iter,
              "iteration_ms": [ms for _, ms in results],
              "build_s": time.perf_counter() - t0 - sum(
                  ms for _, ms in results) / 1e3,
              "losses": losses, "params_moved": moved,
              "update_card_vs_cpu": {"steps": steps,
                                     "metrics_max_rel_err": m_err,
                                     "params_max_abs_err": p_err,
                                     "params_ok": p_ok},
              "nvidia_smi": card})
        require(losses and all(math.isfinite(v) for v in losses.values()),
                f"rl {name}: a loss is missing or not finite: {losses}")
        require(moved, f"rl {name}: the params did not move")
        require(m_err < 1e-4 and p_ok, f"rl {name}: the update on the card "
                f"differs from the CPU's ({m_err}, {p_err})")
        algo.stop()
    _rl_spawned_runners(torch, card)
    return {}


# --- phase 5 ---------------------------------------------------------------

def _time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, each timed alone
    with CUDA events and preceded by a write of 128 MB, which evicts the
    50 MB L2: on the serving path a layer's weights pass through L2
    between two attention calls, so the kernels find their inputs cold.
    A ~1 ms spin on the device before the start event lets the host queue
    all of ``fn`` first, so the time is the device's alone, without the
    wrapper's host time."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _host_us(torch, fn, n=50):
    """Host microseconds per call of ``fn``, enqueued behind a ~20 ms spin
    on the device: kernel launches return at once, so n calls take far
    less than the spin unless a call waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return host_us


def _clocks():
    """The card's SM clock, power draw and throttle reasons now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip()


def _paged_work(args):
    """Bytes and FLOPs of one paged decode call on these inputs: every
    valid K and V row read once, q read and out written once, the tables
    and lengths; 4 hd FLOPs per (query head, valid position)."""
    q, ck, cv, nk, nv, bt, ctx, new_len = args
    B, kvh, rep, hd = q.shape
    valid = int(ctx.clamp(0, bt.shape[1] * ck.shape[1]).sum()) + int(
        new_len.clamp(0, nk.shape[1]).sum())
    nbytes = (2 * valid * kvh * hd * ck.element_size()
              + 2 * q.numel() * q.element_size() + bt.numel() * 4 + 2 * B * 4)
    return nbytes, 4 * hd * rep * kvh * valid


def _paged_library(torch, args):
    """The yardstick: one gather of the whole tables (index_select), then
    SDPA with the mask over old and new positions."""
    import torch.nn.functional as F

    q, ck, cv, nk, nv, bt, ctx, new_len = args
    B, kvh, rep, hd = q.shape
    K = nk.shape[1]
    Sold = bt.shape[1] * ck.shape[1]
    pos = torch.arange(Sold + K, device="cuda")
    mask = torch.cat([pos[None, :Sold] < ctx[:, None],
                      pos[None, :K] < new_len[:, None]], dim=1)[:, None, None]
    qs = q.reshape(B, kvh * rep, 1, hd)

    def library():
        idx = bt.reshape(-1).long()
        ok = ck.index_select(0, idx).reshape(B, Sold, kvh, hd)
        ov = cv.index_select(0, idx).reshape(B, Sold, kvh, hd)
        kk = torch.cat([ok, nk], dim=1).transpose(1, 2)
        vv = torch.cat([ov, nv], dim=1).transpose(1, 2)
        return F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask,
                                              enable_gqa=True)

    return library


def phase_timing(torch, launches, max_err, clip_launches):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_reference,
                                             fwd_route)
    from ray_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    rows = []
    saved = (flash_attention.launches, paged_decode_attention.launches)
    clocks_before = _clocks()

    # flash forward at the 8B prefill shape
    _, B, Sq, Skv, Hq, Hkv, D, causal, _, _ = FLASH_CASES[0]
    q, k, v = _flash_inputs(torch, B, Sq, Skv, Hq, Hkv, D, "bf16", False)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = _time_ms(torch, lambda: flash_attention(q, k, v, causal=True))
    plain = _time_ms(torch, lambda: flash_attention_reference(
        q, k, v, causal=True), iters=5)
    lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    q_off = Skv - Sq
    pairs = sum(min(Skv, max(0, i + q_off + 1)) for i in range(Sq))
    flops = 4 * D * pairs * B * Hq
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * B * Hq * Sq
    rows.append(_row("flash_fwd", "ray_tpu_torch/csrc/flash_fwd.cu",
                     "ray_tpu/ops/attention.py:132",
                     launches.get("flash_fwd", 0), max_err.get("flash_fwd"), ms, plain,
                     nbytes, flops, lib,
                     _cuda_kernel("flash_fwd", fwd_route(q, k, v), D)))

    # paged decode at the 8B decode shape, full 16-page tables
    args = _paged_inputs(torch, *PAGED_8B, "bf16")
    ms = _time_ms(torch, lambda: paged_decode_attention(*args))
    plain = _time_ms(torch, lambda: paged_decode_attention_reference(*args),
                     iters=5)
    lib = _time_ms(torch, _paged_library(torch, args))
    rows.append(_row("paged_decode", "ray_tpu_torch/csrc/paged_decode.cu",
                     "ray_tpu/ops/paged_attention.py:51",
                     launches.get("paged_decode", 0),
                     max_err.get("paged_decode"), ms,
                     plain, *_paged_work(args), lib,
                     "paged_decode_split_kernel, paged_decode_combine_kernel"))
    # the wrappers' host time per call with the device busy: a call that
    # waited for the device would show the spin queued ahead of it
    emit({"phase": "timing_extra", "name": "host_us_per_call",
          "paged_decode": _host_us(torch,
                                   lambda: paged_decode_attention(*args)),
          "flash_fwd": _host_us(torch, lambda: flash_attention(
              q, k, v, causal=True))})
    # and at the 8k shape: every row 7,650 cached positions and 32 new
    args = _paged_inputs(torch, *PAGED_8K, "bf16")
    args[6].fill_(CTX_8K)
    args[7].fill_(PAGED_8K[-1])
    ms = _time_ms(torch, lambda: paged_decode_attention(*args))
    plain = _time_ms(torch, lambda: paged_decode_attention_reference(*args),
                     iters=5)
    lib = _time_ms(torch, _paged_library(torch, args))
    r = _row("paged_decode", "", "", 0, None, ms, plain, *_paged_work(args),
             lib)
    emit({"phase": "timing_extra", "name": "paged_decode",
          "shape": f"8k context, B=4, kvh=8, rep=4, hd=128, page 64, "
                   f"128-page tables, ctx {CTX_8K}, K=32",
          **{k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "bytes")},
          "share_of_bound": r["bound_ms"] / ms,
          "gb_s": r["bytes"] / ms / 1e6})
    flash_attention.launches, paged_decode_attention.launches = saved
    rows += _timing_bwd(torch, launches, max_err)
    rows += _timing_d64(torch, clip_launches)
    # "sm MHz, max sm MHz, power draw, temperature, throttle reasons"
    emit({"phase": "timing_clocks", "before": clocks_before,
          "after": _clocks()})
    for r in rows:
        emit({"phase": "timing", **r})
    return rows


def _timing_bwd(torch, launches, max_err):
    """Both backward kernels at the 8B training shape (B=1, S=2048, 32 q
    and 8 kv heads, D=128, causal, bf16), and the forward kernel there
    beside one SDPA forward (enable_gqa, causal). The backward rows'
    library yardstick is one SDPA backward (enable_gqa, from a retained
    graph), which computes dQ, dK and dV together: its time stands on
    both rows."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import (dkv_route, dq_route,
                                             flash_attention, flash_bwd_dkv,
                                             flash_bwd_dkv_reference,
                                             flash_bwd_dq,
                                             flash_bwd_dq_reference)

    saved = _train_counts()
    _, B, Sq, Skv, Hq, Hkv, D, causal, _ = BWD_CASES[0]
    args = _bwd_inputs(torch, B, Sq, Skv, Hq, Hkv, D, "bf16", causal)
    q, k, v, do, lse, dvec = args
    pairs = sum(min(Skv, max(0, i + Skv - Sq + 1)) for i in range(Sq))
    mm_flops = 2 * D * pairs * B * Hq        # one causal product
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd_ms = _time_ms(torch, lambda: flash_attention(q, k, v, causal=True))
    fwd_lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    emit({"phase": "timing_extra", "name": "flash_fwd",
          "shape": "8b training, B=1, S=2048", "ms": fwd_ms,
          "library_ms": fwd_lib, "flops": 2 * mm_flops,
          "bound_ms": 2 * mm_flops / BF16_FLOPS * 1e3,
          "tflop_s": 2 * mm_flops / fwd_ms / 1e9})

    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    lib = _time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, dot, retain_graph=True))
    del out, leaves

    qb, kb, lb = q.numel() * 2, k.numel() * 2, lse.numel() * 4
    rows = []
    ms = _time_ms(torch, lambda: flash_bwd_dq(*args))
    plain = _time_ms(torch, lambda: flash_bwd_dq_reference(*args), iters=3)
    # read q, k, v, dO, lse, D; write dQ
    rows.append(_row("flash_bwd_dq", "ray_tpu_torch/csrc/flash_bwd.cu",
                     "ray_tpu/ops/attention.py:279",
                     launches.get("flash_bwd_dq", 0),
                     max_err.get("flash_bwd_dq"), ms, plain,
                     3 * qb + 2 * kb + 2 * lb, 3 * mm_flops, lib,
                     _cuda_kernel("flash_bwd_dq", dq_route(*args[:4]), D)))
    ms = _time_ms(torch, lambda: flash_bwd_dkv(*args))
    plain = _time_ms(torch, lambda: flash_bwd_dkv_reference(*args), iters=3)
    # read q, k, v, dO, lse, D; write dK, dV
    rows.append(_row("flash_bwd_dkv", "ray_tpu_torch/csrc/flash_bwd.cu",
                     "ray_tpu/ops/attention.py:323",
                     launches.get("flash_bwd_dkv", 0),
                     max_err.get("flash_bwd_dkv"), ms, plain,
                     2 * qb + 4 * kb + 2 * lb, 4 * mm_flops, lib,
                     _cuda_kernel("flash_bwd_dkv", dkv_route(*args[:4]), D)))
    _set_train_counts(saved)
    return rows


D64_TIMED = ("clip_b16_vision", "clip_b16_text")


def _timing_d64(torch, clip_launches):
    """The three flash kernels at the clip phase's shapes (clip_b16_vision:
    B=128, S=197, 12 heads of 64, non-causal; clip_b16_text: B=128, S=77,
    8 heads of 64, causal; bf16, q, k, v strided as CLIP's projection
    gives them), all three on the tensor cores, each beside its plain
    version, its bound and SDPA: one SDPA forward, and one SDPA backward
    (dQ, dK and dV together, from a retained graph) on both backward rows.
    One `timing_extra` line each. Returns the vision shape's rows for the
    `kernels` line, each with the clip phase's tensor-core launches of its
    wrapper (``clip_launches``) and its largest difference from the plain
    version here, which must be within the parity phase's relative 2e-2."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import (
        dkv_route, dq_route, flash_attention, flash_attention_reference,
        flash_bwd_dkv, flash_bwd_dkv_reference, flash_bwd_dq,
        flash_bwd_dq_reference, fwd_route)

    saved = _train_counts()
    rows = []
    for case in (c for c in FLASH_CASES if c[0] in D64_TIMED):
        name, B, Sq, Skv, Hq, Hkv, D, causal, dtype, strided = case
        q, k, v = _flash_inputs(torch, B, Sq, Skv, Hq, Hkv, D, dtype,
                                strided)
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        g = torch.Generator("cuda").manual_seed(100)
        do = torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
        dvec = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, dvec)
        routes = {"flash_fwd": fwd_route(q, k, v),
                  "flash_bwd_dq": dq_route(*args[:4]),
                  "flash_bwd_dkv": dkv_route(*args[:4])}
        require(set(routes.values()) == {"tc"},
                f"{name} does not take the D=64 routes: {routes}")
        # products over the pairs the mask keeps (bottom-right causal)
        pairs = (sum(min(Skv, max(0, i + Skv - Sq + 1)) for i in range(Sq))
                 if causal else Sq * Skv)
        mm_flops = 2 * D * pairs * B * Hq          # one product
        qb, kb, lb = q.numel() * 2, k.numel() * 2, lse.numel() * 4
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        bwd_lib = _time_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do.transpose(1, 2), retain_graph=True))
        del out, leaves
        timed = (
            ("flash_fwd", "flash_fwd.cu", "132",
             lambda: flash_attention(q, k, v, causal=causal),
             lambda: flash_attention_reference(q, k, v, causal=causal)[0],
             _time_ms(torch, lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal)),
             # read q, k, v; write O and the LSE
             2 * qb + 2 * kb + lb, 2 * mm_flops),
            ("flash_bwd_dq", "flash_bwd.cu", "279",
             lambda: flash_bwd_dq(*args, causal=causal),
             lambda: flash_bwd_dq_reference(*args, causal=causal), bwd_lib,
             3 * qb + 2 * kb + 2 * lb, 3 * mm_flops),
            ("flash_bwd_dkv", "flash_bwd.cu", "323",
             lambda: flash_bwd_dkv(*args, causal=causal),
             lambda: flash_bwd_dkv_reference(*args, causal=causal), bwd_lib,
             2 * qb + 4 * kb + 2 * lb, 4 * mm_flops))
        for (kernel, src, line, fn, plain_fn, lib, nbytes,
             flops) in timed:
            ms = _time_ms(torch, fn)
            plain = _time_ms(torch, plain_fn, iters=3)
            got, want = fn(), plain_fn()
            pairs_out = (list(zip(got, want)) if isinstance(got, tuple)
                         else [(got, want)])
            err = max(_max_err(a, b) for a, b in pairs_out)
            # the parity phase's bf16 measure and limit, here at the
            # strided q, k, v of CLIP's projection
            rel = max(_rel_err(a, b) for a, b in pairs_out)
            require(rel < 2e-2, f"{kernel} at {name} (strided q/k/v): "
                    f"max_err_over_max {rel} >= 2e-2")
            r = _row(f"{kernel}<64>", f"ray_tpu_torch/csrc/{src}",
                     f"ray_tpu/ops/attention.py:{line}",
                     clip_launches.get(kernel + "_tc", 0), err, ms, plain,
                     nbytes, flops, lib,
                     _cuda_kernel(kernel, routes[kernel], D))
            emit({"phase": "timing_extra", "name": kernel,
                  "route": routes[kernel],
                  "shape": f"{name}: B={B}, S={Sq}, {Hq} heads of {D}, "
                           f"{'causal' if causal else 'non-causal'}, bf16, "
                           f"strided q/k/v",
                  **{k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by", "bytes",
                                       "flops", "tflop_s", "max_abs_err")},
                  "max_err_over_max": rel,
                  "share_of_bound": r["bound_ms"] / ms,
                  "vs_library": ms / lib})
            if name == "clip_b16_vision":
                rows.append(r)
    _set_train_counts(saved)
    return rows


def _profile_window(torch, fn):
    """Run ``fn`` once under torch.profiler. Returns the window's host
    wall time, the union of device kernel intervals (busy time), the
    kernel count and the top kernels by device time; and the profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the device-side copies of record_function
    # ranges (the trainer's "train.*" and GRPO's "grpo.*"), which span gaps
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev
               if not e.name.startswith(("train.", "grpo."))]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    if not spans:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}, prof
    busy = _union_us(spans)
    by_name = {}
    for ev in kernels:
        t, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (t + ev.time_range.end - ev.time_range.start,
                            n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall_ms,
            "kernels": len(spans),
            "top": [{"name": k[:80], "ms": t / 1e3, "count": n}
                    for k, (t, n) in top]}, prof


def phase_profile(torch):
    """Where the serving time goes at the engine phases' shapes: one
    whole-prompt prefill of 511 tokens on an idle engine, one decode burst
    at B=8, one speculative round in each regime and one LoRA burst at
    B=8, and one 32-step burst at 8k context (B=4), each traced once
    after a warm-up."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS, init_params

    cfg = LLAMA_CONFIGS["8b"]
    params = init_params(cfg, seed=7, device="cuda")
    engine = LLMEngine(params, cfg, EngineConfig(**SERVE_ECFG),
                       device="cuda")
    sp = SamplingParams(temperature=0.0, max_tokens=64)
    prompts = _serving_prompts(torch, cfg.vocab)
    engine.generate([prompts[0]], SamplingParams(temperature=0.0,
                                                 max_tokens=9))
    warm = engine.add_request(prompts[-1], sp)
    engine.step(skip_decode=True)          # warm the 512 bucket
    engine.abort_request(warm)
    engine.add_request(prompts[-1], sp)
    prefill, _ = _profile_window(torch,
                                 lambda: engine.step(skip_decode=True))
    emit({"phase": "profile", "window": "prefill 511 tokens, B=1",
          **prefill})
    for p in prompts[:-1]:
        engine.add_request(p, sp)
    while sum(s is not None and s.ctx_len > 0 for s in engine.slots) < 8:
        engine.step(skip_decode=True)
    engine.step()                           # warm-up burst
    decode, _ = _profile_window(torch, engine.step)
    emit({"phase": "profile", "window": "one decode burst, K=8, B=8",
          **decode})
    del engine
    # the slice's serving paths at B=8: one speculative round per regime,
    # one LoRA decode burst, each after a warm-up round
    for name, ecfg, spec, draft_params, model_ids in (
            ("one speculative round, reject regime (1B-shaped drafter), "
             "k=4, B=8", {}, {"draft_config": "1b", "num_draft_tokens": 4,
                              "draft_seed": 11}, None, None),
            ("one speculative round, agree regime (8B drafter), k=4, B=8",
             {}, {"draft_config": "8b", "num_draft_tokens": 4}, params,
             None),
            ("one LoRA decode burst, rank 16, 4 of 8 rows on adapters, "
             "K=8, B=8", {"lora_rank": LORA_RANK, "max_loras": 4}, None,
             None, ["a", None, "b", None] * 2)):
        engine = LLMEngine(params, cfg, EngineConfig(**SERVE_ECFG, **ecfg),
                           device="cuda")
        if spec:
            engine.enable_speculation(spec, draft_params=draft_params)
        if model_ids:
            for m, seed in (("a", 21), ("b", 22)):
                engine.add_lora(m, _lora_adapter(torch, cfg, seed, "cuda",
                                                 0.01))
        for p, m in zip(prompts, model_ids or [None] * len(prompts)):
            engine.add_request(p, sp, model_id=m)
        while sum(s is not None and s.ctx_len > 0
                  for s in engine.slots) < 8:
            engine.step(skip_decode=True)
        engine.step()                       # warm-up (drafter warm-ups)
        window, _ = _profile_window(torch, engine.step)
        emit({"phase": "profile", "window": name, **window})
        del engine
    engine, _ = _engine_8k(torch, params, cfg)
    decode, _ = _profile_window(torch, engine.step)
    emit({"phase": "profile", "window": "one decode burst at 8k context, "
          "K=32, B=4", **decode})


def _emit_moe_window(torch, name, fn):
    from torch.autograd import DeviceType

    window, prof = _profile_window(torch, fn)
    attn = sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and ("paged_decode" in e.name or "flash_fwd" in e.name))
    emit({"phase": "profile_moe", "window": name, **window,
          "attention_ms": attn / 1e3})


def phase_profile_moe(torch):
    """Where MoE serving's device time goes (the moe phase's model and
    engine): one 511-token prefill and one decode burst at B=8, traced
    after a warm-up; device time of the attention kernels (flash_fwd,
    paged_decode) against the rest, which is the f32 expert mixture
    (upcasts and f32 GEMMs) and the bf16 projections."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import init_params

    _fresh_phase(torch)
    cfg = _mixtral_cfg(torch, MOE_SERVE_LAYERS)
    params = init_params(cfg, seed=7, device="cuda")
    engine = LLMEngine(params, cfg, EngineConfig(**SERVE_ECFG),
                       device="cuda")
    sp = SamplingParams(temperature=0.0, max_tokens=SLICE_TOKENS)
    prompts = _serving_prompts(torch, cfg.vocab)
    engine.generate([prompts[0]], SamplingParams(temperature=0.0,
                                                 max_tokens=9))
    warm = engine.add_request(prompts[-1], sp)
    engine.step(skip_decode=True)          # warm the 512 bucket
    engine.abort_request(warm)
    engine.add_request(prompts[-1], sp)
    _emit_moe_window(torch, "MoE prefill 511 tokens, B=1",
                     lambda: engine.step(skip_decode=True))
    for p in prompts[:-1]:
        engine.add_request(p, sp)
    while sum(s is not None and s.ctx_len > 0 for s in engine.slots) < 8:
        engine.step(skip_decode=True)
    engine.step()                           # warm-up burst
    _emit_moe_window(torch, "MoE decode burst, K=8, B=8", engine.step)
    del engine, params


GEMM_WORDS = ("gemm", "xmma", "nvjet", "cutlass", "cublas", "wgmma")
# the CUDA kernels of each training wrapper, as the profiler names them
# ("<namespace>::flash_bwd_dkv_tc_kernel(...)", "...::flash_fwd_kernel<...>")
KERNEL_NAMES = {"flash_fwd": ("flash_fwd_kernel", "flash_fwd_tc_kernel"),
                "flash_bwd_dq": ("flash_bwd_dq_kernel",
                                 "flash_bwd_dq_tc_kernel"),
                "flash_bwd_dkv": ("flash_bwd_dkv_kernel",
                                  "flash_bwd_dkv_tc_kernel")}


def _flash_split(prof):
    """Device ms and launches of each flash kernel in a profile, by
    wrapper, tensor-core (<name>_tc) and SIMT kernels apart."""
    from torch.autograd import DeviceType

    split = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name, (simt, tc) in KERNEL_NAMES.items():
            key = name + "_tc" if tc in e.name else name if simt in e.name \
                else None
            if key:
                ms, n = split.get(key, (0.0, 0))
                split[key] = (ms + (e.time_range.end
                                    - e.time_range.start) / 1e3, n + 1)
    return {k: {"ms": ms, "launches": n} for k, (ms, n) in split.items()}


def phase_profile_train(torch):
    """Where one 8B training step's device time goes: the three flash
    kernels (by kernel name), cuBLAS GEMMs (by kernel name) and the
    optimizer (the kernels inside the step's "train.optimizer" range on
    the device timeline), after one warm-up step."""
    from torch.autograd import DeviceType

    cfg, state, step_fn, batch = _build_8b_trainer(torch)
    state, _ = step_fn(state, batch)
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batch)

    window, prof = _profile_window(torch, one_step)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in kernels if e.name.startswith("train.")}
    kernels = [e for e in kernels if not e.name.startswith("train.")]

    def ms(events):
        return sum(e.time_range.end - e.time_range.start for e in events) / 1e3

    split = {name: ms([e for e in kernels
                       if any(k in e.name for k in names)])
             for name, names in KERNEL_NAMES.items()}
    split["gemm"] = ms([e for e in kernels if any(
        w in e.name.lower() for w in GEMM_WORDS)])
    if "train.optimizer" in ranges:
        lo, hi = ranges["train.optimizer"]
        split["optimizer"] = ms([e for e in kernels
                                 if lo <= e.time_range.start
                                 and e.time_range.end <= hi])
    else:
        split["optimizer"] = "not measured"
    busy = window.get("device_busy_ms")
    if isinstance(busy, float):
        split["other"] = busy - sum(v for v in split.values()
                                    if isinstance(v, float))
    tokens = TRAIN_B * TRAIN_S
    emit({"phase": "profile_train", "window": "one 8B training step, "
          "B=1, S=2048, remat full", **window, "split_ms": split,
          "tok_s_profiled": tokens / (window["wall_ms"] / 1e3),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


def _cuda_kernel(wrapper, route, D):
    """The CUDA kernel that flash wrapper ``wrapper`` (flash_fwd,
    flash_bwd_dq, flash_bwd_dkv) launches on ``route`` for bf16 at head
    dim D, as ptxas names it."""
    return (f"{wrapper}_tc_kernel<{D}>" if route == "tc"
            else f"{wrapper}_kernel<bf16,{D}>")


def _row(name, source, replaces, launches, err, ms, plain, nbytes, flops,
         lib, kernel=""):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return {"name": name, "kernel": kernel, "route": "cuda",
            "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib, "bytes": nbytes, "flops": flops,
            "tflop_s": flops / ms / 1e9}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    all_phases = ["build", "parity", "engine", "engine_8k", "spec", "lora",
                  "fleet", "serve", "hf", "train", "parallel", "moe",
                  "moe_train", "mamba",
                  "clip", "resnet", "data", "channel", "dag", "grpo", "rl",
                  "reference", "timing"]
    phases = sys.argv[1].split(",") if len(sys.argv) > 1 else all_phases
    try:
        card = phase_device(torch)
        if "build" in phases:
            phase_build()
        max_err = phase_parity(torch) if "parity" in phases else {}
        torch.cuda.empty_cache()
        launches = {}
        if "engine" in phases:
            launches = phase_engine(torch)
            torch.cuda.empty_cache()
        if "engine_8k" in phases:
            # paged_decode runs on every serving path: its row counts all
            launches["paged_decode"] = (launches.get("paged_decode", 0)
                                        + phase_engine_8k(torch, card))
        for name, phase in (("spec", phase_spec), ("lora", phase_lora),
                            ("fleet", phase_fleet), ("serve", phase_serve),
                            ("hf", phase_hf)):
            if name in phases:
                for kernel, n in phase(torch, card).items():
                    launches[kernel] = launches.get(kernel, 0) + n
                torch.cuda.empty_cache()
        _SERVING.clear()
        torch.cuda.empty_cache()
        if "train" in phases:
            # flash_fwd runs on both paths: its row counts both runs
            for name, n in phase_train(torch, card).items():
                launches[name] = launches.get(name, 0) + n
            torch.cuda.empty_cache()
        if "parallel" in phases:
            # the 8B step and forwards through the mesh
            for name, n in phase_parallel(torch, card).items():
                launches[name] = launches.get(name, 0) + n
            torch.cuda.empty_cache()
        # the other families, after the 8B weights are freed; each phase
        # empties the cache and starts a new peak. The clip phase is the
        # one path at head_dim 64: its launches stand on the D=64 rows
        clip_launches = {}
        for name, phase in (("moe", phase_moe),
                            ("moe_train", phase_moe_train),
                            ("mamba", phase_mamba), ("clip", phase_clip),
                            ("resnet", phase_resnet), ("data", phase_data),
                            ("channel", phase_channel), ("dag", phase_dag),
                            ("grpo", phase_grpo),
                            ("rl", phase_rl)):
            if name in phases:
                counts = phase(torch, card)
                for kernel, n in counts.items():
                    launches[kernel] = launches.get(kernel, 0) + n
                if name in ("clip", "data"):
                    # CLIP's training, fed both ways in data
                    for kernel, n in counts.items():
                        clip_launches[kernel] = (clip_launches.get(kernel, 0)
                                                 + n)
                torch.cuda.empty_cache()
        if "reference" in phases:
            # the head_dim-16 runs (tiny, jamba_tiny, GRPO) count too
            for kernel, n in phase_reference(torch).items():
                launches[kernel] = launches.get(kernel, 0) + n
        if "profile" in phases:
            phase_profile(torch)
            torch.cuda.empty_cache()
        if "profile_train" in phases:
            phase_profile_train(torch)
            torch.cuda.empty_cache()
        if "profile_moe" in phases:
            phase_profile_moe(torch)
            torch.cuda.empty_cache()
        if "parallel4" in phases:
            phase_parallel4(torch, card)
            torch.cuda.empty_cache()
        if "timing" in phases:
            rows = phase_timing(torch, launches, max_err, clip_launches)
            emit({"kernels": [{k: r[k] for k in (
                "name", "kernel", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")} for r in rows]})
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if phases != all_phases and phases != ["parallel4"]:
        print("chip_smoke: partial run, no result", file=sys.stderr)
        return 3
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
