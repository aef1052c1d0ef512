"""Why ``mistral7b.train.s8k`` is not a cell yet: the program's bf16
step leaves the RMSNorm weights unmoved where the float32 reference
moves them.

The trainer keeps the parameters and AdamW's moments in the parameters'
dtype and has no float32 master copy. At ``adamw(3e-4,
weight_decay=0.1)`` an update moves a weight by about 3e-4, while a bf16
weight near 1.0 (every norm weight) lies 2**-8 or 2**-7 from its
neighbours: the update is under half a step and rounds away. The reference
(and the program itself in float32) moves them. By the comparison's rules
a run that leaves unmoved a leaf the reference moves is no sound run, so
the cell waits for an optimizer with float32 master weights or stochastic
rounding.

The CPU test shows it at a small size (bf16 against float32, one path of
the program each); the card test at the cell's size on three seeds, with
the float32 update that the same gradient (from AdamW's first moment)
would give beside it. Each test asserts the fault, so it fails once the
program is mended: the cell can then be added.
"""

from __future__ import annotations

import json

import pytest
import torch

from gpubench import model
from gpubench.spec import spec_from_config

from conftest import TINY_CONFIG

LR, WD = 3e-4, 0.1


def _one_step(spec, seed, seq, device):
    """The program's train step, one step on a seeded batch: the norm
    leaves' bits before and after, and the first moments."""
    from ray_tpu_torch.models.llama import lm_loss
    from ray_tpu_torch.train import adamw, make_train_step

    cfg = model.llama_config(spec, remat=True)
    w = model.make_weights(spec, seed, device)
    norms = {k: w["layers"][k].clone() for k in ("attn_norm", "mlp_norm")}
    norms["final_norm"] = w["final_norm"].clone()
    init_fn, step_fn, _ = make_train_step(
        lambda p, b: lm_loss(p, b, cfg), adamw(LR, weight_decay=WD),
        device=device)
    state = init_fn(w)
    gen = torch.Generator(device).manual_seed(seed)
    tokens = torch.randint(0, spec.vocab, (1, seq), generator=gen,
                           device=device)
    state, m = step_fn(state, {"tokens": tokens})
    after = {"attn_norm": w["layers"]["attn_norm"],
             "mlp_norm": w["layers"]["mlp_norm"],
             "final_norm": w["final_norm"]}
    return norms, after, state, float(m["loss"])


def _unmoved(before, after):
    return {k: int((before[k] == after[k]).all(dim=-1).sum())
            if before[k].dim() > 1 else int(bool((before[k] == after[k]).all()))
            for k in before}


@pytest.mark.parametrize("dtype,moves", [("bfloat16", False),
                                         ("float32", True)])
def test_norm_weights_move_only_in_float32_on_cpu(dtype, moves):
    spec = spec_from_config(dict(TINY_CONFIG, torch_dtype=dtype))
    before, after, _, _ = _one_step(spec, 5, 64, torch.device("cpu"))
    unmoved = _unmoved(before, after)
    if moves:
        assert unmoved == {"attn_norm": 0, "mlp_norm": 0, "final_norm": 0}
    else:
        assert unmoved == {"attn_norm": spec.n_layers,
                           "mlp_norm": spec.n_layers, "final_norm": 1}


@pytest.mark.cuda
def test_bf16_step_leaves_norm_weights_unmoved_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the step runs at full size")
    from gpubench.run import ROOT

    spec = spec_from_config(json.loads(
        (ROOT / "gpubench" / "configs" / "mistral-7b-v0.3.json").read_text()))
    dev = torch.device("cuda")
    for seed in (2**31 + 11, 2**31 + 22, 2**31 + 33):
        before, after, state, loss = _one_step(spec, seed, 8192, dev)
        unmoved = _unmoved(before, after)
        # the float32 first step from the same gradient: g = mu / (1 - b1),
        # p -= lr * (g / (|g| + eps) + wd * p)
        mu = state.opt_state.mu
        ref = []
        for li in range(spec.n_layers):
            for k in ("attn_norm", "mlp_norm"):
                g = mu["layers"][li][k].float() / 0.1
                p = before[k][li].float()
                ref.append(float((LR * (g / (g.abs() + 1e-8) + WD * p))
                                 .norm()))
        print(json.dumps({"seed": seed, "loss": loss,
                          "norm_leaves_unmoved": unmoved,
                          "f32_change_norm_min": min(ref),
                          "f32_change_norm_max": max(ref)}), flush=True)
        assert unmoved == {"attn_norm": spec.n_layers,
                           "mlp_norm": spec.n_layers, "final_norm": 1}
        assert min(ref) > 0
        del before, after, state
        torch.cuda.empty_cache()
