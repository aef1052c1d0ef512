"""GRPO: group-relative policy optimisation for LLM RLHF (counterpart of
``ray_tpu/rllib/grpo.py``; Shao et al. 2024).

G completions are sampled per prompt; each completion's advantage is its
reward standardised within its group (the group mean is the baseline);
the update is a token-level policy gradient on the completion tokens
plus the k3 KL estimator (Schulman 2020) to the frozen reference policy.
The policy is the port's Llama (``models/llama.py``), so on the card
sampling and the update run through the flash kernels: ``flash_fwd``
for every forward, ``flash_bwd_dq`` and ``flash_bwd_dkv`` in the update's
backward (and, under ``cfg.remat``, ``flash_fwd`` again as each layer is
recomputed).

Sampling keeps the reference's semantics: one full ``forward`` over the
padded [G, P+T] tokens for every new token (no KV cache, no engine),
greedy at temperature 0, else Gumbel-max over the whole vocabulary with
noise from a ``torch.Generator`` on the algorithm's device (it cannot
match ``jax.random.categorical`` draw for draw). Rewards, group
standardisation (numpy's population std) and padding stay on the host.

The reference policy is a copy (``clone``) of the initial params: JAX's
``jax.tree.map(lambda x: x, params)`` shares immutable buffers, but the
port updates the policy in place, so a shared tensor would drag the
reference along and make the KL 0 for ever. ``GRPO(config, params=p)``
copies ``p`` and never writes to it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from .._private.tree import tree_leaves, tree_map, unstack_layers
from ..models.llama import LLAMA_CONFIGS, LlamaConfig, forward, init_params
from ..train.optim import adamw
from ..util.tracing import span

__all__ = ["GRPO", "GRPOConfig"]


@dataclass
class GRPOConfig:
    model: str = "tiny"               # LLAMA_CONFIGS key, or .llama_config
    llama_config: Optional[LlamaConfig] = None
    group_size: int = 8               # completions per prompt (G)
    max_prompt_len: int = 16
    max_tokens: int = 16              # completion budget
    temperature: float = 1.0
    lr: float = 1e-4
    kl_coef: float = 0.02
    adv_clip: float = 5.0
    seed: int = 0

    def training(self, **kwargs) -> "GRPOConfig":
        for key, val in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown training option {key!r}")
            setattr(self, key, val)
        return self

    def build(self, params=None, device: DeviceLike = None) -> "GRPO":
        return GRPO(self, params=params, device=device)


def _gumbel_argmax(logits, gen: torch.Generator):
    """A draw from softmax(logits) over the last axis: Gumbel-max with
    uniform noise from ``gen`` (on the logits' device)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return (logits + gumbel).argmax(dim=-1)


def _sample_group(params, cfg: LlamaConfig, prompt: Sequence[int],
                  group: int, max_tokens: int, temperature: float,
                  gen: Optional[torch.Generator]):
    """G sampled continuations of one prompt -> (tokens [G, P+T] int32,
    completion_mask [G, P+T] f32), numpy. Greedy when temperature == 0
    (``gen`` unused)."""
    dev = params["embed"].device
    plen = len(prompt)
    total = plen + max_tokens
    tokens = torch.zeros((group, total), dtype=torch.int32, device=dev)
    tokens[:, :plen] = torch.tensor(prompt, dtype=torch.int32)
    with torch.no_grad():
        for t in range(plen, total):
            logits = forward(params, tokens, cfg)[:, t - 1, :]
            if temperature == 0.0:
                nxt = logits.argmax(dim=-1)
            else:
                nxt = _gumbel_argmax(logits / temperature, gen)
            tokens[:, t] = nxt.to(torch.int32)
    mask = np.zeros((group, total), np.float32)
    mask[:, plen:] = 1.0
    return tokens.cpu().numpy(), mask


def _token_logp(params, tokens, cfg: LlamaConfig):
    """log pi(token t | tokens < t) for t >= 1, [B, S-1] f32."""
    logits = forward(params, tokens, cfg).float()
    logp_all = torch.log_softmax(logits[:, :-1, :], dim=-1)
    return logp_all.gather(-1, tokens[:, 1:, None].long())[..., 0]


def _grpo_loss(params, ref_params, batch, kl_coef: float, cfg: LlamaConfig):
    tokens = batch["tokens"]
    mask = batch["mask"][:, 1:]            # predicts token t from t - 1
    logp = _token_logp(params, tokens, cfg)
    with torch.no_grad():
        ref_logp = _token_logp(ref_params, tokens, cfg)
    adv = batch["advantages"][:, None]     # per sequence, broadcast
    denom = mask.sum() + 1e-8
    pg = -(adv * logp * mask).sum() / denom
    # k3 KL estimator: e^(ref - pi) - (ref - pi) - 1 >= 0, low variance
    diff = ref_logp - logp
    kl = ((torch.exp(diff) - diff - 1.0) * mask).sum() / denom
    total = pg + kl_coef * kl
    return total, (pg, kl, (logp * mask).sum() / denom)


def _grpo_update(params, ref_params, opt_state, batch, lr, *,
                 kl_coef: float, cfg: LlamaConfig):
    """One GRPO step in place (optax's adam: ``adamw(lr,
    weight_decay=0)``). ``params``: leaves that require grad, per-layer
    lists (``unstack_layers``) so that no layer's backward touches a whole
    stacked leaf. Returns (params, opt_state, metrics as 0-d tensors)."""
    loss, aux = _grpo_loss(params, ref_params, batch, kl_coef, cfg)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    adamw(lr, weight_decay=0.0).update_(params, grads, opt_state)
    del grads
    return params, opt_state, {"total_loss": loss.detach(),
                               "pg_loss": aux[0].detach(),
                               "kl": aux[1].detach(),
                               "mean_logp": aux[2].detach()}


class GRPO:
    """train(prompts, reward_fn): one GRPO iteration — sample G completions
    per prompt, group-standardise the rewards, one policy-gradient update
    with the reference KL. The policy, the reference and the optimizer
    state live on ``device`` (default: the card)."""

    def __init__(self, config: GRPOConfig, params=None,
                 device: DeviceLike = None):
        self.config = config
        self.cfg = config.llama_config or LLAMA_CONFIGS[config.model]
        self.device = resolve_device(device)
        if params is None:
            policy = init_params(self.cfg, seed=config.seed,
                                 device=self.device)
        else:
            policy = tree_map(lambda t: t.detach().to(self.device,
                                                      copy=True), params)
        # the frozen reference policy the KL tethers to: a copy
        self.ref_params = tree_map(lambda t: t.detach().clone(), policy)
        self.params = tree_map(lambda t: t.detach().requires_grad_(),
                               unstack_layers(policy))
        self.opt_state = adamw(config.lr, weight_decay=0.0).init(self.params)
        self._gen = torch.Generator(self.device).manual_seed(config.seed + 1)
        self.iteration = 0

    def train(self, prompts: Sequence[Sequence[int]],
              reward_fn: Callable[[List[List[int]]], Sequence[float]]
              ) -> Dict[str, Any]:
        """reward_fn receives the COMPLETION token lists (prompt
        stripped) for all groups flattened, returns one float each.
        ``timers`` holds the host milliseconds of sampling and rewards
        (ending when the last group's tokens reach the host) and of the
        update (ending when the losses do), the ranges a profile shows as
        ``grpo.sample`` and ``grpo.update``."""
        cfg, ccfg = self.cfg, self.config
        t0 = time.perf_counter()
        all_tokens, all_masks, all_advs, all_rewards = [], [], [], []
        with span("grpo.sample"):
            for prompt in prompts:
                prompt = list(prompt)[: ccfg.max_prompt_len]
                tokens, mask = _sample_group(
                    self.params, cfg, prompt, ccfg.group_size,
                    ccfg.max_tokens, ccfg.temperature, self._gen)
                completions = [row[len(prompt):].tolist() for row in tokens]
                rewards = np.asarray(reward_fn(completions), np.float32)
                # group-relative: the group's mean is the baseline
                adv = (rewards - rewards.mean()) / (rewards.std() + 1e-6)
                adv = np.clip(adv, -ccfg.adv_clip, ccfg.adv_clip)
                all_tokens.append(tokens)
                all_masks.append(mask)
                all_advs.append(adv)
                all_rewards.extend(rewards.tolist())
        t1 = time.perf_counter()
        # mixed prompt lengths: every group right-padded to the longest
        # total; pads sit after each row's completion, so causal attention
        # never lets them reach a scored position, and the mask (0 on
        # pads) keeps them out of the loss
        width = max(t.shape[1] for t in all_tokens)
        all_tokens = [np.pad(t, ((0, 0), (0, width - t.shape[1])))
                      for t in all_tokens]
        all_masks = [np.pad(m, ((0, 0), (0, width - m.shape[1])))
                     for m in all_masks]
        batch = {
            "tokens": torch.from_numpy(np.concatenate(all_tokens)),
            "mask": torch.from_numpy(np.concatenate(all_masks)),
            "advantages": torch.from_numpy(np.concatenate(all_advs)),
        }
        with span("grpo.update"):
            batch = {k: v.to(self.device) for k, v in batch.items()}
            self.params, self.opt_state, losses = _grpo_update(
                self.params, self.ref_params, self.opt_state, batch,
                ccfg.lr, kl_coef=ccfg.kl_coef, cfg=cfg)
            losses = {k: float(v) for k, v in losses.items()}
        t2 = time.perf_counter()
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "reward_mean": float(np.mean(all_rewards)),
            "reward_std": float(np.std(all_rewards)),
            "num_completions": len(all_rewards),
            **losses,
            "timers": {"sample_ms": (t1 - t0) * 1e3,
                       "update_ms": (t2 - t1) * 1e3},
        }
