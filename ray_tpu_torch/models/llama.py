"""Llama-3 family in PyTorch (counterpart of ``ray_tpu/models/llama.py``).

Parameters are a nested dict of tensors with the reference's stacked
tree: layer weights carry a leading "layers" axis, projections keep the
reference's einsum layouts (wq (L, d, h, hd), wo (L, h, hd, d), ...), so
a ``ray_tpu`` tree converts leaf for leaf (models/convert.py).

``forward`` is the single-device forward; the layers run as a Python
loop over the stacked axis, each under ``torch.utils.checkpoint`` when
``cfg.remat`` is set and grad is on. ``lm_loss`` is the training loss.
The trainer (train/step.py) hands the model one leaf per layer and name
instead of the stacked leaves (``params["layers"]`` a list of per-layer
dicts), so that no layer's backward touches a whole stacked leaf.

MoE configurations (``n_experts > 0``) route each layer's MLP through
``ops.moe.moe_mlp`` (top-k, capacity-capped dispatch); ``forward`` can
return the layers' summed load-balancing loss, which ``lm_loss`` adds
with ``aux_loss_coef``.

Under a mesh (``forward(..., mesh=...)``, params as DTensors placed by
``param_logical_axes``) the activations are constrained at the
reference's points and DTensor inserts the collectives, as GSPMD does
there. Attention runs in a per-rank region on each rank's local q, k, v:
``ring_attention`` over "sp" when the mesh has sp > 1, else the flash
path with whole sequences and heads split over tp; so does the lm_head
product, the vocab split over tp.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._private.device import resolve_device
from .._private.tree import layer_params
from ..ops import apply_rotary, attention, rms_norm, rope_frequencies
from ..ops.moe import moe_mlp
from ..ops.quant import logits_matmul
from ..ops.ring_attention import ring_attention
from ..parallel.collectives import (_mentioned, _names, allreduce,
                                    axis_index, shard_map)
from ..parallel.mesh import active_mesh, axis_sizes
from ..parallel.sharding import (DEFAULT_RULES, _spec_for,
                                 distribute_batch, fit_spec,
                                 with_sharding_constraint_logical)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 2.0
    aux_loss_coef: float = 0.01
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def n_params(self) -> int:
        d, L = self.dim, self.n_layers
        attn = d * self.n_heads * self.head_dim \
            + 2 * d * self.n_kv_heads * self.head_dim \
            + self.n_heads * self.head_dim * d
        mlp = 3 * d * self.mlp_dim
        if self.n_experts:
            mlp = self.n_experts * mlp + d * self.n_experts
        return self.vocab * d * 2 + L * (attn + mlp + 2 * d) + d


LLAMA_CONFIGS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(vocab=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, mlp_dim=128, max_seq=256,
                        dtype=torch.float32, remat=False),
    "400m": LlamaConfig(vocab=32768, dim=1024, n_layers=24, n_heads=8,
                        n_kv_heads=4, mlp_dim=2816, max_seq=2048,
                        remat_policy="dots"),
    "1b": LlamaConfig(vocab=128256, dim=2048, n_layers=16, n_heads=16,
                      n_kv_heads=8, mlp_dim=8192, max_seq=8192),
    "8b": LlamaConfig(),  # Llama-3-8B
    "70b": LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                       mlp_dim=28672),
}


def param_logical_axes(cfg: LlamaConfig):
    """Tree of logical-axis tuples mirroring init_params' structure."""
    if cfg.n_experts:
        mlp_axes = {
            "router": ("layers", "embed", "expert"),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        }
    else:
        mlp_axes = {
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        }
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "mlp_norm": ("layers", "embed"),
            **mlp_axes,
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def init_params(cfg: LlamaConfig, seed: int = 0, device=None):
    """Scaled-normal init (1/sqrt(fan_in)) from a seeded torch.Generator,
    stored in ``cfg.dtype``. ``device=None`` is the CUDA card;
    ``device="meta"`` gives the shapes without allocating. Draws are made
    one layer at a time in f32, so the f32 temporaries stay one layer
    wide (one expert wide for MoE weights). An MoE router is stored in
    f32 whatever ``cfg.dtype``, as in the reference. The values differ
    from the JAX init (another generator); tests carry JAX weights over
    with models/convert.py."""
    dev = resolve_device(device)
    L, d, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    h, hkv, m = cfg.n_heads, cfg.n_kv_heads, cfg.mlp_dim
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(dev)
        gen.manual_seed(seed)

    def norm(shape, fan_in, lead=0, dtype=cfg.dtype):
        """Drawn one slice of the ``lead`` leading axes at a time."""
        out = torch.empty(shape, dtype=dtype, device=dev)
        if gen is None:
            return out
        for sl in out.view(-1, *shape[lead:]) if lead else [out]:
            sl.copy_(torch.randn(sl.shape, generator=gen, device=dev,
                                 dtype=torch.float32) * fan_in ** -0.5)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    if cfg.n_experts:
        E = cfg.n_experts
        mlp = {"router": norm((L, d, E), d, 1, torch.float32),
               "w_gate": norm((L, E, d, m), d, 2),
               "w_up": norm((L, E, d, m), d, 2),
               "w_down": norm((L, E, m, d), m, 2)}
    else:
        mlp = {"w_gate": norm((L, d, m), d, 1),
               "w_up": norm((L, d, m), d, 1),
               "w_down": norm((L, m, d), m, 1)}
    return {
        "embed": norm((cfg.vocab, d), d),
        "layers": {
            "attn_norm": ones((L, d)),
            "wq": norm((L, d, h, hd), d, 1),
            "wk": norm((L, d, hkv, hd), d, 1),
            "wv": norm((L, d, hkv, hd), d, 1),
            "wo": norm((L, h, hd, d), h * hd, 1),
            "mlp_norm": ones((L, d)),
            **mlp,
        },
        "final_norm": ones((d,)),
        "lm_head": norm((d, cfg.vocab), d),
    }


def _mesh_attention(q, k, v, mesh, rules):
    """Attention on each rank's local q, k, v: ring attention over "sp"
    when the mesh has sp > 1, else the flash path on whole sequences with
    the batch and heads split as the rules split them."""
    seq = "seq" if axis_sizes(mesh).get("sp", 1) > 1 else None
    spec = _spec_for(("batch", seq, "heads", None), rules, mesh)
    spec = min((fit_spec(spec, t.shape, mesh) for t in (q, k)), key=len)
    fn = (functools.partial(ring_attention, axis="sp", causal=True) if seq
          else functools.partial(attention, causal=True))
    return shard_map(fn, mesh, spec, spec)(q, k, v)


def _mesh_logits(x, head, mesh, rules):
    """The lm_head product on each rank's local blocks, the vocab split
    as the rules split it (DTensor has no rule for the card's bf16
    product with an f32 result)."""
    shape = (*x.shape[:-1], head.shape[-1])
    spec = fit_spec(_spec_for(("batch", "seq", "vocab"), rules, mesh),
                    shape, mesh)
    spec = spec + (None,) * (3 - len(spec))
    x_spec, head_spec = spec[:2], (None, spec[2])
    return shard_map(logits_matmul, mesh, [x_spec, head_spec], spec)(
        x, head)


def _vocab_lookup(table, ids, axis):
    """Rows ``ids`` of the vocab-split ``table`` (this rank's block of
    the vocab along ``axis``): each rank looks up the ids in its block,
    zeros the others, and the sum over ``axis`` puts every row together
    (Megatron's vocab-parallel embedding)."""
    ids = ids.long()
    if axis is None:
        return table[ids]
    local = ids - axis_index(axis) * table.shape[0]
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return allreduce(rows * mine[..., None].to(rows.dtype), axis)


def _mesh_embed(table, tokens, mesh, rules):
    """The table lookup on each rank's local tokens, the table's vocab
    split as the rules split it and its embed dim whole (the reference
    gathers from a (vocab, None) table). Its gradient leaves the region
    partial over the other axes and is summed into the table's
    placement. DTensor's own gather fails its backward,
    ``aten.index_put``, on batch-sharded indices in torch 2.11."""
    shape = (*tokens.shape, table.shape[-1])
    spec = fit_spec(_spec_for(("batch", "seq", None), rules, mesh), shape,
                    mesh)
    spec = spec + (None,) * (3 - len(spec))
    table_spec = fit_spec(_spec_for(("vocab", None), rules, mesh),
                          table.shape, mesh)
    axis = table_spec[0] if table_spec else None
    if axis is not None and set(_names(axis)) & _mentioned(spec):
        # tokens split over the vocab's axis: no rank has all of a row's
        # lookups, so every rank takes the whole table
        axis, table_spec = None, ()
    return shard_map(functools.partial(_vocab_lookup, axis=axis), mesh,
                     [table_spec, spec[:2]], spec)(table, tokens)


def _product(eq, x, w, batched=False):
    """``torch.einsum(eq, x, w)`` for a projection: x's dims after
    (batch, seq) contracted with w's leading ones. ``batched``: as one
    product a batch row (bmm), for a sequence-sharded x: torch 2.11's
    DTensor cannot view (batch, seq) as one dim when seq is sharded,
    which einsum asks for."""
    if not batched:
        return torch.einsum(eq, x, w)
    n_in = x.dim() - 2
    w2 = w.flatten(0, n_in - 1).flatten(1)
    out = torch.bmm(x.flatten(2),
                    w2.unsqueeze(0).expand(x.shape[0], -1, -1))
    return out.unflatten(-1, w.shape[n_in:])


def _layer(x, lp, cfg: LlamaConfig, cos, sin, mesh=None, rules=None):
    csl = functools.partial(with_sharding_constraint_logical, rules=rules,
                            mesh=mesh)
    seq_sharded = mesh is not None and axis_sizes(mesh).get("sp", 1) > 1
    prod = functools.partial(_product, batched=seq_sharded)
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = apply_rotary(prod("bsd,dhk->bshk", h, lp["wq"]), cos, sin)
    k = apply_rotary(prod("bsd,dhk->bshk", h, lp["wk"]), cos, sin)
    v = prod("bsd,dhk->bshk", h, lp["wv"])
    if mesh is None:
        o = attention(q, k, v, causal=True)
    else:
        o = _mesh_attention(q, k, v, mesh, rules)
    x = csl(x + prod("bshk,hkd->bsd", o, lp["wo"]),
            ("batch", "seq", "embed"))
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    out, aux = _mlp(h, lp, cfg, csl if mesh is not None else None, prod)
    return csl(x + out, ("batch", "seq", "embed")), aux


def _mlp(h, lp, cfg: LlamaConfig, csl=None, prod=_product):
    """SwiGLU, or the routed expert MLP for MoE; and the layer's f32
    load-balancing loss (None when dense)."""
    if cfg.n_experts:
        return moe_mlp(h, lp["router"], lp["w_gate"], lp["w_up"],
                       lp["w_down"], top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor, csl=csl)
    g = prod("bsd,dm->bsm", h, lp["w_gate"])
    u = prod("bsd,dm->bsm", h, lp["w_up"])
    if csl is not None:
        # the hidden over tp: left to DTensor, the down projection's input
        # can come out sharded three ways, whose first sharding
        # propagation takes minutes on a 3-dim mesh
        g, u = (csl(t, ("batch", "seq", "mlp")) for t in (g, u))
    out = prod("bsm,md->bsd", torch.nn.functional.silu(g) * u,
               lp["w_down"])
    return out, None


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: save
    the products without batch dims (the projections, which einsum lowers
    to bmm with a batch of 1, or mm), recompute everything else."""
    aten = torch.ops.aten
    if (op in (aten.mm.default, aten.addmm.default)
            or (op is aten.bmm.default and args[0].shape[0] == 1)):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer_body(cfg: LlamaConfig):
    """The layer as the forward runs it: under per-layer remat when
    ``cfg.remat`` is set and grad is on (``remat_policy`` "dots" saves the
    projections, anything else recomputes the whole layer), else bare."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _layer
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, _layer, **kw)


def _replicated(t, mesh):
    on = active_mesh(mesh)
    return DTensor.from_local(t, on, [Replicate()] * on.mesh.ndim)



def forward(params, tokens: torch.Tensor, cfg: LlamaConfig, *,
            mesh=None, rules=DEFAULT_RULES, return_aux: bool = False):
    """tokens (B, S) int → logits (B, S, vocab) in f32. Attention is the
    flash kernels on the card and their plain versions on the CPU.
    ``return_aux``: also return the MoE load-balancing loss summed over
    layers (f32 scalar, 0 for a dense model). With ``mesh`` the params
    are DTensors on it, the tokens a DTensor or a tensor every rank holds
    whole, and the logits a DTensor sharded by ("batch", "seq",
    "vocab")."""
    S = tokens.shape[1]
    dev = tokens.device
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta,
                                device=dev)
    csl = functools.partial(with_sharding_constraint_logical, rules=rules,
                            mesh=mesh)
    if mesh is None:
        x = params["embed"][tokens.long()]
    else:
        tokens = distribute_batch(tokens, mesh, rules)
        cos, sin = _replicated(cos, mesh), _replicated(sin, mesh)
        x = csl(_mesh_embed(params["embed"], tokens, mesh, rules),
                ("batch", "seq", "embed"))
    body = _layer_body(cfg)
    aux = None
    for li in range(cfg.n_layers):
        x, layer_aux = body(x, layer_params(params["layers"], li), cfg,
                            cos, sin, mesh, rules)
        if layer_aux is not None:
            aux = layer_aux if aux is None else aux + layer_aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # operands in the model dtype, f32 accumulation and result
    x, head = x.to(cfg.dtype), params["lm_head"].to(cfg.dtype)
    if mesh is None:
        logits = logits_matmul(x, head)
    else:
        logits = _mesh_logits(x, head, mesh, rules)
    logits = csl(logits, ("batch", "seq", "vocab"))
    if not return_aux:
        return logits
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        if mesh is not None:
            aux = _replicated(aux, mesh)
    return logits, aux


def lm_loss(params, batch, cfg: LlamaConfig, *, mesh=None,
            rules=DEFAULT_RULES, z_loss: float = 1e-4):
    """Next-token cross-entropy in f32 with the z-loss regularizer.

    batch: {"tokens": (B, S) int, "mask": optional (B, S) 0/1 valid}.
    Targets are the tokens shifted left; the final position is dropped.
    loss = sum(nll * mask) / max(sum(mask), 1), plus ``aux_loss_coef``
    times the summed load-balancing loss for MoE (added after masking, so
    an all-masked MoE batch gives ``aux_loss_coef * aux``)."""
    tokens, mask = batch["tokens"], batch.get("mask")
    if mesh is not None:
        tokens, mask = (distribute_batch(t, mesh, rules) for t in (tokens, mask))
    if cfg.n_experts:
        logits, aux = forward(params, tokens, cfg, mesh=mesh, rules=rules,
                              return_aux=True)
    else:
        logits = forward(params, tokens, cfg, mesh=mesh, rules=rules)
    if mesh is not None:
        # whole rows of the vocab and the sequence on each rank: DTensor's
        # gather over a vocab-sharded dim fails
        logits = with_sharding_constraint_logical(
            logits, ("batch", None, None), rules, mesh)
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - logits.gather(-1, targets[..., None])[..., 0]
    if z_loss:
        nll = nll + z_loss * logz.square()
    mask = (torch.ones_like(nll) if mask is None
            else mask[:, 1:].to(nll.dtype))
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    if cfg.n_experts:
        loss = loss + cfg.aux_loss_coef * aux
    return loss
