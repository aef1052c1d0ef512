"""HuggingFace checkpoint interop for the Llama family (counterpart of
``ray_tpu/models/hf_interop.py``): safetensors files and ``config.json``
<-> the port's stacked Llama tree.

The safetensors IO is the reference's own format, written and read over
bytes: an 8-byte little-endian header length, a JSON header of
``{name: {dtype, shape, data_offsets}}`` in the tensors' order, then each
tensor's row-major bytes. bf16 goes through ``tensor.view(torch.uint8)``
on write and ``torch.frombuffer`` on read, so neither ``ml_dtypes`` nor
``safetensors`` nor ``transformers`` is needed, and a file either side
writes loads bit for bit in the other.

Layouts, as in the reference: HF linears are (out, in), the port's
projections (in, out) with the heads split (``wq`` (d, h, hd), ``wo``
(h, hd, d)); HF keeps one tensor per layer, the port stacks them on a
leading "layers" axis. Rotary is the half-split convention HF uses, so
q and k need no permutation. A checkpoint with ``tie_word_embeddings``
has no ``lm_head``: it becomes a contiguous copy of ``embed.T`` (a view
would share ``embed``'s storage, so an in-place update of one would move
the other).
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .._private.device import DeviceLike, resolve_device
from .._private.tree import layer_params, tree_map
from ..ops.quant import quantize_params
from .llama import LlamaConfig

__all__ = ["config_from_hf", "config_to_hf", "load_hf_checkpoint",
           "read_safetensors", "save_hf_checkpoint", "write_safetensors"]

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {dtype: name for name, dtype in _ST_DTYPES.items()}


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (on any device, any strides) to one safetensors
    file with the reference's header. The header is made from shapes
    alone; each tensor is then made contiguous, copied to the host and
    written in turn, so the host holds one tensor at a time."""
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"unsupported safetensors dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            host = t.detach().contiguous().cpu().reshape(-1)
            f.write(host.view(torch.uint8).numpy())


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of one safetensors file, as CPU tensors over a
    copy-on-write map of the file: nothing is read until a tensor is used,
    and writing to one changes neither the file nor the others."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + header_len
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        if end == start:
            out[name] = torch.empty(tuple(meta["shape"]), dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - start,
                               offset=base + start)
        out[name] = raw.view(dtype).reshape(tuple(meta["shape"]))
    return out


def config_from_hf(hf: Dict[str, Any], **overrides) -> LlamaConfig:
    cfg = LlamaConfig(
        vocab=hf["vocab_size"],
        dim=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads",
                          hf["num_attention_heads"]),
        mlp_dim=hf["intermediate_size"],
        max_seq=hf.get("max_position_embeddings", 8192),
        rope_theta=float(hf.get("rope_theta", 500000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def config_to_hf(cfg: LlamaConfig) -> Dict[str, Any]:
    return {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab,
        "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.mlp_dim,
        "max_position_embeddings": cfg.max_seq,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "head_dim": cfg.head_dim,
        "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
    }


def _load_shards(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of a single-file or index-sharded safetensors
    checkpoint, as a flat {hf_name: CPU tensor} dict (see
    :func:`read_safetensors`)."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        shards = sorted(set(weight_map.values()))
    else:
        shards = ["model.safetensors"]
    tensors: Dict[str, torch.Tensor] = {}
    for shard in shards:
        tensors.update(read_safetensors(os.path.join(path, shard)))
    return tensors


def load_hf_checkpoint(path: str, dtype: Optional[torch.dtype] = None,
                       quantize: Optional[str] = None,
                       device: DeviceLike = None,
                       **config_overrides) -> Tuple[Dict, LlamaConfig]:
    """Import an HF-format Llama checkpoint directory -> (params, cfg).

    ``path`` holds config.json and model.safetensors (or shards with an
    index). ``dtype`` overrides the storage dtype (default: the config's,
    bf16). Each per-layer group is stacked straight into one tensor
    allocated on ``device`` (default: the card): a layer's HF tensor is
    copied there as it lies in the file, then transposed and cast into its
    slot, so the host never holds the tree. ``quantize="int8"`` assembles
    the tree on the host instead, rounded to ``dtype`` first, quantizes it
    there with ``ops.quant.quantize_params`` (per-output-channel int8, the
    embedding per row) and moves the int8 tree to ``device``: the
    full-precision tree never occupies the card."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    if dtype is not None:
        config_overrides.setdefault("dtype", dtype)
    cfg = config_from_hf(hf_cfg, **config_overrides)
    t = _load_shards(path)
    stage = torch.device("cpu") if quantize else dev
    L, d, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads

    def new(src: torch.Tensor, shape=None) -> torch.Tensor:
        """A fresh tensor on ``stage`` in cfg.dtype: ``src`` as it is, or,
        given our ``shape``, HF's (out, in) transposed into it."""
        src = src.to(stage)
        if shape is None:
            return torch.empty(src.shape, dtype=cfg.dtype,
                               device=stage).copy_(src)
        return torch.empty(shape, dtype=cfg.dtype,
                           device=stage).copy_(src.T.reshape(shape))

    def stacked(fmt: str, shape=None) -> torch.Tensor:
        first = t[fmt.format(0)]
        out = torch.empty((L, *(shape or first.shape)), dtype=cfg.dtype,
                          device=stage)
        for i in range(L):
            src = t[fmt.format(i)].to(stage)
            out[i].copy_(src if shape is None else src.T.reshape(shape))
        return out

    pre = "model.layers.{}."
    layers = {
        "attn_norm": stacked(pre + "input_layernorm.weight"),
        "wq": stacked(pre + "self_attn.q_proj.weight", (d, h, hd)),
        "wk": stacked(pre + "self_attn.k_proj.weight", (d, hkv, hd)),
        "wv": stacked(pre + "self_attn.v_proj.weight", (d, hkv, hd)),
        # o_proj is (d, h*hd): transposed to (h*hd, d), split to (h, hd, d)
        "wo": stacked(pre + "self_attn.o_proj.weight", (h, hd, d)),
        "mlp_norm": stacked(pre + "post_attention_layernorm.weight"),
        "w_gate": stacked(pre + "mlp.gate_proj.weight", (d, cfg.mlp_dim)),
        "w_up": stacked(pre + "mlp.up_proj.weight", (d, cfg.mlp_dim)),
        "w_down": stacked(pre + "mlp.down_proj.weight", (cfg.mlp_dim, d)),
    }
    embed = new(t["model.embed_tokens.weight"])
    if "lm_head.weight" in t:
        lm_head = new(t["lm_head.weight"], (d, cfg.vocab))
    else:  # tie_word_embeddings: a copy, not a view of embed
        lm_head = embed.T.contiguous()
    params = {
        "embed": embed,
        "layers": layers,
        "final_norm": new(t["model.norm.weight"]),
        "lm_head": lm_head,
    }
    if quantize == "int8":
        params = tree_map(lambda x: x.to(dev),
                          quantize_params(params, cfg))
    return params, cfg


def save_hf_checkpoint(params: Dict, cfg: LlamaConfig, path: str) -> None:
    """Export a dense Llama tree (stacked, or the trainer's per-layer
    lists; on any device) to an HF-format directory: config.json and
    model.safetensors, loadable by transformers and by
    :func:`load_hf_checkpoint`, byte for byte the file the reference
    writes for the same values."""
    if cfg.n_experts:
        raise NotImplementedError(
            "HF export for MoE configs is not wired up (mixtral-format "
            "expert naming differs); dense Llama only")
    os.makedirs(path, exist_ok=True)
    d = cfg.dim
    t: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
        "lm_head.weight": params["lm_head"].T,
    }
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        pre = f"model.layers.{i}."
        t[pre + "input_layernorm.weight"] = lp["attn_norm"]
        t[pre + "self_attn.q_proj.weight"] = lp["wq"].reshape(d, -1).T
        t[pre + "self_attn.k_proj.weight"] = lp["wk"].reshape(d, -1).T
        t[pre + "self_attn.v_proj.weight"] = lp["wv"].reshape(d, -1).T
        t[pre + "self_attn.o_proj.weight"] = lp["wo"].reshape(-1, d).T
        t[pre + "post_attention_layernorm.weight"] = lp["mlp_norm"]
        t[pre + "mlp.gate_proj.weight"] = lp["w_gate"].T
        t[pre + "mlp.up_proj.weight"] = lp["w_up"].T
        t[pre + "mlp.down_proj.weight"] = lp["w_down"].T
    write_safetensors(t, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg), f, indent=2)
