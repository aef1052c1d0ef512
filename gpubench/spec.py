"""A configuration file read into the sizes the yardstick works from.

The file holds the published ``config.json`` keys (Hugging Face names) as
they are run; ``ModelSpec`` is the benchmark's own reading of them, used by
the FLOP arithmetic, the weight maker and the reference. It imports
nothing of the program.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    mlp_dim: int
    rope_theta: float
    norm_eps: float
    max_positions: int
    n_experts: int = 0       # 0: a dense MLP
    top_k: int = 0           # experts a token, when n_experts > 0
    dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def spec_from_config(cfg: Dict[str, Any]) -> ModelSpec:
    """The sizes of a Mistral or Mixtral ``config.json``."""
    dim, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    head_dim = int(cfg.get("head_dim") or dim // heads)
    if cfg.get("sliding_window") is not None:
        raise ValueError("a sliding window is not part of these models")
    return ModelSpec(
        vocab=int(cfg["vocab_size"]), dim=dim,
        n_layers=int(cfg["num_hidden_layers"]), n_heads=heads,
        n_kv_heads=int(cfg["num_key_value_heads"]), head_dim=head_dim,
        mlp_dim=int(cfg["intermediate_size"]),
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        max_positions=int(cfg["max_position_embeddings"]),
        n_experts=int(cfg.get("num_local_experts", 0)),
        top_k=int(cfg.get("num_experts_per_tok", 0)),
        dtype=str(cfg.get("torch_dtype", "bfloat16")))


def load_spec(path: Path) -> ModelSpec:
    return spec_from_config(json.loads(Path(path).read_text()))
