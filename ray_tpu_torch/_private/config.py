"""The port's own copy of the flags it reads.

Counterpart of the ``llm_paged_kernel`` / ``llm_paged_kernel_min_ctx_pages``,
``serve_kv_handoff_chunk_bytes`` and ``llm_spec_fleet_verify*`` fields of
``ray_tpu/_private/config.py``. The port keeps its own copy and imports
nothing of ``ray_tpu``. Unlike the reference, ``llm_paged_kernel`` defaults
to True: on the card, decode runs the hand-written paged kernel; the gather
path stays selectable by the same flag. Each flag is overridden by the
environment variable ``RAY_TPU_TORCH_<NAME>``.
"""

from __future__ import annotations

import dataclasses
import os


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class DeviceConfig:
    # decode attention streams KV pages through the paged-decode kernel
    # (ops/paged_attention.py) instead of gathering them once per burst
    llm_paged_kernel: bool = True
    # when llm_paged_kernel is off, a decode round whose bucketed table
    # span is >= this many pages uses the paged kernel anyway (0 = never)
    llm_paged_kernel_min_ctx_pages: int = 0
    # prefill->decode KV handoff (llm/serve.py): exported pages are
    # shipped in puts of at most this many bytes
    serve_kv_handoff_chunk_bytes: int = 8 * 1024**2
    # speculative decoding, fleet verify: decode-pool replicas corroborate
    # each drafted window against the prefill pool, within the timeout
    llm_spec_fleet_verify: bool = False
    llm_spec_fleet_verify_timeout_s: float = 2.0

    @classmethod
    def from_env(cls) -> "DeviceConfig":
        env = os.environ.get
        return cls(
            llm_paged_kernel=_env_bool("RAY_TPU_TORCH_LLM_PAGED_KERNEL",
                                       True),
            llm_paged_kernel_min_ctx_pages=int(env(
                "RAY_TPU_TORCH_LLM_PAGED_KERNEL_MIN_CTX_PAGES", "0")),
            serve_kv_handoff_chunk_bytes=int(env(
                "RAY_TPU_TORCH_SERVE_KV_HANDOFF_CHUNK_BYTES",
                str(8 * 1024**2))),
            llm_spec_fleet_verify=_env_bool(
                "RAY_TPU_TORCH_LLM_SPEC_FLEET_VERIFY", False),
            llm_spec_fleet_verify_timeout_s=float(env(
                "RAY_TPU_TORCH_LLM_SPEC_FLEET_VERIFY_TIMEOUT_S", "2.0")))


_CONFIG = None


def global_config() -> DeviceConfig:
    """Process-wide flags, read from the environment at first use."""
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = DeviceConfig.from_env()
    return _CONFIG
