"""op.mlp_device_share.batch (%): ``op.mlp_device_share`` in the cells
that report ``output_tokens_per_s.batch``; read by
``gpubench/spans.py::mlp_device_share``."""

from gpubench.spans import mlp_device_share as read  # noqa: F401
