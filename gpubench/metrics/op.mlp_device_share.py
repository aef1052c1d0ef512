"""op.mlp_device_share (%): the traced slice's busy time inside the
program's ``op.mlp`` device spans, over its busy time, in the cells that
report ``output_tokens_per_s``; read by
``gpubench/spans.py::mlp_device_share``."""

from gpubench.spans import mlp_device_share as read  # noqa: F401
