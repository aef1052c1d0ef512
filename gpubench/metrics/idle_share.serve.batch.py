"""idle_share.serve.batch (%): ``idle_share.serve`` in the cells that
report ``output_tokens_per_s.batch``; read by
``gpubench/work.py::idle_share``."""

from gpubench.work import idle_share as read  # noqa: F401
