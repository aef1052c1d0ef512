"""engine.decode_rows_mean (rows): rows a decode step advanced over the
window, in the cells that report ``output_tokens_per_s``; read by
``gpubench/work.py::decode_rows_mean``."""

from gpubench.work import decode_rows_mean as read  # noqa: F401
