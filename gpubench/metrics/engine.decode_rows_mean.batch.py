"""engine.decode_rows_mean.batch (rows): ``engine.decode_rows_mean`` in
the cells that report ``output_tokens_per_s.batch``; read by
``gpubench/work.py::decode_rows_mean``."""

from gpubench.work import decode_rows_mean as read  # noqa: F401
