"""mfu.serve.batch (%): ``mfu.serve`` in the cells that report
``output_tokens_per_s.batch``; read by ``gpubench/work.py::serve_mfu``."""

from gpubench.work import serve_mfu as read  # noqa: F401
