"""mfu.serve (%): the served tokens' operations over the window, as a
share of the card's dense bf16 peak, in the cells that report
``output_tokens_per_s``; read by ``gpubench/work.py::serve_mfu``."""

from gpubench.work import serve_mfu as read  # noqa: F401
