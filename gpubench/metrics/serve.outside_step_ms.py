"""serve.outside_step_ms (ms): the server pump's host time between two
engine steps, in the cells that report ``output_tokens_per_s``; read by
``gpubench/work.py::outside_step_ms``."""

from gpubench.work import outside_step_ms as read  # noqa: F401
