"""serve.outside_step_ms.batch (ms): ``serve.outside_step_ms`` in the
cells that report ``output_tokens_per_s.batch``; read by
``gpubench/work.py::outside_step_ms``."""

from gpubench.work import outside_step_ms as read  # noqa: F401
