"""serve.pump_ms (ms): the server pump's host time a step outside the
engine, from the program's ``serve.pump.hop`` and ``serve.pump.fanout``
spans over the window, in the cells that report ``output_tokens_per_s``;
read by ``gpubench/spans.py::pump_ms``."""

from gpubench.spans import pump_ms as read  # noqa: F401
