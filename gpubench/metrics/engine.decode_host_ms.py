"""engine.decode_host_ms (ms): host ms a decode step not spent waiting on
the card, from the program's ``engine.decode`` spans less their
``engine.decode.sync`` children over the window; read by
``gpubench/spans.py::decode_host_ms``."""

from gpubench.spans import decode_host_ms as read  # noqa: F401
