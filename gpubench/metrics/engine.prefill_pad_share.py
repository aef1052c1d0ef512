"""engine.prefill_pad_share (%): padding's share of the tokens the
window's prefills ran, from the program's ``engine.prefill`` spans; read
by ``gpubench/spans.py::prefill_pad_share``."""

from gpubench.spans import prefill_pad_share as read  # noqa: F401
