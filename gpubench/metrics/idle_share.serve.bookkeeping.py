"""idle_share.serve.bookkeeping (%): the part of ``idle_share.serve`` in
which the host's innermost span is the pump's, admission, a phase's prep,
the decode's emission or ``engine.step`` itself; read by
``gpubench/spans.py::idle_share_bookkeeping``."""

from gpubench.spans import idle_share_bookkeeping as read  # noqa: F401
