"""idle_share.serve (%): the traced slice's share with nothing running on
the card, in the cells that report ``output_tokens_per_s``; read by
``gpubench/work.py::idle_share``."""

from gpubench.work import idle_share as read  # noqa: F401
