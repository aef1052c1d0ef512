"""idle_share.serve.dispatch (%): the part of ``idle_share.serve`` in
which the host's innermost span is the runner's or an op's (the model's
forward being launched); read by
``gpubench/spans.py::idle_share_dispatch``."""

from gpubench.spans import idle_share_dispatch as read  # noqa: F401
