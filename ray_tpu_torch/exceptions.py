"""The port's own copies of the reference's exceptions that its device
plane raises (counterpart of the matching classes of
``ray_tpu/exceptions.py``)."""

from __future__ import annotations


class CollectiveTimeoutError(TimeoutError):
    """A collective op timed out waiting for peers (names missing ranks)."""

    def __init__(self, op: str = "collective", missing_ranks=None,
                 timeout_s: float = 0.0, detail: str = ""):
        self.op = op
        self.missing_ranks = list(missing_ranks or [])
        self.timeout_s = timeout_s
        msg = f"{op} timed out after {timeout_s:.1f}s"
        if self.missing_ranks:
            msg += f"; missing ranks: {self.missing_ranks}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
