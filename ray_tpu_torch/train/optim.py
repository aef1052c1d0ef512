"""AdamW with optax's semantics, updating in place one tensor at a time.

Counterpart of ``optax.adamw`` as the reference's trainer uses it. The
defaults are optax's: ``weight_decay=1e-4`` (torch's AdamW defaults to
1e-2) and no mask, so norms and the embedding decay too. mu and nu stay
in the parameter dtype (optax's ``mu_dtype=None``), and bias correction
follows optax's ``count``. Each leaf is updated on its own, so the
update's temporaries are one tensor wide; a list-wide (``foreach``) update
would build temporaries of several GB at 8B.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from .._private.tree import tree_leaves, tree_map


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: ``count`` updates applied so far,
    and the moments, trees laid out as the params."""
    count: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update_(self, params, grads: Sequence[torch.Tensor],
                state: AdamState) -> None:
        """One update of every leaf of ``params`` in place, ``grads`` in
        the order of ``tree_leaves(params)``:
        p -= lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p)."""
        state.count += 1
        bc1 = 1 - self.b1 ** state.count
        bc2 = 1 - self.b2 ** state.count
        for p, g, m, v in zip(tree_leaves(params), grads,
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = m.div(bc1).div_(v.div(bc2).sqrt_().add_(self.eps))
            p.add_(u.add_(p, alpha=self.weight_decay),
                   alpha=-self.learning_rate)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with a constant learning rate."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)
