"""Multi-process bring-up of a training gang (counterpart of
``_maybe_init_jax_distributed`` in ``ray_tpu/train/worker_group.py``).

The reference's rank-0 coordinator rendezvous (``jax.distributed``)
becomes ``torch.distributed.init_process_group``. The actors around it
(the worker group, its polling and checkpoint handover) are host plane
and are not ported.
"""

from __future__ import annotations

import datetime

import torch.distributed as dist

from .._private.device import DeviceLike, resolve_device


def init_torch_distributed(context, device: DeviceLike = None,
                           timeout_s: float = 600.0) -> bool:
    """Join the gang's process group: ``context`` carries
    ``coordinator_address`` ("host:port", or an init-method URL such as
    ``file:///path``), ``world_size`` and ``rank`` (the reference's
    ``TrainContext``). NCCL for the card (the default ``device``; raises
    without one), gloo for ``device="cpu"``. Nothing at world size 1 or
    without an address; a process whose group is already initialized (a
    gang restart on a reused process) keeps it. Every other rendezvous
    error is raised. Returns whether it made the group."""
    dev = resolve_device(device)
    if context.world_size <= 1 or not context.coordinator_address:
        return False
    if dist.is_initialized():
        return False
    addr = context.coordinator_address
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=context.world_size, rank=context.rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True
