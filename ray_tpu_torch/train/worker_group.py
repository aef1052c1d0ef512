"""Multi-process bring-up of a training gang (counterpart of
``_maybe_init_jax_distributed`` in ``ray_tpu/train/worker_group.py``).

The reference's rank-0 coordinator rendezvous (``jax.distributed``)
becomes ``torch.distributed.init_process_group``. Each process of a
``jax.distributed`` gang sees its host's chips; here one process drives
one card, so before the first NCCL call a rank takes the card of its
local rank (its index among the gang's ranks on its host). The actors
around the rendezvous (the worker group, its polling and checkpoint
handover) are host plane and are not ported.
"""

from __future__ import annotations

import datetime
import socket
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from .._private.device import DeviceLike, checked_device

_HOST_KEY = "ray_tpu_torch/host/"


def local_placement(hosts: Sequence[str], rank: int) -> Tuple[int, int]:
    """``(local rank, ranks on the host)`` of ``rank`` among the gang's
    ranks, given every rank's host name: ranks on one host are numbered
    in the order of their global ranks."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return mine.index(rank), len(mine)


def _bind_card(store, rank: int, world_size: int,
               timeout: datetime.timedelta) -> torch.device:
    """Exchange host names over the rendezvous store, then make this
    rank's card (its local rank) the current one. Raises when the host
    has more ranks than cards."""
    store = dist.PrefixStore(_HOST_KEY, store)
    store.set(str(rank), socket.gethostname())
    keys = [str(r) for r in range(world_size)]
    store.wait(keys, timeout)
    hosts = [store.get(k).decode() for k in keys]
    local_rank, on_host = local_placement(hosts, rank)
    cards = torch.cuda.device_count()
    if on_host > cards:
        raise RuntimeError(
            f"host {hosts[rank]} has {on_host} ranks of the gang but "
            f"{cards} CUDA cards (rank {rank} wants card {local_rank}): "
            "one rank drives one card, and two ranks never share one")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def init_torch_distributed(context, device: DeviceLike = None,
                           timeout_s: float = 600.0) -> bool:
    """Join the gang's process group: ``context`` carries
    ``coordinator_address`` ("host:port", or an init-method URL such as
    ``file:///path``), ``world_size`` and ``rank`` (the reference's
    ``TrainContext``). NCCL for the card (the default ``device``; raises
    without one), each rank on the card of its local rank, which is then
    the current card, so that ``resolve_device()`` and ``build_mesh``
    give it; gloo for ``device="cpu"``. Nothing at world size 1 or
    without an address (the current card stays); a process whose group
    is already initialized (a gang restart on a reused process) keeps
    it. Every other rendezvous error is raised. Returns whether it made
    the group."""
    # the type only: asking for the current card would start CUDA on the
    # first card before this rank takes its own
    dev = checked_device(device)
    if context.world_size <= 1 or not context.coordinator_address:
        return False
    if dist.is_initialized():
        return False
    addr = context.coordinator_address
    url = addr if "://" in addr else f"tcp://{addr}"
    timeout = datetime.timedelta(seconds=timeout_s)
    if dev.type != "cuda":
        dist.init_process_group(
            "gloo", init_method=url, world_size=context.world_size,
            rank=context.rank, timeout=timeout)
        return True
    store, rank, world_size = next(dist.rendezvous(
        url, context.rank, context.world_size, timeout=timeout))
    store.set_timeout(timeout)
    card = _bind_card(store, rank, world_size, timeout)
    dist.init_process_group(
        "nccl", store=dist.PrefixStore("default_pg", store),
        world_size=world_size, rank=rank, timeout=timeout, device_id=card)
    return True
