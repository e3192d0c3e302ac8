"""Process groups and collectives of host objects (counterpart of
``mdqe_cvpr2023_tpu/utils/dist.py``).

The JAX package runs one program over a device mesh and XLA places the
collectives; the port runs one process per card (or several on the CPU) in a
``torch.distributed`` group, started from the environment that
``python -m torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). With no group every
function here is that of one process: rank 0 of 1, ``all_gather_objects``
returns ``[obj]``.

The backend is chosen, never fallen back to: ``nccl`` for a CUDA device, one
rank per card (the default there); ``gloo`` on the CPU; ``gloo`` on a CUDA
device only when the caller asks for it (several ranks on one card).
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Any, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
TIMEOUT = timedelta(seconds=600)  # of the store and of every collective


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if initialized() and world_size() > 1:
        dist.barrier()


def backend() -> Optional[str]:
    return dist.get_backend() if initialized() else None


def default_group():
    """The group the Trainer and the step reduce over: the default group
    once one is started, else None (one process)."""
    return dist.group.WORLD if initialized() else None


def choose_backend(device: torch.device, asked: Optional[str] = None) -> str:
    """``asked`` if given and possible on ``device``; otherwise nccl on a CUDA
    device and gloo on the CPU."""
    if asked is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if asked not in BACKENDS:
        raise ValueError(f"unknown backend {asked!r}; choose one of {BACKENDS}")
    if asked == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, the rank runs on {device}")
    return asked


def _device_key(device: torch.device) -> str:
    """The physical card a CUDA device is, host included (a UUID where torch
    gives one, so ranks that see other CUDA_VISIBLE_DEVICES still compare)."""
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def check_one_rank_per_card(store, rank_: int, world: int, key: str) -> None:
    """Exchange each rank's card through ``store`` and raise when two ranks
    name the same one: NCCL cannot hold two ranks of one communicator on one
    device, and fails later in its own way."""
    store.set(f"mdqe_card_{rank_}", key)
    keys = [store.get(f"mdqe_card_{r}").decode() for r in range(world)]
    shared = sorted({k for k in keys if keys.count(k) > 1})
    if shared:
        ranks = {k: [r for r in range(world) if keys[r] == k] for k in shared}
        raise RuntimeError(
            f"the nccl backend takes one rank per card, but ranks share a card: {ranks}; "
            "start one rank per card, or pass --dist-backend gloo to run several ranks "
            "on one card")


def init_from_env(device, backend_: Optional[str] = None) -> str:
    """Start the default process group from torch.distributed.run's
    environment for a rank that runs on ``device``; returns the backend.
    With nccl the ranks' cards are compared first (``check_one_rank_per_card``)."""
    device = torch.device(device)
    name = choose_backend(device, backend_)
    rank_ = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    # under torch.distributed.run the launcher's agent already serves the
    # store at MASTER_PORT; rank 0 serves it otherwise
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    store = dist.TCPStore(os.environ.get("MASTER_ADDR", "127.0.0.1"),
                          int(os.environ["MASTER_PORT"]), world,
                          is_master=rank_ == 0 and not agent,
                          timeout=TIMEOUT)
    if name == "nccl":
        check_one_rank_per_card(store, rank_, world, _device_key(device))
    kwargs = {"device_id": device} if name == "nccl" else {}
    dist.init_process_group(name, store=store, rank=rank_, world_size=world,
                            timeout=TIMEOUT, **kwargs)
    return name


def destroy() -> None:
    if initialized():
        dist.destroy_process_group()


def all_gather_objects(obj: Any) -> List[Any]:
    """A picklable object from every rank, as a list in rank order (``[obj]``
    with no group)."""
    if not initialized() or world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out
