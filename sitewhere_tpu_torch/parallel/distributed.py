"""Multi-process entry: a `torch.distributed` process group and a mesh
whose `data` axis spans its processes.

The JAX package's recipe is one process per host, `jax.distributed.
initialize` to form the group, then one global mesh that pjit shards
over. Here each process holds its own devices' rows of the mesh, and
the trainer all-reduces its gradients over the group
(`training/trainer.py`), so every process takes the same step.

Environment contract (the reference's):
    SWX_COORDINATOR   host:port of process 0 (e.g. "10.0.0.1:8476")
    SWX_NUM_PROCESSES total process count
    SWX_PROCESS_ID    this process's rank

The backend follows the device: gloo for the CPU, nccl for the card
(with no nccl the call raises; nothing falls back to gloo). Two CPU
processes train in lockstep to the losses of one process
(`tests/test_torch_distributed.py`).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch

from sitewhere_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
)
from sitewhere_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

_device: Optional[torch.device] = None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """Join (or skip joining) the multi-process group on `device`'s
    backend (None: the card, nccl; "cpu": gloo).

    Explicit args win; otherwise the SWX_* env contract is read; if
    neither names a coordinator, this is a single-process run and the
    call is a no-op returning False. Idempotent."""
    global _device
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "SWX_COORDINATOR")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["SWX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["SWX_PROCESS_ID"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no nccl backend: a process "
                               "group on the card cannot form")
        backend = "nccl"
        # one card a process: ranks map onto the host's cards in turn
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _device = dev
    logger.info("joined process group: rank %d/%d via %s (%s)",
                process_id, num_processes, coordinator_address, backend)
    return True


def make_global_mesh(data: Optional[int] = None, model: int = 1,
                     devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh whose `data` axis spans every process of the
    group: this process holds the rows of its local `devices` (default:
    the device it joined with), and `mesh.shape["data"]` is the global
    size. `data` is the global size if given, and must match."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return make_mesh(data=data, model=model, devices=devices)
    if devices is None:
        devices = [_device if _device is not None else resolve_device()]
    local = make_mesh(model=model, devices=devices)
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = Mesh(local.devices, (DATA_AXIS, MODEL_AXIS),
                process_count=world, process_index=rank)
    if data is not None and mesh.shape[DATA_AXIS] != data:
        raise ValueError(f"a global data axis of {data} over {world} "
                         f"processes of {len(devices)} devices")
    return mesh


def shutdown_distributed() -> None:
    """Leave the process group (every rank, after its last collective)."""
    global _device
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _device = None


def process_info() -> dict:
    """Rank/size/device facts for logs and health endpoints."""
    import torch.distributed as dist

    joined = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "backend": dist.get_backend() if joined else None,
        "device": str(_device) if _device is not None else None,
        "initialized": joined,
    }


__all__ = ["initialize_distributed", "make_global_mesh", "process_info",
           "shutdown_distributed", "DATA_AXIS", "MODEL_AXIS"]
