"""Multi-process bootstrap — one process per device, joined by
``torch.distributed``.

The JAX package joins ``jax.distributed`` (one controller per TPU host,
collectives over ICI/DCN). Here every process owns one device and joins a
``torch.distributed`` process group: NCCL between CUDA devices, gloo on
the CPU. The rendezvous is process 0's TCP store at
``tcp://<coordinator>``; rank and world size come from the same
environment variables the JAX package reads (``LO_TPU_COORDINATOR``,
``LO_TPU_NUM_PROCESSES``, ``LO_TPU_PROCESS_ID``).

A single process needs no initialization: with nothing set this module
does nothing, and the mesh (parallel/mesh.py) is 1×1×1 with no process
group. A bad device or an unreachable coordinator raises; it never turns
into a one-process run.

The backend follows the device unless the caller names one: NCCL for
CUDA, gloo for the CPU. ``backend="gloo"`` with ``device="cuda"`` joins
ranks that share one card (NCCL refuses two ranks of a communicator on
one device): each rank computes on the card and gloo stages the
collectives' tensors through the host. Nothing picks a backend by
itself: two NCCL ranks on one device still raise.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from learningorchestra_tpu_torch import config
from learningorchestra_tpu_torch.parallel.runtime import resolve_device

#: Seconds a rank waits for the others at the rendezvous and in a
#: collective before it raises.
TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: str = "cuda", backend: Optional[str] = None,
               timeout_s: float = TIMEOUT_S) -> None:
    """Join (or start, as process 0) the process group.

    Arguments default from the env vars above. ``device="cuda"`` (the
    default) makes device ``process_id`` modulo the local device count
    current. ``backend`` None joins with NCCL for ``cuda`` and gloo for
    ``cpu``; ``"gloo"`` or ``"nccl"`` is taken as given. No-op when
    nothing is set, or when this process already joined."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or config.coordinator_address()
    if num_processes is None:
        num_processes = config.num_processes()
    if process_id is None:
        process_id = config.process_id()
    if coordinator_address is None and num_processes is None:
        return  # single process
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a process group needs the coordinator address, the number of "
            "processes and this process's id; got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    dev = resolve_device(device)
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    elif backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=timedelta(seconds=timeout_s))


def process_info(device: Optional[str] = None) -> dict:
    """Topology snapshot for the /cluster observability route (the JAX
    package's keys, and ``backend``): one device a process, so the
    global device count is the world size; ``devices`` names this
    process's device (``device``, the runtime's, when the caller has
    one). ``backend`` is the process group's, None without one."""
    joined = dist.is_initialized()
    backend = dist.get_backend() if joined else None
    if device is None:
        cuda = (backend == "nccl" if joined
                else torch.cuda.is_available())
        device = f"cuda:{torch.cuda.current_device()}" if cuda else "cpu"
    count = dist.get_world_size() if joined else 1
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": count,
        "local_device_count": 1,
        "global_device_count": count,
        "devices": [str(device)],
        "platform": "gpu" if str(device).startswith("cuda") else "cpu",
        "backend": backend,
    }
