"""Multi-process start (port of rpe_tpu/parallel/multihost.py).

Within one host a single process drives every card (mesh.py). Across
hosts, one process per host joins a `torch.distributed` process group --
NCCL between cards, gloo for CPU meshes -- and the collectives
(collectives.py) reduce over it on top of their reduction across the
process's own devices. Each process must drive cards of its own: NCCL
refuses two ranks on one card.
"""

from __future__ import annotations

import os

import torch

from .mesh import Mesh, pairs_mesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> bool:
    """Join the process group if one is configured; True when joined.

    Configuration by the arguments or by torchrun's variables
    (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK), where the reference
    reads JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID.
    No-op (False) when no address is set: single-host mode. The backend is
    NCCL for the cards (the default; raises without a card) and gloo for
    device="cpu". Every process needs the same address, the world size and
    its own rank.
    """
    import torch.distributed as dist

    if coordinator_address is None:
        host = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if host and port:
            coordinator_address = f"{host}:{port}"
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = os.environ.get("WORLD_SIZE")
    if process_id is None:
        process_id = os.environ.get("RANK")
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed: an address needs the "
                         "number of processes and this process's id "
                         "(arguments, or WORLD_SIZE and RANK)")
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    elif torch.cuda.is_available():
        backend = "nccl"
    else:
        raise RuntimeError("initialize_distributed: NCCL needs a CUDA card; "
                           "pass device='cpu' for gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    return True


def global_pairs_mesh(device=None) -> Mesh:
    """'pairs' mesh over this process's devices (every card, or one CPU
    entry with device="cpu") that carries the default process group."""
    import torch.distributed as dist

    return Mesh(pairs_mesh(None, device).devices, ("pairs",),
                group=dist.group.WORLD)
