"""Several processes, one rank each (port of ``oetr_tpu/parallel/multihost.py``).

In torch every rank is a process, so JAX's two cases (virtual devices
inside one process, and processes) are one here: ``torch.distributed``
with NCCL on the card and gloo on the CPU. ``initialize_distributed``
joins the group from torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or from the
explicit arguments, which override them as JAX's ``JAX_*`` variables do.
``spawn`` starts the ranks of one machine with a file rendezvous, so that
runs beside each other never contend for a port.
"""
from __future__ import annotations

import os
from typing import Callable, Mapping

import torch
import torch.distributed as dist


def _init_method(coordinator: str | None) -> str:
    """A ``torch.distributed`` init method from a "host:port" coordinator
    (JAX's form), a URL (``tcp://``, ``file://``, ``env://``), or torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` when there is none."""
    if coordinator is None:
        if not os.environ.get("MASTER_ADDR"):
            raise ValueError(
                "several processes need a coordinator: pass coordinator="
                "'host:port' (--coordinator) or run under torchrun "
                "(MASTER_ADDR, MASTER_PORT)")
        return "env://"
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def backend_for(device) -> str:
    """'nccl' for the card, 'gloo' for the CPU; the card without NCCL
    raises (there is no quiet fall back to gloo)."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, but torch sees no "
                               "CUDA device; pass device='cpu' for gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("device 'cuda' asked for, but this torch has "
                               "no NCCL; pass device='cpu' for gloo")
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> None:
    """Join the process group (JAX's ``jax.distributed.initialize``).

    ``num_processes`` and ``process_id`` default from ``WORLD_SIZE`` and
    ``RANK``, the rendezvous from ``coordinator`` ("host:port" or a URL such
    as ``file:///tmp/rdv``) or ``MASTER_ADDR``/``MASTER_PORT``. A no-op for
    one process without a coordinator, and once a group exists. On
    ``device`` 'cuda' (the default) the backend is NCCL and the rank's card
    is ``LOCAL_RANK`` (else the rank modulo the cards); on 'cpu' gloo.
    NCCL that fails raises; nothing falls back to gloo.
    """
    if dist.is_initialized():
        return
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator is None and (num_processes or 1) <= 1:
        return
    if num_processes is None:
        raise ValueError("a coordinator needs the number of processes: "
                         "num_processes (--num_processes) or WORLD_SIZE")
    if process_id is None:
        raise ValueError("a coordinator needs this process's rank: "
                         "process_id (--process_id) or RANK")
    device = "cuda" if device is None else device
    backend = backend_for(device)
    kwargs = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def rank_device(device_type: str) -> torch.device:
    """This rank's device of a mesh's type: its card, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def make_global_mesh(axis_sizes: Mapping[str, int] | None = None,
                     device_type: str | None = None):
    """A mesh over every rank of the group, the leading axis varying
    slowest (JAX's DCN-major layout): ``{"data": world}`` by default."""
    from .mesh import make_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(axis_sizes or {"data": world}, device_type)


def shard_batch_global(batch: Mapping, mesh, axis: str = "data") -> dict:
    """This rank's rows as tensors on the mesh's device: each rank passes
    its LOCAL slice of the global batch, and the global batch is the ranks'
    slices in rank order along the data axis (JAX's
    ``make_array_from_process_local_data``); the rows stay where they are."""
    dev = rank_device(mesh.device_type)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _rank_main(rank: int, fn: Callable, world: int, device: str,
               init_file: str, args: tuple, threads: int | None) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    initialize_distributed(f"file://{init_file}", world, rank, device)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device: str, init_file: str,
          args: tuple = (), threads: int | None = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes, each a
    rank of one group on ``device`` ('cuda': NCCL; 'cpu': gloo), joined
    through the file ``init_file`` (which must not exist yet; a file
    rendezvous needs no port). ``fn`` must be importable by name, from a
    module that the children can import (they import only what ``fn``'s
    module imports). Raises when a rank raises, after the others stop."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(fn, world, device, init_file, args, threads),
             nprocs=world, join=True)
