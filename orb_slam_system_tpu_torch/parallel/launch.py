"""Start the ranks of a torch.distributed process group on one host.

`spawn_ranks(fn, world, backend, *args)` runs fn(rank, world, *args) in
`world` fresh processes (torch.multiprocessing, start method "spawn"),
each joined to a group over a FileStore in a temporary directory: "nccl"
with rank r on card r, or "gloo" with every rank on the CPU. Each rank runs
torch on one intra-op thread, so `world` ranks share the host's cores
without oversubscribing them. Any rank's exception fails the call, after
every rank has stopped. fn must be importable by name from a module that
a fresh interpreter can import.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn, world: int, backend: str, store_path: str,
               args: tuple) -> None:
    torch.set_num_threads(1)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kwargs["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, **kwargs)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, backend: str, *args) -> None:
    """Run fn(rank, world, *args) on `world` ranks (module docstring)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} cards, "
                           f"{torch.cuda.device_count()} present")
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank_main, args=(fn, world, backend,
                                   os.path.join(d, "store"), args),
                 nprocs=world, join=True)
