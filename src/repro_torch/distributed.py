"""Process groups for the port's multi-device code: the counterpart of the
reference's ``repro.compat.make_mesh`` / ``shard_map`` and of the replica
set-up in ``repro.launch.train``.

One process per rank.  Where the reference's single controller splits
global arrays over a mesh axis, every rank here builds the same replicated
inputs from the same seed, works on its own part and meets the others in
``torch.distributed`` collectives; the group takes the place of the axis
name.  The backend follows the device: NCCL for CUDA, gloo for the CPU.
Ranks rendezvous through a ``FileStore``, so nothing needs the network.

    ctx = init_group(rank, world, device="cuda", store_path=path)
    results = spawn(fn, world, *args, device="cuda")   # fn(ctx, *args) per rank
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import device as _device


@dataclasses.dataclass(frozen=True)
class RankContext:
    rank: int
    world: int
    device: torch.device
    group: dist.ProcessGroup


def rank_device(rank: int, device: str | torch.device = "cuda") -> torch.device:
    """The device of ``rank``: ``cuda:(rank % device_count)``, or the CPU
    when the caller asks for it; raises for CUDA without CUDA."""
    dev = _device.resolve(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _store_path(world: int) -> str:
    run = os.environ.get("TORCHELASTIC_RUN_ID")
    if run is not None:  # torchrun's local ranks share the temporary directory
        name = f"repro_torch_{run}_{os.environ.get('MASTER_PORT', '')}.store"
        return os.path.join(tempfile.gettempdir(), name)
    if world > 1:
        raise ValueError("the ranks of a world > 1 need a shared store_path")
    return os.path.join(tempfile.mkdtemp(prefix="repro_torch_"), "store")


def init_group(
    rank: int | None = None,
    world: int | None = None,
    *,
    device: str | torch.device = "cuda",
    store_path: str | None = None,
) -> RankContext:
    """Join the default process group as ``rank`` of ``world``.

    ``rank`` and ``world`` default to torchrun's ``RANK`` and ``WORLD_SIZE``
    (0 and 1 when unset).  ``store_path`` is the ``FileStore`` file every
    rank of the group names; without it a world of one makes its own in a
    new temporary directory.  The rank's CUDA device becomes the current one.
    """
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else world
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path or _store_path(world), world)
    cuda = dev.type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", store=store, rank=rank,
                            world_size=world, device_id=dev if cuda else None)
    return RankContext(rank, world, dev, dist.group.WORLD)


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group=None) -> torch.Tensor:
    """``out`` (world * x.shape[0], ...) <- every rank's ``x``, in rank order
    (the reference's ``all_gather(..., tiled=True)``)."""
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group=None) -> torch.Tensor:
    """``out`` <- this rank's block (of ``world`` along dim 0) of the sum of
    every rank's ``x``."""
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, x.contiguous(), group=group)
    return out


def spawn(fn, world: int, *args, device: str | torch.device = "cuda",
          timeout: float | None = None) -> list:
    """Run ``fn(ctx, *args)`` on ``world`` new local processes, one per rank,
    in one group; returns each rank's result, in rank order.

    ``fn`` must be importable by name (the processes are spawned, not
    forked).  On the CPU each rank gets ``cpu_count // world`` threads.
    ``timeout``: seconds of wall clock for the whole run, after which every
    rank still running is killed and ``TimeoutError`` raised (a collective
    that never pairs up hangs its ranks); None waits for ever.
    """
    _device.resolve(device)  # raise here, not in every child
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        procs = mp.start_processes(_rank_entry, args=(fn, world, str(device), tmp, args),
                                   nprocs=world, start_method="spawn", join=False)
        deadline = None if timeout is None else time.monotonic() + timeout
        while not procs.join(None if deadline is None
                             else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for p in procs.processes:
                    if p.is_alive():
                        p.kill()
                    p.join()
                raise TimeoutError(f"spawn: {world} ranks of {fn.__name__} still running "
                                   f"after {timeout} s; killed")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _rank_entry(rank: int, fn, world: int, device: str, tmp: str, args: tuple) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    ctx = init_group(rank, world, device=device, store_path=os.path.join(tmp, "store"))
    result = fn(ctx, *args)
    dist.barrier()
    dist.destroy_process_group()
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
