"""Data parallelism over rays with torch.distributed (the counterpart of
emap_tpu/parallel/mesh.py).

The JAX package shards the ray batch over a 1-D device mesh and lets XLA
partition the step and insert the gradient psum. Here each device is one
process (a rank), and the step does what GSPMD does, by hand:
- parameters, Adam state and the ray pool are replicated by construction
  (the same seed and the same init on every rank);
- every rank draws the full batch from the same generator and keeps its
  rows (`RayGroup.shard`), so the random streams stay identical across
  ranks and equal to one process;
- the gradients (with the metric partials) go through ONE flat all-reduce
  sum a step (`RayGroup.all_reduce_sum`), the JAX psum;
- validation and extraction shard their rays or points the same way and
  gather the rows back in order (`RayGroup.gather_rows`).
No DistributedDataParallel: the step takes its gradients with
torch.autograd.grad through the fused training query, and DDP's hooks do not
belong in a captured CUDA graph.

`world_size` is the JAX CLI's rule (emap_tpu/cli.py:34-63) and `launch`
spawns one process a device: NCCL on cuda:rank, gloo on the CPU. A failed
init, collective or rank raises and ends the run; nothing drops to one
process.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# How long a collective may wait for the other ranks: rank 0 alone fits
# and writes the extraction's results (minutes at 256^3) while the others
# wait at the closing barrier. A rank that fails ends the run through the
# launcher well before this.
TIMEOUT = datetime.timedelta(hours=2)


@dataclasses.dataclass
class RayGroup:
    """One rank of a data-parallel group over rays: its rank, the world size,
    its device, and the collectives the step needs. `collectives` counts
    the collective calls made through it (a captured step counts those the
    graph holds once, at capture)."""

    rank: int
    world: int
    device: torch.device
    collectives: int = 0

    def bounds(self, n: int) -> tuple:
        """(lo, hi, per): this rank's rows [lo, hi) of `n` rows split in
        `per` = ceil(n / world) rows a rank (the last ranks may hold
        fewer, or none)."""
        per = -(-n // self.world)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n), per

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of `x`, whose rows split evenly over the
        world."""
        n = x.shape[0]
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} ranks")
        per = n // self.world
        return x[self.rank * per:(self.rank + 1) * per]

    def padded_shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's `per` rows of `x` (bounds), zero-padded at the end
        to `per` rows, so that every rank holds as many rows."""
        lo, hi, per = self.bounds(x.shape[0])
        mine = x[lo:hi]
        if hi - lo < per:
            mine = torch.cat([mine, mine.new_zeros((per - (hi - lo),)
                                                   + tuple(x.shape[1:]))])
        return mine

    def all_reduce_sum(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum `flat` over the ranks, in place; returns it."""
        self.collectives += 1
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return flat

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` (equal shapes) concatenated along dim 0 in rank
        order, on every rank."""
        self.collectives += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def barrier(self) -> None:
        self.collectives += 1
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def world_size(conf, batch_size: int, n_devices: int) -> int:
    """The JAX CLI's rule (emap_tpu/cli.py::build_mesh_from_conf): with
    `train.multi_device` (default true) and `n_devices` visible devices,
    the largest device count that divides the ray batch; 1 when
    multi_device is false, when one device is visible, or (with a
    warning) when no count above 1 divides the batch."""
    if not conf.get_bool("train.multi_device", True):
        return 1
    n = n_devices
    if n <= 1:
        return 1
    while n > 1 and batch_size % n != 0:
        n -= 1
    if n <= 1:
        logger.warning(
            "multi_device requested but batch_size %d has no usable device "
            "split; running single-device", batch_size)
        return 1
    logger.info("data-parallel group over %d devices", n)
    return n


def init_group(rank: int, world: int, device,
               port: int | None = None) -> RayGroup:
    """Join the process group (NCCL on a card, gloo on the CPU) through the
    key-value store that `launch` serves on 127.0.0.1:`port`, or, with no
    port, one this process serves on a port the system picks (a group of
    one process); return this rank's RayGroup. On a card the NCCL
    communicator is made here, so a failed init raises now."""
    device = torch.device(device)
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    store = dist.TCPStore("127.0.0.1", port or 0, is_master=port is None,
                          timeout=TIMEOUT)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, world_size=world, rank=rank,
                            timeout=TIMEOUT, **kwargs)
    return RayGroup(rank, world, device)


def _worker(rank: int, fn, world: int, device_type: str, port: int,
            out_dir: str, log_level: int, args: tuple) -> None:
    logging.basicConfig(
        level=log_level if rank == 0 else max(log_level, logging.WARNING),
        format=f"[rank {rank} %(filename)s:%(lineno)s] %(message)s")
    if device_type == "cuda":
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    group = init_group(rank, world, device, port)
    result = fn(group, *args)
    # no rank leaves before rank 0 has written what it writes
    group.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(fn, world: int, device_type: str, *args) -> list:
    """Run `fn(group, *args)` on `world` spawned ranks, one a device
    (cuda:0 .. cuda:world-1, or the CPU with gloo), and return each rank's
    return value in rank order. `fn` and `args` must pickle (a module-level
    function). A rank that raises ends the others, and this raises."""
    import torch.multiprocessing as mp

    if device_type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards; "
                           f"{torch.cuda.device_count()} are visible")
    # served from here for the ranks' lifetime, on a port the system picks
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, timeout=TIMEOUT)
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(
            _worker, args=(fn, world, device_type, store.port, out_dir,
                           logging.getLogger().getEffectiveLevel(), args),
            nprocs=world, join=True, start_method="spawn")
        results = []
        for rank in range(world):
            # written by the ranks above, from this program's own objects
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
