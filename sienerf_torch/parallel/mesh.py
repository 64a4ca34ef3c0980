"""Ray-sharded data parallelism over torch.distributed (port of the JAX
package's parallel/mesh.py).

The JAX package puts one `rays` axis over its devices and runs the sharded
paths under `shard_map`: the hash table, the MLPs and the occupancy grid
are replicated, ray batches (and, for the sweep, vertex planes and slab
ranges) are split, gradients are averaged and frames gathered.  JAX is
single-controller; here every rank is a process that drives one device
(NCCL between cards, gloo on the CPU), because one Python thread driving
several cards would serialise their launches, and the host is what bounds
this program.  A `RayMesh` is a process group and this rank's device.

The collectives the sharded paths need are written so that every rank ends
with the same bits, from run to run and on any backend: a rank-ordered
all-gather, and the sums, means and maxima built on it (each rank's
tensor gathered, then folded in rank order, as ops/fixed_order.py fixes
the order of the other sums of the trainer).  Gloo carries the collectives
of ranks that share one card (it takes their CUDA tensors as they are).

`run_ranks` starts ranks as spawned processes joined through a file
rendezvous, waits for them with a deadline and kills them when it passes,
and returns each rank's result.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class RayMesh:
    """The default process group, over which rays are sharded, and this
    rank's place in it: `rank` of `world`, computing on `device`."""

    rank: int
    world: int
    device: torch.device
    backend: str


def make_ray_mesh(n_devices: int | None = None, device=None) -> RayMesh:
    """The mesh of the initialised default process group, with this rank
    computing on `device` (default: the current CUDA device).  Starts no
    group: raises if none is initialised, or if `n_devices` is not the
    group's size."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_ray_mesh: no process group is initialised; start one "
                           "with torch.distributed.init_process_group (or run_ranks)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_ray_mesh: {n_devices} devices asked for, the group has {world}")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return RayMesh(rank=dist.get_rank(), world=world, device=torch.device(device),
                   backend=dist.get_backend())


def shard_range(n: int, world: int, rank: int) -> tuple[int, int]:
    """Rank `rank`'s contiguous share [lo, hi) of n items, as the JAX
    package shards them: n padded to a multiple of `world`, ceil(n / world)
    items a rank, the pad (and any rank wholly in it) discarded."""
    per = -(-n // world)
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def all_gather(t: torch.Tensor, mesh: RayMesh) -> list[torch.Tensor]:
    """Every rank's `t` (one shape and dtype on all ranks), in rank order,
    on `t`'s device."""
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src)
    return parts


def ordered_sum(parts) -> torch.Tensor:
    """((p0 + p1) + p2) + ...: a sum of per-rank tensors in rank order."""
    total = parts[0].clone()
    for p in parts[1:]:
        total = total + p
    return total


def ordered_mean(parts) -> torch.Tensor:
    """ordered_sum / the number of parts (the JAX package's pmean)."""
    return ordered_sum(parts) / len(parts)


def all_mean(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """The mean of every rank's `t`, summed in rank order: the same bits on
    every rank and from run to run."""
    return ordered_mean(all_gather(t, mesh))


def all_sum(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """The sum of every rank's `t` in rank order."""
    return ordered_sum(all_gather(t, mesh))


def all_max(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """The elementwise maximum of every rank's `t`; a bool tensor as uint8,
    as the JAX package takes its int8 pmax of the bitfield."""
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    out = torch.stack(all_gather(src, mesh)).amax(dim=0)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def gather_rows(local: torch.Tensor, n: int, mesh: RayMesh) -> torch.Tensor:
    """Every rank's shard_range share of n rows (`local`, its rows of dim
    0), concatenated in rank order -> (n, ...) on every rank.  Each share is
    padded to ceil(n / world) rows for the collective and the pad dropped."""
    per = -(-n // mesh.world)
    if local.shape[0] > per:
        raise ValueError(f"gather_rows: {local.shape[0]} rows, a share holds {per}")
    pad = local.new_zeros((per - local.shape[0],) + tuple(local.shape[1:]))
    return torch.cat(all_gather(torch.cat([local, pad]), mesh))[:n]


def replicate(tree, mesh: RayMesh):
    """Rank 0's tensors on every rank: each tensor leaf of a tree of dicts,
    lists and tuples is broadcast from rank 0 in place (other leaves are
    left as they are).  Returns the tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, mesh)
    elif isinstance(tree, torch.Tensor):
        buf = tree.contiguous()
        dist.broadcast(buf, src=0)
        if buf.data_ptr() != tree.data_ptr():
            tree.copy_(buf)
    return tree


def rank_generator(generator: torch.Generator, mesh: RayMesh) -> torch.Generator:
    """This rank's generator, the counterpart of the JAX package's
    fold_in(key, axis_index): one draw from `generator` (the same on every
    rank when every rank passes the same seeded generator) mixed with the
    rank, on the generator's device."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    mixed = np.random.SeedSequence([seed, mesh.rank]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(mixed) >> 1)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _rank_main(rank: int, fn, world: int, backend: str, devices, init_method: str,
               out_dir: str, timeout_s: float, args) -> None:
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        # NCCL binds the rank to its card; gloo's ranks may share one
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s),
                                device_id=device if backend == "nccl" else None)
        try:
            result = fn(make_ray_mesh(world, device), *args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        # every rank's failure, so that the parent reports the first cause
        # and not only a peer's lost connection
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time():.6f}\n{traceback.format_exc()}")
        raise
    with open(os.path.join(out_dir, f"rank{rank}.tmp"), "wb") as f:
        pickle.dump(_to_numpy(result), f)
    os.replace(os.path.join(out_dir, f"rank{rank}.tmp"), os.path.join(out_dir, f"rank{rank}.pkl"))


def _rank_errors(out_dir: str) -> str:
    """The tracebacks the ranks wrote, the earliest first."""
    errs = []
    for name in os.listdir(out_dir):
        if name.endswith(".err"):
            with open(os.path.join(out_dir, name)) as f:
                stamp, _, text = f.read().partition("\n")
            errs.append((float(stamp), name[:-4], text))
    return "\n".join(f"--- {rank} ---\n{text}" for _, rank, text in sorted(errs))


def run_ranks(fn, world: int, backend: str, devices, *args, timeout_s: float = 60.0) -> list:
    """Run fn(mesh, *args) on `world` spawned ranks -> each rank's result in
    rank order, tensors as numpy arrays.

    Rank r computes on devices[r] ("cpu", "cuda:0", ...) and joins the
    `backend` group ("gloo" or "nccl") through a file rendezvous in a fresh
    temporary directory, with `timeout_s` as the group's timeout.  `fn` and
    `args` must pickle (a module-level function).  A rank that fails raises
    RuntimeError here with every failed rank's traceback, the earliest
    first; when `timeout_s` has passed and a rank is still running (a
    collective that one rank never joins), every rank is killed and
    TimeoutError raised."""
    if len(devices) != world:
        raise ValueError(f"run_ranks: {len(devices)} devices for {world} ranks")
    tmp = tempfile.mkdtemp(prefix="sienerf_ranks_")
    try:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, backend, list(devices), init, tmp, timeout_s, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: the ranks of {fn.__name__} ran past "
                                       f"their {timeout_s} s deadline and were killed")
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as exc:
            raise RuntimeError(f"run_ranks: a rank of {fn.__name__} failed\n"
                               f"{_rank_errors(tmp) or exc}") from exc
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(timeout=10.0)
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
