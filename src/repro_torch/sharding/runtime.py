"""Cells groups: the port's counterpart of the reference's ``cells`` mesh.

The reference shard_maps its serving tick over a one-axis ``("cells",)``
device mesh (``repro.sharding.runtime.cells_mesh``).  The port runs one
process per shard instead: a :class:`CellsGroup` is a
``torch.distributed`` process group whose rank ``r`` of ``S`` owns cells
``[r·C/S, (r+1)·C/S)`` of a fleet, on its own device.

    group = cells_group("cpu")          # this process's group (a new
                                        # one-rank group when none exists)
    reports = spawn_cells(fn, 4, "cuda", *args)   # fn(group, *args) on
                                                  # each of 4 ranks

:func:`spawn_cells` starts the ranks with ``torch.multiprocessing``
(spawn) and meets them through a file in a temporary directory, so no
TCP port is taken.  Rank ``r`` runs on ``cuda:(r % device_count)`` (or
the CPU); the backend is NCCL when every rank has a card of its own and
gloo otherwise (gloo takes CUDA tensors for ``all_reduce`` and stages
them through the host).  Ranks that reach a kernel first at the same
time build it once (``kernels/_build.py`` takes a file lock).

The serving engine reduces its cross-cell couplings through
:func:`all_reduce` and merges its per-rank copies at run end through
:func:`all_gather_object`; each call adds one to its count in
:data:`COLLECTIVES`, as the kernel wrappers count their launches.

The registry (``set_mesh_info`` / ``get_mesh_info``) holds the group a
launcher registered, which ``serve_stream`` picks up when it is given
none.  The reference's ``MeshInfo`` also describes the LM substrate's
``data`` / ``model`` meshes; those wait for the port's multi-card LM
slice (``ROADMAP.md`` queue 1 item 10.5).
"""
from __future__ import annotations

import dataclasses
import datetime
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

CELLS_AXIS = "cells"
COLLECTIVES = {"all_reduce": 0, "all_gather_object": 0}
# a rank that waits longer than this in a collective raises: a peer died
RANK_TIMEOUT = datetime.timedelta(minutes=5)


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


@dataclasses.dataclass(frozen=True)
class CellsGroup:
    """One rank's view of a cells group: the process group, this rank's
    place in it, its device and the backend."""
    pg: Any                  # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str             # "nccl" or "gloo"


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """The registered cells group (the reference's ``MeshInfo`` of a
    ``cells`` mesh)."""
    group: CellsGroup
    cells_axis: str = CELLS_AXIS

    @property
    def cells_size(self) -> int:
        return self.group.size


_CURRENT: Optional[MeshInfo] = None
# the temporary directory of the one-rank group cells_group() made
_OWN_GROUP: dict = {}


def set_mesh_info(group: Optional[CellsGroup]) -> None:
    global _CURRENT
    _CURRENT = None if group is None else MeshInfo(group)


def get_mesh_info() -> Optional[MeshInfo]:
    return _CURRENT


def backend_for(n: int, device) -> str:
    """NCCL when each of ``n`` ranks has a card of its own, else gloo
    (NCCL refuses two ranks on one device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)`` for a CUDA
    ``device``, else ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def cells_group(device="cuda") -> CellsGroup:
    """This process's cells group: the default process group when
    ``torch.distributed`` is initialised (a rank of :func:`spawn_cells`),
    else a new one-rank group on ``device`` (release it with
    :func:`destroy_cells_group`)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="cells-group-")
        backend = backend_for(1, dev)
        if dev.type == "cuda":
            torch.cuda.set_device(rank_device(0, dev))
        dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0, timeout=RANK_TIMEOUT)
        _OWN_GROUP["dir"] = tmp
    rank = dist.get_rank()
    return CellsGroup(dist.group.WORLD, rank, dist.get_world_size(),
                      rank_device(rank, dev), dist.get_backend())


def destroy_cells_group(group: CellsGroup) -> None:
    """Tear down a one-rank group :func:`cells_group` made (and unregister
    it); a group of :func:`spawn_cells` is torn down by its rank."""
    if _CURRENT is not None and _CURRENT.group is group:
        set_mesh_info(None)
    tmp = _OWN_GROUP.pop("dir", None)
    if tmp is not None:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def all_reduce(t: torch.Tensor, group: CellsGroup) -> torch.Tensor:
    """Sum ``t`` in place over the group's ranks (one collective)."""
    dist.all_reduce(t, group=group.pg)
    COLLECTIVES["all_reduce"] += 1
    return t


def all_gather_object(obj, group: CellsGroup) -> list:
    """Every rank's ``obj`` (picklable host data), in rank order."""
    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.pg)
    COLLECTIVES["all_gather_object"] += 1
    return out


def _rank_main(rank: int, fn: Callable, n: int, device: str, tmp: str,
               threads: int, args: tuple) -> None:
    torch.set_num_threads(threads)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(n, device)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                            world_size=n, rank=rank, timeout=RANK_TIMEOUT)
    try:
        out = fn(CellsGroup(dist.group.WORLD, rank, n, dev, backend), *args)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_cells(fn: Callable, n: int, device="cuda", *args) -> list:
    """Run ``fn(group, *args)`` on each of ``n`` new ranks of a cells
    group and return their results in rank order.  ``fn`` must be
    importable by module path (spawn pickles it by name); ``args`` and the
    results are pickled.  A rank that raises ends the run, and this
    raises with its traceback."""
    if n < 1:
        raise ValueError(f"a cells group needs at least one rank, got {n}")
    dev = resolve_device(device)
    threads = max(1, torch.get_num_threads() // n)
    tmp = tempfile.mkdtemp(prefix="cells-")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, n, dev.type, tmp, threads, args),
            nprocs=n, join=True)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
