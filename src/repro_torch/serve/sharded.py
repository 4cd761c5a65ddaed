"""Serving over a cells group of spawned ranks.

    reports = serve_sharded([ServeJob(bundle, scenario, stream, cfg, key)],
                            n=4, device="cuda")

:func:`serve_sharded` starts ``n`` ranks (``repro_torch.sharding.
spawn_cells``); each rank serves every job's stream with ``serve_stream``
under the group, one job after the other, and rank 0's merged reports
come back.  A job names its policy by a ``PolicyBundle`` (picklable,
unlike a policy's functions) and carries the whole scenario and stream;
each rank loads the bundle on its device and serves its block.  Each
report gains ``"ranks"``: every rank's kernel launches and collectives
in its run.  ``serve_fleet --mesh-cells`` is the command-line form.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.fleet.workload import FleetScenario
from repro_torch.kernels import orchestration
from repro_torch.policy.bundle import PolicyBundle, policy_from_bundle
from repro_torch.serve.engine import ServeConfig, serve_stream
from repro_torch.serve.stream import RequestStream
from repro_torch.sharding.runtime import (COLLECTIVES, CellsGroup,
                                          reset_collective_counts,
                                          spawn_cells)


class ServeJob(NamedTuple):
    """One ``serve_stream`` call of a sharded run."""
    bundle: PolicyBundle
    scenario: FleetScenario    # the whole fleet
    stream: RequestStream
    cfg: ServeConfig
    key: Optional[torch.Tensor] = None


def rank_counts() -> dict:
    """This rank's kernel launches and collectives since the last
    reset."""
    return {"launches": dict(orchestration.LAUNCHES),
            "collectives": dict(COLLECTIVES)}


def serve_rank(group: CellsGroup, jobs: list) -> list:
    """Each job through ``serve_stream`` on this rank of ``group``; rank 0
    returns the merged reports, every rank its counts (``rank_counts``,
    reset before each job)."""
    out = []
    for job in jobs:
        policy, params = policy_from_bundle(job.bundle, group.device)
        orchestration.reset_launch_counts()
        reset_collective_counts()
        report = serve_stream(policy, params, job.scenario, job.stream,
                              job.cfg, key=job.key, mesh=group)
        out.append((report if group.rank == 0 else None, rank_counts()))
    return out


def serve_sharded(jobs: list, n: int, device="cuda") -> list:
    """Serve ``jobs`` (:class:`ServeJob`) over a new ``n``-rank cells
    group on ``device``; returns one merged report per job, with
    ``report["ranks"]`` the ranks' counts in rank order."""
    per_rank = spawn_cells(serve_rank, n, device, list(jobs))
    reports = []
    for j, (report, _) in enumerate(per_rank[0]):
        report["ranks"] = [ranks[j][1] for ranks in per_rank]
        reports.append(report)
    return reports
