"""Cells-sharded serving: the port's cells group against the reference's
single-device ``serve_stream``.

The same scenario, stream, params and key through ``repro.serve.
serve_stream`` on one device and through the port's ``serve_stream``
under a cells group of 1 (in this process), 2 and 4 ranks (spawned gloo
CPU processes, ``repro_torch.serve.sharded.serve_sharded``), for the
greedy baseline and an untrained DQN with both couplings and telemetry
on, at the deployment's layout (groups of 4 cells) and at layouts whose
edge groups span ranks (groups of 8 over blocks of 4; ``cell % 4``); and
under the ``spot`` economy with ``cost_greedy``:

* ``dropped`` / ``served`` / ``violated`` / ``action`` identical, wait /
  service / ART and the report's figures within 1e-5;
* telemetry counters and histogram identical, gauges within 1e-5 with
  the same unwritten windows; ``spot`` billing integers identical;
* the port's audit passes on a sharded report.

Also: ``merge_shard_buffers`` against the reference's on the same stacked
buffers; the sharded bucketer against the reference's; a block's group
totals against the fleet's; the collectives a tick and an epoch issue
(at most the reference's traced ``psum`` count); the misuse refusals of
the engine and the CLI; the registry pick-up; ``serve_fleet --mesh-cells
2 --device cpu`` against ``--mesh-cells 0``.  The ``gpu`` case of a
2-rank group on the card is in ``tests/test_torch_kernels_gpu.py``
(JAX-free).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.economy import builtin_profile as ref_builtin_profile
from repro.economy import routing as ref_routing
from repro.fleet import random_fleet as ref_random_fleet
from repro.policy import adapters as ref_adapters
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import poisson_request_stream as ref_poisson_stream
from repro.serve import serve_stream as ref_serve_stream
from repro.serve.engine import _tick_buckets as ref_tick_buckets
from repro.serve.stream import RequestStream as RefRequestStream
from repro.specs.observation import make_spec as ref_make_spec
from repro.telemetry import MetricBuffer as RefMetricBuffer
from repro.telemetry import merge_shard_buffers as ref_merge_shard_buffers
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.economy import builtin_profile
from repro_torch.fleet.latency import fleet_totals
from repro_torch.fleet.workload import random_fleet
from repro_torch.kernels.orchestration import group_index, group_occupancy
from repro_torch.launch import serve_fleet
from repro_torch.policy import adapters
from repro_torch.policy.bundle import PolicyBundle, policy_from_bundle
from repro_torch.serve import ServeConfig, make_serve_engine, serve_stream
from repro_torch.serve.engine import _tick_buckets
from repro_torch.serve.sharded import ServeJob, serve_sharded
from repro_torch.serve.stream import poisson_request_stream
from repro_torch.sharding import (COLLECTIVES, CellsGroup, cells_group,
                                  destroy_cells_group, get_mesh_info,
                                  reset_collective_counts, set_mesh_info)
from repro_torch.specs.observation import make_spec
from repro_torch.telemetry import audit_serve_report, build_trace
from repro_torch.telemetry.metrics import MetricBuffer, merge_shard_buffers

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent
N_MAX, CELLS, SPEC = 4, 16, "full"
EXACT = ("dropped", "served", "violated", "action")
CLOSE = ("wait_ms", "service_ms", "art_ms")
FIGURES = ("n_requests", "served_requests", "dropped_requests",
           "deferred_requests", "slo_attainment", "violation_rate",
           "mean_latency_ms", "mean_wait_ms", "mean_service_ms",
           "mean_art_ms", "p50_latency_ms", "p95_latency_ms",
           "p99_latency_ms", "n_epochs", "n_ticks")
# (policy, edge-group layout): "cpe4" the deployment's groups of 4, inside
# every block of 4 or 8 cells; "cpe8" groups of 8, spanning two blocks of
# 4; "mod" group cell % 4, every group spanning all 4 blocks
CASES = [("greedy", "cpe4"), ("dqn", "cpe4"), ("greedy", "cpe8"),
         ("dqn", "cpe8"), ("greedy", "mod"), ("dqn", "mod")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors this small gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(scn, layout):
    """The reference scenario with its edge groups set to ``layout``."""
    c = scn.weak_e.shape[0]
    if layout == "mod":
        return scn._replace(edge_group=jnp.arange(c, dtype=jnp.int32)
                            % (c // 4))
    per = {"cpe4": 4, "cpe8": 8}[layout]
    return scn._replace(edge_group=jnp.arange(c, dtype=jnp.int32) // per)


def _case(kind, layout, *, seed=11, rate=2.5, rounds=6):
    """A coupled case with telemetry (the reference's sharded fixture at
    the ``full`` spec): (reference report, the port's ServeJob)."""
    kw = dict(n_max=N_MAX, obs_spec=SPEC, shared_cloud=True,
              shared_edge=True, telemetry=True, window_ms=500.0)
    ref_cfg = RefServeConfig(**kw)
    scn = _layout(ref_random_fleet(jax.random.PRNGKey(seed), CELLS,
                                   n_max=N_MAX), layout)
    horizon = rounds * ref_cfg.round_ms
    stream = ref_poisson_stream(jax.random.PRNGKey(seed + 1), scn, horizon,
                                rate=rate, round_ms=ref_cfg.round_ms,
                                epoch_ms=horizon / 3)
    ref_spec = ref_make_spec(SPEC, N_MAX)
    if kind == "greedy":
        ref_pol = ref_adapters.heuristic_greedy_policy(ref_spec)
        ref_params = ref_pol.init(jax.random.PRNGKey(0))
        bundle = PolicyBundle("greedy", SPEC, N_MAX, {})
    else:
        ref_pol = ref_adapters.dqn_policy(ref_spec, hidden=(16,))
        ref_params = ref_pol.init(jax.random.PRNGKey(5))
        bundle = PolicyBundle("dqn", SPEC, N_MAX,
                              jax.tree.map(np.asarray, ref_params))
    key = jax.random.PRNGKey(7)
    ref = ref_serve_stream(ref_pol, ref_params, scn, stream, ref_cfg,
                           key=key)
    job = ServeJob(bundle, convert.fleet_scenario(scn, CPU),
                   convert.request_stream(stream), ServeConfig(**kw),
                   convert.key_from_data(np.asarray(key), CPU))
    return ref, job


def _spot_case():
    """``spot`` with ``cost_greedy`` at ``full_economy``, background on,
    both couplings: (reference report, the port's ServeJob)."""
    kw = dict(n_max=N_MAX, obs_spec="full_economy", shared_cloud=True,
              shared_edge=True, telemetry=True, window_ms=500.0)
    ref_p, p = ref_builtin_profile("spot"), builtin_profile("spot")
    ref_cfg = RefServeConfig(economy=ref_p, **kw)
    scn = ref_random_fleet(jax.random.PRNGKey(3), CELLS, n_max=N_MAX,
                           cells_per_edge=4)
    horizon = 10 * ref_cfg.round_ms
    stream = ref_poisson_stream(jax.random.PRNGKey(4), scn, horizon,
                                rate=3.0, round_ms=ref_cfg.round_ms,
                                epoch_ms=horizon / 2)
    ref_pol = ref_routing.cost_greedy_policy(
        ref_make_spec("full_economy", N_MAX), ref_p)
    key = jax.random.PRNGKey(5)
    ref = ref_serve_stream(ref_pol, ref_pol.init(None), scn, stream, ref_cfg,
                           key=key)
    bundle = PolicyBundle("cost_greedy", "full_economy", N_MAX, {},
                          meta={"economy_profile": "spot"})
    job = ServeJob(bundle, convert.fleet_scenario(scn, CPU),
                   convert.request_stream(stream),
                   ServeConfig(economy=p, **kw),
                   convert.key_from_data(np.asarray(key), CPU))
    return ref, job


@pytest.fixture(scope="module")
def cases():
    """Every case's reference report and job, built once."""
    out = {case: _case(*case) for case in CASES}
    out["spot"] = _spot_case()
    return out


def _gauges(values):
    return np.array([np.nan if v is None else v for v in values], np.float64)


def assert_matches_reference(rep, ref):
    """Records and figures as ``tests/test_torch_serve.py`` holds them,
    telemetry as ``tests/test_torch_telemetry.py`` does, the economy's
    report equal (billing integers exactly)."""
    assert rep["served_requests"] > 0
    for k in EXACT:
        np.testing.assert_array_equal(rep["records"][k],
                                      np.asarray(ref["records"][k]), k)
    for k in CLOSE:
        np.testing.assert_allclose(rep["records"][k],
                                   np.asarray(ref["records"][k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    for k in FIGURES:
        got, want = rep[k], ref[k]
        assert (got is None) == (want is None), (k, got, want)
        if want is not None:
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), k
    assert rep.get("economy") == ref.get("economy")
    got, want = rep["telemetry"], ref["telemetry"]
    assert got.keys() == want.keys()
    for k in want:
        if k != "series":
            assert got[k] == want[k], k
    assert got["series"].keys() == want["series"].keys()
    for name, w in want["series"].items():
        g = got["series"][name]
        if all(isinstance(v, int) for v in w):
            assert g == w, name
            continue
        ga, wa = _gauges(g), _gauges(w)
        np.testing.assert_array_equal(np.isnan(ga), np.isnan(wa), name)
        np.testing.assert_allclose(ga, wa, atol=1e-5, rtol=0, err_msg=name)


def _serve_in_group(job, group, **kw):
    pol, params = policy_from_bundle(job.bundle, CPU)
    return serve_stream(pol, params, job.scenario, job.stream, job.cfg,
                        key=job.key, **kw)


@pytest.fixture
def group():
    g = cells_group("cpu")
    yield g
    destroy_cells_group(g)


# ------------------------------------------------------ one rank, in-process
@pytest.mark.parametrize("case", CASES[:2] + ["spot"])
def test_one_rank_group_matches_reference(case, cases, group):
    ref, job = cases[case]
    rep = _serve_in_group(job, group, mesh=group)
    assert rep["mesh_cells"] == 1
    assert rep["cells_group"]["backend"] == "gloo"
    assert_matches_reference(rep, ref)
    audit = audit_serve_report(
        rep, trace=build_trace(job.stream, rep["records"], job.cfg.tick_ms),
        n_cells=CELLS, n_max=N_MAX, queue_cap=job.cfg.queue_cap)
    assert audit.ok, audit.render()


def test_collectives_per_tick_and_epoch(cases, group):
    """Two all_reduces a tick (the observation's totals and the
    transition's) and one an epoch, at most the reference's traced
    cross-cell ``psum`` count for one epoch program (one tick and the
    decision count) at the benchmark's configuration."""
    kw = dict(n_max=5, obs_spec="full", shared_cloud=True, shared_edge=True)
    scn = random_fleet(rnd.PRNGKey(1, CPU), 8, n_max=5, cells_per_edge=4)
    cfg = ServeConfig(**kw)
    horizon = 4 * cfg.round_ms
    stream = poisson_request_stream(rnd.PRNGKey(2, CPU), scn, horizon,
                                    rate=2.0, round_ms=cfg.round_ms,
                                    epoch_ms=horizon / 2)
    pol = adapters.heuristic_greedy_policy(make_spec("full", 5))
    reset_collective_counts()
    rep = serve_stream(pol, pol.init(0, CPU), scn, stream, cfg,
                       key=rnd.PRNGKey(3, CPU), mesh=group)
    per_tick, per_epoch = 2, 1
    assert COLLECTIVES == rep["cells_group"]["collectives"] == {
        "all_reduce": per_tick * rep["n_ticks"] + per_epoch * rep["n_epochs"],
        "all_gather_object": 1}
    contracts = json.loads((REPO / "results" / "analysis_contracts.json")
                           .read_text())["contracts"]
    assert per_tick + per_epoch <= \
        contracts["serve_epoch_sharded"]["psum_cells"] == 13
    # uncoupled at the base spec, a tick needs no cross-cell total
    reset_collective_counts()
    base = ServeConfig(n_max=5)
    serve_stream(adapters.heuristic_greedy_policy(5),
                 pol.init(0, CPU), scn, stream, base, mesh=group)
    assert COLLECTIVES["all_reduce"] == rep["n_epochs"]


def test_registry_pickup(cases, group):
    """A group registered with ``set_mesh_info`` serves without
    ``mesh=``."""
    ref, job = cases[("greedy", "cpe4")]
    set_mesh_info(group)
    try:
        assert get_mesh_info().cells_size == 1
        assert get_mesh_info().cells_axis == "cells"
        rep = _serve_in_group(job, group)
    finally:
        set_mesh_info(None)
    assert rep["mesh_cells"] == 1 and "cells_group" in rep
    assert_matches_reference(rep, ref)
    assert get_mesh_info() is None


def test_misuse_refusals(group, tmp_path):
    """Live export under a group, a fleet that does not divide over the
    group and a mesh that is no cells group raise; the CLI refuses
    ``--mesh-cells`` with ``--round-replay``, with ``--live`` and when
    ``--cells`` does not divide, before any work."""
    pol = adapters.heuristic_greedy_policy(N_MAX)
    with pytest.raises(ValueError, match="live"):
        make_serve_engine(pol, ServeConfig(n_max=N_MAX, telemetry=True),
                          live=object(), mesh=group)
    with pytest.raises(TypeError, match="CellsGroup"):
        make_serve_engine(pol, ServeConfig(n_max=N_MAX), mesh=object())
    two = CellsGroup(None, 0, 2, CPU, "gloo")
    scn = random_fleet(rnd.PRNGKey(1, CPU), 7, n_max=N_MAX)
    stream = poisson_request_stream(rnd.PRNGKey(2, CPU), scn, 400.0,
                                    rate=1.0, round_ms=200.0,
                                    epoch_ms=400.0)
    with pytest.raises(ValueError, match="divide"):
        serve_stream(pol, pol.init(0, CPU), scn, stream,
                     ServeConfig(n_max=N_MAX), mesh=two)
    with pytest.raises(ValueError, match="divide"):
        scn.shard(0, 2)
    for argv, what in ((["--round-replay"], "round-replay"),
                       (["--telemetry", "--live"], "live"),
                       (["--cells", "7"], "divide")):
        with pytest.raises(SystemExit, match=what):
            serve_fleet.main(["--greedy", "--mesh-cells", "2", "--device",
                              "cpu"] + argv)


# ------------------------------------------------------------- blocks
@pytest.mark.parametrize("layout", ["cpe4", "cpe8", "mod", "random"])
@pytest.mark.parametrize("size", [1, 2, 4])
def test_blocks_total_to_the_fleet(layout, size):
    """Each rank's block: its cells, local groups indexed from 0, and
    group totals that, written at the blocks' global ids and added, are
    the whole fleet's ``group_occupancy``."""
    c = 16
    groups = {"cpe4": np.arange(c) // 4, "cpe8": np.arange(c) // 8,
              "mod": np.arange(c) % 4,
              "random": np.random.default_rng(3).integers(0, c, c)}[layout]
    groups = torch.as_tensor(groups.astype(np.int32))
    scn = random_fleet(rnd.PRNGKey(4, CPU), c, n_max=N_MAX)
    scn = scn._replace(edge_group=groups, group_index=group_index(groups))
    own = torch.as_tensor(np.random.default_rng(5).integers(0, 9, c)
                          .astype(np.int32))
    want = group_occupancy(own, scn.group_index)
    blocks = [scn.shard(r, size) for r in range(size)]
    per = c // size
    total = torch.zeros(blocks[0].group_index.block.n_groups,
                        dtype=torch.int32)
    for r, b in enumerate(blocks):
        blk = b.group_index.block
        assert blk.cell0 == r * per and blk.n_cells == c
        assert torch.equal(b.weak_s, scn.weak_s[r * per:(r + 1) * per])
        local = group_occupancy(own[r * per:(r + 1) * per], b.group_index)
        total[blk.group_ids] += local[blk.group_first]
        assert torch.equal(blk.group_size, scn.group_index.size[
            r * per:(r + 1) * per])
    for r, b in enumerate(blocks):
        blk = b.group_index.block
        np.testing.assert_array_equal(total[blk.cell_group],
                                      want[r * per:(r + 1) * per])
    # off a group, fleet_totals is the plain sums and group totals
    tot, gtot = fleet_totals(scn.group_index, [own], [own])
    assert int(tot[0]) == int(own.sum()) and torch.equal(gtot[0], want)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_tick_buckets_match_reference(cases, n_shards):
    _, job = cases[("greedy", "cpe4")]
    ref_stream = RefRequestStream(*job.stream)
    got = _tick_buckets(job.stream, 50.0, 4, n_shards)
    want = ref_tick_buckets(ref_stream, 50.0, 4, n_shards=n_shards)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------- merge_shard_buffers
@pytest.mark.parametrize("shards,seed", [(1, 0), (2, 1), (4, 2), (8, 3)])
def test_merge_shard_buffers_matches_reference(shards, seed):
    """The same stacked buffers (NaN windows scattered, a window no
    shard wrote) merged by both packages: counters and histogram
    identical, gauges equal with the same NaN windows."""
    rng = np.random.default_rng(seed)
    W, B = 6, 5
    counters = {n: rng.integers(0, 50, (shards, W)).astype(np.int32)
                for n in ("served", "dropped")}
    gauges = {}
    for n in ("backlog", "queue_depth", "inflight"):
        g = rng.uniform(0, 10, (shards, W)).astype(np.float32)
        g[rng.random((shards, W)) < 0.3] = np.nan
        g[:, 2] = np.nan
        gauges[n] = g
    hist = rng.integers(0, 20, (shards, B)).astype(np.int32)
    edges = np.geomspace(1.0, 100.0, B + 1).astype(np.float32)
    reduce = {"queue_depth": "mean"}
    want = ref_merge_shard_buffers(RefMetricBuffer(
        jnp.asarray(edges), jnp.asarray(hist),
        {n: jnp.asarray(v) for n, v in counters.items()},
        {n: jnp.asarray(v) for n, v in gauges.items()}), gauge_reduce=reduce)
    got = merge_shard_buffers(MetricBuffer(
        torch.as_tensor(edges), torch.as_tensor(hist),
        torch.as_tensor(np.stack(list(counters.values()), -1).astype(
            np.int64)),
        torch.as_tensor(np.stack(list(gauges.values()), -1)),
        tuple(counters), tuple(gauges)), gauge_reduce=reduce)
    np.testing.assert_array_equal(got.hist.numpy(), np.asarray(want.hist))
    assert got.hist.dtype == torch.int32 and got.edges.shape == (B + 1,)
    for n in counters:
        np.testing.assert_array_equal(got.counters[n].numpy(),
                                      np.asarray(want.counters[n]), n)
    for n in gauges:
        np.testing.assert_array_equal(got.gauges[n].numpy(),
                                      np.asarray(want.gauges[n]), n)


def test_merge_shard_buffers_semantics():
    """The reference's own case: sums, a mean over the shards that wrote,
    an all-NaN window kept NaN."""
    nan = float("nan")
    buf = MetricBuffer(
        torch.tensor([1.0, 10.0, 100.0]), torch.tensor([[1, 2], [3, 4]],
                                                       dtype=torch.int32),
        torch.tensor([[[1], [0], [2]], [[0], [5], [1]]]),
        torch.tensor([[[1.0, 2.0], [nan, 4.0], [2.0, nan]],
                      [[3.0, 4.0], [nan, nan], [nan, nan]]]),
        ("served",), ("backlog", "queue_depth"))
    out = merge_shard_buffers(buf, gauge_reduce={"queue_depth": "mean"})
    assert out.hist.tolist() == [4, 6]
    assert out.counters["served"].tolist() == [1, 5, 3]
    backlog, depth = out.gauges["backlog"], out.gauges["queue_depth"]
    assert backlog[0] == 4.0 and torch.isnan(backlog[1]) and backlog[2] == 2.0
    assert depth[0] == 3.0 and depth[1] == 4.0 and torch.isnan(depth[2])


# ------------------------------------------------------ spawned ranks
def test_two_ranks_match_reference(cases):
    """2 gloo ranks: greedy and dqn at the deployment's groups of 4, and
    the spot economy."""
    names = [("greedy", "cpe4"), ("dqn", "cpe4"), "spot"]
    reports = serve_sharded([cases[n][1] for n in names], 2, "cpu")
    for name, rep in zip(names, reports):
        assert rep["mesh_cells"] == 2, name
        assert rep["cells_group"]["backend"] == "gloo"
        assert [r["collectives"] for r in rep["ranks"]] == \
            [rep["cells_group"]["collectives"]] * 2
        assert_matches_reference(rep, cases[name][0])


def test_four_ranks_match_reference_groups_across_ranks(cases):
    """4 gloo ranks of 4 cells each: groups inside a block, groups of 8
    over two blocks, groups of ``cell % 4`` over all four; greedy and
    dqn; and the spot economy."""
    names = CASES + ["spot"]
    reports = serve_sharded([cases[n][1] for n in names], 4, "cpu")
    for name, rep in zip(names, reports):
        assert rep["mesh_cells"] == 4 and len(rep["ranks"]) == 4, name
        assert_matches_reference(rep, cases[name][0])
    audit = audit_serve_report(reports[-1])
    assert audit.ok, audit.render()


def test_cli_mesh_cells_matches_one_device(tmp_path, capsys):
    """``serve_fleet --mesh-cells 2 --device cpu`` (groups of 4 over two
    blocks of 4, both couplings, telemetry and a trace) against the same
    call with ``--mesh-cells 0``: the report's records, figures and
    telemetry equal, the trace written once and identical."""
    base = ["--greedy", "--cells", "8", "--rounds", "4", "--seed", "3",
            "--cells-per-edge", "4", "--shared-cloud", "--shared-edge",
            "--telemetry", "--window-ms", "250", "--device", "cpu"]
    reps = {}
    for n in (0, 2):
        trace = tmp_path / f"trace{n}.jsonl"
        reps[n] = serve_fleet.main(base + ["--mesh-cells", str(n),
                                           "--trace-out", str(trace),
                                           "--out", str(tmp_path / f"{n}.json")])
    one, two = reps[0], reps[2]
    assert one["mesh_cells"] == 1 and two["mesh_cells"] == 2
    assert two["config"]["mesh_cells"] == 2
    for k, v in one["records"].items():
        np.testing.assert_array_equal(v, two["records"][k], k)
    for k in FIGURES:
        assert one[k] == two[k], k
    assert one["telemetry"]["latency_hist"] == two["telemetry"]["latency_hist"]
    for name, s in one["telemetry"]["series"].items():
        np.testing.assert_allclose(_gauges(s),
                                   _gauges(two["telemetry"]["series"][name]),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert (tmp_path / "trace0.jsonl").read_text() == \
        (tmp_path / "trace2.jsonl").read_text()
    written = json.loads((tmp_path / "2.json").read_text())
    assert written["mesh_cells"] == 2 and len(written["ranks"]) == 2
