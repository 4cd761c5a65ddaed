#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  Phases, each printing one JSON line:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` of the port compiled from source (one nvcc
   per file, started together), with ``-Xptxas -v`` register and
   shared-memory lines;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving deployment's shapes (C = 65,536 cells, Q = 64, the busiest
   tick's arrival burst from the real bucketer; queue_admit also on a
   burst of 131,072 lanes in four lane orders; group_occupancy over four
   group layouts, float32 bit for bit against its summation order
   emulated on the CPU in ten launches, one kernel per call in the
   profiler) — bit-exact on integer inputs — and timed with CUDA events
   after warm-up beside its plain version, a one-call PyTorch yardstick
   where one exists, and its bound (bytes at 3.35 TB/s, each input read
   once and each output written once, counted from this run's data);
   group_occupancy also beside an empty kernel's launch
   (``launch_floor_ms``);
4. serve: the deployment — 65,536 cells, 4 cells per edge server, shared
   cloud and edge, Poisson rate 3 per cell per 250 ms round over 4 rounds,
   fleet and stream drawn from ``split(PRNGKey(0), 4)`` as the serving
   CLI and the reference's draw them (bit for bit the reference's) —
   through ``repro_torch.launch.serve_fleet``, greedy and then a
   guarded DQN from a bundle the port wrote and read back (weights from a
   ``torch.Generator``), with launch counts per kernel read around each
   run (group_occupancy 3 a tick), and device ops and busy time per tick
   from ``torch.profiler`` (one kernel per group_occupancy call, no
   memset but queue_admit's);
5. parity: a small configuration served on the CPU and on the card —
   integer records identical, float records within 1e-5;
6. round_replay: policy evaluation against the exact solver optimum at
   the deployment (65,536 cells, 8 rounds of a rate-3 round trace from
   the same seed split). (a) Coupled, background on, through
   ``serve_fleet --round-replay`` for the greedy baseline and an
   ``oracle`` bundle the port wrote and read back: every traced request
   served, no violation, every round's ART at least its oracle's less
   1e-2, group_occupancy launched 3 times a decision step and
   queue_admit never; the host seconds of ``solve_oracle`` (memoised,
   and the per-cell loop on 1,024 cells); ms per round and decisions/s,
   and one round's device ops and busy time in the profiler.
   (b) Quiet and uncoupled: the oracle replay's every round at the
   optimum within 1e-3; ``serve_stream`` on the trace's
   round-synchronous stream reproduces the greedy replay's
   request-weighted ART and violation rate within 1e-5, nothing dropped
   or deferred, queue_admit once a tick; every cell's reward gap to the
   optimum at least -1e-6 (the greedy baseline through the evaluator,
   and ``evaluate_vs_solver`` of phase 4's DQN); the throughput runner's
   decisions/s.  (c) 64 cells, 4 rounds, coupled, background on, greedy
   and oracle, replayed on the CPU and on the card: per-round requests
   and violation rates identical, ART and reward within 1e-5;
7. lm_kernels: flash attention, WKV6 and the SSD scan against their
   plain versions on the card at the LM serving shapes (yi-6b f32 and
   bf16, h2o-danube's window and head_dim 120 in f32 and bf16,
   zamba2-1.2b's shared block; rwkv6-1.6b's WKV6, also at a ragged S and
   in bf16, against its plain version in float64, with its kernels'
   ptxas registers and spills; zamba2-1.2b's Mamba2 scan, also at a
   ragged S and at G = 2; bf16 flash also row by row, each (query, head)
   row within 1e-2 of the plain row's norm), timed like phase 3 beside
   one ``F.scaled_dot_product_attention`` call for attention, with their
   bound (operations at the data-sheet peak of what runs them, or bytes
   at 3.35 TB/s, whichever is larger: the f32 flash kernel's three TF32
   products at the TF32 peak, with its FP32 CUDA-core bound beside; bf16
   flash at the dense BF16 peak; WKV6 at the FP32 peak, with its
   design's own byte floor beside; SSD's chunked products as three TF32
   products at the TF32 peak, with the exact recurrence's FP32 bound
   beside) and the flash and SSD kernels' tensor-core instruction counts
   from ``cuobjdump -sass`` of the built libraries (every instance must
   hold some);
8. lm_serve: ``repro_torch.launch.serve`` at full width — yi-6b,
   rwkv6-1.6b and zamba2-1.2b, weights from a ``torch.Generator`` on the
   card, batch 4, prompt 2048, 32 greedy tokens — with launch counts read
   around each run (each kernel launched as often as the config's blocks
   call it in one prefill: flash once per attn block and per application
   of zamba2's shared block, WKV6 once per rwkv6 block, SSD once per
   mamba2 block, the others not at all) and the serving invariant: a
   teacher-forced forward over prompt + generated tokens matches the
   prefill and decode logits within 1e-3;
9. lm_parity: the yi, h2o-danube, rwkv6 and zamba2 smoke configs from
   one seed on the CPU and on the card — logits within 1e-4, greedy
   tokens identical;
10. hltrain: fleet Hybrid Learning training (Algorithm 1).  (a) The
   deployment (65,536 cells, n_max 5, ``full``, shared cloud and edge,
   4 cells per edge) trained through ``rl_train --fleet`` for 4 epochs
   of a 4-stage curriculum, the CLI's defaults otherwise: direct steps
   equal to the closed-form budget, verifications inside theirs,
   group_occupancy launched exactly as ``session_schedule`` implies
   around ``run_curriculum`` (2 per observe at init and stage swaps, 3
   per env step, one env step per direct step and k_best + 1 per
   planning step) and queue_admit never, finite losses and parameters,
   every cell's reward gap to the optimum at least -1e-6 on the last
   stage and a held-out fleet; host seconds per epoch, real steps/s,
   the solver's host seconds, and one direct and one planning step's
   device ops and busy ms in the profiler.  (b) The bundle it wrote
   loads and replays 2 rounds of the deployment's trace on the card,
   every request served, 3 group sums a decision step.  (c) One epoch
   at 4,096 cells under ``torch.cuda.set_sync_debug_mode("error")``.
   (d) 64 cells, 2 tiny epochs from one key on the CPU and the card,
   epoch by epoch: integers identical (counters, ring pointers and
   sizes, actions, done flags, plan keys), floats within the CPU tests'
   bars; a differing direct action only at a near-tie (Q gap < 1e-4);
11. economy: tier economics in the serving tick.  (a) Phase 4's
   deployment under the ``spot`` profile through ``serve_fleet --economy
   spot`` with a ``cost_greedy`` bundle (``full_economy``) the port
   wrote and read back: queue_admit once a tick and group_occupancy 3
   times a tick, read around the run; every billing total a
   non-negative integer; preemptions > 0; ms per steady tick beside
   phase 4's, and one tick's device ops and busy ms in the profiler.
   (b) ``--economy local`` against no economy on the card, greedy and
   quiet: records byte-identical, no spend, energy metered.  (c) 64
   cells under ``spot`` with the ``cost_greedy`` bundle, 4 rounds,
   background on, on the CPU and the card: integer records and the four
   billing integers identical, float records within 1e-5.  (d) The
   CLI's ``--quiet --tick-ms 40 --queue-cap 16 --out`` on the card: the
   file holds the returned report; an unwritable ``--out`` exits
   non-zero before any kernel launches.

12. telemetry: the per-window metric buffer in the tick and the trainer.
   (a) Phase 4's deployment through ``serve_fleet --greedy --telemetry
   --window-ms 250 --live --live-out --trace-out --trace-sample 0.05
   --out``: records byte-identical to the same call without telemetry,
   queue_admit once and group_occupancy 3 times a tick, one live
   ``window`` record per window and the summary last, the audit
   (``repro_torch.telemetry.audit_serve_report``) passing on the written
   report and the sampled trace, ``validate_trace`` passing; device ops
   and busy ms per tick of a short run with telemetry off and on (same
   call) and the kernels telemetry adds, ms per steady tick in four
   runs (off, on, on, off); host syncs counted with
   ``set_sync_debug_mode("warn")`` over epoch 1 of a 5-epoch run, by
   source line: equal with telemetry off and on, and with live export at
   most one more per window it closed plus one for its epoch record.
   (b) Phase 11's ``spot`` run with ``--telemetry``: the audit's four
   economy conservation laws hold exactly (Σ window µ$, mJ, cold starts
   and preemptions = ``report["economy"]``).  (c) One 4,096-cell epoch with
   ``FleetHLParams(telemetry=True)`` under ``set_sync_debug_mode("error")``,
   then two with a ``TrainLiveEmitter``: one ``train_session`` record per
   direct session and ``audit_train_report`` passing.  (d) 64 cells on
   the CPU and the card with telemetry, serving greedy and under ``spot``
   (counters and histograms identical, gauges within 1e-5 with the same
   unwritten windows, the live NDJSON identical but for ``wall_s``) and 2
   tiny training epochs (counts and the |TD| histogram identical, gauges
   within 1e-5).
13. sharded: the serving tick over a cells group of spawned ranks
   (``repro_torch.sharding``).  (a) Phase 4's deployment through
   ``serve_fleet.serve(mesh_cells=4)`` (gloo on one card, NCCL when each
   rank has a card) and ``mesh_cells=1`` (NCCL), beside one device in the
   same call: flags and actions identical, floats within 1e-5, each rank
   launching queue_admit once and group_occupancy 3 times a tick (the
   ranks' counts zeroed just before their run and read just after; the
   parent launches nothing), two ``all_reduce`` a tick and one an epoch,
   the backend, ms per steady tick by rank.  (b) 4,096 cells whose edge
   groups span every rank (``cell % 1024``) over 4 ranks against one
   device; then the deployment's host syncs in epoch 1 on each rank
   (``set_sync_debug_mode("warn")``, by source line).  (c) Phase 11's
   ``spot`` run with telemetry over 4 ranks: billing integers identical
   to one device's, counters and histogram identical, gauges within 1e-5
   with the same unwritten windows, the audit passing.  (d) 64 cells over
   2 ranks on the CPU and on the card: records identical.  Prints its
   seconds.
14. single_cell: the paper's single-cell agents (the numpy env and
   buffers on the host, the networks on the card).  (a) Table V's agent
   cell through ``rl_train`` without ``--fleet`` (``train_single``): HL
   at 5 users, A/89%, with the CLI's hyper-parameters and bundle; seeds
   0, 1 and 2 in turn until one converges within the CLI's 400 epochs;
   the optimum (269.8 ms) and its decisions, the converged step, real
   steps, final ART (within 1% of the optimum, no violation),
   experience and compute minutes, wall seconds, real steps/s, and
   every kernel's launches around each run (all 0).  (e) On that agent:
   ``IntelligentOrchestrator.decide_round`` gives 5 decisions whose
   tiers are the final round's, and its bundle loads through
   ``load_bundle`` / ``policy_from_bundle`` on the card and acts as the
   agent on 1,000 recorded observations.  (b) Table VI's 3-user row at
   A/89%, seed 0, with ``run_one``'s hyper-parameters: HL and DQL
   converge, QL (host-side) is the reference's run, 22,000 / 28,000
   steps and final ART 269.8; no kernel launched.  (c) Host syncs
   (``set_sync_debug_mode("warn")``, by source line) per real step over
   epoch 2 of a fresh 5-user HL agent, and device ops and busy ms of one
   direct session, one planning session and one DQN update in the
   profiler.  (d) One seed at 3 users on the CPU and the card, HL for 2
   tiny epochs and DQL for 1,000 steps: integers identical, float
   buffers within 1e-5, TD priorities within 1e-5 of max(1, |p|),
   parameters within 2e-6, a differing decision only at a near-tie
   (gap < 1e-4, the CPU's values); then the card's DQL networks after
   its last update and one minibatch of its buffer go through the
   agent's update on the CPU and on the card, and the TD errors' gap is
   reported in float32 ulps of the priority.  Prints its seconds.
15. analysis: the port's analysis gate and the tick with no host sync.
   (a) ``python -m repro_torch.analysis --check --lint`` on the card
   against the committed baseline the CPU wrote
   (``results/analysis_contracts_torch.json``; its output goes to
   ``chiprun_out/chip_smoke_analysis.txt``).  (b) Phase 4's deployment,
   greedy, with every ``run_epoch`` under
   ``torch.cuda.set_sync_debug_mode("error")``, then with telemetry and
   live export, whose window lane steps out of the error mode for its
   one copy: queue_admit once and group_occupancy 3 times a tick (counts
   zeroed just before each run, read just after), records byte-identical
   to the same run unguarded.  (c) Host syncs by source line over epoch
   1 of the greedy deployment (``set_sync_debug_mode("warn")``): none
   inside the tick, the same lines as phase 12's count.  Prints its
   seconds.

Any failed check raises, so the exit code is non-zero.  Ends with the
``nvidia-smi`` line, the kernels' JSON summary and, last,
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# device spin before timed calls: ~10 ms at H100 clocks, longer than the
# host takes to enqueue them (checked per measurement)
SLEEP_CYCLES = 20_000_000

# the serving deployment: the 65,536-cell row of the cells sweep
CELLS, CELLS_PER_EDGE, RATE, ROUNDS, EPOCHS, SEED = 65536, 4, 3.0, 4, 2, 0
SERVE_KW = dict(cells=CELLS, rate=RATE, rounds=ROUNDS, seed=SEED,
                epochs=EPOCHS, cells_per_edge=CELLS_PER_EDGE,
                shared_cloud=True, shared_edge=True)
# round replay of the deployment: rounds of its trace, decision steps a
# round (n_max)
REPLAY_ROUNDS, N_MAX = 8, 5
REPLAY_KW = dict(SERVE_KW, rounds=REPLAY_ROUNDS, round_replay=True)
ORCH_CU = "src/repro_torch/kernels/csrc/orchestration.cu"
REPLACES = {"queue_admit": "src/repro/kernels/orchestration.py:114",
            "group_occupancy": "src/repro/kernels/orchestration.py:55",
            "flash_attention": "src/repro/kernels/flash_attention.py:69",
            "wkv6": "src/repro/kernels/wkv6.py:83",
            "ssd": "src/repro/kernels/ssd.py:66"}
SOURCES = {"flash_attention":
           "src/repro_torch/kernels/csrc/flash_attention.cu",
           "wkv6": "src/repro_torch/kernels/csrc/wkv6.cu",
           "ssd": "src/repro_torch/kernels/csrc/ssd.cu"}
# each LM kernel's name in the profiler's device events
DEVICE_NAMES = {"flash_attention": "flash_fwd_kernel",
                "wkv6": "wkv6_kernel", "ssd": "ssd_kernel"}
# H100 SXM data-sheet peaks: FP32 on the CUDA cores, dense TF32 and BF16
# on the tensor cores
PEAK_FP32, PEAK_TF32, PEAK_BF16 = 67e12, 495e12, 989e12
# traces of one call taken before the profiler's loss of every device
# record fails the run
PROFILE_ATTEMPTS = 3
# the LM serving runs: batch, prompt, greedy tokens
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32

results: dict = {}


def emit(phase: str, **fields) -> None:
    results[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def roofline(n_bytes: float, flops: float, peak: float) -> dict:
    """The least time for the work: bytes at the HBM rate or flops at the
    data-sheet ``peak`` of the units that run them, whichever is
    larger."""
    by_bytes = bound_ms(n_bytes)
    by_ops = flops / peak * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=n_bytes, flops=flops)


def reset_all_counts() -> None:
    from repro_torch.kernels import flash_attention, orchestration, ssd, wkv6
    for mod in (orchestration, flash_attention, wkv6, ssd):
        mod.reset_launch_counts()


def all_counts() -> dict:
    from repro_torch.kernels import flash_attention, orchestration, ssd, wkv6
    return {**orchestration.LAUNCHES, **flash_attention.LAUNCHES,
            **wkv6.LAUNCHES, **ssd.LAUNCHES}


def cuda_ms(torch, fn, reset=None, iters=10, per=1, warmup=3) -> dict:
    """Time ``fn`` with CUDA events after warm-up; ``reset`` (untimed)
    restores inputs an in-place kernel changed.

    ``ms``: device time per call.  The card first spins in
    ``torch.cuda._sleep`` while the host enqueues ``per`` calls between
    the two events, so the events bracket device work only;
    ``blocker_held`` says the spin outlasted every enqueue (a version
    that synchronises inside, like the plain ``queue_admit``, waits the
    spin out and is timed from the start event on, host gaps included).
    ``call_ms``: one call with a synchronise around it — what a caller
    pays, launch overhead included."""
    ev = lambda: torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        if reset:
            reset()
        fn()
    torch.cuda.synchronize()
    dev_total, call_total, held = 0.0, 0.0, True
    for _ in range(iters):
        if reset:
            reset()
        e0, start, end = ev(), ev(), ev()
        e0.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        held = held and host_ms < e0.elapsed_time(start)
        dev_total += start.elapsed_time(end) / per
        if reset:
            reset()
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        call_total += start.elapsed_time(end)
    return dict(ms=dev_total / iters, call_ms=call_total / iters,
                blocker_held=held)


# ------------------------------------------------------------------ phases
def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return card


def phase_build() -> None:
    from repro_torch.kernels import _build
    sources = sorted(_build.CSRC.glob("*.cu"))

    def timed(source):
        t = time.perf_counter()
        _, log = _build.build(source, force=True)
        return log, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(timed, sources))
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for log, _ in built for ln in log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    emit("build", seconds=seconds, sources=[s.name for s in sources],
         seconds_by_source={s.name: t for s, (_, t) in zip(sources, built)},
         ptxas=ptxas)
    return ptxas_by_entry(ptxas)


def ptxas_by_entry(lines: list) -> dict:
    """{mangled entry: registers, spill stores and loads in bytes} from
    ``-Xptxas -v`` lines (an entry's lines follow its "Compiling entry")."""
    import re
    out, entry = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m[1]
            out[entry] = {}
        elif entry and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out[entry].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif entry and (m := re.search(r"Used (\d+) registers", ln)):
            out[entry]["registers"] = int(m[1])
    return out


def deployment_burst(torch, dev):
    """The deployment's scenario and stream, drawn from the keys the
    serving CLI (and the reference's) splits from ``PRNGKey(SEED)``, and
    the busiest tick's arrival lanes from the engine's own bucketer."""
    import numpy as np
    from repro_torch import random as rnd
    from repro_torch.fleet.workload import random_fleet
    from repro_torch.serve.engine import ServeConfig, _tick_buckets
    from repro_torch.serve.stream import poisson_request_stream
    k_fleet, k_trace, _, _ = rnd.split(rnd.PRNGKey(SEED, dev), 4)
    scn = random_fleet(k_fleet, CELLS, n_max=5,
                       cells_per_edge=CELLS_PER_EDGE)
    cfg = ServeConfig(n_max=5, obs_spec="full")
    horizon = ROUNDS * cfg.round_ms
    stream = poisson_request_stream(k_trace, scn, horizon, rate=RATE,
                                    round_ms=cfg.round_ms,
                                    epoch_ms=horizon / EPOCHS)
    ids = _tick_buckets(stream, cfg.tick_ms, 10)[0][:, 0]  # one shard
    row = ids[int((ids >= 0).sum(1).argmax())]
    rid = torch.as_tensor(row, device=dev)
    cell = torch.as_tensor(stream.cell[np.maximum(row, 0)], device=dev)
    return scn, stream, rid, cell, rid >= 0


def phase_kernels(torch, dev) -> dict:
    from repro_torch.kernels import orchestration as orch
    scn, stream, rid, cell, valid = deployment_burst(torch, dev)
    C, Q, A = CELLS, 64, rid.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED)
    q_ids0 = torch.randint(0, stream.n_requests, (C, Q), generator=g,
                           device=dev, dtype=torch.int32)
    q_head0 = torch.randint(0, Q, (C,), generator=g, device=dev,
                            dtype=torch.int32)
    # ring fills over the whole range, so the burst also overflows
    q_len0 = torch.randint(0, Q + 1, (C,), generator=g, device=dev,
                           dtype=torch.int32)
    out = {}

    # queue_admit: bit-exact against the plain version, then timed
    def admit_on(fn, q_ids, q_len):
        return fn(q_ids, q_head0, q_len, rid, cell, valid)

    k_ids, k_len = q_ids0.clone(), q_len0.clone()
    _, _, k_adm = admit_on(orch.queue_admit, k_ids, k_len)
    p_ids, p_len = q_ids0.clone(), q_len0.clone()
    _, _, p_adm = admit_on(orch.queue_admit_plain, p_ids, p_len)
    torch.cuda.synchronize()
    err = max(int((k_ids - p_ids).abs().max()),
              int((k_len - p_len).abs().max()),
              int((k_adm != p_adm).sum()))
    check(err == 0, f"queue_admit differs from its plain version ({err})")
    n_adm, n_drop = int(k_adm.sum()), int((valid & ~k_adm).sum())
    check(n_adm > 0 and n_drop > 0, "burst exercises admits and drops")
    # adversarial lane orders on the card: one cell's burst past Q, and
    # interleaved cells
    for name, cells_ in (("one_cell", torch.full_like(cell, 7)),
                         ("interleaved", (torch.arange(
                             A, device=dev, dtype=torch.int32) % 3))):
        a_ids, a_len = q_ids0.clone(), q_len0.clone()
        b_ids, b_len = q_ids0.clone(), q_len0.clone()
        ka = orch.queue_admit(a_ids, q_head0, a_len, rid, cells_, valid)[2]
        pa = orch.queue_admit_plain(b_ids, q_head0, b_len, rid, cells_,
                                    valid)[2]
        check(torch.equal(a_ids, b_ids) and torch.equal(a_len, b_len)
              and torch.equal(ka, pa), f"queue_admit {name} burst")
    wide = admit_wide(torch, dev, orch, q_ids0, q_head0, q_len0, g)
    ws_ids, ws_len = q_ids0.clone(), q_len0.clone()

    def reset():
        ws_ids.copy_(q_ids0)
        ws_len.copy_(q_len0)

    touched = int(torch.unique(cell[valid]).numel())
    kern = cuda_ms(torch, lambda: admit_on(orch.queue_admit, ws_ids, ws_len),
                   reset, iters=20)
    plain = cuda_ms(torch, lambda: admit_on(orch.queue_admit_plain, ws_ids,
                                            ws_len), reset, iters=20)
    out["queue_admit"] = dict(
        name="queue_admit", route="cuda", source=ORCH_CU,
        replaces=REPLACES["queue_admit"], max_abs_err=err,
        ms=kern["ms"], plain_ms=plain["ms"],
        # rid, cell, valid in and admitted out per lane; head and length
        # in, length out per touched cell; one ring slot per admit
        bound_ms=bound_ms(10 * A + 12 * touched + 4 * n_adm),
        bound_by="bytes", library_ms=None,
        call_ms=kern["call_ms"], plain_call_ms=plain["call_ms"],
        blocker_held=kern["blocker_held"],
        shape=dict(C=C, Q=Q, A=A, valid=int(valid.sum()), admitted=n_adm,
                   dropped=n_drop, touched_cells=touched),
        wide_burst=wide)

    out["group_occupancy"] = group_occupancy_entry(torch, dev, orch, scn, g)
    emit("kernels", **out)
    return out


def group_layouts(torch, dev, g) -> dict:
    """The four edge-group layouts at the deployment's C: its contiguous
    groups of 4, singletons, one group of all cells (a combining launch),
    and random ids in [0, C), some of them without a cell."""
    ar = torch.arange(CELLS, device=dev, dtype=torch.int32)
    return {"groups_of_4": ar // CELLS_PER_EDGE, "singleton": ar,
            "one_group": torch.zeros_like(ar),
            "random": torch.randint(0, CELLS, (CELLS,), generator=g,
                                    device=dev, dtype=torch.int32)}


def traced(torch, fn, cpu=True, before=None) -> tuple:
    """Run ``fn`` under ``torch.profiler``: the profile, its device events
    and what ``fn`` returned.  Every ``fn`` traced here launches kernels,
    so a trace without a single device event lost its records; it is
    taken again (``before`` runs, untraced, ahead of each attempt), up to
    ``PROFILE_ATTEMPTS`` times, and each lost trace is counted in
    ``results["profiler_lost_traces"]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    for _ in range(PROFILE_ATTEMPTS):
        if before:
            before()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            result = fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            return prof, events, result
        results["profiler_lost_traces"] = results.get(
            "profiler_lost_traces", 0) + 1
    raise RuntimeError(f"chip_smoke check failed: the profiler recorded no "
                       f"device event in {PROFILE_ATTEMPTS} traces")


def stream_ops(torch, fn) -> dict:
    """Device events of one ``fn()`` call under ``torch.profiler``, by
    name."""
    names: dict = {}
    for e in traced(torch, fn, cpu=False)[1]:
        names[e.name[:60]] = names.get(e.name[:60], 0) + 1
    return names


def group_occupancy_entry(torch, dev, orch, scn, g) -> dict:
    """group_occupancy over the deployment's group index: int32 against
    the plain version, float32 (non-integer values) bit for bit against
    the kernel's summation order emulated on the CPU and across ten
    launches, at each of the four layouts; one kernel per call (two for
    the one-group layout) in the profiler; timed beside the plain
    version, one ``index_add_`` + gather, and an empty kernel's launch
    through the same path (``launch_floor_ms``)."""
    C = CELLS
    index = scn.group_index
    check(index is not None and torch.equal(index.groups, scn.edge_group),
          "the deployment carries its group index")
    own = torch.randint(0, 6, (C,), generator=g, device=dev,
                        dtype=torch.int32)
    own_f = torch.randn(C, generator=g, device=dev)
    layouts = {}
    for name, groups in group_layouts(torch, dev, g).items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = orch.group_index(groups)  # set-up: host clock, synchronised
        build_ms = (time.perf_counter() - t0) * 1e3
        k_out = orch.group_occupancy(own, idx)
        p_out = orch.group_occupancy_plain(own, groups)
        torch.cuda.synchronize()
        check(torch.equal(k_out, p_out),
              f"group_occupancy {name}: int32 equals its plain version")
        tree = orch.group_occupancy_tree(own_f.cpu(), idx.to("cpu"))
        runs = [orch.group_occupancy(own_f, idx).cpu() for _ in range(10)]
        check(all(torch.equal(r, tree) for r in runs),
              f"group_occupancy {name}: float32 equals the kernel's order "
              "emulated on the CPU, in each of ten launches")
        ops = stream_ops(torch, lambda: orch.group_occupancy(own, idx))
        check(sum(ops.values()) == 1 + idx.chunked and all(
            "group_" in n for n in ops), f"group_occupancy {name}: "
            f"{1 + idx.chunked} kernel launch(es) per call, nothing else "
            f"({ops})")
        layouts[name] = dict(
            n_groups=idx.n_groups, max_size=idx.max_size,
            n_tiles=idx.n_tiles, chunked=idx.chunked, stream_ops=ops,
            index_build_ms=build_ms,
            float32_vs_plain_max_abs_err=float(
                (runs[0] - orch.group_occupancy_plain(
                    own_f, groups).cpu()).abs().max()),
            ms=cuda_ms(torch, lambda: orch.group_occupancy(own, idx),
                       per=20)["ms"])
    groups = index.groups
    lib = lambda: torch.zeros(C, dtype=own.dtype, device=dev).index_add_(
        0, groups, own)[groups]
    p_out = orch.group_occupancy_plain(own, groups)
    err = int((orch.group_occupancy(own, index) - p_out).abs().max())
    check(err == 0, "group_occupancy differs from its plain version")
    check(torch.equal(lib(), p_out), "index_add_ yardstick agrees")
    kern, plain, library, floor = (
        cuda_ms(torch, fn, per=20)
        for fn in (lambda: orch.group_occupancy(own, index),
                   lambda: orch.group_occupancy_plain(own, groups), lib,
                   lambda: orch.empty_launch(dev)))
    return dict(
        name="group_occupancy", route="cuda", source=ORCH_CU,
        replaces=REPLACES["group_occupancy"], max_abs_err=err,
        ms=kern["ms"], plain_ms=plain["ms"],
        # own and groups read, out written: 12 bytes a cell
        bound_ms=bound_ms(12 * C), bound_by="bytes",
        library_ms=library["ms"], launch_floor_ms=floor["ms"],
        # the design reads slot_cell and slot_seg for groups: 16 a cell
        design_floor_ms=bound_ms(16 * C),
        call_ms=kern["call_ms"], plain_call_ms=plain["call_ms"],
        library_call_ms=library["call_ms"], launch_floor_call_ms=floor[
            "call_ms"],
        blocker_held=all(x["blocker_held"]
                         for x in (kern, plain, library, floor)),
        layouts=layouts, shape=dict(C=C, groups=index.n_groups))


def admit_wide(torch, dev, orch, q_ids0, q_head0, q_len0, g) -> dict:
    """queue_admit on a 131,072-lane burst over the deployment's rings in
    four lane orders, bit-exact against the plain version; the random
    order timed."""
    C, A = CELLS, 131072
    rid = torch.randperm(A, generator=g, device=dev).to(torch.int32)
    valid = torch.rand(A, generator=g, device=dev) < 0.9
    rand = torch.randint(0, C, (A,), generator=g, device=dev,
                         dtype=torch.int32)
    orders = {"random": rand,
              "one_cell": torch.full_like(rand, 11),
              "interleaved": torch.arange(A, device=dev,
                                          dtype=torch.int32) % 3,
              "reversed": torch.sort(rand, descending=True).values}
    out = {}
    for name, cell in orders.items():
        a_ids, a_len = q_ids0.clone(), q_len0.clone()
        b_ids, b_len = q_ids0.clone(), q_len0.clone()
        ka = orch.queue_admit(a_ids, q_head0, a_len, rid, cell, valid)[2]
        pa = orch.queue_admit_plain(b_ids, q_head0, b_len, rid, cell,
                                    valid)[2]
        check(torch.equal(a_ids, b_ids) and torch.equal(a_len, b_len)
              and torch.equal(ka, pa), f"queue_admit {name} burst of {A}")
        out[name] = dict(admitted=int(ka.sum()), dropped=int((valid
                                                              & ~ka).sum()))
    ws_ids, ws_len = q_ids0.clone(), q_len0.clone()

    def reset():
        ws_ids.copy_(q_ids0)
        ws_len.copy_(q_len0)

    kern = cuda_ms(torch, lambda: orch.queue_admit(
        ws_ids, q_head0, ws_len, rid, rand, valid), reset, iters=20)
    touched = int(torch.unique(rand[valid]).numel())
    return dict(A=A, orders=out, ms=kern["ms"], call_ms=kern["call_ms"],
                bound_ms=bound_ms(10 * A + 12 * touched
                                  + 4 * out["random"]["admitted"]),
                blocker_held=kern["blocker_held"])


def _summary(report: dict) -> dict:
    keys = ("n_requests", "served_requests", "dropped_requests",
            "deferred_requests", "slo_attainment", "violation_rate",
            "p50_latency_ms", "p95_latency_ms", "p99_latency_ms",
            "mean_art_ms", "n_epochs", "n_ticks", "steady_ticks",
            "ms_per_tick", "compile_time_s", "run_time_s",
            "decisions_per_s")
    return {k: report[k] for k in keys}


def serve_counted(orch, serve_fleet, **kw) -> tuple[dict, dict]:
    """One main-path run with the launch counts zeroed just before it
    and read just after."""
    reset_all_counts()
    report = serve_fleet.serve(device="cuda", verbose=False, **kw)
    launches = dict(orch.LAUNCHES)
    for name, n in launches.items():
        check(n > 0, f"{name} launched during the serving run")
    return report, launches


def phase_serve(torch) -> dict:
    from repro_torch.kernels import orchestration as orch
    from repro_torch.launch import serve_fleet
    from repro_torch.policy.adapters import dqn_policy
    from repro_torch.policy.bundle import (PolicyBundle, load_bundle,
                                           save_bundle)
    from repro_torch.specs.observation import make_spec

    greedy, g_launch = serve_counted(orch, serve_fleet, greedy=True,
                                     **SERVE_KW)
    spec = make_spec("full", 5)
    path = OUT / "chip_smoke_dqn.bundle.msgpack"
    meta = {"shared_cloud": True, "shared_edge": True,
            "cells_per_edge": CELLS_PER_EDGE}
    save_bundle(str(path), PolicyBundle(
        "dqn", "full", 5, dqn_policy(spec).init(SEED, "cpu"), meta=meta))
    check(load_bundle(str(path), expect_spec="full").kind == "dqn",
          "bundle reads back")
    guarded, q_launch = serve_counted(orch, serve_fleet, bundle=str(path),
                                      guard=True, **SERVE_KW)
    check(guarded["violation_rate"] == 0.0, "guarded run never violates")
    # a tick sums edge groups three times: its observe's coupling and
    # group load, and the transition's coupling
    for name, rep, launches in (("greedy", greedy, g_launch),
                                ("guarded_dqn", guarded, q_launch)):
        check(launches["group_occupancy"] == 3 * rep["n_ticks"],
              f"{name}: group_occupancy launched 3 times a tick "
              f"({launches['group_occupancy']} in {rep['n_ticks']} ticks)")

    # device-busy share of a tick: profile a short run of the deployment
    prof, dev_events, short = traced(
        torch, lambda: serve_fleet.serve(
            greedy=True, device="cuda", verbose=False,
            **dict(SERVE_KW, rounds=1, epochs=1)), before=reset_all_counts)
    prof_launches = dict(orch.LAUNCHES)
    # every tick opens with its admission kernel: count from the first
    # one on, so set-up copies before the ticks stay out
    first = min((e.time_range.start for e in dev_events
                 if "queue_admit_kernel" in e.name), default=None)
    check(first is not None, "profiler saw the admission kernel")
    dev_events = [e for e in dev_events if e.time_range.start >= first]
    # in the ticks: one kernel per group_occupancy call, and no memset but
    # queue_admit's
    n_group = sum("group_occupancy_kernel" in e.name for e in dev_events)
    n_combine = sum("group_combine_kernel" in e.name for e in dev_events)
    n_memset = sum("memset" in e.name.lower() for e in dev_events)
    check(n_group == prof_launches["group_occupancy"] and n_combine == 0,
          f"one group_occupancy kernel per call ({n_group} kernels, "
          f"{n_combine} combining, {prof_launches['group_occupancy']} calls)")
    check(n_memset <= prof_launches["queue_admit"],
          f"no memset for group_occupancy ({n_memset} memsets, "
          f"{prof_launches['queue_admit']} queue_admit calls)")
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    (OUT / "chip_smoke_profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    prof_ticks = short["n_ticks"]

    out = {}
    for name, rep, launches in (("greedy", greedy, g_launch),
                                ("guarded_dqn", guarded, q_launch)):
        out[name] = dict(_summary(rep), launches=launches,
                         launches_per_tick={k: v / rep["n_ticks"]
                                            for k, v in launches.items()})
    busy_ms = busy_us / 1e3 / prof_ticks
    out["profile"] = dict(
        ticks=prof_ticks, launches=prof_launches,
        group_occupancy_kernels=n_group, memsets=n_memset,
        device_events=len(dev_events),
        device_events_per_tick=len(dev_events) / prof_ticks,
        device_busy_ms_per_tick=busy_ms,
        wall_ms_per_tick_unprofiled=greedy["ms_per_tick"],
        device_busy_share=busy_ms / greedy["ms_per_tick"])
    emit("serve", **out)
    return out


def phase_parity() -> None:
    import numpy as np
    from repro_torch.launch import serve_fleet
    small = dict(cells=64, rounds=4, seed=1, epochs=2, cells_per_edge=4,
                 shared_cloud=True, shared_edge=True, verbose=False)
    path = str(OUT / "chip_smoke_dqn.bundle.msgpack")
    worst = {}
    for name, kw in (("greedy", dict(greedy=True)),
                     ("guarded_dqn", dict(bundle=path, guard=True))):
        cpu = serve_fleet.serve(device="cpu", **kw, **small)["records"]
        gpu = serve_fleet.serve(device="cuda", **kw, **small)["records"]
        for k in ("dropped", "served", "violated", "action"):
            check(np.array_equal(cpu[k], gpu[k]), f"{name} {k} identical")
        errs = {k: float(np.abs(cpu[k] - gpu[k]).max())
                for k in ("wait_ms", "service_ms", "art_ms")}
        check(max(errs.values()) <= 1e-5, f"{name} floats within 1e-5")
        worst[name] = dict(errs, n_served=int(cpu["served"].sum()))
    emit("parity", **worst)


def _replay_summary(rep: dict) -> dict:
    keys = ("served_requests", "mean_art_ms", "opt_art_ms",
            "violation_rate", "mean_reward", "opt_reward", "decisions_per_s")
    out = {k: rep[k] for k in keys}
    dps = rep["decisions_per_s"]
    # decisions/s counts C * n_max decisions a round
    out["ms_per_round"] = (rep["n_cells"] * N_MAX / dps * 1e3
                           if dps else None)
    return out


def replay_counted(serve_fleet, **kw) -> tuple[dict, dict]:
    """One round replay through the CLI's entry point on the card, with
    the launch counts zeroed just before it and read just after."""
    reset_all_counts()
    rep = serve_fleet.serve(device="cuda", verbose=False, **kw)
    return rep, all_counts()


def phase_round_replay(torch) -> dict:
    import numpy as np
    from repro_torch import random as rnd
    from repro_torch.env.scenarios import Scenario
    from repro_torch.fleet.env import FleetConfig
    from repro_torch.fleet.evaluate import (make_greedy_evaluator,
                                            make_throughput_runner)
    from repro_torch.fleet.solver import solve_optimal
    from repro_torch.fleet.workload import poisson_round_trace, random_fleet
    from repro_torch.hltrain.metrics import (evaluate_vs_solver,
                                             optimal_rewards,
                                             reward_from_round)
    from repro_torch.launch import serve_fleet
    from repro_torch.policy import adapters
    from repro_torch.policy.bundle import (PolicyBundle, load_bundle,
                                           policy_from_bundle, save_bundle)
    from repro_torch.serve.compat import make_gateway, replay_trace
    from repro_torch.serve.engine import ServeConfig, serve_stream
    from repro_torch.serve.stream import round_synchronous_stream
    from repro_torch.specs.observation import make_spec

    dev = torch.device("cuda")
    spec = make_spec("full", N_MAX)
    meta = {"shared_cloud": True, "shared_edge": True,
            "cells_per_edge": CELLS_PER_EDGE}

    def oracle_bundle(name, cells, seed):
        """An oracle bundle for the fleet the CLI draws from ``seed``,
        written and read back; with the tables and the solver's host
        seconds."""
        k_fleet = rnd.split(rnd.PRNGKey(seed, dev), 4)[0]
        scn = random_fleet(k_fleet, cells, n_max=N_MAX,
                           cells_per_edge=CELLS_PER_EDGE)
        t0 = time.perf_counter()
        tables = adapters.solve_oracle(scn)
        seconds = time.perf_counter() - t0
        path = str(OUT / f"chip_smoke_{name}.bundle.msgpack")
        save_bundle(path, PolicyBundle(
            "oracle", "full", N_MAX, adapters.oracle_params(scn, tables),
            meta=meta))
        b = load_bundle(path, expect_spec="full", expect_n_max=N_MAX)
        check(b.kind == "oracle" and np.array_equal(
            b.params["table"].numpy(), tables["actions"]),
            f"{name} bundle reads back")
        return path, scn, tables, seconds

    # (a) the deployment, coupled, background on, through the CLI
    path, scn, tables, solve_s = oracle_bundle("oracle", CELLS, SEED)
    # the reference's per-cell loop, which the memoised solver replaces,
    # on 1,024 cells
    weak_s, weak_e, cons = (x.cpu().numpy() for x in (
        scn.weak_s, scn.weak_e, scn.constraint))
    t0 = time.perf_counter()
    for i in range(1024):
        for n in range(1, N_MAX + 1):
            solve_optimal(Scenario(f"cell{i}", tuple(map(bool, weak_s[i, :n])),
                                   bool(weak_e[i])),
                          round(float(cons[i]), 4), n)
    loop_s = time.perf_counter() - t0
    k_trace, k_serve = rnd.split(rnd.PRNGKey(SEED, dev), 4)[1:3]
    trace, stats = poisson_round_trace(k_trace, scn, REPLAY_ROUNDS,
                                       rate=RATE, with_stats=True)
    n_traced = int(trace.sum())
    coupled = {}
    per_round = 3 * N_MAX  # observe's coupling and group load, transition's
    for name, kw in (("greedy", dict(greedy=True)),
                     ("oracle", dict(bundle=path))):
        rep, launches = replay_counted(serve_fleet, **kw, **REPLAY_KW)
        check(rep["served_requests"] == n_traced
              == sum(r["served_requests"] for r in rep["rounds"])
              and rep["trace_stats"] == stats,
              f"{name}: every traced request served ({n_traced})")
        check(rep["violation_rate"] == 0.0, f"{name}: no violation")
        for r in rep["rounds"]:
            check(r["mean_art_ms"] >= r["opt_art_ms"] - 1e-2,
                  f"{name} round {r['round']}: ART {r['mean_art_ms']} at "
                  f"least the oracle's {r['opt_art_ms']} - 1e-2")
        want = {"group_occupancy": per_round * REPLAY_ROUNDS,
                "queue_admit": 0, "flash_attention": 0, "wkv6": 0, "ssd": 0}
        check(launches == want, f"{name}: launches {launches}, want {want}")
        coupled[name] = dict(_replay_summary(rep), launches=launches,
                             rounds=[dict(round=r["round"],
                                          art=r["mean_art_ms"],
                                          opt=r["opt_art_ms"])
                                     for r in rep["rounds"]])
    # device ops and busy time of one coupled greedy round, after a warm
    # one, as the gateway serves it
    greedy = adapters.heuristic_greedy_policy(spec)
    g_params = greedy.init(SEED, dev)
    cfg_c = FleetConfig(n_max=N_MAX, obs_spec="full", shared_cloud=True,
                        shared_edge=True)
    env, serve_round = make_gateway(greedy, cfg_c)
    scn_0 = scn._replace(n_users=trace[0])
    p_0 = greedy.refresh(g_params, scn_0)
    state = serve_round(p_0, scn_0, env.init(k_serve, scn), k_serve)[0]
    prof, _ = _device_time(torch, lambda: serve_round(p_0, scn_0, state,
                                                      k_serve))
    prof["device_busy_share"] = (prof["device_busy_ms"]
                                 / coupled["greedy"]["ms_per_round"])
    coupled["greedy"]["profile_one_round"] = prof

    # (b) the deployment, quiet and uncoupled
    cfg_q = FleetConfig(n_max=N_MAX, obs_spec="full", quiet=True)
    orep = replay_trace(adapters.oracle_policy(spec),
                        adapters.oracle_params(scn, tables), scn, trace,
                        cfg_q, key=k_serve, oracle=tables, device=dev)
    oracle_gap = max(abs(r["mean_art_ms"] - r["opt_art_ms"])
                     for r in orep["rounds"])
    check(oracle_gap <= 1e-3 and orep["violation_rate"] == 0.0,
          f"quiet uncoupled oracle replay at the optimum ({oracle_gap})")
    g_rep = replay_trace(greedy, g_params, scn, trace, cfg_q, key=k_serve,
                         oracle=tables, device=dev)
    scfg = ServeConfig(n_max=N_MAX, obs_spec="full", quiet=True)
    stream = round_synchronous_stream(trace, scfg.round_ms)
    reset_all_counts()
    req = serve_stream(greedy, g_params, scn, stream, scfg, key=k_serve,
                       device=dev)
    req_launches = all_counts()
    art_err = abs(req["mean_art_ms"] - g_rep["mean_art_ms"])
    vio_err = abs(req["violation_rate"] - g_rep["violation_rate"])
    check(art_err <= 1e-5 and vio_err <= 1e-5,
          f"round-request parity: ART {art_err}, violations {vio_err}")
    check(req["served_requests"] == n_traced
          and req["dropped_requests"] == 0
          and req["deferred_requests"] == 0,
          "round-synchronous stream served whole")
    check(req_launches["queue_admit"] == req["n_ticks"],
          f"queue_admit once a tick ({req_launches['queue_admit']} in "
          f"{req['n_ticks']} ticks)")
    opt_reward = optimal_rewards(scn)
    g_info = make_greedy_evaluator(cfg_q, greedy)(
        greedy.refresh(g_params, scn), scn, rnd.PRNGKey(SEED, dev))
    g_reward = reward_from_round(*(g_info[k].cpu().numpy()
                                   for k in ("art", "acc")),
                                 scn.constraint.cpu().numpy())
    g_gap = (opt_reward - g_reward) / np.abs(opt_reward)
    dqn, net = policy_from_bundle(load_bundle(
        str(OUT / "chip_smoke_dqn.bundle.msgpack")), dev)
    d_eval = evaluate_vs_solver(net, scn, cfg_q, opt_reward=opt_reward)
    check(float(g_gap.min()) >= -1e-6 and float(
        d_eval["reward_gap"].min()) >= -1e-6,
        "the optimum bounds every cell's reward")
    steps = 25
    run = make_throughput_runner(cfg_c, greedy, n_steps=steps)
    g_ref = greedy.refresh(g_params, scn)
    run(g_ref, scn, k_serve)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reward = float(run(g_ref, scn, k_serve))
    throughput_s = time.perf_counter() - t0
    quiet = dict(
        oracle_max_art_gap_ms=oracle_gap,
        greedy=_replay_summary(g_rep),
        parity=dict(art_abs_err=art_err, violation_abs_err=vio_err,
                    request_mean_art_ms=req["mean_art_ms"],
                    n_ticks=req["n_ticks"], launches=req_launches),
        greedy_gap=dict(min=float(g_gap.min()), mean=float(g_gap.mean())),
        dqn_vs_solver=dict(min_gap=float(d_eval["reward_gap"].min()),
                           mean_gap=d_eval["mean_reward_gap"],
                           violation_rate=d_eval["violation_rate"]),
        throughput=dict(steps=steps, coupled=True, mean_reward=reward,
                        seconds=throughput_s,
                        decisions_per_s=CELLS * steps / throughput_s))

    # (c) CPU against the card, small and coupled, background on
    small = dict(cells=64, rounds=4, seed=1, cells_per_edge=CELLS_PER_EDGE,
                 shared_cloud=True, shared_edge=True, round_replay=True,
                 verbose=False)
    s_path = oracle_bundle("oracle_small", 64, 1)[0]
    worst = {}
    for name, kw in (("greedy", dict(greedy=True)),
                     ("oracle", dict(bundle=s_path))):
        cpu = serve_fleet.serve(device="cpu", **kw, **small)["rounds"]
        gpu = serve_fleet.serve(device="cuda", **kw, **small)["rounds"]
        for c, g in zip(cpu, gpu, strict=True):
            check(c["served_requests"] == g["served_requests"]
                  and c["violation_rate"] == g["violation_rate"],
                  f"{name} round {c['round']}: requests and violations "
                  "identical on the CPU and the card")
        errs = {k: max(abs(c[k] - g[k]) for c, g in zip(cpu, gpu))
                for k in ("mean_art_ms", "mean_reward")}
        check(max(errs.values()) <= 1e-5, f"{name}: CPU and card within "
              f"1e-5 ({errs})")
        worst[name] = errs

    out = dict(cells=CELLS, rounds=REPLAY_ROUNDS, rate=RATE,
               clipped_fraction=stats["clipped_fraction"],
               floor_fraction=stats["floor_fraction"],
               traced_requests=n_traced,
               solve_oracle_host_s=solve_s,
               per_cell_loop_host_s_1024_cells=loop_s,
               per_cell_loop_host_s_extrapolated=loop_s * CELLS / 1024,
               coupled=coupled, quiet_uncoupled=quiet, cpu_vs_card=worst)
    emit("round_replay", **out)
    return out


# ------------------------------------------------------------- LM phases
# (name, B, S, H, KV, D, window, dtype): the LM serving shapes
FLASH_SHAPES = (
    ("yi-6b", 4, 2048, 32, 4, 128, 0, "float32"),
    ("yi-6b_bf16", 4, 2048, 32, 4, 128, 0, "bfloat16"),
    ("h2o-danube-3-4b", 1, 8192, 32, 8, 120, 4096, "float32"),
    ("zamba2-1.2b_shared", 4, 2048, 32, 32, 64, 4096, "float32"),
    ("h2o-danube-3-4b_bf16", 1, 8192, 32, 8, 120, 4096, "bfloat16"),
)
# (name, B, S, H, N, dtype): rwkv6-1.6b's prefill, a ragged S, bf16
WKV_SHAPES = (
    ("rwkv6-1.6b", 4, 2048, 32, 64, "float32"),
    ("wkv6_ragged_S2000", 4, 2000, 32, 64, "float32"),
    ("wkv6_bf16", 4, 2048, 32, 64, "bfloat16"),
)
# (name, B, S, H, P, G, N): zamba2-1.2b's Mamba2 scan, a ragged S, G = 2
SSD_SHAPES = (
    ("zamba2-1.2b", 4, 2048, 64, 64, 1, 64),
    ("ragged_S2000", 4, 2000, 64, 64, 1, 64),
    ("groups_2", 4, 2048, 64, 64, 2, 64),
)
SSD_CHUNK = 256  # the config's chunk, which the plain version uses
# bf16 flash: largest |kernel row - plain row| / |plain row| over the
# (query, head) rows, beside the element-wise 3e-2 / 3e-2
BF16_ROW_BAR = 1e-2


def visible_pairs(s: int, window: int) -> int:
    """Causal (query, key) pairs per head, within the window if any."""
    if not window:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def sass_tensor_ops(lib: Path) -> dict | None:
    """Tensor-core instructions (``HMMA...TF32``, ``HGMMA...BF16``) in
    each flash and SSD kernel instance of the built library, from
    ``cuobjdump -sass``; None where the toolkit has no ``cuobjdump``."""
    import re
    import shutil
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            # flash_fwd_kernel_tf32<8>, ssd_kernel<bf16,32,64>, ...
            m = re.search(r"(flash_fwd_kernel_\w+?|ssd_kernel)I"
                          r"(f|13__nv_bfloat16)?((?:Li\d+E)+)E", line)
            args = re.findall(r"Li(\d+)E", m[3]) if m else []
            if m and m[2]:
                args.insert(0, "float" if m[2] == "f" else "bf16")
            fn = f"{m[1]}<{','.join(args)}>" if m else None
            if fn:
                counts[fn] = {"HMMA.TF32": 0, "HGMMA.BF16": 0}
        elif fn and re.search(r"\bHMMA\.\S*TF32", line):
            counts[fn]["HMMA.TF32"] += 1
        elif fn and re.search(r"\bHGMMA\.\S*BF16", line):
            counts[fn]["HGMMA.BF16"] += 1
    return counts


def phase_lm_kernels(torch, dev, ptxas: dict) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    sass = sass_tensor_ops(_build.library_path(
        _build.CSRC / "flash_attention.cu"))
    ssd_sass = sass_tensor_ops(_build.library_path(_build.CSRC / "ssd.cu"))
    for found_in, inst, key in ((sass, "flash_fwd_kernel_tf32", "HMMA.TF32"),
                                (sass, "flash_fwd_kernel_wgmma",
                                 "HGMMA.BF16"),
                                (ssd_sass, "ssd_kernel", "HMMA.TF32")):
        if found_in is None:
            continue
        found = {k: v for k, v in found_in.items() if k.startswith(inst)}
        check(bool(found), f"cuobjdump lists an instance of {inst}")
        for fn, ops in found.items():
            check(ops[key] > 0, f"{fn} runs {key} on the tensor cores")
    for name, b, s, h, kv, d, window, dt in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, s, n, d, generator=g, device=dev)
                   .to(dtype) for n in (h, kv, kv))
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        atol, rtol = (3e-5, 1e-4) if dt == "float32" else (3e-2, 3e-2)
        excess = float(((got.float() - want.float()).abs()
                        - (atol + rtol * want.float().abs())).max())
        check(excess <= 0, f"flash {name} within atol {atol} rtol {rtol} "
              f"of its plain version (max err {err})")
        # bf16 also by rows, sized to its rounding: one bf16 step is at
        # most 2^-7 of a value, so a row off by a step in every element
        # is off by 7.8e-3 of its norm; a row that lost a key tile is off
        # by far more, even where each element stays inside 3e-2
        row_err = float(((got.float() - want.float()).norm(dim=-1)
                         / want.float().norm(dim=-1).clamp_min(1e-30)).max())
        if dt == "bfloat16":
            check(row_err <= BF16_ROW_BAR, f"flash {name} rows within "
                  f"{BF16_ROW_BAR} of the plain rows' norm ({row_err})")
        # the yardstick: one SDPA call on (B, H, S, D) views, the window
        # as an explicit mask built outside the timed call
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                  - window)
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)
        lib_err = float((lib().transpose(1, 2).float()
                         - want.float()).abs().max())
        kern = cuda_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=True, window=window), iters=10)
        plain = cuda_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=True, window=window), iters=3, warmup=1)
        library = cuda_ms(torch, lib, iters=10)
        pairs = b * h * visible_pairs(s, window)
        size = q.element_size()
        n_bytes = size * (2 * b * s * h * d + 2 * b * s * kv * d)
        flops = 4 * d * pairs
        # f32: three TF32 products per product (3xTF32) at the TF32 peak,
        # the FP32 CUDA-core bound of the same function beside
        bound = (roofline(n_bytes, 3 * flops, PEAK_TF32)
                 if dt == "float32" else roofline(n_bytes, flops, PEAK_BF16))
        extra = (dict(fp32_bound_ms=roofline(n_bytes, flops,
                                             PEAK_FP32)["bound_ms"])
                 if dt == "float32" else {})
        inst = ("flash_fwd_kernel_tf32" if dt == "float32"
                else "flash_fwd_kernel_wgmma")
        out[name] = dict(
            name="flash_attention", route="cuda",
            source=SOURCES["flash_attention"],
            replaces=REPLACES["flash_attention"], max_abs_err=err,
            max_row_rel_err=row_err, ms=kern["ms"], plain_ms=plain["ms"],
            library_ms=library["ms"],
            **bound, **extra,
            sass_tensor_ops=None if sass is None else {
                k: v for k, v in sass.items() if inst in k},
            call_ms=kern["call_ms"], plain_call_ms=plain["call_ms"],
            library_call_ms=library["call_ms"], library_max_abs_err=lib_err,
            blocker_held=kern["blocker_held"] and library["blocker_held"],
            shape=dict(B=b, S=s, H=h, KV=kv, D=d, window=window, dtype=dt,
                       visible_pairs=pairs))
    wkv_ptxas = {k: v for k, v in ptxas.items() if "wkv6_kernel" in k}
    for name, b, s, h, n, dt in WKV_SHAPES:
        out[name] = dict(wkv6_entry(torch, dev, b=b, s=s, h=h, n=n, dt=dt),
                         ptxas=wkv_ptxas)
    for name, b, s, h, p, g, n in SSD_SHAPES:
        out[name] = dict(ssd_entry(torch, dev, g_=g, b=b, s=s, h=h, p=p,
                                   n=n), sass_tensor_ops=ssd_sass)
    emit("lm_kernels", **out)
    return out


def wkv6_entry(torch, dev, *, b, s, h, n, dt) -> dict:
    """The WKV6 kernel against its plain version on the same inputs,
    timed.

    The check holds the kernel to the plain version evaluated in float64
    on those inputs, o and the state within 5e-4 (bf16 r, k, v: the bf16
    o within atol 5e-2 rtol 5e-2, the GPU test's bar, the float32 state
    within 5e-4): at S 2000-2048 the float32 plain version's own rounding
    (the chunked form's exponent differences) comes near the bar, so its
    distance to the kernel is recorded beside, with both versions'
    distance to the float64 one."""
    from repro_torch.kernels import wkv6 as wk
    gen = torch.Generator(device=dev).manual_seed(SEED)
    r, k, v = (torch.randn(b, s, h, n, generator=gen, device=dev)
               .to(getattr(torch, dt)) for _ in range(3))
    lw = -torch.exp(torch.randn(b, s, h, n, generator=gen, device=dev))
    u = 0.5 * torch.randn(h, n, generator=gen, device=dev)
    o, st = wk.wkv6(r, k, v, lw, u)
    po, ps = wk.wkv6_plain(r.float(), k.float(), v.float(), lw, u)
    wo, ws = wk.wkv6_plain(*(t.double() for t in (r, k, v, lw, u)))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o).all() and torch.isfinite(st).all()),
          "wkv6 output finite")
    o_err = float((o.double() - wo).abs().max())
    s_err = float((st.double() - ws).abs().max())
    atol, rtol = (5e-4, 0.0) if dt == "float32" else (5e-2, 5e-2)
    excess = float(((o.double() - wo).abs() - (atol + rtol * wo.abs()))
                   .max())
    check(excess <= 0 and s_err <= 5e-4, f"wkv6 (S {s}, {dt}) o within "
          f"atol {atol} rtol {rtol} (max err {o_err}) and state within "
          f"5e-4 ({s_err}) of its plain version in float64")
    f32_err = max(float((o.float() - po).abs().max()),
                  float((st - ps).abs().max()))
    plain_err = max(float((po.double() - wo).abs().max()),
                    float((ps.double() - ws).abs().max()))
    del po, ps, wo, ws
    kern = cuda_ms(torch, lambda: wk.wkv6(r, k, v, lw, u), iters=10)
    plain = cuda_ms(torch, lambda: wk.wkv6_plain(r, k, v, lw, u), iters=3,
                    warmup=1)
    size = r.element_size()
    x = b * s * h * n  # elements of one (B, S, H, N) operand
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    steps = wk.chunk_len(b * h, s, n_sms)
    chunks = -(-s // steps)
    # the design's bytes: k, v, lw read by both chunk passes, r read and o
    # written by the second; the chunk states written by the first pass,
    # read and written by the scan, read by the second pass; the decay
    # products written and read once; the final state written once
    design_bytes = (x * (2 * (2 * size + 4) + 2 * size)
                    + 4 * 4 * b * h * chunks * n * n
                    + 2 * 4 * b * h * chunks * n + 4 * b * h * n * n)
    # r, k, v, lw read and o written per step; u read and the state
    # written once; ~5 N^2 flops per (batch, head, step)
    return dict(
        name="wkv6", route="cuda", source=SOURCES["wkv6"],
        replaces=REPLACES["wkv6"], max_abs_err=max(o_err, s_err),
        state_max_abs_err=s_err, f32_plain_max_abs_err=f32_err,
        plain_f32_vs_f64_max_abs_err=plain_err, ms=kern["ms"],
        plain_ms=plain["ms"],
        library_ms=None,
        **roofline(x * (4 * size + 4) + 4 * (h * n + b * h * n * n),
                   5 * b * s * h * n * n, PEAK_FP32),
        design_bytes=design_bytes, design_floor_ms=bound_ms(design_bytes),
        steps_per_cta=steps, ctas_per_pass=b * h * chunks,
        call_ms=kern["call_ms"], plain_call_ms=plain["call_ms"],
        blocker_held=kern["blocker_held"],
        shape=dict(B=b, S=s, H=h, N=n, dtype=dt))


def ssd_chunked_flops(b: int, s: int, h: int, p: int, n: int) -> int:
    """Flops of the chunked form's four products per 64-step chunk (the
    last one padded), with the score tiles above the diagonal skipped as
    the kernel skips them (20 of 32 16 x 8 tiles): C B^T and scores x
    over the kept tiles, C S^T and the state update in full; C B^T once
    per (batch, head, chunk), however many CTAs split P."""
    q, kept = 64, 20 / 32
    per_chunk = 2 * q * q * (n + p) * kept + 2 * 2 * q * p * n
    return int(b * h * -(-s // q) * per_chunk)


def ssd_entry(torch, dev, *, g_, b, s, h, p, n) -> dict:
    """The SSD kernel against its plain version on the same inputs, timed.

    The check holds the kernel to the plain version evaluated in float64
    on those inputs (atol 3e-4, rtol 1e-3, the reference test's bar): at
    S = 2048 the float32 plain version's own summation error is of the
    same order as the bar, so its distance to the kernel is recorded
    beside, with both versions' distance to the float64 one."""
    from repro_torch.kernels import ssd as sk
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    x, bm, cm = rn(b, s, h, p), rn(b, s, g_, n), rn(b, s, g_, n)
    dt = torch.nn.functional.softplus(rn(b, s, h))
    a = -torch.exp(rn(h))
    d = torch.linspace(0.5, 1.5, h, device=dev)
    args = (x, dt, a, bm, cm, d)
    y, st = sk.ssd(*args, chunk=SSD_CHUNK)
    py, ps = sk.ssd_plain(*args, chunk=SSD_CHUNK)
    wy, ws = sk.ssd_plain(*(t.double() for t in args), chunk=SSD_CHUNK)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
          "ssd output finite")
    excess = max(float(((got.double() - want).abs()
                        - (3e-4 + 1e-3 * want.abs())).max())
                 for got, want in ((y, wy), (st, ws)))
    err = max(float((y.double() - wy).abs().max()),
              float((st.double() - ws).abs().max()))
    check(excess <= 0, f"ssd (S {s}, G {g_}) within atol 3e-4 rtol 1e-3 "
          f"of its plain version (max err {err})")
    plain_err = max(float((py.double() - wy).abs().max()),
                    float((ps.double() - ws).abs().max()))
    f32_err = max(float((y - py).abs().max()), float((st - ps).abs().max()))
    del py, ps, wy, ws
    kern = cuda_ms(torch, lambda: sk.ssd(*args, chunk=SSD_CHUNK), iters=10)
    plain = cuda_ms(torch, lambda: sk.ssd_plain(*args, chunk=SSD_CHUNK),
                    iters=3, warmup=1)
    # x, dt, B, C, a, d read once, y and the final state written once
    n_bytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * g_ * n
                   + 2 * h + b * h * p * n)
    return dict(
        name="ssd", route="cuda", source=SOURCES["ssd"],
        replaces=REPLACES["ssd"], max_abs_err=err, ms=kern["ms"],
        plain_ms=plain["ms"], library_ms=None,
        # three TF32 products per product of the chunked form at the TF32
        # peak; beside it the FP32 CUDA-core bound of the exact
        # recurrence's 4 P N flops per (batch, step, head)
        **roofline(n_bytes, 3 * ssd_chunked_flops(b, s, h, p, n),
                   PEAK_TF32),
        fp32_bound_ms=roofline(n_bytes, 4 * b * s * h * p * n,
                               PEAK_FP32)["bound_ms"],
        chunked_flops=ssd_chunked_flops(b, s, h, p, n),
        f32_plain_max_abs_err=f32_err, plain_f32_vs_f64_max_abs_err=plain_err,
        call_ms=kern["call_ms"], plain_call_ms=plain["call_ms"],
        blocker_held=kern["blocker_held"],
        shape=dict(B=b, S=s, H=h, P=p, G=g_, N=n, dtype="float32",
                   plain_chunk=SSD_CHUNK))


def _device_time(torch, fn, matches=(), before=None) -> tuple[dict, object]:
    """Run ``fn`` under ``torch.profiler`` (``before`` untraced ahead of
    each attempt); device ops, busy ms, the five kernels with the most
    device time and, for each name in ``matches``, the time of the
    kernels whose name holds it."""
    _, events, result = traced(torch, fn, before=before)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(device_ops=len(events),
                device_busy_ms=sum(by_name.values()) / 1e3,
                match_ms={m: sum(us for n, us in by_name.items()
                                 if m in n) / 1e3 for m in matches},
                top_kernels_ms={n[:80]: us / 1e3 for n, us in top}), result


def profile_lm(torch, run, rep: dict, steps: int = 2) -> dict:
    """Device time of one more prefill and ``steps`` decode steps of the
    run's model and prompt, against the unprofiled run's wall times."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import make_serve_step
    cfg, params, tokens = run.cfg, run.params, run.prompt["tokens"]
    step = make_serve_step(cfg)
    kernels = [k for k, n in expected_launches(cfg).items() if n]
    with torch.inference_mode():
        pre, (logits, cache) = _device_time(torch, lambda: tf.prefill(
            params, cfg, tokens, max_len=LM_PROMPT + steps + 1),
            [DEVICE_NAMES[k] for k in kernels])
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
        pos0 = cache["pos"]

        def decode():  # from the prefill's position, so a retrace fits
            cache["pos"], tok = pos0, tok0
            for _ in range(steps):
                tok, _, _ = step(params, tok, cache)

        dec, _ = _device_time(torch, decode)
    del cache, logits
    return dict(
        prefill=dict(pre, wall_ms_unprofiled=rep["prefill_ms"],
                     busy_share=pre["device_busy_ms"] / rep["prefill_ms"]),
        kernel_share_of_prefill_busy={
            k: pre["match_ms"][DEVICE_NAMES[k]] / pre["device_busy_ms"]
            for k in kernels},
        decode_per_token=dict(
            device_ops=dec["device_ops"] / steps,
            device_busy_ms=dec["device_busy_ms"] / steps,
            top_kernels_ms={n: ms / steps
                            for n, ms in dec["top_kernels_ms"].items()},
            wall_ms_unprofiled=rep["decode_ms_per_token"],
            busy_share=dec["device_busy_ms"] / steps
            / rep["decode_ms_per_token"]))


def expected_launches(cfg) -> dict:
    """LM kernel launches of one prefill of ``cfg``: flash per attn block
    and per application of the shared block, WKV6 per rwkv6 block, SSD
    per mamba2 block."""
    from repro_torch.models import transformer as tf
    kinds = cfg.block_kinds()
    return {"flash_attention": kinds.count("attn")
            + tf.n_shared_applications(cfg),
            "wkv6": kinds.count("rwkv6"), "ssd": kinds.count("mamba2")}


def phase_lm_serve(torch) -> dict:
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    out = {}
    for arch in ("yi-6b", "rwkv6-1.6b", "zamba2-1.2b"):
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        run = serve.serve(arch, batch=LM_BATCH, prompt_len=LM_PROMPT,
                          gen=LM_GEN, device="cuda", verbose=False)
        counts = all_counts()
        expect = expected_launches(run.cfg)
        for kernel, n in expect.items():
            check(counts[kernel] == n, f"{arch}: {kernel} launched {n} "
                  f"times in the prefill (counted {counts[kernel]})")
        launches = {k: counts[k] for k, n in expect.items() if n}
        # the serving invariant: teacher-forced logits over prompt +
        # generated tokens match the prefill and decode logits
        res = run.result
        seq = torch.cat([run.prompt["tokens"], res.tokens[:, :-1]], dim=1)
        with torch.inference_mode():
            full, _ = tf.forward(run.params, run.cfg, seq)
        ref = full[:, LM_PROMPT - 1:]
        check(ref.shape == res.logits.shape, "logit shapes agree")
        fwd_err = float((ref - res.logits).abs().max())
        # the first token's logits come from the prefill, the rest from
        # decode steps: where the two paths part, and on what scale
        prefill_err = float((ref[:, 0] - res.logits[:, 0]).abs().max())
        check(bool(torch.isfinite(res.logits).all()), f"{arch} finite")
        check(fwd_err <= 1e-3, f"{arch}: forward matches prefill + decode "
              f"logits within 1e-3 ({fwd_err})")
        rep = run.report
        prof = profile_lm(torch, run, rep)
        out[arch] = dict(
            params=rep["params"], batch=LM_BATCH, prompt=LM_PROMPT,
            gen=LM_GEN, prefill_ms=rep["prefill_ms"],
            decode_ms_per_token=rep["decode_ms_per_token"],
            tokens_per_s=rep["tokens_per_s"],
            decode_tokens_per_s=rep["decode_tokens_per_s"],
            launches=launches, launches_per_prefill=launches,
            forward_max_abs_err=fwd_err,
            forward_max_abs_err_prefill_token=prefill_err,
            max_abs_logit=float(res.logits.abs().max()),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            profile=prof, sample=rep["tokens"][0][:8])
        del run, res, full, ref, seq
        torch.cuda.empty_cache()
    emit("lm_serve", **out)
    return out


def phase_lm_parity(torch) -> None:
    import copy
    from repro_torch import random as rnd
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import make_batch
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import generate
    out = {}
    for arch in ("yi-6b", "h2o-danube-3-4b", "rwkv6-1.6b", "zamba2-1.2b"):
        cfg = get_smoke_config(arch)
        cpu_params = tf.init_params(cfg, seed=SEED, device="cpu")
        gpu_params = copy.deepcopy(cpu_params).to("cuda")
        # 40 tokens: past the danube and zamba2 smoke windows (32), so
        # the rings wrap
        prompt = make_batch(cfg, rnd.PRNGKey(SEED, "cpu"), 2, 40,
                            with_labels=False)
        cpu = generate(cpu_params, cfg, prompt, steps=8)
        gpu = generate(gpu_params, cfg,
                       {"tokens": prompt["tokens"].to("cuda")}, steps=8)
        err = float((cpu.logits - gpu.logits.cpu()).abs().max())
        check(err <= 1e-4, f"{arch}: CPU and card logits within 1e-4 "
              f"({err})")
        check(torch.equal(cpu.tokens, gpu.tokens.cpu()),
              f"{arch}: greedy tokens identical on CPU and card")
        out[arch] = dict(max_abs_logit_err=err,
                         tokens=gpu.tokens[0].tolist())
    emit("lm_parity", **out)


# ------------------------------------------------------- training phase
# the trainer's deployment run: the serving deployment trained as the
# reference CLI trains it, cut to a few epochs (one curriculum stage each)
TRAIN_EPOCHS = 4
TRAIN_ARGS = ["--algo", "HL", "--fleet", "--cells", str(CELLS), "--n-max",
              str(N_MAX), "--obs-spec", "full", "--shared-cloud",
              "--shared-edge", "--cells-per-edge", str(CELLS_PER_EDGE),
              "--epochs", str(TRAIN_EPOCHS), "--chunk", "1", "--seed",
              str(SEED)]
SYNC_FREE_CELLS = 4096
# CPU vs card: cells, and a schedule small enough for the CPU
SMALL_TRAIN_CELLS = 64
SMALL_TRAIN_HP = dict(epochs=2, n_direct=3, t_direct=6, n_world=6,
                      n_suggest=2, t_suggest=3, n_plan=6, k_best=3,
                      batch=16, direct_cap=2048, world_cap=2048,
                      plan_cap=512)  # D_direct holds its 1,536 rows unwrapped
# the CPU tests' bars (tests/test_torch_trainer.py): buffers and metrics
# 1e-5, parameters and moments 2e-6; a differing argmax only at a near-tie
BUFFER_BAR, PARAM_BAR, NEAR_TIE = 1e-5, 2e-6, 1e-4


def train_launches(hp, n_stages: int, epochs: int) -> dict:
    """group_occupancy launches in ``run_curriculum`` under shared_edge
    and the full spec: 2 per observe (the coupling and the group load) at
    init and at each stage swap, 3 per env step (transition's coupling
    and the next observe's two), one env step per direct step and
    k_best + 1 per planning step."""
    from repro_torch.hltrain.trainer import session_schedule
    sched = session_schedule(hp)
    direct = int(sched["direct"][:epochs].sum()) * hp.t_direct
    planning = int(sched["suggest"][:epochs].sum()) * hp.t_suggest
    return dict(direct_steps_per_cell=direct, planning_steps=planning,
                group_occupancy=2 * n_stages + 3 * direct
                + 3 * (hp.k_best + 1) * planning)


def step_profiles(torch, cfg, scn, key) -> dict:
    """Device ops and busy ms of one direct step and one planning step
    at the deployment: one-epoch runs of a schedule of one session of
    each kind, traced, with one more direct (planning) step taken apart
    by difference."""
    import dataclasses
    from repro_torch.hltrain.trainer import make_hl_trainer
    from repro_torch.launch.rl_train import fleet_params
    base = dataclasses.replace(fleet_params(CELLS, 1, SEED), n_direct=1,
                               n_world=1, n_suggest=1, n_plan=1,
                               t_direct=1, t_suggest=1)
    out = {}
    for name, kw in (("base", {}), ("direct", dict(t_direct=2)),
                     ("planning", dict(t_suggest=2))):
        trainer = make_hl_trainer(cfg, dataclasses.replace(base, **kw))
        trainer.run(trainer.init(key, scn), scn, 0, 1)  # warm
        carry = {}

        def fresh():  # run consumes its carry: a new one for every trace
            carry["state"] = trainer.init(key, scn)
        prof, _ = _device_time(
            torch, lambda: trainer.run(carry["state"], scn, 0, 1),
            before=fresh)
        out[name] = prof
    return {name: dict(device_ops=out[name]["device_ops"]
                       - out["base"]["device_ops"],
                       device_busy_ms=out[name]["device_busy_ms"]
                       - out["base"]["device_busy_ms"])
            for name in ("direct", "planning")}


def _carry_arrays(state) -> dict:
    from repro_torch.convert import hl_train_state_arrays

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}.{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, tree
    return dict(leaves(hl_train_state_arrays(state)))


def recording_make_dqn(record: list):
    """A ``make_dqn`` for ``make_hl_trainer`` whose ``q_values`` also keeps,
    in order, the Q-values of every direct step's greedy choice (a (C, D)
    observation; planning passes (C, A, D) model states) on the host:
    each step's Q under the weights that chose its actions."""
    from repro_torch.core.dqn import make_dqn

    def make(*args, **kw):
        init, q_values, update, sync = make_dqn(*args, **kw)

        def q(params, s):
            out = q_values(params, s)
            if s.dim() == 2:
                record.append(out.cpu().numpy().copy())
            return out
        return init, q, update, sync
    return make


def train_cpu_vs_card(torch) -> dict:
    """The same key and fleet on the CPU and on the card, epoch by epoch:
    integers identical, floats within the CPU tests' bars; where a direct
    action first differs (in time order: D_direct does not wrap), the
    CPU's gap between its top two Q-values at that step, under the
    weights that chose the action, must be a near-tie."""
    import numpy as np
    from repro_torch import random as rnd
    from repro_torch.fleet.env import FleetConfig
    from repro_torch.fleet.workload import random_fleet
    from repro_torch.hltrain import trainer as trainer_mod
    from repro_torch.hltrain.trainer import FleetHLParams, make_hl_trainer
    cfg = FleetConfig(n_max=N_MAX, obs_spec="full", shared_cloud=True,
                      shared_edge=True)
    hp = FleetHLParams(**SMALL_TRAIN_HP)
    q_cpu: list = []  # (C, A) Q-values of each CPU direct step, in order
    make_dqn = trainer_mod.make_dqn
    trainer_mod.make_dqn = recording_make_dqn(q_cpu)
    try:
        trainers = {"cpu": make_hl_trainer(cfg, hp)}
    finally:
        trainer_mod.make_dqn = make_dqn
    trainers["cuda"] = make_hl_trainer(cfg, hp)
    states, worst = {}, {"buffers": 0.0, "params": 0.0}
    for dev in ("cpu", "cuda"):
        k_fleet, k_init = rnd.split(rnd.PRNGKey(SEED + 7, dev), 2)
        scn = random_fleet(k_fleet, SMALL_TRAIN_CELLS, n_max=N_MAX,
                           cells_per_edge=CELLS_PER_EDGE)
        states[dev] = (scn, trainers[dev].init(k_init, scn))
    tie = None
    for e in range(hp.epochs):
        arrays = {}
        for dev, (scn, st) in states.items():
            st, _ = trainers[dev].run(st, scn, e, 1)
            states[dev] = (scn, st)
            arrays[dev] = _carry_arrays(st)
        cpu, gpu = arrays["cpu"], arrays["cuda"]
        rows = len(q_cpu) * SMALL_TRAIN_CELLS
        check(rows == int(states["cpu"][1].d_direct.ring.size)
              and rows <= hp.direct_cap,
              f"D_direct holds its {rows} rows in time order (no wrap)")
        a_c, a_g = cpu[".d_direct.ring.a"], gpu[".d_direct.ring.a"]
        if not np.array_equal(a_c, a_g):
            slot = int(np.flatnonzero(a_c != a_g)[0])
            step, cell = divmod(slot, SMALL_TRAIN_CELLS)
            q = np.sort(q_cpu[step][cell])
            gap = float(q[-1] - q[-2])
            tie = dict(epoch=e, step=step, cell=cell, q_gap=gap)
            print(json.dumps({"hltrain_cpu_vs_card_first_difference": tie}),
                  flush=True)
            check(gap < NEAR_TIE, f"CPU and card actions differ at a Q gap "
                  f"of {gap} (near-tie bar {NEAR_TIE})")
            break  # past a near-tie the two runs train apart
        for path, c in cpu.items():
            g = gpu[path]
            if c.dtype.kind == "f":
                kind = "params" if path.startswith((".dqn", ".sm")) \
                    else "buffers"
                err = float(np.abs(c.astype(np.float64) - g).max()) \
                    if c.size else 0.0
                worst[kind] = max(worst[kind], err)
            else:
                check(np.array_equal(c, g), f"epoch {e}: {path} identical on "
                      f"the CPU and the card")
    check(tie is not None or (worst["buffers"] <= BUFFER_BAR
                              and worst["params"] <= PARAM_BAR),
          f"CPU and card floats within {BUFFER_BAR} / {PARAM_BAR}: {worst}")
    return dict(cells=SMALL_TRAIN_CELLS, epochs=hp.epochs,
                max_abs_err=worst, first_difference=tie,
                verify_steps=int(states["cpu"][1].verify_steps))


def phase_hltrain(torch) -> dict:
    import numpy as np
    from repro_torch import random as rnd
    from repro_torch.fleet.workload import poisson_round_trace, random_fleet
    from repro_torch.hltrain.metrics import real_step_budget
    from repro_torch.hltrain.trainer import make_hl_trainer
    from repro_torch.launch import rl_train, serve_fleet
    from repro_torch.launch.rl_train import fleet_params
    from repro_torch.policy.bundle import load_bundle, policy_from_bundle

    dev = torch.device("cuda")
    # (a) the deployment trained through the CLI, launches counted around
    # run_curriculum (zeroed just before it, read just after)
    path = OUT / "hl_fleet.bundle.msgpack"
    curriculum_counts: dict = {}
    run_curriculum = rl_train.run_curriculum

    def counted(*args, **kw):
        reset_all_counts()
        state = run_curriculum(*args, **kw)
        curriculum_counts.update(all_counts())
        return state

    rl_train.run_curriculum = counted
    try:
        reset_all_counts()
        rep = rl_train.main(TRAIN_ARGS + ["--ckpt", str(path)])
        cli_counts = all_counts()
    finally:
        rl_train.run_curriculum = run_curriculum
    hp, state = rep["hp"], rep["state"]
    n_stages = len(rep["stages"])
    budget = real_step_budget(hp, CELLS, TRAIN_EPOCHS)
    direct, verify = int(state.direct_steps), int(state.verify_steps)
    check(direct == budget["direct_steps"],
          f"direct_steps {direct} == the budget {budget['direct_steps']}")
    check(0 < verify <= budget["verify_steps_max"],
          f"0 < verify_steps {verify} <= {budget['verify_steps_max']}")
    want = train_launches(hp, n_stages, TRAIN_EPOCHS)
    check(curriculum_counts == {"queue_admit": 0,
                                "group_occupancy": want["group_occupancy"],
                                "flash_attention": 0, "wkv6": 0, "ssd": 0},
          f"launches around run_curriculum {curriculum_counts}, want "
          f"group_occupancy {want['group_occupancy']} and nothing else")
    # the two evaluations: one quiet round each, 3 sums a decision step
    check(cli_counts["group_occupancy"]
          == want["group_occupancy"] + 2 * 3 * N_MAX,
          f"launches in the whole CLI run {cli_counts}")
    for c in rep["chunks"]:
        m = c["metrics"]
        for k in ("q_loss", "sm_loss", "plan_loss"):
            # at 65,536 cells every buffer holds a batch from its first
            # session on
            check(all(np.isfinite(m[k])), f"stage {c['stage']}: {k} finite "
                  f"({m[k]})")
    nets = (state.dqn.params, state.dqn.target_params, state.sm.params)
    check(all(bool(torch.isfinite(p).all()) for net in nets
              for p in net.parameters()), "every final parameter finite")
    gaps = {}
    for name in ("final", "held_out"):
        ev = rep[name]
        check(float(ev["reward_gap"].min()) >= -1e-6,
              f"{name}: every cell's reward at most the optimum's")
        gaps[name] = dict(mean_reward_gap=ev["mean_reward_gap"],
                          min_reward_gap=float(ev["reward_gap"].min()),
                          violation_rate=ev["violation_rate"],
                          mean_policy_reward=ev["mean_policy_reward"],
                          mean_opt_reward=ev["mean_opt_reward"])
    k_fleet, k_init = rnd.split(rnd.PRNGKey(SEED, dev), 3)[:2]
    profiles = step_profiles(torch, rep["cfg"], rep["stages"][-1], k_init)

    # (b) the bundle it wrote serves: loaded, then 2 rounds of the
    # deployment's trace replayed on the card
    pol, net = policy_from_bundle(load_bundle(str(path), expect_spec="full",
                                              expect_n_max=N_MAX), dev)
    check(pol.kind == "dqn" and net.sizes[0] == rep["cfg"].state_dim,
          "the trained bundle loads")
    rounds = 2
    rep_b, launches_b = replay_counted(
        serve_fleet, **dict(REPLAY_KW, rounds=rounds, bundle=str(path)))
    scn = random_fleet(rnd.split(rnd.PRNGKey(SEED, dev), 4)[0], CELLS,
                       n_max=N_MAX, cells_per_edge=CELLS_PER_EDGE)
    trace = poisson_round_trace(rnd.split(rnd.PRNGKey(SEED, dev), 4)[1],
                                scn, rounds, rate=RATE)
    check(rep_b["served_requests"] == int(trace.sum()),
          f"every traced request served ({rep_b['served_requests']})")
    check(launches_b["group_occupancy"] == 3 * N_MAX * rounds
          and launches_b["queue_admit"] == 0,
          f"3 group sums a decision step in the replay: {launches_b}")

    # (c) one epoch makes no host sync
    cfg = rep["cfg"]
    trainer = make_hl_trainer(cfg, fleet_params(SYNC_FREE_CELLS, 4, SEED))
    small = random_fleet(k_fleet, SYNC_FREE_CELLS, n_max=N_MAX,
                         cells_per_edge=CELLS_PER_EDGE)
    st = trainer.init(k_init, small)
    st, _ = trainer.run(st, small, 0, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, m = trainer.run(st, small, 1, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(m["q_loss"]).all()),
          "the sync-free epoch trained")

    # (d) CPU against the card
    cpu_vs_card = train_cpu_vs_card(torch)

    epoch_s = [c["seconds"] / c["epochs"] for c in rep["chunks"]]
    out = dict(cells=CELLS, epochs=TRAIN_EPOCHS, stages=n_stages,
               direct_steps=direct, verify_steps=verify, budget=budget,
               expected=want, launches_run_curriculum=curriculum_counts,
               launches_cli=cli_counts,
               host_s_per_epoch=epoch_s, train_host_s=rep["train_seconds"],
               real_steps_per_s=rep["real_steps"] / rep["train_seconds"],
               solver_host_s=rep["solver_seconds"], vs_solver=gaps,
               metrics=[c["metrics"] for c in rep["chunks"]],
               step_profiles=profiles,
               bundle_replay=dict(rounds=rounds,
                                  served=rep_b["served_requests"],
                                  mean_art_ms=rep_b["mean_art_ms"],
                                  violation_rate=rep_b["violation_rate"],
                                  launches=launches_b),
               sync_free_epoch=dict(cells=SYNC_FREE_CELLS, syncs=0),
               cpu_vs_card=cpu_vs_card)
    emit("hltrain", **out)
    return out


# ------------------------------------------------------- economy phase
ECONOMY_PROFILE = "spot"
# the billing totals of report["economy"], integers on both devices
BILLING = ("spend_uusd_total", "energy_j_total", "cold_starts",
           "preemptions")


def cli_args(**kw) -> list:
    """``serve_fleet`` command-line arguments for keyword settings."""
    args = []
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        if v is True:
            args.append(flag)
        elif v not in (False, None):
            args += [flag, str(v)]
    return args


def cli_main(serve_fleet, argv: list) -> tuple[dict, str]:
    """``serve_fleet.main(argv)``, its standard output kept out of this
    run's: the report and the JSON line the CLI printed last."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = serve_fleet.main(argv)
    return rep, buf.getvalue().splitlines()[-1]


def phase_economy(torch) -> dict:
    import numpy as np
    from repro_torch.economy import builtin_profile, cost_greedy_policy
    from repro_torch.kernels import orchestration as orch
    from repro_torch.launch import serve_fleet
    from repro_torch.policy.bundle import (PolicyBundle, load_bundle,
                                           save_bundle)
    from repro_torch.specs.observation import make_spec

    # (a) the deployment under spot, through the CLI, with a cost_greedy
    # bundle written and read back
    path = OUT / "chip_smoke_cost_greedy.bundle.msgpack"
    profile = builtin_profile(ECONOMY_PROFILE)
    pol = cost_greedy_policy(make_spec("full_economy", N_MAX), profile)
    save_bundle(str(path), PolicyBundle(
        "cost_greedy", "full_economy", N_MAX, pol.init(SEED, "cpu"),
        meta={"economy_profile": ECONOMY_PROFILE, "shared_cloud": True,
              "shared_edge": True, "cells_per_edge": CELLS_PER_EDGE}))
    check(load_bundle(str(path), expect_spec="full_economy").kind
          == "cost_greedy", "the cost_greedy bundle reads back")
    argv = (["--bundle", str(path), "--economy", ECONOMY_PROFILE]
            + cli_args(**{k: v for k, v in SERVE_KW.items()
                          if k not in ("shared_cloud", "shared_edge")}))
    reset_all_counts()
    rep, _ = cli_main(serve_fleet, argv)
    launches = all_counts()
    n_ticks = rep["n_ticks"]
    check(launches == {"queue_admit": n_ticks,
                       "group_occupancy": 3 * n_ticks,
                       "flash_attention": 0, "wkv6": 0, "ssd": 0},
          f"spot run: queue_admit once and group_occupancy 3 times a tick "
          f"({launches} in {n_ticks} ticks)")
    eco = rep["economy"]
    check(eco["profile"] == ECONOMY_PROFILE, "the spot profile served")
    for k in ("spend_uusd_total", "cold_starts", "preemptions"):
        check(isinstance(eco[k], int) and eco[k] >= 0,
              f"{k} a non-negative integer ({eco[k]!r})")
    energy_mj = eco["energy_j_total"] * 1e3
    check(energy_mj >= 0 and energy_mj == round(energy_mj),
          f"energy a non-negative integer of mJ ({eco['energy_j_total']})")
    check(eco["preemptions"] > 0,
          f"spot preempts at 2e-3 a tick over {CELLS} cells "
          f"({eco['preemptions']} preemptions)")
    check(rep["served_requests"] > 0, "the spot run served")

    # one tick's device ops and busy time: a short profiled run
    short_argv = (argv[:4] + cli_args(**dict(
        {k: v for k, v in SERVE_KW.items()
         if k not in ("shared_cloud", "shared_edge")},
        rounds=1, epochs=1)))
    _, dev_events, (short, _) = traced(
        torch, lambda: cli_main(serve_fleet, short_argv),
        before=reset_all_counts)
    first = min((e.time_range.start for e in dev_events
                 if "queue_admit_kernel" in e.name), default=None)
    check(first is not None, "profiler saw the admission kernel")
    dev_events = [e for e in dev_events if e.time_range.start >= first]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    prof_ticks = short["n_ticks"]
    spot = dict(
        _summary(rep), economy=eco, launches=launches,
        launches_per_tick={k: v / n_ticks for k, v in launches.items()},
        ms_per_tick_no_economy=results["serve"]["greedy"]["ms_per_tick"],
        profile=dict(ticks=prof_ticks, device_events=len(dev_events),
                     device_events_per_tick=len(dev_events) / prof_ticks,
                     device_busy_ms_per_tick=busy_ms / prof_ticks,
                     device_busy_share=(busy_ms / prof_ticks
                                        / rep["ms_per_tick"])))

    # (b) local against no economy: greedy, quiet, on the card
    kw = dict(SERVE_KW, greedy=True, quiet=True, device="cuda",
              verbose=False)
    off = serve_fleet.serve(**kw)
    loc = serve_fleet.serve(economy="local", **kw)
    check("economy" not in off, "no economy, no economy report")
    for k, v in off["records"].items():
        check(np.array_equal(v, loc["records"][k]),
              f"local records[{k}] byte-identical to no economy")
    check(loc["economy"]["spend_uusd_total"] == 0, "local spends nothing")
    check(loc["economy"]["energy_j_total"] > 0, "local meters energy")
    local = dict(served=loc["served_requests"],
                 energy_j_total=loc["economy"]["energy_j_total"],
                 ms_per_tick=loc["ms_per_tick"],
                 ms_per_tick_no_economy=off["ms_per_tick"])

    # (c) CPU against the card: 64 cells, spot, cost_greedy, background on
    small = dict(bundle=str(path), economy=ECONOMY_PROFILE, cells=64,
                 rounds=4, seed=1, epochs=2, verbose=False)
    cpu = serve_fleet.serve(device="cpu", **small)
    gpu = serve_fleet.serve(device="cuda", **small)
    for k in ("dropped", "served", "violated", "action"):
        check(np.array_equal(cpu["records"][k], gpu["records"][k]),
              f"spot {k} identical on the CPU and the card")
    errs = {k: float(np.abs(cpu["records"][k] - gpu["records"][k]).max())
            for k in ("wait_ms", "service_ms", "art_ms")}
    check(max(errs.values()) <= 1e-5, f"spot floats within 1e-5: {errs}")
    for k in BILLING:
        check(cpu["economy"][k] == gpu["economy"][k],
              f"spot {k} identical on the CPU and the card "
              f"({cpu['economy'][k]} vs {gpu['economy'][k]})")
    cpu_vs_card = dict(errs, economy=gpu["economy"],
                       n_served=int(gpu["records"]["served"].sum()))

    # (d) the CLI's four options on the card
    out_path = OUT / "chip_smoke_cli_options.json"
    opt, printed = cli_main(serve_fleet, [
        "--greedy", "--quiet", "--tick-ms", "40", "--queue-cap", "16",
        "--out", str(out_path)] + cli_args(
            cells=4096, rounds=4, seed=SEED, cells_per_edge=CELLS_PER_EDGE,
            shared_cloud=True, shared_edge=True))
    check(out_path.read_text() == printed == json.dumps(
        {k: v for k, v in opt.items() if k != "records"}),
          "--out holds the returned report")
    check({k: opt["config"][k] for k in ("quiet", "tick_ms", "queue_cap")}
          == {"quiet": True, "tick_ms": 40.0, "queue_cap": 16},
          f"the config records the options ({opt['config']})")
    reset_all_counts()
    code = None
    try:
        cli_main(serve_fleet, ["--greedy", "--out",
                               str(OUT / "missing" / "serve.json")])
    except SystemExit as e:
        code = e.code
    check(code not in (None, 0), f"an unwritable --out exits non-zero "
          f"({code!r})")
    check(not any(all_counts().values()),
          "an unwritable --out exits before any kernel launch")
    cli = dict(served=opt["served_requests"],
               dropped=opt["dropped_requests"], tick_ms=opt["tick_ms"],
               unwritable_out_exit=str(code))

    out = dict(spot=spot, local_vs_off=local, cpu_vs_card=cpu_vs_card,
               cli_options=cli)
    emit("economy", **out)
    return out

# ----------------------------------------------------- telemetry phase
TEL_WINDOW_MS, TEL_TRACE_SAMPLE = 250.0, 0.05
# the sync count's run: 5 epochs of 5 ticks, the window counted is
# epoch 1's
SYNC_EPOCHS = 4


def telemetry_parity(got: dict, want: dict, what: str) -> dict:
    """Two ``telemetry_report``s: counters, histogram and edges
    identical; gauges within 1e-5 with the same unwritten windows.
    Returns the largest gauge difference."""
    import numpy as np
    check(got.keys() == want.keys() and got["series"].keys()
          == want["series"].keys(), f"{what}: the same telemetry fields")
    for k in ("window_ms", "n_windows", "latency_hist",
              "latency_hist_edges_ms", "hist_p50_latency_ms",
              "hist_p95_latency_ms", "hist_p99_latency_ms"):
        check(got[k] == want[k], f"{what}: {k} identical")
    worst = 0.0
    for name, w in want["series"].items():
        g = got["series"][name]
        if all(isinstance(v, int) for v in w):
            check(g == w, f"{what}: counter {name} identical")
            continue
        ga = np.array([np.nan if v is None else v for v in g], np.float64)
        wa = np.array([np.nan if v is None else v for v in w], np.float64)
        check(np.array_equal(np.isnan(ga), np.isnan(wa)),
              f"{what}: {name} unwritten in the same windows")
        ok = ~np.isnan(wa)
        err = float(np.abs(ga[ok] - wa[ok]).max()) if ok.any() else 0.0
        check(err <= 1e-5, f"{what}: gauge {name} within 1e-5 ({err})")
        worst = max(worst, err)
    return dict(max_gauge_err=worst)


def ndjson(path) -> list:
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def without_wall(events: list) -> list:
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in events]


def tick_profile(torch, serve_fleet, argv: list) -> dict:
    """Device ops and busy ms per tick of one short CLI run, counted from
    its first admission kernel on, and by kernel name."""
    _, dev_events, (short, _) = traced(
        torch, lambda: cli_main(serve_fleet, argv), before=reset_all_counts)
    first = min((e.time_range.start for e in dev_events
                 if "queue_admit_kernel" in e.name), default=None)
    check(first is not None, "profiler saw the admission kernel")
    dev_events = [e for e in dev_events if e.time_range.start >= first]
    ticks = short["n_ticks"]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    by_name: dict = {}
    for e in dev_events:
        n, us = by_name.get(e.name[:70], (0, 0.0))
        by_name[e.name[:70]] = (n + 1, us + e.time_range.elapsed_us())
    return dict(ticks=ticks, device_events_per_tick=len(dev_events) / ticks,
                device_busy_ms_per_tick=busy / ticks, by_name=by_name)


def profile_added(off: dict, on: dict, top: int = 8) -> list:
    """The kernels telemetry adds a tick, by busy time: (name, launches
    per tick, µs per tick)."""
    names = set(off["by_name"]) | set(on["by_name"])
    diff = []
    for name in names:
        n0, us0 = off["by_name"].get(name, (0, 0.0))
        n1, us1 = on["by_name"].get(name, (0, 0.0))
        diff.append((name, (n1 - n0) / on["ticks"], (us1 - us0) / on["ticks"]))
    return sorted(diff, key=lambda d: -d[2])[:top]


def count_syncs(torch, run_epochs, on: int) -> tuple[dict, object]:
    """Host syncs (``set_sync_debug_mode("warn")`` warnings) between the
    start of epoch ``on`` and the start of the next, in a run driven by
    ``run_epochs(on_epoch)``, by the source line that made them.  Returns
    the counts and the run's result."""
    import warnings
    marks: dict = {}

    def on_epoch(e, params):
        if e == on:
            torch.cuda.synchronize()
            marks["start"] = len(caught)
            torch.cuda.set_sync_debug_mode("warn")
        elif e == on + 1:
            torch.cuda.set_sync_debug_mode(0)
            marks["end"] = len(caught)
        return params

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            result = run_epochs(on_epoch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where: dict = {}
    for w in caught[marks["start"]:marks["end"]]:
        if "synchroniz" in str(w.message):
            line = f"{Path(w.filename).relative_to(ROOT)}:{w.lineno}" \
                if Path(w.filename).is_relative_to(ROOT) else \
                f"{Path(w.filename).name}:{w.lineno}"
            where[line] = where.get(line, 0) + 1
    return where, result


def phase_telemetry(torch) -> dict:
    import dataclasses
    import numpy as np
    from repro_torch import random as rnd
    from repro_torch.fleet.env import FleetConfig
    from repro_torch.fleet.workload import random_fleet
    from repro_torch.hltrain.trainer import (FleetHLParams, make_hl_trainer,
                                             train_telemetry_report)
    from repro_torch.kernels import orchestration as orch
    from repro_torch.launch import serve_fleet
    from repro_torch.launch.rl_train import fleet_params
    from repro_torch.policy.adapters import heuristic_greedy_policy
    from repro_torch.serve.engine import (TEL_COUNTERS, TEL_GAUGES,
                                          ServeConfig, serve_stream)
    from repro_torch.serve.stream import poisson_request_stream
    from repro_torch.specs.observation import make_spec
    from repro_torch.telemetry import (BurnRateAlerter, LiveEmitter,
                                       NdjsonSink, TrainLiveEmitter,
                                       audit_serve_report,
                                       audit_train_report, read_trace,
                                       validate_trace)

    # (a) the deployment with telemetry, live export and a sampled trace,
    # through the CLI, beside the same call without telemetry
    paths = {k: OUT / f"chip_smoke_telemetry.{k}" for k in
             ("live.ndjson", "trace.jsonl", "serve.json")}
    base = ["--greedy"] + cli_args(**SERVE_KW)
    tel_args = ["--telemetry", "--window-ms", str(TEL_WINDOW_MS), "--live",
                "--live-out", str(paths["live.ndjson"]), "--trace-out",
                str(paths["trace.jsonl"]), "--trace-sample",
                str(TEL_TRACE_SAMPLE), "--out", str(paths["serve.json"])]
    reset_all_counts()
    rep, _ = cli_main(serve_fleet, base + tel_args)
    launches = all_counts()
    off, _ = cli_main(serve_fleet, base)
    n_ticks = rep["n_ticks"]
    check(launches == {"queue_admit": n_ticks,
                       "group_occupancy": 3 * n_ticks,
                       "flash_attention": 0, "wkv6": 0, "ssd": 0},
          f"telemetry run: queue_admit once and group_occupancy 3 times a "
          f"tick ({launches} in {n_ticks} ticks)")
    for k, v in off["records"].items():
        check(v.tobytes() == rep["records"][k].tobytes(),
              f"records[{k}] byte-identical with telemetry on and off")
    tel = rep["telemetry"]
    events = ndjson(paths["live.ndjson"])
    windows = [e["window"] for e in events if e["event"] == "window"]
    check(windows == list(range(tel["n_windows"]))
          and events[-1]["event"] == "summary"
          and events[-1]["n_windows"] == tel["n_windows"],
          f"one window record per window ({len(windows)} of "
          f"{tel['n_windows']}) and the summary last")
    written = json.loads(paths["serve.json"].read_text())
    trace = read_trace(str(paths["trace.jsonl"]))
    audit = audit_serve_report(written, trace=trace)
    check(audit.ok, "the deployment's audit passes:\n" + audit.render())
    summary = validate_trace(trace)
    check(0 < summary["n_events"] < rep["n_requests"],
          f"a sampled trace ({summary['n_events']} events)")
    # device ops and busy ms per tick, telemetry on and off, one call
    short = cli_args(**dict(SERVE_KW, rounds=1, epochs=1))
    prof = {"off": tick_profile(torch, serve_fleet, ["--greedy"] + short),
            "on": tick_profile(torch, serve_fleet, ["--greedy"] + short + [
                "--telemetry", "--window-ms", str(TEL_WINDOW_MS)])}
    # host syncs over one epoch: off, on, and on with live export
    dev = torch.device("cuda")
    k_fleet, k_trace, k_serve, _ = rnd.split(rnd.PRNGKey(SEED, dev), 4)
    scn = random_fleet(k_fleet, CELLS, n_max=N_MAX,
                       cells_per_edge=CELLS_PER_EDGE)
    spec = make_spec("full", N_MAX)
    pol = heuristic_greedy_policy(spec)
    syncs, sync_lines, live_lines = {}, {}, {}
    for name in ("off", "on", "live"):
        cfg = ServeConfig(n_max=N_MAX, obs_spec="full", shared_cloud=True,
                          shared_edge=True, telemetry=name != "off",
                          window_ms=TEL_WINDOW_MS)
        horizon = ROUNDS * cfg.round_ms
        stream = poisson_request_stream(k_trace, scn, horizon, rate=RATE,
                                        round_ms=cfg.round_ms,
                                        epoch_ms=horizon / SYNC_EPOCHS)
        sink = NdjsonSink(io.StringIO())
        live = (LiveEmitter(sink, TEL_COUNTERS, TEL_GAUGES,
                            window_ms=TEL_WINDOW_MS)
                if name == "live" else None)
        lines = []

        def run(on_epoch):
            def hook(e, params):  # the live lines written by each boundary
                lines.append(sink.n_events)
                return on_epoch(e, params)
            return serve_stream(pol, pol.init(SEED, dev), scn, stream, cfg,
                                key=k_serve, device=dev, live=live,
                                on_epoch=hook)
        sync_lines[name], _ = count_syncs(torch, run, on=1)
        syncs[name] = sum(sync_lines[name].values())
        live_lines[name] = lines
    out_lines = sink._out.getvalue().splitlines()
    epoch1 = [json.loads(x) for x in
              out_lines[live_lines["live"][1]:live_lines["live"][2]]]
    closed = sum(e["event"] == "window" for e in epoch1)
    check(syncs["off"] >= 1, f"the count sees the epoch's own sync "
          f"(its decision count read back): {syncs}")
    check(syncs["on"] == syncs["off"],
          f"telemetry adds no host sync to an epoch ({syncs})")
    check(syncs["live"] - syncs["off"] <= closed + 1,
          f"live export adds at most one sync per closed window ({closed}) "
          f"and one per epoch ({syncs})")
    # ms per steady tick, telemetry off and on in turns
    turns = []
    for on in (False, True, True, False):
        r = serve_fleet.serve(greedy=True, device="cuda", verbose=False,
                              telemetry=on, window_ms=TEL_WINDOW_MS,
                              **SERVE_KW)
        turns.append(("on" if on else "off", r["ms_per_tick"]))
    deployment = dict(
        n_ticks=n_ticks, launches=launches, n_windows=tel["n_windows"],
        live_events=len(events), alerts=sum(e["event"] == "alert"
                                            for e in events),
        trace=summary, audit=audit.summary(),
        hist_p99_latency_ms=tel["hist_p99_latency_ms"],
        p99_latency_ms=rep["p99_latency_ms"],
        ms_per_tick=rep["ms_per_tick"], ms_per_tick_off=off["ms_per_tick"],
        ms_per_tick_turns=turns,
        profile={k: {f: v[f] for f in ("ticks", "device_events_per_tick",
                                       "device_busy_ms_per_tick")}
                 for k, v in prof.items()},
        added_kernels_per_tick=profile_added(prof["off"], prof["on"]),
        syncs_epoch1=syncs, sync_lines_epoch1=sync_lines,
        closed_windows_epoch1=closed)

    # (b) phase 11's spot run with telemetry: the economy's conservation
    path = OUT / "chip_smoke_cost_greedy.bundle.msgpack"
    argv = (["--bundle", str(path), "--economy", ECONOMY_PROFILE,
             "--telemetry"]
            + cli_args(**{k: v for k, v in SERVE_KW.items()
                          if k not in ("shared_cloud", "shared_edge")}))
    reset_all_counts()
    spot, _ = cli_main(serve_fleet, argv)
    spot_launches = all_counts()
    check(spot_launches["queue_admit"] == spot["n_ticks"]
          and spot_launches["group_occupancy"] == 3 * spot["n_ticks"],
          f"spot with telemetry: the tick's launches ({spot_launches})")
    spot_audit = audit_serve_report(
        {k: v for k, v in spot.items() if k != "records"})
    laws = {c["check"]: c for c in spot_audit.checks}
    for law in ("spend_conservation", "energy_conservation",
                "cold_start_conservation", "preemption_conservation"):
        check(law in laws and laws[law]["ok"],
              f"spot: {law} ({laws.get(law)})")
    check(spot_audit.ok, "the spot audit passes:\n" + spot_audit.render())
    s = spot["telemetry"]["series"]
    economy = dict(audit=spot_audit.summary(), economy=spot["economy"],
                   window_spend_uusd=s["spend_uusd"],
                   max_window_spend_uusd=max(s["spend_uusd"]),
                   int32_max=2 ** 31 - 1, launches=spot_launches)

    # (c) trainer telemetry: an epoch under the sync check, then live
    cfg = FleetConfig(n_max=N_MAX, obs_spec="full", shared_cloud=True,
                      shared_edge=True)
    hp = dataclasses.replace(fleet_params(SYNC_FREE_CELLS, 4, SEED),
                             telemetry=True)
    k_fleet, k_init = rnd.split(rnd.PRNGKey(SEED, dev), 3)[:2]
    small = random_fleet(k_fleet, SYNC_FREE_CELLS, n_max=N_MAX,
                         cells_per_edge=CELLS_PER_EDGE)
    trainer = make_hl_trainer(cfg, hp)
    st, _ = trainer.run(trainer.init(k_init, small), small, 0, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, m = trainer.run(st, small, 1, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(m["q_loss"]).all()),
          "the sync-free telemetry epoch trained")
    rep_c = train_telemetry_report(st)
    sink = NdjsonSink(io.StringIO())
    live_tr = make_hl_trainer(cfg, hp, live=TrainLiveEmitter(sink))
    st2, _ = live_tr.run(live_tr.init(k_init, small), small, 0, 2)
    sessions = [json.loads(x) for x in sink._out.getvalue().splitlines()]
    rep_live = train_telemetry_report(st2)
    check(len(sessions) == int(st2.sessions) == rep_live["n_sessions"]
          and all(e["event"] == "train_session" for e in sessions),
          f"one train_session record per direct session ({len(sessions)})")
    tr_audit = audit_train_report(rep_live,
                                  direct_steps=int(st2.direct_steps),
                                  sessions=int(st2.sessions))
    check(tr_audit.ok, "the trainer's audit passes:\n" + tr_audit.render())
    trainer_out = dict(cells=SYNC_FREE_CELLS, sync_free_epoch_sessions=
                       rep_c["n_sessions"], td_p50=rep_c["td_p50"],
                       td_p99=rep_c["td_p99"], live_sessions=len(sessions),
                       audit=tr_audit.summary())

    # (d) CPU against the card at 64 cells: serving greedy and spot, and
    # two tiny training epochs, all with telemetry
    parity = {}
    small_kw = dict(cells=64, rounds=4, seed=1, epochs=2, telemetry=True,
                    window_ms=TEL_WINDOW_MS, live=True, verbose=False)
    for name, kw in (("greedy", dict(greedy=True, cells_per_edge=4,
                                     shared_cloud=True, shared_edge=True)),
                     ("spot", dict(bundle=str(path),
                                   economy=ECONOMY_PROFILE))):
        reps, lives = {}, {}
        for d in ("cpu", "cuda"):
            lp = OUT / f"chip_smoke_telemetry_{name}_{d}.ndjson"
            reps[d] = serve_fleet.serve(device=d, live_out=str(lp),
                                        **kw, **small_kw)
            lives[d] = ndjson(lp)
        for k in ("dropped", "served", "violated", "action"):
            check(np.array_equal(reps["cpu"]["records"][k],
                                 reps["cuda"]["records"][k]),
                  f"{name}: {k} identical on the CPU and the card")
        parity[name] = telemetry_parity(reps["cuda"]["telemetry"],
                                        reps["cpu"]["telemetry"],
                                        f"{name} CPU vs card")
        check(without_wall(lives["cpu"]) == without_wall(lives["cuda"]),
              f"{name}: the live NDJSON identical on the CPU and the card "
              f"apart from wall_s")
        parity[name]["live_events"] = len(lives["cpu"])
    hp_small = FleetHLParams(**SMALL_TRAIN_HP, telemetry=True)
    tr_reps, tr_lives = {}, {}
    for d in ("cpu", "cuda"):
        k_fleet, k_init = rnd.split(rnd.PRNGKey(SEED + 7, d), 2)
        scn_d = random_fleet(k_fleet, SMALL_TRAIN_CELLS, n_max=N_MAX,
                             cells_per_edge=CELLS_PER_EDGE)
        sink = NdjsonSink(io.StringIO())
        tr = make_hl_trainer(cfg, hp_small, live=TrainLiveEmitter(sink))
        st_d, _ = tr.run(tr.init(k_init, scn_d), scn_d, 0, hp_small.epochs)
        tr_reps[d] = train_telemetry_report(st_d)
        tr_lives[d] = [json.loads(x) for x in
                       sink._out.getvalue().splitlines()]
    c, g = tr_reps["cpu"], tr_reps["cuda"]
    for k in ("n_sessions", "direct_steps", "td_hist", "td_hist_edges",
              "td_p50", "td_p95", "td_p99"):
        check(c[k] == g[k], f"trainer {k} identical on the CPU and the card")
    gauges = [(a, b) for k in ("epsilon", "mean_reward", "q_loss")
              for a, b in zip(c[k], g[k], strict=True)]
    check(all((a is None) == (b is None) for a, b in gauges),
          "trainer gauges written in the same sessions")
    tr_err = max(abs(a - b) for a, b in gauges if a is not None)
    check(tr_err <= BUFFER_BAR, f"trainer gauges within {BUFFER_BAR} "
          f"({tr_err})")
    for ec, eg in zip(tr_lives["cpu"], tr_lives["cuda"], strict=True):
        check(all(ec[k] == eg[k] for k in ("event", "epoch", "session"))
              and all((ec[k] is None) == (eg[k] is None)
                      and (ec[k] is None or abs(ec[k] - eg[k]) <= BUFFER_BAR)
                      for k in ("mean_reward", "q_loss", "epsilon")),
              f"train_session records alike on the CPU and the card "
              f"({ec} vs {eg})")
    parity["trainer"] = dict(max_gauge_err=tr_err, sessions=c["n_sessions"],
                             td_updates=sum(c["td_hist"]))

    out = dict(deployment=deployment, economy=economy, trainer=trainer_out,
               cpu_vs_card=parity)
    emit("telemetry", **out)
    return out


# ------------------------------------------------------- sharded phase
# ranks of the deployment's cells group (gloo on one card, NCCL when each
# rank has a card), and the cells of the layout whose groups span ranks
SHARDS, SPAN_CELLS = 4, 4096
# the CPU-against-card group: cells, ranks
SMALL_SHARD_CELLS, SMALL_SHARDS = 64, 2
# per tick: the observation's totals and the transition's; per epoch: the
# decision count
ALL_REDUCE_PER_TICK = 2


def records_parity(got: dict, want: dict, what: str) -> dict:
    """Flags and actions identical, float records within 1e-5; returns
    the largest float difference by record."""
    import numpy as np
    for k in ("dropped", "served", "violated", "action"):
        check(np.array_equal(got[k], want[k]), f"{what}: {k} identical")
    errs = {k: float(np.abs(got[k] - want[k]).max())
            for k in ("wait_ms", "service_ms", "art_ms")}
    check(max(errs.values()) <= 1e-5, f"{what}: floats within 1e-5 {errs}")
    return errs


def sharded_rank(group, jobs: list) -> tuple:
    """One rank of phase 13b: ``jobs`` through the package's
    ``serve_rank``, then the deployment served again with the host syncs
    of its epoch 1 counted (``set_sync_debug_mode("warn")``, by source
    line).  Returns the jobs' results and this rank's sync count."""
    import torch
    from repro_torch import random as rnd
    from repro_torch.fleet.workload import random_fleet
    from repro_torch.policy.adapters import heuristic_greedy_policy
    from repro_torch.serve.engine import ServeConfig, serve_stream
    from repro_torch.serve.sharded import serve_rank
    from repro_torch.serve.stream import poisson_request_stream
    from repro_torch.specs.observation import make_spec

    out = serve_rank(group, jobs)
    dev = group.device
    k_fleet, k_trace, k_serve, _ = rnd.split(rnd.PRNGKey(SEED, dev), 4)
    scn = random_fleet(k_fleet, CELLS, n_max=N_MAX,
                       cells_per_edge=CELLS_PER_EDGE)
    cfg = ServeConfig(n_max=N_MAX, obs_spec="full", shared_cloud=True,
                      shared_edge=True)
    horizon = ROUNDS * cfg.round_ms
    stream = poisson_request_stream(k_trace, scn, horizon, rate=RATE,
                                    round_ms=cfg.round_ms,
                                    epoch_ms=horizon / SYNC_EPOCHS)
    pol = heuristic_greedy_policy(make_spec("full", N_MAX))
    where, rep = count_syncs(torch, lambda on_epoch: serve_stream(
        pol, pol.init(SEED, dev), scn, stream, cfg, key=k_serve, mesh=group,
        on_epoch=on_epoch), on=1)
    ticks = int(round(stream.epoch_ms / cfg.tick_ms))
    return out, dict(rank=group.rank, syncs_epoch1=where, ticks_epoch1=ticks,
                     ms_per_tick=rep["ms_per_tick"])


def group_summary(rep: dict, what: str) -> dict:
    """A sharded report's group: each rank's launches (queue_admit once and
    group_occupancy 3 times a tick), the all_reduces a tick, the backend,
    ms per steady tick by rank."""
    n_ticks, n_epochs = rep["n_ticks"], rep["n_epochs"]
    for r in rep["ranks"]:
        check(r["launches"] == {"queue_admit": n_ticks,
                                "group_occupancy": 3 * n_ticks},
              f"{what}: each rank's launches ({r['launches']} in "
              f"{n_ticks} ticks)")
    reduces = rep["cells_group"]["collectives"]["all_reduce"]
    check(reduces == ALL_REDUCE_PER_TICK * n_ticks + n_epochs,
          f"{what}: {ALL_REDUCE_PER_TICK} all_reduces a tick and one an "
          f"epoch ({reduces} in {n_ticks} ticks, {n_epochs} epochs)")
    return dict(mesh_cells=rep["mesh_cells"],
                backend=rep["cells_group"]["backend"],
                launches_per_rank=[r["launches"] for r in rep["ranks"]],
                all_reduce_per_tick=(reduces - n_epochs) / n_ticks,
                collectives=rep["cells_group"]["collectives"],
                ms_per_tick=rep["ms_per_tick"],
                ms_per_tick_by_rank=[r["ms_per_tick"]
                                     for r in rep["cells_group"]["ranks"]],
                compile_time_s=rep["compile_time_s"])


def phase_sharded(torch) -> dict:
    from repro_torch import random as rnd
    from repro_torch.fleet.workload import random_fleet
    from repro_torch.kernels.orchestration import group_index
    from repro_torch.launch import serve_fleet
    from repro_torch.policy.adapters import heuristic_greedy_policy
    from repro_torch.policy.bundle import PolicyBundle
    from repro_torch.serve.engine import ServeConfig, serve_stream
    from repro_torch.serve.sharded import ServeJob
    from repro_torch.serve.stream import poisson_request_stream
    from repro_torch.sharding import backend_for, spawn_cells
    from repro_torch.specs.observation import make_spec
    from repro_torch.telemetry import audit_serve_report

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' contexts share the card
    # (a) the deployment over 4 ranks and over 1, beside one device
    kw = dict(SERVE_KW, greedy=True, verbose=False)
    single = serve_fleet.serve(device="cuda", **kw)
    reset_all_counts()
    four = serve_fleet.serve(device="cuda", mesh_cells=SHARDS, **kw)
    one = serve_fleet.serve(device="cuda", mesh_cells=1, **kw)
    check(not any(all_counts().values()),
          "the parent launches nothing: the ranks serve")
    check(four["cells_group"]["backend"] == backend_for(SHARDS, "cuda")
          and one["cells_group"]["backend"] == "nccl",
          f"backends: {four['cells_group']['backend']} over {SHARDS} "
          f"ranks, {one['cells_group']['backend']} over one")
    deployment = {"single_ms_per_tick": single["ms_per_tick"]}
    for name, rep in ((f"mesh_{SHARDS}", four), ("mesh_1", one)):
        deployment[name] = dict(
            group_summary(rep, name),
            max_float_err=records_parity(rep["records"], single["records"],
                                         f"{name} vs one device"))

    # (b) 4,096 cells whose edge groups span every rank (cell % 1,024),
    # and the deployment's host syncs in epoch 1 under the group
    dev = torch.device("cuda")
    k_fleet, k_trace, k_serve = rnd.split(rnd.PRNGKey(SEED + 5, dev), 3)
    scn = random_fleet(k_fleet, SPAN_CELLS, n_max=N_MAX)
    span = torch.arange(SPAN_CELLS, dtype=torch.int32,
                        device=dev) % (SPAN_CELLS // 4)
    scn = scn._replace(edge_group=span, group_index=group_index(span))
    cfg = ServeConfig(n_max=N_MAX, obs_spec="full", shared_cloud=True,
                      shared_edge=True)
    horizon = ROUNDS * cfg.round_ms
    stream = poisson_request_stream(k_trace, scn, horizon, rate=RATE,
                                    round_ms=cfg.round_ms,
                                    epoch_ms=horizon / EPOCHS)
    pol = heuristic_greedy_policy(make_spec("full", N_MAX))
    want = serve_stream(pol, pol.init(SEED, dev), scn, stream, cfg,
                        key=k_serve, device=dev)
    job = ServeJob(PolicyBundle("greedy", "full", N_MAX, {}),
                   scn.to("cpu"), stream, cfg, k_serve.cpu())
    ranks = spawn_cells(sharded_rank, SHARDS, "cuda", [job])
    got = ranks[0][0][0][0]
    got["ranks"] = [r[0][0][1] for r in ranks]
    spanning = dict(group_summary(got, "spanning groups"),
                    max_float_err=records_parity(
                        got["records"], want["records"],
                        "spanning groups vs one device"),
                    served=got["served_requests"])
    syncs = [r[1] for r in ranks]
    for r in syncs:
        r["syncs_per_tick"] = sum(r["syncs_epoch1"].values()) / \
            r["ticks_epoch1"]

    # (c) phase 11's spot run with telemetry over 4 ranks
    path = OUT / "chip_smoke_cost_greedy.bundle.msgpack"
    spot_kw = dict({k: v for k, v in SERVE_KW.items()
                    if k not in ("shared_cloud", "shared_edge")},
                   bundle=str(path), economy=ECONOMY_PROFILE, telemetry=True,
                   verbose=False)
    spot_one = serve_fleet.serve(device="cuda", **spot_kw)
    spot_four = serve_fleet.serve(device="cuda", mesh_cells=SHARDS,
                                  **spot_kw)
    for k in BILLING:
        check(spot_four["economy"][k] == spot_one["economy"][k],
              f"spot {k} identical over {SHARDS} ranks "
              f"({spot_four['economy'][k]} vs {spot_one['economy'][k]})")
    tel = telemetry_parity(spot_four["telemetry"], spot_one["telemetry"],
                           f"spot telemetry over {SHARDS} ranks")
    audit = audit_serve_report(
        {k: v for k, v in spot_four.items() if k != "records"})
    check(audit.ok, "the sharded spot audit passes:\n" + audit.render())
    spot = dict(group_summary(spot_four, "spot"), telemetry=tel,
                economy=spot_four["economy"], audit=audit.summary(),
                max_float_err=records_parity(
                    spot_four["records"], spot_one["records"],
                    "spot over 4 ranks vs one device"),
                single_ms_per_tick=spot_one["ms_per_tick"])

    # (d) the CPU against the card: 64 cells over 2 ranks
    small = dict(greedy=True, cells=SMALL_SHARD_CELLS, rounds=4, seed=1,
                 epochs=2, cells_per_edge=4, shared_cloud=True,
                 shared_edge=True, mesh_cells=SMALL_SHARDS, verbose=False)
    cpu = serve_fleet.serve(device="cpu", **small)
    gpu = serve_fleet.serve(device="cuda", **small)
    cpu_vs_card = dict(
        backends=[cpu["cells_group"]["backend"],
                  gpu["cells_group"]["backend"]],
        max_float_err=records_parity(gpu["records"], cpu["records"],
                                     "64 cells over 2 ranks, CPU vs card"),
        served=gpu["served_requests"])

    out = dict(deployment=deployment, spanning=spanning, syncs=syncs,
               spot=spot, cpu_vs_card=cpu_vs_card,
               seconds=time.perf_counter() - t_phase)
    emit("sharded", **out)
    return out


# ------------------------------------------------------- single-cell phase
# the paper's Table V agent cell: the CLI at 5 users, A/89%, seeds tried
# in turn until one converges within the CLI's 400 epochs
SC_USERS, SC_SCENARIO, SC_CONSTRAINT, SC_SEEDS = 5, "A", "89%", (0, 1, 2)
# Table VI's 3-user row at A/89%, seed 0, with the hyper-parameters of
# benchmarks/paper_tables.py:41-68 (run_one; copied, that module imports
# the reference): HL over 600 epochs, ε over 1,200·n steps, k_best 5,
# n_suggest 2·n, n_plan 40; DQL with ε over 6,000·n steps, capped at
# 120,000 steps, an evaluation every 200; QL with ε over cap / 8, capped
# at 400,000, an evaluation every 2,000; the tracker on seed + 90 with
# patience 4
T6_USERS, T6_SEED, T6_DQL_CAP, T6_QL_CAP = 3, 0, 120_000, 400_000
# CPU vs card: tests/test_hltrain.py::_tiny_hp's schedule with batch 16
SC_TINY_HP = dict(epochs=2, n_direct=3, t_direct=6, n_world=6, n_suggest=2,
                  t_suggest=3, n_plan=6, k_best=3, batch=16)
SC_DQL_STEPS, SC_RECORDED_OBS = 1000, 1000
TIER = {"L": "local", "E": "edge", "C": "cloud"}


def sc_env(users: int, seed: int, **kw):
    from repro_torch.env.edge_cloud import EdgeCloudEnv, EnvConfig
    from repro_torch.env.scenarios import CONSTRAINTS, SCENARIOS
    return EdgeCloudEnv(EnvConfig(SCENARIOS[SC_SCENARIO],
                                  CONSTRAINTS[SC_CONSTRAINT], n_users=users,
                                  seed=seed, **kw))


def sc_summary(res, wall_s: float) -> dict:
    from repro_torch.env.edge_cloud import decision_string
    return dict(steps_to_converge=res.steps_to_converge,
                real_steps=res.real_steps, final_art=res.final_art,
                decisions=decision_string(res.final_actions),
                compute_updates=res.compute_updates,
                exp_time_min=res.exp_time_ms / 60000.0,
                comp_time_min=res.comp_time_s / 60.0, wall_s=wall_s,
                real_steps_per_s=res.real_steps / wall_s)


def table6_run(algo: str) -> dict:
    """One run of ``run_one``'s cell on the card (QL on the host)."""
    from repro_torch.core.agent import (ConvergenceTracker, HLAgent,
                                        HLHyperParams)
    from repro_torch.core.baselines import DQLAgent, QLAgent, QLHyperParams
    n, seed = T6_USERS, T6_SEED
    env = sc_env(n, seed)
    tracker = ConvergenceTracker(sc_env(n, seed + 90), patience=4)
    t0 = time.perf_counter()
    if algo == "HL":
        agent = HLAgent(env, HLHyperParams(
            seed=seed, epochs=600, eps_decay_steps=1200 * n, k_best=5,
            n_suggest=2 * n, n_plan=40))
        res = agent.train(tracker=tracker)
    elif algo == "DQL":
        agent = DQLAgent(env, HLHyperParams(seed=seed,
                                            eps_decay_steps=6000 * n))
        res = agent.train(tracker=tracker, max_steps=T6_DQL_CAP,
                          eval_every=200)
    else:
        agent = QLAgent(env, QLHyperParams(seed=seed,
                                           eps_decay_steps=T6_QL_CAP // 8))
        res = agent.train(tracker=tracker, max_steps=T6_QL_CAP,
                          eval_every=2000)
    return dict(sc_summary(res, time.perf_counter() - t0),
                optimal_art=tracker.opt_art)


def recording(agent, log: list) -> None:
    """Keep, in order, every greedy decision's Q row and every planning
    step's r̂ + γ max Q values, under the weights that made them."""
    import torch
    pol = agent.policy

    def act(params, obs, key):
        with torch.no_grad():
            log.append(("act", params(obs)[0].cpu().numpy().copy()))
        return pol.act(params, obs, key)
    agent.policy = pol._replace(act=act)
    if hasattr(agent, "_plan_values"):
        plan_values = agent._plan_values

        def values(obs):
            v = plan_values(obs)
            log.append(("plan", v.copy()))
            return v
        agent._plan_values = values


def first_difference(cpu_log: list, gpu_log: list, k: int):
    """None if every decision agrees; else the step and the CPU's gap
    between the two candidates that changed places."""
    import numpy as np
    for i, ((kind, c), (_, g)) in enumerate(zip(cpu_log, gpu_log)):
        if kind == "act":
            a_c, a_g = int(np.argmax(c)), int(np.argmax(g))
            if a_c != a_g:
                return dict(step=i, kind=kind, gap=float(c[a_c] - c[a_g]))
            continue
        o_c, o_g = np.argsort(-c)[:k], np.argsort(-g)[:k]
        for j in range(k):
            if o_c[j] != o_g[j]:
                return dict(step=i, kind=kind,
                            gap=float(abs(c[o_c[j]] - c[o_g[j]])))
    check(len(cpu_log) == len(gpu_log), "as many decisions on both devices")
    return None


def sc_state(agent) -> dict:
    """An agent's counters, buffers and networks as numpy, by name."""
    import numpy as np
    out = dict(real_steps=np.array(agent.real_steps),
               compute_updates=np.array(agent.compute_updates))
    bufs = ({"d_direct": agent.d_direct, "d_world": agent.d_world,
             "d_plan": agent.d_plan} if hasattr(agent, "d_plan")
            else {"buf": agent.buf})
    for name, b in bufs.items():
        for f in ("n", "ptr", "a", "done", "s", "s2", "r", "prio"):
            if hasattr(b, f):
                out[f"{name}.{f}"] = np.asarray(getattr(b, f))
    nets = {"dqn": agent.dqn} | ({"sm": agent.sm} if hasattr(agent, "sm")
                                else {})
    for name, st in nets.items():
        for i, p in enumerate(st.params.parameters()):
            out[f"{name}.params[{i}]"] = p.detach().cpu().numpy()
        for i, (m, v) in enumerate(zip(st.opt_state.mu, st.opt_state.nu)):
            out[f"{name}.mu[{i}]"] = m.cpu().numpy()
            out[f"{name}.nu[{i}]"] = v.cpu().numpy()
    return out


def sc_cpu_vs_card(algo: str) -> dict:
    """One seed at 3 users on the CPU and on the card: HL for 2 tiny
    epochs or DQL for 1,000 steps.  Integers identical, float buffers
    within 1e-5, TD priorities within 1e-5 of max(1, |p|) (a float32 TD
    near the penalty's −33 carries ~2e-6 per ulp) and parameters within
    2e-6, the plan keys the same set; a differing decision only at a
    near-tie, judged with the CPU's values, and nothing compared past
    it."""
    import numpy as np
    from repro_torch.core.agent import (ConvergenceTracker, HLAgent,
                                        HLHyperParams)
    from repro_torch.core.baselines import DQLAgent
    agents, logs = {}, {}
    for dev in ("cpu", "cuda"):
        env, tr = sc_env(T6_USERS, 4), ConvergenceTracker(
            sc_env(T6_USERS, 94))
        if algo == "HL":
            agent = HLAgent(env, HLHyperParams(seed=4, **SC_TINY_HP),
                            device=dev)
            logs[dev] = []
            recording(agent, logs[dev])
            agent.train(tracker=tr, stop_on_convergence=False)
        else:
            agent = DQLAgent(env, HLHyperParams(seed=4,
                                                eps_decay_steps=800),
                             device=dev)
            logs[dev] = []
            recording(agent, logs[dev])
            agent.train(tracker=tr, max_steps=SC_DQL_STEPS, eval_every=200,
                        stop_on_convergence=False)
        agents[dev] = agent
    k = SC_TINY_HP["k_best"] if algo == "HL" else 1
    tie = first_difference(logs["cpu"], logs["cuda"], k)
    worst = {"buffers": 0.0, "priorities": 0.0, "params": 0.0,
             "priorities_abs": 0.0}
    if tie is not None:
        print(json.dumps({f"single_cell_{algo}_first_difference": tie}),
              flush=True)
        check(tie["gap"] < NEAR_TIE, f"{algo}: CPU and card decisions "
              f"differ at a gap of {tie['gap']} (near-tie bar {NEAR_TIE})")
    else:
        cpu, gpu = sc_state(agents["cpu"]), sc_state(agents["cuda"])
        for name, c in cpu.items():
            g = gpu[name]
            if c.dtype.kind == "f":
                err = np.abs(c.astype(np.float64) - g)
                if name.endswith(".prio"):
                    worst["priorities_abs"] = max(worst["priorities_abs"],
                                                  float(err.max()))
                    err = err / np.maximum(1.0, np.abs(c))
                    kind = "priorities"
                else:
                    kind = "params" if name.startswith(("dqn", "sm")) \
                        else "buffers"
                worst[kind] = max(worst[kind], float(err.max()) if c.size
                                  else 0.0)
            else:
                check(np.array_equal(c, g), f"{algo}: {name} identical on "
                      f"the CPU and the card")
        if algo == "HL":
            check(agents["cpu"].d_plan._index.keys()
                  == agents["cuda"].d_plan._index.keys(),
                  "HL: the same plan keys on the CPU and the card")
        check(worst["buffers"] <= BUFFER_BAR
              and worst["priorities"] <= BUFFER_BAR
              and worst["params"] <= PARAM_BAR,
              f"{algo}: CPU and card floats within {BUFFER_BAR} / "
              f"{PARAM_BAR}: {worst}")
    out = dict(decisions=len(logs["cpu"]),
               real_steps=agents["cpu"].real_steps,
               compute_updates=agents["cpu"].compute_updates,
               max_abs_err=worst, first_difference=tie)
    if algo == "DQL":
        out["td_recompute"] = td_recompute(agents["cuda"])
    return out


def td_recompute(agent) -> dict:
    """The card's TD errors against the CPU's from the same inputs: the
    card agent's networks after its last update and one minibatch of its
    buffer, through the agent's own update on a copy of them on each
    device, so the trajectories cannot have forked.  The gap is given in
    float32 ulps of the priority |td| + 1e-4 and in ulps of the larger
    of the two values the TD is the difference of (Q(s, a) and its
    target), with Q(s, a)'s own gap in ulps of Q(s, a)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.training.optimizer import tree_map
    batch, _, w = agent.buf.sample(agent.hp.batch)
    td, q_sa = {}, {}
    for dev in ("cpu", "cuda"):
        params = copy.deepcopy(agent.dqn.params).to(dev)
        st = agent.dqn._replace(
            params=params,
            target_params=copy.deepcopy(agent.dqn.target_params).to(dev),
            opt_state=tree_map(lambda t: t.detach().to(dev),
                               agent.dqn.opt_state),
            step=agent.dqn.step.to(dev))
        b = tuple(torch.as_tensor(x, device=dev) for x in batch)
        with torch.no_grad():
            q_sa[dev] = params(b[0]).gather(
                1, b[1].long()[:, None])[:, 0].cpu().numpy()
        _, _, t = agent.dqn_update(st, b, torch.as_tensor(w, device=dev))
        td[dev] = t.cpu().numpy()
    ulp = lambda v: np.spacing(np.abs(v).astype(np.float32)).astype(
        np.float64)
    p = np.abs(td["cpu"]) + np.float32(1e-4)
    gap = np.abs(td["cpu"].astype(np.float64) - td["cuda"])
    operand = np.maximum(np.abs(q_sa["cpu"]),
                         np.abs(q_sa["cpu"] - td["cpu"]))
    ulps_p, ulps_op = gap / ulp(p), gap / ulp(operand)
    q_gap = np.abs(q_sa["cpu"].astype(np.float64) - q_sa["cuda"])
    return dict(updates=agent.compute_updates, batch=int(len(p)),
                max_abs_gap=float(gap.max()),
                max_rel_gap=float((gap / np.maximum(1.0, p)).max()),
                max_ulps_of_p=float(ulps_p.max()),
                mean_ulps_of_p=float(ulps_p.mean()),
                max_ulps_of_operands=float(ulps_op.max()),
                mean_ulps_of_operands=float(ulps_op.mean()),
                max_q_sa_ulps=float((q_gap / ulp(q_sa["cpu"])).max()),
                max_priority=float(p.max()),
                p_at_max_ulps=float(p[int(ulps_p.argmax())]),
                operand_at_max_ulps=float(operand[int(ulps_p.argmax())]))


class _EpochDone(Exception):
    pass


def sc_epoch_syncs(torch) -> dict:
    """Host syncs (``set_sync_debug_mode("warn")``) over epoch 2 of a
    fresh HL agent on the CLI's 5-user schedule: from its first direct
    session to the first of epoch 3, tracker evaluations included, by
    source line; the run stops there."""
    import warnings
    from repro_torch.core.agent import ConvergenceTracker
    from repro_torch.launch.rl_train import single_cell_agent
    agent = single_cell_agent("HL", sc_env(SC_USERS, 0), SC_USERS, 0, "cuda")
    hp = agent.hp
    per_epoch = [max(1, int(round((1 - e / hp.epochs / 2) * hp.n_direct)))
                 for e in (1, 2)]
    start, end = per_epoch[0], per_epoch[0] + per_epoch[1]
    session = agent._direct_rl_session
    marks: dict = {"calls": 0}

    def direct(obs):
        if marks["calls"] == start:
            torch.cuda.synchronize()
            marks.update(start=len(caught), steps=agent.real_steps,
                         updates=agent.compute_updates)
            torch.cuda.set_sync_debug_mode("warn")
        elif marks["calls"] == end:
            torch.cuda.set_sync_debug_mode(0)
            marks.update(end=len(caught), steps=agent.real_steps
                         - marks["steps"], updates=agent.compute_updates
                         - marks["updates"])
            raise _EpochDone
        marks["calls"] += 1
        return session(obs)

    agent._direct_rl_session = direct
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            agent.train(tracker=ConvergenceTracker(sc_env(SC_USERS, 90),
                                                   patience=4))
        except _EpochDone:
            pass
        finally:
            torch.cuda.set_sync_debug_mode(0)
    check("end" in marks, "the sync count reached epoch 3")
    where: dict = {}
    for w in caught[marks["start"]:marks["end"]]:
        if "synchroniz" in str(w.message):
            line = f"{Path(w.filename).relative_to(ROOT)}:{w.lineno}" \
                if Path(w.filename).is_relative_to(ROOT) else \
                f"{Path(w.filename).name}:{w.lineno}"
            where[line] = where.get(line, 0) + 1
    total = sum(where.values())
    return dict(epoch=2, real_steps=marks["steps"],
                compute_updates=marks["updates"], syncs=total,
                syncs_per_real_step=total / max(1, marks["steps"]),
                by_line=where)


def sc_step_profiles(torch, agent) -> dict:
    """Device ops and busy ms of one direct session (10 steps and its
    DQN update), one planning session and one DQN update alone, on a
    trained agent (ε at its floor: most steps greedy)."""
    from repro_torch.core.agent import prioritized_update
    obs = agent.env.observe()
    out = {}
    for name, fn in (("direct_session",
                      lambda: agent._direct_rl_session(obs)),
                     ("planning_session", agent._planning_session),
                     ("dqn_update",
                      lambda: prioritized_update(agent, agent.d_direct))):
        fn()  # warm
        prof, _ = _device_time(torch, fn)
        out[name] = dict(device_ops=prof["device_ops"],
                         device_busy_ms=prof["device_busy_ms"],
                         top_kernels_ms=prof["top_kernels_ms"])
    return out


def phase_single_cell(torch) -> dict:
    from repro_torch.core.orchestrator import IntelligentOrchestrator
    from repro_torch.env import latency_model as lm
    from repro_torch.env.edge_cloud import decision_string
    from repro_torch.env.scenarios import CONSTRAINTS
    from repro_torch.launch import rl_train
    from repro_torch.policy.bundle import load_bundle, policy_from_bundle

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # (a) Table V's agent cell through the CLI, launches counted around
    # each run (zeroed just before it, read just after)
    path = OUT / "hl_single_cell.bundle.msgpack"
    tries = []
    for seed in SC_SEEDS:
        reset_all_counts()
        rep = rl_train.main(["--algo", "HL", "--users", str(SC_USERS),
                             "--scenario", SC_SCENARIO, "--constraint",
                             SC_CONSTRAINT, "--seed", str(seed), "--ckpt",
                             str(path)])
        launches = all_counts()
        res, opt = rep["result"], rep["optimum"]
        tries.append(dict(seed=seed, launches=launches,
                          **sc_summary(res, rep["wall_seconds"])))
        check(all(v == 0 for v in launches.values()),
              f"the single-cell run launches no kernel: {launches}")
        if res.steps_to_converge is not None:
            break
    check(res.steps_to_converge is not None,
          f"HL converges at {SC_USERS} users for one of seeds {SC_SEEDS}")
    acc = float(lm.action_accuracy(res.final_actions).mean())
    check(res.final_art <= opt["art"] * 1.01 + 1e-9
          and acc >= CONSTRAINTS[SC_CONSTRAINT] - 1e-9,
          f"final ART {res.final_art} within 1% of {opt['art']} at "
          f"accuracy {acc}, no violation")
    agent = rep["agent"]
    table5 = dict(optimum_art=opt["art"],
                  optimum_decisions=decision_string(opt["actions"]),
                  converged_seed=seed, final_accuracy=acc, tries=tries)

    # (e) the orchestrator and the bundle, on (a)'s agent before (c)
    # trains it further
    decisions = IntelligentOrchestrator(
        sc_env(SC_USERS, 0), agent.policy, agent.policy_params).decide_round()
    tiers = [TIER[s[-1]] for s in decision_string(res.final_actions)]
    check(len(decisions) == SC_USERS
          and [d.tier for d in decisions] == tiers,
          f"decide_round's tiers {[d.tier for d in decisions]} are the "
          f"final round's {tiers}")
    bundle = load_bundle(str(path), expect_spec="base",
                         expect_n_max=SC_USERS)
    pol, net = policy_from_bundle(bundle, dev)
    obs = torch.as_tensor(agent.d_direct.s[:SC_RECORDED_OBS], device=dev)
    check(obs.shape[0] == SC_RECORDED_OBS, "1,000 recorded observations")
    check(torch.equal(pol.act(net, obs, None),
                      agent.policy.act(agent.policy_params, obs, None)),
          "the bundle's greedy actions are the agent's")
    check(bundle.meta["algo"] == "HL" and len(bundle.meta["system"]) == 3,
          "the bundle carries the system model")

    # (b) Table VI's 3-user row at A/89%, seed 0
    reset_all_counts()
    table6 = {algo: table6_run(algo) for algo in ("HL", "DQL", "QL")}
    table6["launches"] = all_counts()
    check(all(v == 0 for v in table6["launches"].values()),
          f"the Table VI runs launch no kernel: {table6['launches']}")
    for algo in ("HL", "DQL"):
        check(table6[algo]["steps_to_converge"] is not None,
              f"{algo} converges at {T6_USERS} users")
    ql = table6["QL"]
    check((ql["steps_to_converge"], ql["real_steps"],
           round(ql["final_art"], 1)) == (22_000, 28_000, 269.8),
          f"QL runs the reference's run: {ql}")

    # (c) the cost of a step: host syncs over one epoch, device work of
    # a direct session, a planning session and an update
    syncs = sc_epoch_syncs(torch)
    profiles = sc_step_profiles(torch, agent)

    # (d) the CPU against the card
    cpu_vs_card = {algo: sc_cpu_vs_card(algo) for algo in ("HL", "DQL")}

    out = dict(table5=table5, table6=table6, syncs=syncs,
               step_profiles=profiles, cpu_vs_card=cpu_vs_card,
               orchestrator=[dataclasses.asdict(d) for d in decisions],
               bundle=dict(kind=bundle.kind, n_max=bundle.n_max,
                           recorded_obs=SC_RECORDED_OBS),
               seconds=time.perf_counter() - t_phase)
    emit("single_cell", **out)
    return out


# ------------------------------------------------------- analysis phase
GATE_TIMEOUT_S = 300
ENGINE_PY = "src/repro_torch/serve/engine.py"


def tick_lines() -> range:
    """The source lines of the serving tick (``live_tick`` in
    ``serve/engine.py``)."""
    import ast
    tree = ast.parse((ROOT / ENGINE_PY).read_text())
    tick = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                and n.name == "live_tick")
    return range(tick.lineno, tick.end_lineno + 1)


def phase_analysis(torch) -> dict:
    """15. The port's analysis gate on the card, and the tick with no
    host sync."""
    import os
    import numpy as np
    from repro_torch import random as rnd
    from repro_torch.fleet.workload import random_fleet
    from repro_torch.launch import serve_fleet
    from repro_torch.policy.adapters import heuristic_greedy_policy
    from repro_torch.serve import engine
    from repro_torch.serve.engine import ServeConfig, serve_stream
    from repro_torch.serve.stream import poisson_request_stream
    from repro_torch.specs.observation import make_spec

    t_phase = time.perf_counter()
    # (a) the gate on the card against the baseline the CPU wrote
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    gate = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "--lint"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=GATE_TIMEOUT_S)
    gate_s = time.perf_counter() - t0
    (OUT / "chip_smoke_analysis.txt").write_text(gate.stdout + gate.stderr)
    check(gate.returncode == 0, f"python -m repro_torch.analysis --check "
          f"--lint passes on the card:\n{gate.stdout[-3000:]}"
          f"{gate.stderr[-3000:]}")

    # (b) the deployment's ticks under set_sync_debug_mode("error"): every
    # run_epoch of the greedy run, then with telemetry and live export,
    # whose window lane steps out of the error mode for its one copy
    make, emit_window = engine.make_serve_engine, engine._emit_window

    def guarded(*args, **kw):
        eng = make(*args, **kw)

        def run_epoch(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return eng.run_epoch(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return eng._replace(run_epoch=run_epoch)

    def lane(*a, **k):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return emit_window(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    runs = {}
    for name, kw in (("greedy", {}),
                     ("telemetry_live", dict(
                         telemetry=True, window_ms=TEL_WINDOW_MS, live=True,
                         live_out=str(OUT / "chip_smoke_analysis.ndjson")))):
        free = serve_fleet.serve(greedy=True, device="cuda", verbose=False,
                                 **SERVE_KW, **kw)
        engine.make_serve_engine, engine._emit_window = guarded, lane
        reset_all_counts()
        try:
            rep = serve_fleet.serve(greedy=True, device="cuda",
                                    verbose=False, **SERVE_KW, **kw)
        finally:
            engine.make_serve_engine, engine._emit_window = make, \
                emit_window
        launches = all_counts()
        n_ticks = rep["n_ticks"]
        check(launches == {"queue_admit": n_ticks,
                           "group_occupancy": 3 * n_ticks,
                           "flash_attention": 0, "wkv6": 0, "ssd": 0},
              f"{name}: the sync-free ticks launch queue_admit once and "
              f"group_occupancy 3 times a tick ({launches} in {n_ticks})")
        for k, v in free["records"].items():
            check(v.tobytes() == rep["records"][k].tobytes(),
                  f"{name}: records[{k}] byte-identical under the error "
                  f"mode")
        runs[name] = dict(n_ticks=n_ticks, launches=launches,
                          served=int(rep["served_requests"]),
                          ms_per_tick=rep["ms_per_tick"])

    # (c) host syncs by source line over epoch 1 (phase 12's count)
    dev = torch.device("cuda")
    k_fleet, k_trace, k_serve, _ = rnd.split(rnd.PRNGKey(SEED, dev), 4)
    scn = random_fleet(k_fleet, CELLS, n_max=N_MAX,
                       cells_per_edge=CELLS_PER_EDGE)
    pol = heuristic_greedy_policy(make_spec("full", N_MAX))
    cfg = ServeConfig(n_max=N_MAX, obs_spec="full", shared_cloud=True,
                      shared_edge=True)
    horizon = ROUNDS * cfg.round_ms
    stream = poisson_request_stream(k_trace, scn, horizon, rate=RATE,
                                    round_ms=cfg.round_ms,
                                    epoch_ms=horizon / SYNC_EPOCHS)
    lines, rep = count_syncs(torch, lambda on_epoch: serve_stream(
        pol, pol.init(SEED, dev), scn, stream, cfg, key=k_serve,
        device=dev, on_epoch=on_epoch), on=1)
    ticks_epoch1 = int(round(stream.epoch_ms / cfg.tick_ms))
    tick = tick_lines()
    in_tick = {k: n for k, n in lines.items()
               if k.startswith(ENGINE_PY + ":")
               and int(k.rsplit(":", 1)[1]) in tick}
    check(in_tick == {}, f"no host sync inside the tick: {in_tick}")
    phase12 = results.get("telemetry", {}).get("deployment", {}).get(
        "sync_lines_epoch1", {}).get("off")
    check(phase12 is None or phase12 == lines,
          f"the count agrees with phase 12's ({phase12} vs {lines})")
    syncs = dict(lines_epoch1=lines, total_epoch1=sum(lines.values()),
                 ticks_epoch1=ticks_epoch1,
                 per_tick=sum(in_tick.values()) / ticks_epoch1,
                 phase12_lines_epoch1=phase12,
                 tick_lines=[tick.start, tick.stop - 1])
    out = dict(gate=dict(rc=gate.returncode, seconds=gate_s,
                         contracts=sum(": collectives=" in x for x in
                                       gate.stdout.splitlines())),
               sync_free=runs, syncs=syncs,
               seconds=time.perf_counter() - t_phase)
    emit("analysis", **out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    OUT.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    card = phase_card(torch)
    ptxas = phase_build()
    kernels = phase_kernels(torch, dev)
    serve = phase_serve(torch)
    phase_parity()
    phase_round_replay(torch)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    lm_kernels = phase_lm_kernels(torch, dev, ptxas)
    lm_serve = phase_lm_serve(torch)
    phase_lm_parity(torch)
    phase_hltrain(torch)
    phase_economy(torch)
    phase_telemetry(torch)
    phase_sharded(torch)
    phase_single_cell(torch)
    phase_analysis(torch)
    for name, k in kernels.items():
        k["launches"] = serve["greedy"]["launches"][name]
    kernels["flash_attention"] = dict(
        lm_kernels["yi-6b"],
        launches=lm_serve["yi-6b"]["launches"]["flash_attention"])
    kernels["wkv6"] = dict(
        lm_kernels["rwkv6-1.6b"],
        launches=lm_serve["rwkv6-1.6b"]["launches"]["wkv6"])
    kernels["ssd"] = dict(
        lm_kernels["zamba2-1.2b"],
        launches=lm_serve["zamba2-1.2b"]["launches"]["ssd"])
    summary = {"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms",
                                 "plain_ms", "bound_ms", "launch_floor_ms",
                                 "bound_by", "library_ms") if key in k}
        for k in kernels.values()]}
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(results, summary=summary), indent=1))
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
