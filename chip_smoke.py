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
   tokens identical.

Any failed check raises, so the exit code is non-zero.  Ends with the
``nvidia-smi`` line, the kernels' JSON summary and, last,
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

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
    ids, _, _, _ = _tick_buckets(stream, cfg.tick_ms, 10)
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


def _device_time(torch, fn, matches=()) -> tuple[dict, object]:
    """Run ``fn`` under ``torch.profiler``; device ops, busy ms, the five
    kernels with the most device time and, for each name in ``matches``,
    the time of the kernels whose name holds it."""
    _, events, result = traced(torch, fn)
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
