#!/usr/bin/env python3
"""The WKV6 backward kernels' time by chunk length.

    python3 tools/bwd_chunks.py

Needs one CUDA card and nvcc.  At rwkv6-1.6b's training shape (B 4, S
2048, H 32, N 64), f32, runs the backward at every chunk length L in
(32, 64, 128, 256, 512) (``_build.steps_for`` replaced for the run, the
forward's chunk states taken at the same L) and times it with CUDA
events after warm-up, as ``chip_smoke.py`` times; each gradient's
largest distance to the float64 plain backward, over its largest
magnitude, beside it, and one call's device ms by kernel from
``torch.profiler``.  Marks the L the wrapper picks
(``_build.chunk_len``).  Prints one JSON line and writes
``chiprun_out/bwd_chunks.json`` with the card's ``nvidia-smi`` name and
power limit.  The SSD backward has no chunk length to choose (one
sub-chunk of 64 steps an item): ``tools/ssd_bwd_breakdown.py`` times it.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
STEPS = (32, 64, 128, 256, 512)


def rel_errs(got, want) -> dict:
    return {i: float((g.double() - w).abs().max() / w.abs().max())
            for i, (g, w) in enumerate(zip(got, want)) if w is not None}


def device_split(torch, fn, names) -> dict:
    """Device ms of one call of ``fn`` by kernel, from ``torch.profiler``
    (device activity only): each of ``names`` (the kernels whose name
    holds it) and ``other`` (the wrappers' sums and copies)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(names, 0.0)
    split["other"] = 0.0
    for e in prof.key_averages():
        key = next((n for n in names if n in e.key), "other")
        split[key] += e.device_time_total / 1e3
    return split


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bwd_chunks: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import cuda_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6 as wk
    OUT.mkdir(exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    picked = _build.steps_for
    results = {"card": card}

    b, s, h, n = 4, 2048, 32, 64
    r, k, v, do = (rn(b, s, h, n) for _ in range(4))
    lw = -torch.exp(rn(b, s, h, n))
    u = 0.5 * rn(h, n)
    ds = rn(b, h, n, n)
    want = wk.wkv6_backward_plain(*(t.double() for t in (r, k, v, lw, u, do,
                                                         ds)))
    rows = {}
    for steps in STEPS:
        _build.steps_for = lambda t, steps=steps: steps
        cs = wk._launch(r, k, v, lw, u, steps)[2]
        run = lambda: wk.wkv6_backward(r, k, v, lw, u, cs, do, ds)
        rows[steps] = dict(errs=rel_errs(run(), want),
                           ms=cuda_ms(torch, run, iters=10)["ms"],
                           by_kernel_ms=device_split(torch, run, (
                               "wkv6_bwd_local", "wkv6_bwd_scan",
                               "wkv6_bwd_chunk")))
        del cs
    _build.steps_for = picked
    results["rwkv6-1.6b"] = dict(
        shape=dict(B=b, S=s, H=h, N=n),
        wrapper_steps=_build.chunk_len(b * h, s, n_sms), by_steps=rows)
    print(json.dumps({"rwkv6-1.6b": results["rwkv6-1.6b"]}), flush=True)
    (OUT / "bwd_chunks.json").write_text(json.dumps(results, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
