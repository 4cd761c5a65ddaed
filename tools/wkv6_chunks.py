#!/usr/bin/env python3
"""The WKV6 kernel's time by chunk length and by pass.

    python3 tools/wkv6_chunks.py

Needs one CUDA card and nvcc.  At rwkv6-1.6b's prefill shape (B 4, S
2048, H 32, N 64, f32) and at batch 1 (B 1), times the three launches of
``src/repro_torch/kernels/csrc/wkv6.cu`` together at each chunk length
L in (16, 32, 64, 128, 256, 512) with CUDA events after warm-up (the card
kept busy while the host enqueues, as ``chip_smoke.py`` times), and
splits each into its passes (the chunk pass from zero, the scan, the
emitting pass) from ``torch.profiler``'s device events, each with its
error against the plain version in float64.  Marks the L the wrapper
picks.  Prints one JSON line per shape and writes
``chiprun_out/wkv6_chunks.json`` with the card's ``nvidia-smi`` name
and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
STEPS = (16, 32, 64, 128, 256, 512)
SHAPES = (("rwkv6-1.6b", 4, 2048, 32, 64), ("batch_1", 1, 2048, 32, 64))


def pass_ms(torch, fn, reps: int = 5) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"local": 0.0, "scan": 0.0, "emit": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "wkv6_kernel" not in e.name:
            continue
        part = ("scan" if "scan" in e.name
                else "emit" if "true" in e.name else "local")
        out[part] += e.time_range.elapsed_us() / 1e3 / reps
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wkv6_chunks: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import cuda_ms
    from repro_torch.kernels import wkv6 as wk
    OUT.mkdir(exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {"card": card}
    for name, b, s, h, n in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        r, k, v = (torch.randn(b, s, h, n, generator=g, device=dev)
                   for _ in range(3))
        lw = -torch.exp(torch.randn(b, s, h, n, generator=g, device=dev))
        u = 0.5 * torch.randn(h, n, generator=g, device=dev)
        want, _ = wk.wkv6_plain(*(t.double() for t in (r, k, v, lw, u)))
        rows = {}
        for steps in STEPS:
            run = lambda: wk._launch(r, k, v, lw, u, steps)
            err = float((run()[0].double() - want).abs().max())
            timed = cuda_ms(torch, run, iters=10)
            rows[steps] = dict(ms=timed["ms"], max_abs_err=err,
                               ctas_per_pass=b * h * -(-s // steps),
                               passes_ms=pass_ms(torch, run),
                               blocker_held=timed["blocker_held"])
        results[name] = dict(shape=dict(B=b, S=s, H=h, N=n),
                             wrapper_steps=wk._build.chunk_len(b * h, s,
                                                               n_sms),
                             by_steps=rows)
        print(json.dumps({name: results[name]}), flush=True)
    (OUT / "wkv6_chunks.json").write_text(json.dumps(results, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
