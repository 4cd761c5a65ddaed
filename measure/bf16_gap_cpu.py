#!/usr/bin/env python3
"""How far the port's bfloat16 LM logits lie from the reference's, in
units of the reference's own bfloat16-vs-float32 gap, over seeds and
thread counts: the sweep that sets ``tests/test_torch_bf16.py``'s ``K``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python measure/bf16_gap_cpu.py \
        [--arch yi-6b ...] [--seeds 8] [--out /tmp/bf16_gap.json]

For each smoke config of ``tests/test_torch_bf16.ARCHS`` (MoE configs
dropless) and each seed 0 .. seeds - 1, the reference's bfloat16 weights
(``init_params`` under the config's bfloat16 dtypes, from
``PRNGKey(seed)``) and a batch of B 2, S 33 tokens from the same seed run
three ways: the reference in bfloat16, the reference in float32 on the
same weights widened (the gap: its own rounding), and the port in
bfloat16 on the same weights carried across bit for bit
(``convert.lm_params``), once under ``torch.set_num_threads(1)`` and
once at the default thread count.  For the prefill's last logits (32
tokens) and one decode step it prints one JSON line per (arch, seed,
threads): the gap, the port's distance to the reference's bfloat16
logits, and their ratio; then per arch the largest ratio over every
line and path, ``k_min``, twice that (the least ``K`` the tests may
use), the mean ratio, and ``f32_share``: the mean over lines and paths
of the port's distance to the reference's float32 logits over the
reference's own (below 1: the port's bfloat16 lies nearer the float32
model than the reference's does).

``--round-a`` runs the port with the SSD's decay rate A rounded to
bfloat16 before the scan, as the reference's ``mamba2_forward`` rounds
it (``A.astype(xs_c.dtype)``), to test that cast site (zamba2-1.2b).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
from test_torch_bf16 import ARCHS, logit_gaps  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=ARCHS)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--round-a", action="store_true")
    args = ap.parse_args(argv)
    if args.round_a:
        from repro_torch.models import mamba2
        ssd = mamba2.ssd
        mamba2.ssd = lambda x, dt, a, *r, **kw: ssd(
            x, dt, a.to(x.dtype).float(), *r, **kw)
    default_threads = torch.get_num_threads()
    rows, worst, ratios, shares = [], {}, {}, {}
    for arch in args.arch or ARCHS:
        for seed in range(args.seeds):
            for threads in sorted({1, default_threads}):
                torch.set_num_threads(threads)
                g = logit_gaps(arch, seed)
                row = dict(arch=arch, seed=seed, threads=threads, **g)
                print(json.dumps(row), flush=True)
                rows.append(row)
                worst[arch] = max(worst.get(arch, 0.0),
                                  *g["ratio"].values())
                ratios.setdefault(arch, []).extend(g["ratio"].values())
                shares.setdefault(arch, []).extend(
                    g["port_vs_f32"][p] / g["gap"][p] for p in g["gap"])
        torch.set_num_threads(default_threads)
        print(json.dumps({"arch": arch, "max_ratio": worst[arch],
                          "k_min": 2 * worst[arch],
                          "mean_ratio": statistics.mean(ratios[arch]),
                          "f32_share": statistics.mean(shares[arch])}),
              flush=True)
    summary = {"max_ratio": worst, "k_min": {a: 2 * r for a, r in
                                             worst.items()},
               "mean_ratio": {a: statistics.mean(r)
                              for a, r in ratios.items()},
               "f32_share": {a: statistics.mean(r)
                             for a, r in shares.items()},
               "seeds": args.seeds, "round_a": args.round_a,
               "threads": sorted({1, default_threads})}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(summary, rows=rows),
                                             indent=1))
    return summary


if __name__ == "__main__":
    main()
