#!/usr/bin/env python3
"""The float32 flash kernel at D in (128, 192]: its two tilings that fit.

    python3 tools/flash_wide_layout.py

Needs one Hopper card and nvcc, as ``chip_smoke.py`` does.  At D = 192
the D <= 128 tiling (8 warps of 16 query rows, 64-key tiles) would need
268,288 bytes of shared memory, more than a CTA may hold (232,448).  Two
tilings fit:

* ``keys32``: 8 warps (128 query rows) and 32-key tiles, 184,320 bytes;
* ``rows64``: 4 warps (64 query rows) and 64-key tiles, 218,112 bytes.

Builds ``csrc/flash_attention.cu`` once with each (the source as it
stands and a copy with ``kWideWarps, kWideBK`` set to the other, both
into the git-ignored ``kernels/_build/``), prints each build's
``-Xptxas -v`` lines for the wide instance, and at each row of
``chip_smoke.py``'s ``FLASH_SHAPES`` with D > 128 (deepseek-v2-236b's
MLA prefill; the same inputs, from the same seed) runs both through the
wrapper: the largest difference from the plain version (the figure
``chip_smoke.py`` holds to atol 3e-5 / rtol 1e-4) and the device time
per call with CUDA events (``chip_smoke.cuda_ms``) in the order A, B, B,
A.  Prints the card's name and power limit and one JSON line per shape;
writes ``chiprun_out/flash_wide_layout.json``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chip_smoke import FLASH_SHAPES, SEED, cuda_ms  # noqa: E402

LAYOUTS = {"keys32": "constexpr int kWideWarps = 8, kWideBK = 32;",
           "rows64": "constexpr int kWideWarps = 4, kWideBK = 64;"}


def build_variants() -> tuple[dict, dict]:
    """({layout: the loaded library}, {layout: ptxas lines of the wide
    instance})."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    src = (_build.CSRC / "flash_attention.cu").read_text()
    present = [line for line in LAYOUTS.values() if line in src]
    if len(present) != 1:
        raise RuntimeError("the source sets neither layout: update LAYOUTS "
                           "to the source")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, ptxas = {}, {}
    for name, line in LAYOUTS.items():
        path = _build.BUILD_DIR / f"flash_attention_{name}.cu"
        path.write_text(src.replace(present[0], line))
        lib_path, log = _build.build(path, force=True)
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in fa._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
        keep, entry = [], False
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                entry = re.search(r"flash_fwd_kernel_tf32ILi16ELi\d+ELi\d+E",
                                  ln) is not None and not re.search(
                                      r"ILi16ELi8ELi64E", ln)
            if entry:
                keep.append(ln.strip())
        ptxas[name] = keep
    return libs, ptxas


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs, ptxas = build_variants()
    print(json.dumps({"ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, b, s, h, kv, d, dv, window, dt in FLASH_SHAPES:
        # every row draws its inputs, as chip_smoke.py does, so each row
        # sees the same inputs there and here
        q, k, v = (torch.randn(b, s, n, w, generator=gen, device=dev)
                   .to(getattr(torch, dt))
                   for n, w in ((h, d), (kv, d), (kv, dv)))
        if d <= 128:
            continue
        plain = fa.flash_attention_plain(q, k, v, causal=True,
                                         window=window)
        row = dict(shape=name, card=card)

        def run(layout):
            fa._lib = lambda: libs[layout]
            return fa.flash_attention(q, k, v, causal=True, window=window)

        for layout in LAYOUTS:
            got = run(layout)
            torch.cuda.synchronize()
            row[layout] = dict(err_plain=float((got - plain).abs().max()),
                               ms=[])
        for layout in ("keys32", "rows64", "rows64", "keys32"):
            row[layout]["ms"].append(
                cuda_ms(torch, lambda: run(layout), iters=10)["ms"])
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, plain
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_wide_layout.json").write_text(
        json.dumps({"card": card, "ptxas": ptxas, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
