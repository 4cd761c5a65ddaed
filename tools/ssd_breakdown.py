#!/usr/bin/env python3
"""Where the SSD kernel's time goes, by taking parts of it out.

    python3 tools/ssd_breakdown.py

Needs one CUDA card and nvcc.  Builds variants of
``src/repro_torch/kernels/csrc/ssd.cu`` with one part of the chunk loop
compiled out (each of the four products, the next chunk's copies, all
products, products and copies) or with the TF32 split made free (hi =
the raw bits, lo = 0: the mma count stays, the split's arithmetic goes),
and times each at zamba2-1.2b's Mamba2 shape (S 2048, H 64, P = N = 64,
G 1, f32) at batch 4 and batch 1, with CUDA events after warm-up, the
shipped kernel first and last.  A variant's output is wrong by design:
only its time means something.  Taking out ``scores x`` leaves the
scores unused, so the compiler drops C B^T and the decay as well; the
other variants keep everything else.  Prints one JSON line per batch
and writes ``chiprun_out/ssd_breakdown.json`` with the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"

# (marker line in ssd.cu, macro that compiles it out)
GUARDS = (
    ("    if (more) load_tiles(nxt, t0 + kQ);", "NO_LOADS"),
    ("      mma_3xtf32_tiles(scr, ah4, al4, b0, b1, jmax);", "NO_SCORES"),
    ("      mma_3xtf32_tiles(off, ah4, al4, s0, s1, kPT - 1);", "NO_OFF"),
    ("      mma_3xtf32_tiles(diag, ah4, al4, x0, x1, kPT - 1);", "NO_DIAG"),
    ("          mma_3xtf32_tiles(acc, ah4, al4, b0, b1, 3);", "NO_STATE"),
)
SPLIT = ("  hi = tf32(x);\n  lo = tf32(x - __uint_as_float(hi));",
         "#ifdef FREE_SPLIT\n  hi = __float_as_uint(x);\n  lo = 0u;\n#else\n"
         "  hi = tf32(x);\n  lo = tf32(x - __uint_as_float(hi));\n#endif")
PRODUCTS = ["NO_SCORES", "NO_OFF", "NO_DIAG", "NO_STATE"]
VARIANTS = {
    "shipped": [],
    "no C B^T": ["NO_SCORES"],
    "no scores x (nor C B^T)": ["NO_DIAG"],
    "no C S^T": ["NO_OFF"],
    "no state update": ["NO_STATE"],
    "no next-chunk copies": ["NO_LOADS"],
    "free TF32 split": ["FREE_SPLIT"],
    "no products": PRODUCTS,
    "no products, no copies": PRODUCTS + ["NO_LOADS"],
}


def variant_source(text: str) -> str:
    for line, macro in GUARDS:
        if line not in text:
            raise SystemExit(f"ssd_breakdown: marker not found: {line!r}")
        text = text.replace(line, f"#ifndef {macro}\n{line}\n#endif", 1)
    return text


def variant_header(text: str) -> str:
    """The shared header with split() behind FREE_SPLIT."""
    if SPLIT[0] not in text:
        raise SystemExit("ssd_breakdown: split() not found")
    return text.replace(SPLIT[0], SPLIT[1], 1)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_breakdown: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd as sk
    OUT.mkdir(exist_ok=True)
    work = _build.BUILD_DIR / "ssd_breakdown"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "ssd_variants.cu"
    src.write_text(variant_source((_build.CSRC / "ssd.cu").read_text()))
    # found before csrc/'s: the including file's directory comes first
    (work / "hopper.cuh").write_text(
        variant_header((_build.CSRC / "hopper.cuh").read_text()))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    def build(item):
        i, (name, macros) = item
        lib = work / f"ssd_variant{i}.so"
        proc = subprocess.run(
            [_build.nvcc_path(), *flags, *(f"-D{m}" for m in macros),
             "-I", str(_build.CSRC), "-o", str(lib), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        return name, lib

    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(pool.map(build, enumerate(VARIANTS.items())))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    def use(lib_path):
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in sk._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _build._loaded[_build.CSRC / "ssd.cu"] = lib

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    dev = torch.device("cuda")
    report = {"card": card, "shape": dict(S=2048, H=64, P=64, N=64, G=1,
                                          dtype="float32"), "ms": {}}
    for b in (4, 1):
        gen = torch.Generator(device=dev).manual_seed(0)
        rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
        args = (rn(b, 2048, 64, 64),
                torch.nn.functional.softplus(rn(b, 2048, 64)),
                -torch.exp(rn(64)), rn(b, 2048, 1, 64), rn(b, 2048, 1, 64),
                torch.linspace(0.5, 1.5, 64, device=dev))
        row = {}
        for name in [*VARIANTS, "shipped"]:
            use(libs[name])
            key = name if name not in row else "shipped, again"
            row[key] = time_ms(lambda: sk.ssd(*args))
        report["ms"][f"B{b}"] = row
        print(json.dumps({"batch": b, "ms": row}), flush=True)
    _build._loaded.pop(_build.CSRC / "ssd.cu", None)
    (OUT / "ssd_breakdown.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
