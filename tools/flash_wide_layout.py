#!/usr/bin/env python3
"""The flash kernels at D in (128, 192]: the layouts that fit, per
kernel.

    python3 tools/flash_wide_layout.py

Needs one Hopper card and nvcc, as ``chip_smoke.py`` does.  At D = 192
neither forward instance's D <= 128 layout fits a CTA's shared memory
(232,448 bytes).

float32 (3xTF32 ``mma.sync``): 8 warps of 16 query rows and 64-key tiles
would need 268,288 bytes.  Two tilings fit:

* ``keys32``: 8 warps (128 query rows) and 32-key tiles, 184,320 bytes;
* ``rows64``: 4 warps (64 query rows) and 64-key tiles, 218,112 bytes.

bfloat16 (TMA + ``wgmma``): three 64-column K panels and two V panels of
16 KB a 128-key stage; the D <= 128 ring of three such stages would need
(3 + 3 x 5) x 16 KB = 288 KB.  Two rings fit:

* ``stages3_keys64``: three stages of 64 keys, 3 x 16 KB + 3 x 5 x 8 KB
  + 1 KB of alignment + the mbarriers = 173,136 bytes;
* ``stages2_keys128``: two stages of 128 keys, (3 + 2 x 5) x 16 KB + 1
  KB + the mbarriers = 214,072 bytes.

float32 backward (TMA + 3xTF32 ``wgmma``, dK / dV and dQ kernels over 64
resident rows): the dK / dV kernel's D <= 128 tiling, 32-row streamed
tiles, would need 247,128 bytes at D = 192 / Dv = 128, so it streams
16-row tiles (222,424 bytes) there.  The dQ kernel (no P buffer) fits
either, and ``kBwdWideDqTile`` picks it:

* ``dq32``: 32-row streamed tiles, 230,744 bytes (score products of
  N = 32);
* ``dq16``: 16-row streamed tiles, 165,080 bytes (score products of
  N = 16).

Builds ``csrc/flash_attention.cu`` once with each layout (the source as
it stands and copies with the kernel's layout line set to the other, all
into the git-ignored ``kernels/_build/``, in parallel), prints each
build's ``-Xptxas -v`` lines for the D > 128 instances, and at each row
of ``chip_smoke.py``'s ``FLASH_SHAPES`` with D > 128 (deepseek-v2-236b's
MLA prefill in float32 and in bfloat16; the same inputs, from the same
seed) runs its dtype's layouts through the wrapper: the largest
difference from the plain version (``chip_smoke.py`` holds it to atol
3e-5 / rtol 1e-4 in float32, 3e-2 / 3e-2 in bfloat16), the largest row
error (bfloat16's 1e-2 row bar), and the device time per call with CUDA
events (``chip_smoke.cuda_ms``) in the order A, B, B, A; then at each
row of ``BWD_SHAPES`` with D > 128 (deepseek's training shape) the
backward's layouts: dq, dk, dv's largest difference from the plain
backward over each plain tensor's largest magnitude (``chip_smoke.py``'s
1e-4 bar) and the time, A, B, B, A.  Prints the card's name and power
limit and one JSON line per shape; writes
``chiprun_out/flash_wide_layout.json``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chip_smoke import BWD_SHAPES, FLASH_SHAPES, SEED, cuda_ms  # noqa: E402

# per kernel: {layout: the source line that selects it}, and the mangled
# names of its D > 128 instances
LAYOUTS = {
    "float32": {"keys32": "constexpr int kWideWarps = 8, kWideBK = 32;",
                "rows64": "constexpr int kWideWarps = 4, kWideBK = 64;"},
    "bfloat16": {
        "stages3_keys64": "constexpr int kWideStages = 3, kWideKeys = 64;",
        "stages2_keys128": "constexpr int kWideStages = 2, kWideKeys = 128;"},
    "backward": {
        "dq32": "constexpr int kBwdWideDqTile = 32;",
        "dq16": "constexpr int kBwdWideDqTile = 16;"},
}
WIDE_ENTRIES = {"float32": r"flash_fwd_kernel_tf32ILi16ELi(8ELi32|4ELi64)E",
                "bfloat16": r"flash_fwd_kernel_wgmmaILi3E",
                "backward": r"flash_bwd_(dkdv|dq)_kernelILi3E"}


def build_variants() -> tuple[dict, dict]:
    """({(dtype, layout): the loaded library}, {(dtype, layout): ptxas
    lines of the dtype's D > 128 instances})."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    src = (_build.CSRC / "flash_attention.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for dt, layouts in LAYOUTS.items():
        present = [line for line in layouts.values() if line in src]
        if len(present) != 1:
            raise RuntimeError(f"the source sets no {dt} layout: update "
                               "LAYOUTS to the source")
        for name, line in layouts.items():
            path = _build.BUILD_DIR / f"flash_attention_{dt}_{name}.cu"
            path.write_text(src.replace(present[0], line))
            paths[dt, name] = path
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        built = dict(zip(paths, pool.map(
            lambda p: _build.build(p, force=True), paths.values())))
    libs, ptxas = {}, {}
    for (dt, name), (lib_path, log) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in fa._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
        libs[dt, name] = lib
        keep, entry = [], False
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                entry = re.search(WIDE_ENTRIES[dt], ln) is not None
            if entry:
                keep.append(ln.strip())
        ptxas[dt, name] = keep
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
    ptxas = {f"{dt}/{name}": lines for (dt, name), lines in ptxas.items()}
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
                                         window=window).float()
        row = dict(shape=name, card=card)

        def run(layout):
            fa._lib = lambda: libs[dt, layout]
            return fa.flash_attention(q, k, v, causal=True, window=window)

        a, b_ = LAYOUTS[dt]
        for layout in (a, b_):
            got = run(layout).float()
            torch.cuda.synchronize()
            row[layout] = dict(
                err_plain=float((got - plain).abs().max()),
                row_err_plain=float(((got - plain).norm(dim=-1)
                                     / plain.norm(dim=-1).clamp_min(1e-30))
                                    .max()),
                ms=[])
            del got
        for layout in (a, b_, b_, a):
            row[layout]["ms"].append(
                cuda_ms(torch, lambda: run(layout), iters=10)["ms"])
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, plain
    for name, b, sq, sk, h, kv, d, dv, window in BWD_SHAPES:
        if d <= 128:
            continue
        q = torch.randn(b, sq, h, d, generator=gen, device=dev)
        k = torch.randn(b, sk, kv, d, generator=gen, device=dev)
        v = torch.randn(b, sk, kv, dv, generator=gen, device=dev)
        do = torch.randn(b, sq, h, dv, generator=gen, device=dev)
        o, lse = fa._forward(q, k, v, True, window, d ** -0.5,
                             with_lse=True)
        plain = fa.flash_attention_backward_plain(
            q, k, v, o, lse, do, causal=True, window=window)
        row = dict(shape=f"{name}_backward", card=card)

        def run(layout):
            fa._lib = lambda: libs["backward", layout]
            return fa.flash_attention_backward(q, k, v, o, lse, do,
                                               causal=True, window=window)

        a, b_ = LAYOUTS["backward"]
        for layout in (a, b_):
            got = run(layout)
            torch.cuda.synchronize()
            row[layout] = dict(rel_to_max_err={
                n: float((g - w).abs().max() / w.abs().max())
                for n, g, w in zip(("dq", "dk", "dv"), got, plain)}, ms=[])
            del got
        for layout in (a, b_, b_, a):
            row[layout]["ms"].append(
                cuda_ms(torch, lambda: run(layout), iters=3)["ms"])
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, o, lse, plain
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_wide_layout.json").write_text(
        json.dumps({"card": card, "ptxas": ptxas, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
