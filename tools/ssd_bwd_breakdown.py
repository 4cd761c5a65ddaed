#!/usr/bin/env python3
"""Where the SSD backward's time goes, by taking launches and parts out.

    python3 tools/ssd_bwd_breakdown.py [--also OTHER_SSD_CU]

Needs one CUDA card and nvcc.  Builds variants of
``src/repro_torch/kernels/csrc/ssd.cu`` with launches of the backward
compiled out (so each kernel's time is a difference of two variants'),
with each item's copies waited on as soon as they are issued (what the
overlap of copies with work saves), with the products' ``wgmma`` taken
out (the compiler then drops their operand gathers too: what the rest
costs) or the chunk pass's writes of dx, dB and dC, or with clock64
counts of the chunk pass's stages, and times ``ssd_backward`` with each
at zamba2-1.2b's training shape (B 4, S 2048, H 64, P = N = 64, G 1,
f32, with an initial state and a final state's gradient) with CUDA
events after warm-up, as ``chip_smoke.py`` times (device time only: the
card waits in a spin while the host enqueues the call), the shipped
kernels first and last.  A variant's output is wrong by design: only its
time means something.  The shipped kernels' largest distance to the
float64 plain backward, over each gradient's largest magnitude, is
printed beside (and whether ``--also``'s gradients are the same bits).
Prints one JSON line and writes ``chiprun_out/ssd_bwd_breakdown.json``
with the card's ``nvidia-smi`` name and power limit.
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

# (first line of a statement in ssd.cu, its number of lines, macro that
# compiles it out)
GUARDS = (
    ("  ssd_bwd_local<<<grid, kBThreads, local_smem, s>>>(", 2, "NO_LOCAL"),
    ("  ssd_bwd_scan<<<static_cast<unsigned>((quads + kBScanThreads - 1) /",
     5, "NO_SCAN"),
    ("  ssd_bwd_chunk<<<grid, kBThreads, chunk_smem, s>>>(", 2, "NO_CHUNK"),
    ("    wgmma_tf32<kN>(c, al, dh);", 3, "NO_WGMMA"),
    ("      tma_store_tile(maps.dx, q.perm_out, sDYL, k.h, t0, k.bi);", 2,
     "NO_STORES"),
    ("      tma_store_tile(maps.dc, q.perm_out, sW2, k.h, t0, k.bi);", 1,
     "NO_STORES"),
)
# (line in ssd.cu, a wait for the copies it issues, macro under which the
# wait follows it)
WAITS = (
    ("      load(item + gridDim.x, s ^ 1);",
     "      mbar_wait(bar(s ^ 1), ((it + 1) >> 1) & 1);", "SYNC_COPIES"),
    ("    if (next < items) load(next, sBL, sXL);",
     "    if (next < items) mbar_wait(bar, (it + 1) & 1);", "SYNC_COPIES"),
)
# the chunk pass's stages (ssd.cu's "[A]" to "[F]" comments): under
# STAGE_CLOCKS thread 0 of every CTA adds the clock64 cycles from each
# stage's start to the next one's into a device array read back through
# ssd_bwd_stage_clocks
STAGES = ("[A]", "[B]", "[C]", "[D]", "[E]", "[F]")
CLOCK_DECL = (
    "#ifdef STAGE_CLOCKS\n"
    "__device__ unsigned long long g_stage_clk[6];\n"
    "#endif\n")
CLOCK_VARS = ("#ifdef STAGE_CLOCKS\n"
              "  long long clk_last = 0;\n  int clk_prev = -1;\n#endif")
CLOCK_TICK = (
    "#ifdef STAGE_CLOCKS\n"
    "    if (threadIdx.x == 0) {{\n"
    "      const long long now = clock64();\n"
    "      if (clk_prev >= 0) atomicAdd(&g_stage_clk[clk_prev],\n"
    "          static_cast<unsigned long long>(now - clk_last));\n"
    "      clk_prev = {i};\n      clk_last = now;\n    }}\n#endif")
CLOCK_READ = (
    "#ifdef STAGE_CLOCKS\n"
    "int ssd_bwd_stage_clocks(unsigned long long* out, int reset) {\n"
    "  if (reset) {\n    unsigned long long z[6] = {0, 0, 0, 0, 0, 0};\n"
    "    return static_cast<int>(cudaMemcpyToSymbol(g_stage_clk, z,"
    " sizeof z));\n  }\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stage_clk,"
    " 6 * sizeof(unsigned long long)));\n}\n#endif\n")
VARIANTS = {
    "shipped": [],
    "local only": ["NO_SCAN", "NO_CHUNK"],
    "local + scan": ["NO_CHUNK"],
    "no launch": ["NO_LOCAL", "NO_SCAN", "NO_CHUNK"],
    "scan only": ["NO_LOCAL", "NO_CHUNK"],
    "copies waited at once": ["SYNC_COPIES"],
    "no products": ["NO_WGMMA"],
    "local only, no products": ["NO_SCAN", "NO_CHUNK", "NO_WGMMA"],
    "local + scan, no products": ["NO_CHUNK", "NO_WGMMA"],
    "no dx, dB, dC stores": ["NO_STORES"],
    "stage clocks": ["STAGE_CLOCKS"],
    "stage clocks, copies waited at once": ["STAGE_CLOCKS", "SYNC_COPIES"],
}


def variant_source(text: str) -> str:
    lines = text.split("\n")
    for first, count, macro in GUARDS:
        if first not in lines:
            raise SystemExit(f"ssd_bwd_breakdown: marker not found: "
                             f"{first!r}")
        i = lines.index(first)
        lines[i:i + count] = [f"#ifndef {macro}", *lines[i:i + count],
                              "#endif"]
    for line, wait, macro in WAITS:
        if line not in lines:
            raise SystemExit(f"ssd_bwd_breakdown: marker not found: "
                             f"{line!r}")
        i = lines.index(line)
        lines[i + 1:i + 1] = [f"#ifdef {macro}", wait, "#endif"]
    for i, stage in enumerate(STAGES):
        at = [j for j, line in enumerate(lines)
              if line.startswith(f"    // {stage}")]
        if len(at) != 1:
            raise SystemExit(f"ssd_bwd_breakdown: stage {stage} not found")
        lines.insert(at[0], CLOCK_TICK.format(i=i))
    for marker, text, after in (
            ("// Pass 3: every gradient of a sub-chunk", CLOCK_DECL, False),
            ("  const Frag32 f;  // the warpgroups split", CLOCK_VARS, True),
            ('}  // extern "C"', CLOCK_READ, False)):
        at = [j for j, line in enumerate(lines) if line.startswith(marker)]
        if len(at) != 1:
            raise SystemExit(f"ssd_bwd_breakdown: marker not found: "
                             f"{marker!r}")
        lines.insert(at[0] + after, text)
    return "\n".join(lines)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--also", type=Path, help="another ssd.cu with the same "
                    "C interface (an earlier version), timed beside the "
                    "shipped one: shipped, it, the variants, it, shipped")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_breakdown: no CUDA device is visible",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import cuda_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd as sk
    OUT.mkdir(exist_ok=True)
    work = _build.BUILD_DIR / "ssd_bwd_breakdown"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "ssd_bwd_variants.cu"
    src.write_text(variant_source((_build.CSRC / "ssd.cu").read_text()))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    def build(item):
        i, (name, macros) = item
        lib = work / f"ssd_bwd_variant{i}.so"
        source = work / "ssd_bwd_also.cu" if name == "also" else src
        proc = subprocess.run(
            [_build.nvcc_path(), *flags, *(f"-D{m}" for m in macros),
             "-I", str(_build.CSRC), "-o", str(lib), str(source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        return name, lib

    builds = list(enumerate(VARIANTS.items()))
    if opts.also:
        also = work / "ssd_bwd_also.cu"
        also.write_text(opts.also.read_text())
        builds.append((len(builds), ("also", [])))
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        libs = dict(pool.map(build, builds))
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

    dev = torch.device("cuda")
    b, s, h, p, g, n = 4, 2048, 64, 64, 1, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    x, dy = rn(b, s, h, p), rn(b, s, h, p)
    dt = torch.nn.functional.softplus(rn(b, s, h))
    args = (x, dt, -torch.exp(rn(h)), rn(b, s, g, n), rn(b, s, g, n),
            torch.linspace(0.5, 1.5, h, device=dev), rn(b, h, p, n), dy,
            rn(b, h, p, n))
    use(libs["shipped"])
    got = sk.ssd_backward(*args)
    want = sk.ssd_backward_plain(*(t.double() for t in args))
    names = ("dx", "ddt", "da", "db", "dc", "dd", "dinit")
    errs = {k: float((g_.double() - w).abs().max() / w.abs().max())
            for k, g_, w in zip(names, got, want)}
    del want
    if opts.also:
        use(libs["also"])
        errs["also_bit_identical"] = all(
            torch.equal(x_, y_) for x_, y_ in zip(got, sk.ssd_backward(*args)))
    del got
    items = b * h * -(-s // 64)

    def stage_cycles(name):
        use(libs[name])
        lib = _build._loaded[_build.CSRC / "ssd.cu"]
        clocks = (ctypes.c_ulonglong * 6)()
        lib.ssd_bwd_stage_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        sk.ssd_backward(*args)
        torch.cuda.synchronize()
        _build.raise_on(lib.ssd_bwd_stage_clocks(None, 1), "stage clocks")
        sk.ssd_backward(*args)
        torch.cuda.synchronize()
        _build.raise_on(lib.ssd_bwd_stage_clocks(clocks, 0), "stage clocks")
        return {st: clocks[i] / items for i, st in enumerate(STAGES)}

    cycles = {name: stage_cycles(name) for name in VARIANTS
              if "STAGE_CLOCKS" in VARIANTS[name]}
    ms = {}
    order = ["shipped", *(["also"] if opts.also else []),
             *[v for v in list(VARIANTS)[1:]
               if "STAGE_CLOCKS" not in VARIANTS[v]],
             *(["also"] if opts.also else []), "shipped"]
    for name in order:
        use(libs[name])
        ms[name if name not in ms else f"{name}, again"] = cuda_ms(
            torch, lambda: sk.ssd_backward(*args), iters=10)["ms"]
    _build._loaded.pop(_build.CSRC / "ssd.cu", None)
    shipped = (ms["shipped"] + ms["shipped, again"]) / 2
    by_kernel = {
        "ssd_bwd_local": ms["local only"] - ms["no launch"],
        "ssd_bwd_scan": ms["local + scan"] - ms["local only"],
        "ssd_bwd_scan alone": ms["scan only"] - ms["no launch"],
        "ssd_bwd_chunk": shipped - ms["local + scan"],
        "wrapper (allocations, sums of heads and partials)":
            ms["no launch"],
        "ssd_bwd_chunk without products": ms["no products"]
        - ms["local + scan, no products"],
        "ssd_bwd_local without products": ms["local only, no products"]
        - ms["no launch"]}
    report = {"card": card, "shape": dict(B=b, S=s, H=h, P=p, G=g, N=n,
                                          dtype="float32"),
              "ms": ms, "by_kernel_ms": by_kernel, "errs": errs,
              "chunk_stage_cycles_per_item": cycles}
    print(json.dumps(report), flush=True)
    (OUT / "ssd_bwd_breakdown.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
