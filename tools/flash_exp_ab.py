#!/usr/bin/env python3
"""The float32 flash kernel's exp: ``expf`` against ``exp2f(x log2 e)``.

    python3 tools/flash_exp_ab.py

Needs one Hopper card and nvcc, as ``chip_smoke.py`` does.  Builds
``csrc/flash_attention.cu`` twice, once with each form of ``exp_f32``
(the source as it stands and a copy with the other form, both into the
git-ignored ``kernels/_build/``), and at each float32 row of
``chip_smoke.py``'s ``FLASH_SHAPES`` (the same inputs, from the same
seed) runs both through the wrapper:

* ``err_plain``: the largest difference from the plain version, the
  figure ``chip_smoke.py`` holds to atol 3e-5 / rtol 1e-4;
* ``err_f64``: the largest difference from the same attention evaluated
  in float64, beside the plain version's own, so the error that each
  exp form and the 3xTF32 products add can be told apart;
* ``ms``: device time per call with CUDA events (``chip_smoke.cuda_ms``),
  in the order A, B, B, A.

Prints the card's name and power limit and one JSON line per shape;
writes ``chiprun_out/flash_exp_ab.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chip_smoke import FLASH_SHAPES, SEED, cuda_ms  # noqa: E402

EXP_FORMS = {"expf": "return expf(x);",
             "exp2f": "return exp2f(x * 1.4426950408889634f);"}


def build_variants() -> dict:
    """{form: the loaded library built with that form of exp_f32}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    src = (_build.CSRC / "flash_attention.cu").read_text()
    present = [body for body in EXP_FORMS.values() if body in src]
    if len(present) != 1:
        raise RuntimeError("exp_f32's body is neither form: update "
                           "EXP_FORMS to the source")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for form, body in EXP_FORMS.items():
        path = _build.BUILD_DIR / f"flash_attention_{form}.cu"
        path.write_text(src.replace(present[0], body))
        lib = ctypes.CDLL(str(_build.build(path)[0]))
        for fn, argtypes in fa._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
        libs[form] = lib
    return libs


def attention_f64(q, k, v, window: int, heads: int = 4):
    """Causal (windowed) GQA attention in float64, a few heads at a
    time."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    i = torch.arange(s, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    out = torch.empty((b, s, h, v.shape[-1]), dtype=torch.float64,
                      device=q.device)
    for bi in range(b):
        for h0 in range(0, h, heads):
            hs = torch.arange(h0, min(h0 + heads, h), device=q.device)
            qh = q[bi][:, hs].double().transpose(0, 1) * d ** -0.5
            kh, vh = (t[bi][:, hs // g].double().transpose(0, 1)
                      for t in (k, v))
            p = torch.softmax((qh @ kh.transpose(1, 2))
                              .masked_fill(~mask, float("-inf")), dim=-1)
            out[bi][:, hs] = (p @ vh).transpose(0, 1)
    return out


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
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, b, s, h, kv, d, dv, window, dt in FLASH_SHAPES:
        # every row draws its inputs, as chip_smoke.py does, so each f32
        # row sees the same inputs there and here
        q, k, v = (torch.randn(b, s, n, w, generator=gen, device=dev)
                   .to(getattr(torch, dt))
                   for n, w in ((h, d), (kv, d), (kv, dv)))
        if dt != "float32":
            continue
        plain = fa.flash_attention_plain(q, k, v, causal=True,
                                         window=window)
        exact = attention_f64(q, k, v, window)
        row = dict(shape=name, card=card,
                   plain_err_f64=float((plain.double() - exact).abs().max()))

        def run(form):
            fa._lib = lambda: libs[form]
            return fa.flash_attention(q, k, v, causal=True, window=window)

        for form in EXP_FORMS:
            got = run(form)
            torch.cuda.synchronize()
            row[form] = dict(
                err_plain=float((got - plain).abs().max()),
                err_f64=float((got.double() - exact).abs().max()), ms=[])
        del exact
        for form in ("expf", "exp2f", "exp2f", "expf"):
            row[form]["ms"].append(
                cuda_ms(torch, lambda: run(form), iters=10)["ms"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_exp_ab.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
