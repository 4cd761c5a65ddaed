#!/usr/bin/env python3
"""How the tensor cores read float32 words in a TF32 ``wgmma``, and how
fast the register-A form runs, on the card: the two facts the flash
backward kernel's design rests on.

    python3 tools/tf32_wgmma_probe.py

Needs one Hopper card and nvcc, as ``chip_smoke.py`` does.  Builds a
small CUDA source that includes ``csrc/flash_attention.cu`` (for its
``wgmma``, descriptor and swizzle helpers) into the git-ignored
``kernels/_build/`` and runs:

* ``layout``: one ``wgmma.m64n16k8`` with A (64 x 8) in registers, laid
  out as the backward kernel gathers it, and B (16 x 8) in shared memory
  with the 128-byte swizzle, on small integers (exact in TF32): equal to
  A B^T or not;
* ``read_as``: the same product with one operand carrying float32 words
  whose low 13 bits are set (the other 1): whether the result equals the
  words truncated to TF32, rounded to nearest (``cvt.rna.tf32``), or
  kept whole, for the register operand A and the shared operand B;
* ``rate``: TFLOP/s of back-to-back ``wgmma.m64nNk8`` (register A, B in
  shared memory, three a step as 3xTF32 issues them, each step committed
  and the one before it waited for, or not) at N = 16, 32, 64 and 128,
  with one or two warpgroups a CTA, 528 CTAs, against the 495 TFLOP/s
  TF32 data-sheet peak.

Prints the card's name and power limit and one JSON line a measurement;
writes ``chiprun_out/tf32_wgmma_probe.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

SOURCE = r'''
#include "@CSRC@/flash_attention.cu"
namespace {
// D (64 x 16) = A (registers, as the backward gathers it) . B^T (16 x 8
// in shared memory, K-major, 128-byte swizzle)
__global__ void probe_kernel(const float* a, const float* bsrc, float* d) {
  __shared__ __align__(1024) uint8_t sb[2048];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 512; i += 128) reinterpret_cast<float*>(sb)[i] = 0.f;
  __syncthreads();
  // B's row n, column k (< 8) in a 128-byte-swizzled K-major tile
  const int n = tid / 8, k = tid % 8;
  if (tid < 128)
    *reinterpret_cast<float*>(sb + n * 128 + (((k >> 2) ^ (n & 7)) << 4) +
                              (k & 3) * 4) = bsrc[tid];
  fence_async_smem();
  __syncthreads();
  const int r = 16 * warp + g;
  const uint32_t ar[4] = {
      __float_as_uint(a[r * 8 + t]), __float_as_uint(a[(r + 8) * 8 + t]),
      __float_as_uint(a[r * 8 + t + 4]),
      __float_as_uint(a[(r + 8) * 8 + t + 4])};
  float c[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  wgmma_fence();
  wgmma_tf32_n16(c, ar, desc_sw128(smem_addr(sb), 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(c);
  for (int i = 0; i < 8; ++i)
    d[(16 * warp + g + ((i >> 1) & 1) * 8) * 16 + 8 * (i >> 2) + 2 * t +
      (i & 1)] = c[i];
}

template <int N>
__device__ __forceinline__ void mma_n(float (&c)[N / 2], const uint32_t (&a)[4],
                                      uint64_t db) {
  wgmma_tf32<N>(c, a, db);
}

template <int N, int kWait>
__global__ void __launch_bounds__(256, 1) rate_kernel(float* out, int iters) {
  __shared__ __align__(1024) uint8_t sb[16384];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x)
    reinterpret_cast<float*>(sb)[i] = 1e-3f * (i & 7);
  fence_async_smem();
  __syncthreads();
  float c[N / 2];
  for (int i = 0; i < N / 2; ++i) c[i] = 0.f;
  uint32_t a[4] = {__float_as_uint(1.f), __float_as_uint(2.f),
                   __float_as_uint(3.f), __float_as_uint(4.f)};
  const uint64_t db = desc_sw128(smem_addr(sb), 16, 1024);
  for (int it = 0; it < iters; ++it) {
    a[0] += 1;  // fresh A registers each step, as a gather gives
    a[1] += 1;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 3; ++j) mma_n<N>(c, a, db + 2 * j);
    wgmma_commit();
    if (kWait) wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(c);
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += c[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N>
int rate(float* out, int wait, int iters, int threads, int blocks) {
  if (wait)
    rate_kernel<N, 1><<<blocks, threads>>>(out, iters);
  else
    rate_kernel<N, 0><<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int tf32_probe(const void* a, const void* b, void* d) {
  probe_kernel<<<1, 128>>>(static_cast<const float*>(a),
                           static_cast<const float*>(b),
                           static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tf32_rate(void* out, int n, int wait, int iters, int threads,
                         int blocks) {
  float* o = static_cast<float*>(out);
  switch (n) {
    case 16: return rate<16>(o, wait, iters, threads, blocks);
    case 32: return rate<32>(o, wait, iters, threads, blocks);
    default: return rate<64>(o, wait, iters, threads, blocks);
  }
}
'''
# N = 128 needs a 64-register wrapper the kernel source has no use for
N128 = r'''
namespace {
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      @REGS@
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : @OUTS@
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_n<128>(float (&c)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  wgmma_tf32_n128(c, a, db);
}
}  // namespace
extern "C" int tf32_rate128(void* out, int wait, int iters, int threads,
                            int blocks) {
  return rate<128>(static_cast<float*>(out), wait, iters, threads, blocks);
}
'''
PEAK_TF32 = 495e12


def source() -> str:
    from repro_torch.kernels import _build
    regs = " ".join(f'"{", ".join(f"%{i}" for i in range(j, j + 16))}'
                    f'{", " if j < 48 else ""}"' for j in range(0, 64, 16))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    n128 = N128.replace("@REGS@", regs).replace("@OUTS@", outs)
    return SOURCE.replace("@CSRC@", str(_build.CSRC)) + n128


def trunc(x):
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def rna(x):
    return ((x.view(np.uint32) + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "tf32_wgmma_probe.cu"
    src.write_text(source())
    lib = ctypes.CDLL(str(_build.build(src, force=True)[0]))
    lib.tf32_probe.argtypes = [ctypes.c_void_p] * 3
    lib.tf32_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    lib.tf32_rate128.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    dev = torch.device("cuda")

    def product(a, b):
        d = torch.zeros(64, 16, device=dev)
        at, bt = (torch.as_tensor(x, device=dev) for x in (a, b))
        assert lib.tf32_probe(at.data_ptr(), bt.data_ptr(),
                              d.data_ptr()) == 0
        torch.cuda.synchronize()
        return d.cpu().numpy()

    out = {"card": card}
    rng = np.random.default_rng(0)
    a = rng.integers(-8, 8, (64, 8)).astype(np.float32)
    b = rng.integers(-8, 8, (16, 8)).astype(np.float32)
    out["layout"] = {"exact": bool(np.array_equal(product(a, b), a @ b.T))}
    print(json.dumps(out["layout"]), flush=True)
    vals = (1 + rng.random(64) * 0.999).astype(np.float32)
    ones_a = np.zeros((64, 8), np.float32)
    ones_a[:, 0] = 1
    ones_b = np.zeros((16, 8), np.float32)
    ones_b[:, 0] = 1
    a_vals = np.zeros((64, 8), np.float32)
    a_vals[:, 0] = vals
    b_vals = np.zeros((16, 8), np.float32)
    b_vals[:, 0] = vals[:16]
    read_as = {}
    for operand, got, want in (
            ("register A", product(a_vals, ones_b)[:, 0], vals),
            ("shared B", product(ones_a, b_vals)[0], vals[:16])):
        read_as[operand] = {"truncated": bool(np.array_equal(got, trunc(want))),
                            "rounded": bool(np.array_equal(got, rna(want))),
                            "whole": bool(np.array_equal(got, want))}
    out["read_as"] = read_as
    print(json.dumps({"read_as": read_as}), flush=True)
    buf = torch.empty(528 * 256, device=dev)
    iters, blocks, rates = 4000, 528, []
    for n in (16, 32, 64, 128):
        for wait in (1, 0):
            for threads in (128, 256):
                def launch(k):
                    if n == 128:
                        return lib.tf32_rate128(buf.data_ptr(), wait, k,
                                                threads, blocks)
                    return lib.tf32_rate(buf.data_ptr(), n, wait, k, threads,
                                         blocks)
                assert launch(10) == 0
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                assert launch(iters) == 0
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1)
                flops = blocks * (threads // 128) * iters * 3 * 64 * n * 16
                row = dict(n=n, wait_each_step=bool(wait),
                           warpgroups=threads // 128,
                           tflops=flops / ms / 1e9,
                           share_of_peak=flops / ms / 1e-3 / PEAK_TF32)
                rates.append(row)
                print(json.dumps(row), flush=True)
    out["rate"] = rates
    dst = ROOT / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / "tf32_wgmma_probe.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
