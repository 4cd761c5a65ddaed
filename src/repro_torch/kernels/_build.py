"""Build and load the port's CUDA sources at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library bound with ``ctypes``: a
file that includes no PyTorch header builds in seconds.  Libraries go to
``_build/`` beside this module (listed in ``.gitignore``), named by a
hash of the source and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.  A missing ``nvcc`` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler PyTorch's build helpers find, else the one on
    ``PATH``; raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use and need the "
                           "CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(source: Path, force: bool = False) -> tuple[Path, str]:
    """Compile ``source`` unless its library exists (or ``force``).
    Returns the library path and nvcc's output (``-Xptxas -v`` register
    and shared-memory lines), empty when nothing was compiled."""
    out = library_path(source)
    if out.exists() and not force:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders race harmlessly
    return out, proc.stdout + proc.stderr


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, with
    ``argtypes`` declared from ``signatures`` ({function: argtypes}; every
    function returns a C ``int``)."""
    source = CSRC / f"{name}.cu"
    lib = _loaded.get(source)
    if lib is None:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[source] = lib
    return lib
