"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``ops/csrc`` have a plain C interface, so ``nvcc``
compiles them in seconds (no PyTorch headers).  The shared library lands
in ``turborc_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads at once.  A failed build raises; nothing falls back.

    python -m turborc_tpu_torch.ops.build    # build and print the ptxas report
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("rans_kernel.cu",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: every pointer and the stream are c_void_p.
SIGNATURES = {
    "trc_model": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "trc_decode": [_P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    "trc_coder": [_P] * 5 + [_I] * 2 + [_P],
    "trc_place": [_P] * 5 + [_I] * 3 + [_P],
}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _tag() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels if this source hash has no library yet.

    Returns {"path", "seconds", "built", "ptxas"}: ``ptxas`` is the
    compiler's register/shared-memory report (kept beside the library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _tag()
    lib = BUILD_DIR / f"librans_kernel_{tag}.so"
    log = BUILD_DIR / f"librans_kernel_{tag}.log"
    if lib.exists():
        return dict(path=str(lib), seconds=0.0, built=False,
                    ptxas=log.read_text() if log.exists() else "")
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    report = res.stdout + res.stderr
    log.write_text(report)
    os.replace(tmp, lib)
    return dict(path=str(lib), seconds=seconds, built=True, ptxas=report)


@functools.cache
def load() -> ctypes.CDLL:
    """Build at first use and load the library with typed entry points."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    info = build()
    print(f"{info['path']} built={info['built']} {info['seconds']:.1f}s")
    print(info["ptxas"])
