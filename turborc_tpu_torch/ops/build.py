"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``ops/csrc`` have a plain C interface, so ``nvcc``
compiles each in seconds (no PyTorch headers).  Every source becomes its
own shared library in ``turborc_tpu_torch/_build/`` (git-ignored), named
by a hash of the sources, the shared header and the flags, so a changed
source rebuilds and an unchanged one loads at once.  The sources that
need building are compiled in parallel, one ``nvcc`` each.  A failed
build raises; nothing falls back.

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
HEADERS = ("rans_common.cuh",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of each source: every pointer and the stream are c_void_p.
SIGNATURES = {
    "rans_kernel.cu": {
        # K2: tile and geometry, then rans_kernel.model_launch's threads,
        # shared-memory bytes and five region offsets
        "trc_model": [_P] * 4 + [_I] * 15 + [_P],
        # K1 / K5: tile and geometry, then rans_kernel.decode_launch's
        # threads, shared-memory bytes and six region offsets
        "trc_decode": [_P] * 5 + [_I] * 17 + [_P],
        "trc_decode_x2": [_P] * 5 + [_I] * 17 + [_P],
        # K3: tile, S and G
        "trc_coder": [_P] * 5 + [_I] * 2 + [_P],
        # K4: tile (and the chunk counts' scratch), then
        # rans_kernel.place_launch's S, G, R, chunk, chunks, threads, scratch
        "trc_place": [_P] * 6 + [_I] * 7 + [_P],
    },
    "rans_o1_kernel.cu": {
        # K7: tile and rate
        "trc_o1_model": [_P] * 4 + [_I] * 3 + [_P],
        # K6: tile and rate
        "trc_o1_decode": [_P] * 6 + [_I] * 4 + [_P],
    },
    "bittree_kernel.cu": {
        # K9: tile
        "trc_tree_model": [_P] * 3 + [_I] * 2 + [_P],
        # K8: tile
        "trc_tree_decode": [_P] * 4 + [_I] * 3 + [_P],
    },
    "rans_lane_kernel.cu": {
        # L1: K, L, n_seg, then the span (share, sync, lsync, arows,
        # srows, rate)
        "trc_lane_model": [_P] * 4 + [_I] * 9 + [_P],
        # L2: S, L
        "trc_lane_coder": [_P] * 4 + [_I] * 2 + [_P],
        # L3: the lanes' words, offsets and lengths, the tables, the
        # output; K, L, W (words), n_seg, then the span
        "trc_lane_decode": [_P] * 6 + [_I] * 10 + [_P],
        # L4: words, offsets, lengths, cdf, output; K, L, W
        "trc_lane_static_decode": [_P] * 5 + [_I] * 3 + [_P],
        # L5: cols, id 59's warm tables, probs; K, L, n_seg
        "trc_lane_o1r_model": [_P] * 4 + [_I] * 3 + [_P],
        # L6: L3's words, offsets and lengths, L5's tables, the output;
        # K, L, W, n_seg
        "trc_lane_o1r_decode": [_P] * 6 + [_I] * 4 + [_P],
        # L7: cols, probs; K, L
        "trc_lane_o1_model": [_P] * 2 + [_I] * 2 + [_P],
        # L8: words, offsets, lengths, output; K, L, W
        "trc_lane_o1_decode": [_P] * 4 + [_I] * 3 + [_P],
        # L9: cols, probs; K, L
        "trc_lane_nibble_model": [_P] * 2 + [_I] * 2 + [_P],
        # L10: words, offsets, lengths, cdf (null: adaptive), output;
        # K, L, W
        "trc_lane_nibble_decode": [_P] * 5 + [_I] * 3 + [_P],
    },
    "rans_bit_kernel.cu": {
        # L11: cols, probs, the order-1 tables (null at order 0), the FSM
        # table (null but for sf); K, L, order, predictor, the two rates,
        # the FSM's states and start state
        "trc_lane_bit_model": [_P] * 4 + [_I] * 8 + [_P],
        # L12: words, offsets, lengths, output, the order-1 tables, the
        # FSM table; K, L, W, order, predictor, rates, states, start
        "trc_lane_bit_decode": [_P] * 6 + [_I] * 9 + [_P],
    },
}
SOURCES = tuple(SIGNATURES)


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _tag() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> list[dict]:
    """Compile every source that has no library for this hash yet, all
    at once, one ``nvcc`` each.

    Returns one {"source", "path", "seconds", "built", "ptxas"} per
    source: ``ptxas`` is the compiler's register/shared-memory report
    (kept beside the library), ``seconds`` the wall time of the parallel
    build (0 when nothing was built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _tag()
    infos, jobs = [], []
    for src in SOURCES:
        stem = src.rsplit(".", 1)[0]
        lib = BUILD_DIR / f"lib{stem}_{tag}.so"
        log = BUILD_DIR / f"lib{stem}_{tag}.log"
        info = dict(source=src, path=str(lib), seconds=0.0, built=False,
                    ptxas=log.read_text() if log.exists() else "")
        infos.append(info)
        if not lib.exists():
            tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
            cmd = [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / src)]
            jobs.append((info, lib, log, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    t0 = time.perf_counter()
    failed = []
    for info, lib, log, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{info['source']} ({proc.returncode}):\n{err}")
            continue
        log.write_text(out + err)
        os.replace(tmp, lib)
        info.update(built=True, ptxas=out + err)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    for info, *_ in jobs:
        info["seconds"] = seconds
    return infos


@functools.cache
def load() -> dict:
    """Build at first use and load the libraries; returns the typed C
    entry points by name."""
    fns = {}
    for info in build():
        lib = ctypes.CDLL(info["path"])
        for name, argtypes in SIGNATURES[info["source"]].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


if __name__ == "__main__":
    for info in build():
        print(f"{info['path']} built={info['built']} "
              f"{info['seconds']:.1f}s")
        print(info["ptxas"])
