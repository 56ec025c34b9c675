#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (turborc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--before COMMIT]

Builds the port's CUDA kernels with nvcc (one process per source, in
parallel), holds each kernel against its plain PyTorch version, drives
every ported path through the port's ``compress``/``decompress``
(``rans-cdf-o0-p`` on K1-K4 and, split-state, on K2, K3, K4 and K5;
``rans-cdf-r1-p`` on K7, K3, K4 and K6; ``rans-auto`` over both
flagships; the bit-tree ``rc-p`` on K9, K3, K4 and K8; the per-lane scan
codecs ``rans-cdf-o0`` (the default) and ``rans-cdf-s8`` on L1, L2 and
L3, ``rans-static`` on L2 and L4, the order-1 ``rans-cdf-r1`` on L5, L2
and L6 and ``rans-cdf-o1`` on L7, L2 and L8; the nibble codecs ``rc4``
on L9, L2 and L10 and ``rc4c`` on L2 and L10's static instantiation; the
bitwise byte-tree codecs ``rc-o0``, ``rcc-o1``, ``rc-o0-ss``,
``rcc-o1-ss``, ``rc-o0-sf`` and ``rcc-o1-sf`` on L11, L2 and L12),
checks every container against the golden hashes the JAX package wrote,
then times the kernels.  The
decoders on a shared-memory ring of stream words (the o0 K1 and K5, the
o1 K6, the bit-tree K8) are also held against their plain versions where
the ring wraps and on corrupt streams, the placement K4 on edge cases of
emit (every lane, none, one, slot counts that are not a multiple of its
chunk), the coder K3 on edge cases of probabilities and states
(``coder-edge``), the bit-tree model K9 where its input ring holds less
than a stage or ends inside one, and on tiles its C entry must refuse,
and the lane kernels L1-L4 at 4 to 8192 lanes, spans of 1 to 128 lanes
and on corrupt streams and length tables, beside the codecs' payloads
on the card against the CPU's (``lane-kernels-vs-plain``), the coder L2
on edge cases of probabilities, states and slot counts and L4 on CDFs
at their extremes (``lane-edge``), and L5-L8 (with L2 on their probs)
at their codecs' shapes, at 14 warm-table segments over 512 lanes and on
corrupt streams, and the models L5 and L7 on runs of one byte,
alternations, all 256 bytes in turn, K of 1, 7 and 9 and segments that do
not divide the lanes (``lane-o1-kernels-vs-plain``), L9 and both L10s
(``lane-nibble-kernels-vs-plain``) and L11 and L12 at every (predictor,
order) (``lane-bit-kernels-vs-plain``) at the full shape of a default
4 MB block, the plain versions on the host, then on runs, alternations,
all 256 bytes in turn, bytes whose depth-4 nodes are siblings, K of 1,
7, 9 and 37, extreme CDFs and predictor rates, a random FSM table and
corrupt streams, the bitwise wrappers must refuse an FSM past 32,768
states and L10's static wrapper a cdf that is not non-decreasing from 0
to 2^15.  With ``--before COMMIT``, L5-L12 are timed in turns against
those of a ``git archive COMMIT`` unpacked in ``_archive/COMMIT/``.  It imports no JAX
and nothing of ``turborc_tpu``; the corpora under
``turborc_tpu/bench/_data/`` are read as files.

The phases run in a child process under a wall-clock budget, so a kernel
that hangs becomes a non-zero exit that names the phase.  The last line,
printed only when every phase passed, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "turborc_tpu" / "bench" / "_data"
GOLDEN = ROOT / "turborc_tpu_torch" / "golden" / "o0p.json"
GOLDEN_R1 = ROOT / "turborc_tpu_torch" / "golden" / "r1p.json"
GOLDEN_RCP = ROOT / "turborc_tpu_torch" / "golden" / "rcp.json"
GOLDEN_X2 = ROOT / "turborc_tpu_torch" / "golden" / "o0p_x2.json"
GOLDEN_LANE = ROOT / "turborc_tpu_torch" / "golden" / "lane.json"
GOLDEN_LANE_O1 = ROOT / "turborc_tpu_torch" / "golden" / "lane_o1.json"
GOLDEN_BIT = ROOT / "turborc_tpu_torch" / "golden" / "bit.json"
BUDGET_S = 600
BENCH_GEOM = "g64c8s8y8l32a4r4"
BENCH_GEOM_X2 = BENCH_GEOM + "x2"
# --before COMMIT: the timing-before-after phase builds the sources of
# _archive/COMMIT/ (a git archive of COMMIT unpacked there) that hold the
# kernels in REDESIGNED and times those against the current ones.  Their
# C signatures there, as (pointers, ints) before the stream: those of
# 1b4e577, the same as now.  Without it the phase is skipped.
BEFORE_FLAG = "--before"
BEFORE_ARGS = {"trc_lane_o1r_model": (4, 3), "trc_lane_o1r_decode": (6, 4),
               "trc_lane_o1_model": (2, 2), "trc_lane_o1_decode": (4, 3),
               "trc_lane_bit_model": (4, 8), "trc_lane_bit_decode": (6, 9),
               "trc_lane_nibble_model": (2, 2),
               "trc_lane_nibble_decode": (5, 3)}
# The C entry of a kernel where it is not trc_<kernel>: L10's static
# instantiation shares the adaptive one's.
ENTRY = {"lane_nibble_static_decode": "trc_lane_nibble_decode"}
ARCHIVE = ROOT / "_archive"
CSRC_REL = "turborc_tpu_torch/ops/csrc"
CHILD_FLAG = "--child"
CHILD_DONE = "chip_smoke: all phases passed"
CSRC = "turborc_tpu_torch/ops/csrc/"
SOURCE = {k: CSRC + "rans_kernel.cu"
          for k in ("model", "coder", "place", "decode", "decode_x2")}
SOURCE.update({k: CSRC + "rans_o1_kernel.cu"
               for k in ("o1_model", "o1_decode")})
SOURCE.update({k: CSRC + "bittree_kernel.cu"
               for k in ("tree_model", "tree_decode")})
SOURCE.update({k: CSRC + "rans_lane_kernel.cu"
               for k in ("lane_model", "lane_coder", "lane_decode",
                         "lane_static_decode", "lane_o1r_model",
                         "lane_o1r_decode", "lane_o1_model",
                         "lane_o1_decode", "lane_nibble_model",
                         "lane_nibble_decode", "lane_nibble_static_decode")})
SOURCE.update({k: CSRC + "rans_bit_kernel.cu"
               for k in ("lane_bit_model", "lane_bit_decode")})
REPLACES = {
    "model": "turborc_tpu/ops/pallas/rans_kernel.py:807",
    "coder": "turborc_tpu/ops/pallas/rans_kernel.py:883",
    "place": "turborc_tpu/ops/pallas/rans_kernel.py:1017",
    "decode": "turborc_tpu/ops/pallas/rans_kernel.py:407",
    "o1_model": "turborc_tpu/ops/pallas/rans_o1_kernel.py:266",
    "o1_decode": "turborc_tpu/ops/pallas/rans_o1_kernel.py:124",
    "decode_x2": "turborc_tpu/ops/pallas/rans_kernel.py:569",
    "tree_decode": "turborc_tpu/ops/pallas/bittree_kernel.py:203",
    "tree_model": "turborc_tpu/ops/pallas/bittree_kernel.py:333",
    # the lane kernels replace XLA scans (no Pallas kernel): the JAX
    # package's device passes of ids 56 / 58 and 42
    "lane_model": "turborc_tpu/codecs/rans_cdf_s8.py:134",
    "lane_coder": "turborc_tpu/ops/rans.py:75",
    "lane_decode": "turborc_tpu/codecs/rans_cdf_s8.py:182",
    "lane_static_decode": "turborc_tpu/codecs/rans_static.py:55",
    # and those of ids 59 and 64
    "lane_o1r_model": "turborc_tpu/codecs/rans_cdf_r1.py:117",
    "lane_o1r_decode": "turborc_tpu/codecs/rans_cdf_r1.py:144",
    "lane_o1_model": "turborc_tpu/codecs/rans_cdf_o1.py:38",
    "lane_o1_decode": "turborc_tpu/codecs/rans_cdf_o1.py:63",
    # those of ids 41 and 40
    "lane_nibble_model": "turborc_tpu/codecs/rans_nibble.py:38",
    "lane_nibble_decode": "turborc_tpu/codecs/rans_nibble.py:52",
    "lane_nibble_static_decode": "turborc_tpu/codecs/rans_nibble.py:80",
    # and those of ids 1, 2, 101-104
    "lane_bit_model": "turborc_tpu/codecs/rc_bit.py:71",
    "lane_bit_decode": "turborc_tpu/codecs/rc_bit.py:100",
}
# Kernels timed against a parent's with --before.
REDESIGNED = ("lane_o1r_model", "lane_o1r_decode", "lane_o1_model",
              "lane_o1_decode", "lane_bit_model", "lane_bit_decode",
              "lane_nibble_model", "lane_nibble_decode",
              "lane_nibble_static_decode")
# Each path's kernels in stage order: model, coder, place, decode.
KERNELS = {"o0": ("model", "coder", "place", "decode"),
           "o1": ("o1_model", "coder", "place", "o1_decode"),
           "x2": ("model", "coder", "place", "decode_x2"),
           "tree": ("tree_model", "coder", "place", "tree_decode")}
# The lane kernels each per-lane scan codec runs.
LANE = {"rans-cdf-o0": ("lane_model", "lane_coder", "lane_decode"),
        "rans-cdf-s8": ("lane_model", "lane_coder", "lane_decode"),
        "rans-static": ("lane_coder", "lane_static_decode")}
# The lane kernels each order-1 per-lane scan codec runs: model, coder,
# decode.
LANE_O1 = {"rans-cdf-r1": ("lane_o1r_model", "lane_coder", "lane_o1r_decode"),
           "rans-cdf-o1": ("lane_o1_model", "lane_coder", "lane_o1_decode")}
# The lane kernels of the nibble codecs rc4 (id 41) and rc4c (id 40).
NIBBLE = {"rc4": ("lane_nibble_model", "lane_coder", "lane_nibble_decode"),
          "rc4c": ("lane_coder", "lane_nibble_static_decode")}
# The bitwise byte-tree codecs, (order, predictor) each; every one runs
# L11, L2 and L12 (BIT_KERNELS).
BIT = {"rc-o0": (0, "s"), "rcc-o1": (1, "s"), "rc-o0-ss": (0, "ss"),
       "rcc-o1-ss": (1, "ss"), "rc-o0-sf": (0, "sf"), "rcc-o1-sf": (1, "sf")}
BIT_KERNELS = ("lane_bit_model", "lane_coder", "lane_bit_decode")
# H100 SXM peaks: HBM3 bytes/s, and the float32 rate outside the tensor
# cores, used for 32-bit integer ops (taking the higher of the two rates
# keeps this a lower bound).
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


def log(*parts) -> None:
    print(*parts, flush=True)


T_START = time.monotonic()


def phase(name: str) -> None:
    log(f"at {time.monotonic() - T_START:.1f} s")
    log(f"phase {name}")


# ---------------------------------------------------------------------------
# child: the phases
# ---------------------------------------------------------------------------

def _sync():
    import torch
    torch.cuda.synchronize()


def _smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def phase_build(before: str | None):
    """Build the port's sources and, beside them, the sources of commit
    ``before`` (from _archive/<before>/) that hold the REDESIGNED kernels;
    returns {kernel: that library's path}, empty without ``before``."""
    import torch
    from turborc_tpu_torch.ops import build
    phase("build")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    jobs = []
    if before is not None:
        src = ARCHIVE / before / CSRC_REL
        for name in REDESIGNED:
            cu = Path(SOURCE[name]).name
            if not (src / cu).exists():
                raise FileNotFoundError(f"{BEFORE_FLAG} {before}: no {src}/"
                                        f"{cu} (unpack a git archive of the "
                                        "commit there)")
            lib = build.BUILD_DIR / f"lib{Path(cu).stem}_{before}.so"
            if all(job[1] != lib for job in jobs):
                build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
                jobs.append((cu, lib, subprocess.Popen(
                    [build.nvcc(), *build.FLAGS, "-I", str(src), "-o",
                     str(lib), str(src / cu)], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)))
    infos = build.build()
    build.load()
    for info in infos:
        log(f"build: {info['path']} built={info['built']} "
            f"nvcc {info['seconds']:.2f} s (sources in parallel)")
        # ptxas -v: "Compiling entry function 'X'" then "Used N registers"
        fn = None
        for line in info["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '\w*?"
                          r"(lane_static_decode|lane_model|lane_coder|"
                          r"lane_decode|lane_o1_model|lane_o1_decode|"
                          r"lane_nibble_model|lane_nibble_decode|"
                          r"lane_bit_model|lane_bit_decode|bit_fill|"
                          r"tree_model|tree_decode|decode_x2|"
                          r"o1_model|o1_decode|place_count|model|coder|"
                          r"place|decode)"
                          r"_kernel", line)
            if m:
                fn = m.group(1)
                if fn.startswith("lane_o1") and "O1Rank" in line:
                    fn = fn.replace("lane_o1", "lane_o1r")  # id 59's
                if fn == "lane_nibble_decode" and "ILb1E" in line:
                    fn = "lane_nibble_static_decode"  # id 40's
                t = re.search(r"Pred(SS|SF|S)ELi(\d)E", line)
                if fn.startswith("lane_bit") and t:
                    fn = f"{fn}<{t.group(1).lower()},{t.group(2)}>"
            elif ("Used" in line or "stack frame" in line) and fn:
                log(f"ptxas {fn}: {line.split(':', 1)[-1].strip()}")
    libs = {}
    for cu, lib, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of {before}'s {cu} failed:\n{err}")
        log(f"build: {lib} ({before}'s {cu})")
        for name in REDESIGNED:
            if Path(SOURCE[name]).name == cu:
                libs[name] = lib
    return libs


def _corpus(name: str, n: int | None = None):
    import numpy as np
    return np.fromfile(DATA / name, np.uint8, count=-1 if n is None else n)


def _max_abs(a, b) -> int:
    import torch
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(a.device, torch.int64)).abs().max())


def _codec(kind: str):
    """The codec module whose ``encode_args`` feeds path ``kind``."""
    from turborc_tpu_torch.codecs import rans_cdf_o0_p as C0
    from turborc_tpu_torch.codecs import rans_cdf_r1_p as C1
    from turborc_tpu_torch.codecs import rc_tree as CT
    return {"o0": C0, "x2": C0, "o1": C1, "tree": CT}[kind]


def _decode_fn(kind: str, args, geom, kernel: bool):
    """gstreams -> (bytes, final states): path ``kind``'s decoder
    (``KERNELS``), the kernel or its plain version, on ``args``' tables
    and K."""
    from turborc_tpu_torch.ops import bittree_kernel as B
    from turborc_tpu_torch.ops import rans_kernel as K_
    from turborc_tpu_torch.ops import rans_o1_kernel as K1
    K = args.K
    if kind == "tree":
        fn = B.tree_decode_tile if kernel else B.tree_decode_plain
        extra = (geom,) if kernel else ()
        return lambda gs: fn(gs, K, args.tree, *extra)
    fn = {"o0": (K_.decode_tile, K_.decode_plain),
          "x2": (K_.decode_tile_x2, K_.decode_x2_plain),
          "o1": (K1.decode_tile, K1.decode_plain)}[kind][not kernel]
    return lambda gs: fn(gs, K, args.hi_tbl, args.lo_tbl, geom)


def _stages(kind: str, args, geom, kernels: bool):
    """The encode-decode chain of one block's arguments: model -> coder ->
    place -> decode of path ``kind`` (``KERNELS``), through the kernels
    (``kernels``) or their plain versions.  Split-state (x2) runs coder
    and place once per stream set, on the even and the odd slots; its
    stages then return both sets' outputs in one flat tuple."""
    import torch
    from turborc_tpu_torch.ops import bittree_kernel as B
    from turborc_tpu_torch.ops import rans_kernel as K_
    from turborc_tpu_torch.ops import rans_o1_kernel as K1
    G, K = geom.groups, args.K
    cols = args.block.T.contiguous().reshape(K, G, 128)
    m, _, _, d = KERNELS[kind]
    coder = K_.coder if kernels else K_.coder_plain
    place = K_.place if kernels else K_.place_plain
    if kind == "tree":
        model = ((lambda c: B.tree_model(c, args.tree, geom)) if kernels
                 else (lambda c: B.tree_model_plain(c, args.tree)))
    else:
        mod = K1 if kind == "o1" else K_
        mfn = mod.model if kernels else mod.model_plain
        model = lambda c: mfn(c, args.hi_tbl, args.lo_tbl, geom)  # noqa: E731
    decode = _decode_fn(kind, args, geom, kernels)
    if kind != "x2":
        return ((m, model, lambda o: (cols,)),
                ("coder", coder, lambda o: (o[m], args.init_states)),
                ("place", place, lambda o: (*o["coder"], geom)),
                (d, decode, lambda o: (o["place"][0],)))

    def coder2(probs_h, init_h, probs_l, init_l):
        return (*coder(probs_h, init_h), *coder(probs_l, init_l))

    def place2(words_h, emit_h, state_h, words_l, emit_l, state_l):
        return (*place(words_h, emit_h, state_h, geom),
                *place(words_l, emit_l, state_l, geom))

    return ((m, model, lambda o: (cols,)),
            ("coder", coder2,
             lambda o: (o[m][0::2].contiguous(), args.init_states[0],
                        o[m][1::2].contiguous(), args.init_states[1])),
            ("place", place2, lambda o: o["coder"]),
            (d, decode, lambda o: (torch.stack(o["place"][0::2]),)))


def _segments() -> int:
    """cudaMalloc calls of PyTorch's caching allocator so far."""
    import torch
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def _run_path(stages, mallocs: dict | None = None):
    """Run the stages in order; returns every output and the per-stage
    milliseconds (CUDA events).  With ``mallocs``, adds each stage's
    cudaMalloc calls (new allocator segments) to ``mallocs[stage]``: a
    wrapper's output that the allocator's cache cannot hold is a
    cudaMalloc inside the timed span."""
    import torch
    outs, ms = {}, {}
    for name, fn, mk in stages:
        a = mk(outs)
        seg = _segments()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs[name] = fn(*a)
        end.record()
        end.synchronize()
        ms[name] = start.elapsed_time(end)
        if mallocs is not None:
            mallocs[name] = mallocs.get(name, 0) + _segments() - seg
    return outs, ms


def _compare(kern: dict, plain: dict) -> dict:
    """Exact comparison, kernel vs plain, of every output of each stage."""
    err = {}
    for name in kern:
        k, p = kern[name], plain[name]
        k = k if isinstance(k, tuple) else (k,)
        p = p if isinstance(p, tuple) else (p,)
        err[name] = max(_max_abs(a, b) for a, b in zip(k, p))
        if err[name] != 0:
            raise AssertionError(f"{name} kernel differs from its plain "
                                 f"version: max abs err {err[name]}")
    return err


def _check_block(label: str, args, outs: dict, decode: str) -> None:
    import torch
    out, fstates = outs[decode]
    if not (torch.equal(out.reshape(args.K, -1).T, args.block)
            and torch.equal(fstates, args.init_states)):
        raise AssertionError(f"kernels {label}: decode did not return the "
                             "block and the seeded states")


# Geometries that drive the o0 kernels' other branches at 64 KB: per-lane
# models (share 1), a full-warp set, shared-memory set sums (share 64,
# 128), static lo rows (arows 4, 0), srows > arows, and rate 9.
BRANCH_GEOMS = ("g2c2s1y2l4a16r4", "g4c4s32y4l8a0r0", "g1c8s64y8l32a16r4",
                "g1c8s128y8l32a8r2u9", "g2c2s8y2l4a4r4", "g2c8s16y8l16a16r20")
# The o1 kernels at the default geometry (1 MB: 4 warm-table segments)
# and at small ones: groups 1, 2 and 4, chunk 2 and 8, the 600 KB case
# with two segments over two groups, one group at K = 2048, and id 61's
# g4 and g8 (K = 2048 and 1024), where K7 has 16 and 32 CTAs.
O1_GEOMS = ((None, 1 << 20), ("g1c2s8y2l4a16r4", 1 << 16),
            ("g2c8s8y4l32a16r4", 600_000), ("g4c2s8y2l4a16r4", 1 << 16),
            ("g1c8s8y4l32a16r4", 1 << 18), ("g4c8s8y4l32a16r4", 1 << 20),
            ("g8c8s8y4l32a16r4", 1 << 20))


# The bit-tree kernels at groups 1, 2 and 4, chunk 2 and 8, K of 128 to
# 1176 byte steps, and at the default geometry on 1 MB; then K9's input
# ring at K = 14, below one stage of 16 byte steps, and K = 24, not a
# multiple of it.
TREE_GEOMS = (("g1c2s8y2l4a16r4", 1 << 16), ("g2c8s8y4l32a16r4", 300_000),
              ("g4c2s8y2l4a16r4", 1 << 16), (None, 1 << 20),
              ("g1c2s8y2l4a16r4", 2000), ("g2c8s8y4l32a16r4", 5000))


def _kernel_cases(label: str, kind: str, cases, dev,
                  min_wraps: int = 0) -> None:
    """Each case (geometry, bytes) through path ``kind``'s kernels and
    their plain versions: every output equal, and the decode gives the
    block and the seeded states back.  With ``min_wraps``, every group
    stream must hold that many times the decoders' ring of words."""
    from turborc_tpu_torch.ops import rans_kernel as K_
    phase(label)
    for geom, data in cases:
        args = _codec(kind).encode_args(data, geom, dev)
        kern, _ = _run_path(_stages(kind, args, geom, kernels=True))
        plain, _ = _run_path(_stages(kind, args, geom, kernels=False))
        err = _compare(kern, plain)
        _check_block(geom.spec, args, kern, KERNELS[kind][3])
        note = ""
        if min_wraps:  # words of the longest group stream of each set
            words = [int(gl.max()) - 256 for gl in kern["place"][1::2]]
            if max(words) < min_wraps * K_.RING_WORDS:
                raise AssertionError(f"{label}: {words} words a stream "
                                     f"set, under {min_wraps} rings")
            note = (f"; words of the longest group stream per set {words}"
                    f" = {[round(w / K_.RING_WORDS, 1) for w in words]} "
                    "rings")
        log(f"{kind} kernels {geom.spec} n={data.size} K={args.K}: equal to "
            f"plain, tolerance 0 (max abs err {err}); decode returns the "
            f"block{note}")


# The decoders' ring wraps: one group at K = 2048 on 256 KB of textbwt.
# o0: about 11 rings of words in the group stream (4 at least); under x2
# the lo set's stream wraps as often, the hi set's (mostly rank-0
# nibbles) holds under half a ring; o1 (K6) and bit-tree (K8): the same
# bytes at the default geometry cut to one group.
RING_CASES = (("o0", "g1c8s8y8l32a4r4"), ("x2", "g1c8s8y8l32a4r4x2"),
              ("o1", "g1c8s8y4l32a16r4"), ("tree", "g1c8s8y4l32a16r4"))
# Corrupt streams for K1, K5, K6 and K8: two groups, K = 256 (o0) or 512
# (o1, bit-tree).
CORRUPT_CASES = (("o0", "g2c8s8y8l32a4r4"), ("x2", "g2c8s8y8l32a4r4x2"),
                 ("o1", "g2c8s8y4l32a16r4"), ("tree", "g2c8s8y4l32a16r4"))


def phase_decode_cases(dev) -> None:
    """K1, K5, K6 and K8 where the ring wraps many times, and on corrupt
    streams: flipped words, and streams cut short (fewer rows than the
    block needs, down to the two state rows).  Each kernel equals its
    plain version, final states included; a hang would overrun the
    budget."""
    import torch
    from turborc_tpu_torch.ops.geom import Geom
    text = _corpus("textbwt_16777216.bin", 1 << 18)
    for kind, spec in RING_CASES:
        _kernel_cases("decode-ring-wrap", kind, [(Geom.parse(spec), text)],
                      dev, min_wraps=4)
    phase("decode-corrupt")
    gen = torch.Generator().manual_seed(20261017)
    for kind, spec in CORRUPT_CASES:
        geom = Geom.parse(spec)
        args = _codec(kind).encode_args(text[:1 << 17], geom, dev)
        stages = _stages(kind, args, geom, kernels=True)
        outs, _ = _run_path(stages[:3])
        gs = stages[3][2](outs)[0]
        R = gs.shape[-2]
        used = max(int(gl.max()) for gl in outs["place"][1::2]) // 128
        flip = gs.clone().reshape(-1, R * 128)
        at = torch.randint(256, R * 128, (flip.shape[0], 64), generator=gen)
        bits = torch.randint(1, 1 << 16, at.shape, generator=gen,
                             dtype=torch.int32)
        flip.scatter_(1, at.to(dev), flip.gather(1, at.to(dev))
                      ^ bits.to(dev))
        cases = {"flipped words": flip.reshape(gs.shape),
                 f"R cut to {used // 2} of {used} rows":
                     gs[..., :used // 2, :].contiguous(),
                 "R cut to 2": gs[..., :2, :].contiguous()}
        for what, bad in cases.items():
            k_out, k_fs = _decode_fn(kind, args, geom, True)(bad)
            p_out, p_fs = _decode_fn(kind, args, geom, False)(bad)
            err = max(_max_abs(k_out, p_out), _max_abs(k_fs, p_fs))
            if err:
                raise AssertionError(f"decode-corrupt {spec} {what}: kernel "
                                     f"differs from plain by {err}")
            wrong = int((k_out.reshape(args.K, -1).T != args.block).sum())
            log(f"decode-corrupt {kind} {spec} {what}: kernel equals plain "
                f"(max abs err 0); {wrong} bytes differ from the block")


# K3 on constructed tiles: (S, G).  S = 1, S below, at and past one stage
# (64 slots) and not a multiple of it; G = 1 and 64.
CODER_EDGES = ((1, 1), (1, 64), (63, 1), (64, 2), (65, 1), (4133, 64),
               (4096, 64))
CODER_FREQS = (1, 2, 32767, 32768)  # the extremes of a 15-bit frequency
CODER_STATES = (1 << 15, (1 << 31) - 1)  # the least and the largest state


def phase_coder_edge(dev) -> None:
    """K3 against coder_plain on the CODER_EDGES tiles: half the slots take
    a frequency of CODER_FREQS, the rest one drawn from [1, 2^15], each with
    a low that keeps low + freq <= 2^15; half the lanes start at a state of
    CODER_STATES, the rest at one drawn from [2^15, 2^31).  Words, emit
    flags and flush states equal (tolerance 0)."""
    import torch
    from turborc_tpu_torch.ops import rans_kernel as K_
    phase("coder-edge")
    gen = torch.Generator(device=dev).manual_seed(20261019)
    for S, G in CODER_EDGES:
        shape = (S, G, 128)
        edge = torch.tensor(CODER_FREQS, device=dev)[
            torch.randint(0, len(CODER_FREQS), shape, generator=gen,
                          device=dev)]
        freq = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5,
                           edge, torch.randint(1, (1 << 15) + 1, shape,
                                               generator=gen, device=dev))
        low = (torch.rand(shape, generator=gen, device=dev)
               * ((1 << 15) - freq + 1)).to(torch.int64).clamp(
                   max=(1 << 15) - freq)
        probs = ((low << 16) | freq).to(torch.int32)
        init = torch.randint(1 << 15, 1 << 31, (G, 128), generator=gen,
                             device=dev, dtype=torch.int64)
        pick = torch.randint(0, 2, (G, 128), generator=gen, device=dev)
        init = torch.where(pick == 0, init,
                           torch.tensor(CODER_STATES, device=dev)[
                               torch.randint(0, 2, (G, 128), generator=gen,
                                             device=dev)]).to(torch.int32)
        k = K_.coder(probs, init)
        want = K_.coder_plain(probs, init)
        err = max(_max_abs(a, b) for a, b in zip(k, want))
        if err:
            raise AssertionError(f"coder-edge S={S} G={G}: kernel differs "
                                 f"from plain by {err}")
        D = K_.CODER_SLOTS
        stages = -(-S // D)
        log(f"coder-edge S={S} G={G} ({G * 128 // K_.CODER_LANES} CTAs, "
            f"{stages} stages of {D} slots, the top one "
            f"{S - (stages - 1) * D}; {int(k[1].sum())} words emitted): "
            "equal to plain, tolerance 0 (max abs err 0)")


def phase_kernels(dev) -> None:
    import dataclasses
    from turborc_tpu_torch.ops.geom import Geom
    full = _corpus("textbwt_16777216.bin", 1 << 20)
    real = _corpus("realsrcbwt_16777216.bin", 1 << 20)
    o0 = [(Geom.parse(BENCH_GEOM), full), (Geom(), full)] + [
        (Geom.parse(spec), full[:1 << 16]) for spec in BRANCH_GEOMS]
    _kernel_cases("kernels-vs-plain", "o0", o0, dev)
    _kernel_cases("o1-kernels-vs-plain", "o1",
                  [(Geom.parse(spec) if spec else Geom(), real[:n])
                   for spec, n in O1_GEOMS], dev)
    _kernel_cases("x2-kernels-vs-plain", "x2",
                  [(dataclasses.replace(g, nstates=2), d) for g, d in o0],
                  dev)
    _kernel_cases("tree-kernels-vs-plain", "tree",
                  [(Geom.parse(spec) if spec else Geom(), full[:n])
                   for spec, n in TREE_GEOMS], dev)
    _tree_model_refusals(dev)


def _tree_model_refusals(dev) -> None:
    """K9's wrapper refuses misaligned cols, and ``trc_tree_model`` tiles
    it cannot take, each as cudaErrorInvalidValue (1) before any launch:
    a negative K, no group, cols 1 byte past a 16-byte boundary.  No
    launch is counted."""
    import torch
    from turborc_tpu_torch.ops import bittree_kernel as B
    from turborc_tpu_torch.ops import rans_kernel as K_
    from turborc_tpu_torch.ops.geom import Geom
    K, G = 16, 1
    buf = torch.zeros(K * G * 128 + 16, dtype=torch.uint8, device=dev)
    cols, off = buf[:-16].view(K, G, 128), buf[1:1 - 16].view(K, G, 128)
    tree = torch.ones(256, dtype=torch.int32, device=dev)
    probs = torch.empty((2 * K, G, 128), dtype=torch.int32, device=dev)
    before = B.launches["tree_model"]
    try:
        B.tree_model(off, tree, Geom(groups=G))
    except ValueError as e:
        log(f"tree-kernels-vs-plain: the K9 wrapper refuses cols 1 byte past "
            f"a 16-byte boundary ({e})")
    else:
        raise AssertionError("tree_model took misaligned cols")
    for what, cargs in (("K = -1", [cols, tree, probs, -1, G]),
                        ("G = 0", [cols, tree, probs, K, 0]),
                        ("cols 1 byte past a 16-byte boundary",
                         [off, tree, probs, K, G])):
        try:
            K_.launch("tree_model", "trc_tree_model", *cargs,
                      counts=B.launches)
        except RuntimeError as e:
            if not str(e).endswith("CUDA error 1"):
                raise
        else:
            raise AssertionError(f"trc_tree_model took a tile with {what}")
        log(f"tree-kernels-vs-plain: trc_tree_model refuses {what} (CUDA "
            "error 1, no launch)")
    if B.launches["tree_model"] != before:
        raise AssertionError("tree-kernels-vs-plain: a refused tile counted "
                             "a launch")


def _golden(path: Path) -> dict:
    return {c["name"]: c for c in json.loads(path.read_text())["large"]}


def _kernel_modules():
    from turborc_tpu_torch.ops import bittree_kernel as B
    from turborc_tpu_torch.ops import rans_bit_kernel as BK
    from turborc_tpu_torch.ops import rans_kernel as K_
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
    from turborc_tpu_torch.ops import rans_nibble_kernel as NK
    from turborc_tpu_torch.ops import rans_o1_kernel as K1
    return K_, K1, B, LK, LO, NK, BK


def _launch_counts() -> dict:
    return {k: v for mod in _kernel_modules() for k, v in mod.launches.items()}


def _reset_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def _roundtrip(label: str, case: dict, needs: tuple, dev) -> dict:
    """One path through api.compress/decompress, with every launch count
    set to 0 just before it and read just after; the kernels in ``needs``
    must have launched."""
    from turborc_tpu_torch import api
    from turborc_tpu_torch.ops.geom import Geom
    from turborc_tpu_torch.utils.config import CodecConfig
    phase(label)
    data = _corpus(case["file"], case.get("n"))
    geom = Geom.parse(case["geom"]) if case.get("geom") else None
    cfg = CodecConfig(codec=case.get("codec", "rans-cdf-o0-p"),
                      block_size=case["block_size"], geom=geom)
    _reset_launches()
    t0 = time.perf_counter()
    comp = api.compress(data, cfg, device=dev)
    _sync()
    t1 = time.perf_counter()
    back = api.decompress(comp, device=dev)
    _sync()
    t2 = time.perf_counter()
    counts = _launch_counts()
    if back != data.tobytes():
        raise AssertionError(f"{label}: decompress(compress(x)) != x")
    sha = hashlib.sha256(comp).hexdigest()
    if (len(comp), sha) != (case["length"], case["sha256"]):
        raise AssertionError(
            f"{label}: container {len(comp)} B sha256 {sha} differs from the "
            f"JAX golden {case['length']} B {case['sha256']}")
    missing = [k for k in needs if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    res = dict(codec=cfg.codec, bytes=int(data.size), comp=len(comp),
               ratio=len(comp) / data.size,
               encode_s=t1 - t0, decode_s=t2 - t1, launches=counts,
               geom=(geom or Geom()).spec)
    log(f"{label}: ok, container equals golden sha256 {sha[:16]}..., "
        + json.dumps(res))
    return res


# A CDF16 lookup (symbol -> low, freq): two picks of an entry, a select
# (entry 16 is 2^15) and a subtraction, as the kernels' lookups do it.
LOOKUP = 4
# A binary decision of the bitwise codecs: the slot's load and clamp (3),
# the bit (2), the predictor's update (5), the slot's store and the
# (low, freq) pair (4).
BIT_STEP = 14


def _lane_ops(kind: str, geom, K: int, decode: bool) -> int:
    """Integer ops of one lane over K bytes in a model pass (or, with
    ``decode``, a decode pass: the model plus a search, a state step and
    a word fetch a nibble) of ``kind`` "o0" (the span model at ``geom``),
    "o1", "o1byte" (id 64: the previous byte is the hi context, a shift
    and an add the lo context) or "tree", counted as ``_bound_ms``
    says."""
    import math
    search = 30
    if kind == "o1":
        model_ops = K * (2 * (LOOKUP + 80) + 12 + 6)
    elif kind == "o1byte":
        model_ops = K * (2 * (LOOKUP + 80) + 2)
    elif kind == "tree":
        model_ops = K * 8 * 16
        search = 0  # the descent is the search
    else:
        rejoin = 16 * (2 * int(math.log2(geom.share)) + 6) \
            if geom.share > 1 else 0
        hot = (K // geom.sync) * (1 + geom.hrows) * rejoin
        cold = (K // geom.lsync) * max(geom.arows - geom.srows, 0) * rejoin
        model_ops = K * 2 * (LOOKUP + 80) + hot + cold
    return model_ops + K * 2 * (search + 6 + 6) if decode else model_ops


def _bound_ms(name: str, geom, K: int, glens_sum: int) -> tuple[float, str]:
    """Least time for the same work: max(bytes / HBM rate, ops / peak).

    Bytes count each input read once and each output written once; only
    the words the streams hold are read (by the decoders) or placed (by
    place, which reads the words of emitting lanes alone); the o1
    kernels' per-lane table rows are working state, not input or
    output.  Under
    a split-state geometry coder and place run once per stream set, each
    over S = K slots (else S = 2K), and ``glens_sum`` sums both sets.  Ops
    count the algorithm's integer operations per lane and step: a CDF16
    lookup ``LOOKUP`` (4), a search 30, an update 80 (5 per entry), a state
    step 6, a word fetch or placement 6, a re-join 16 entries x
    (2 log2(share) + 6) per table row, an o1 hi context 12 and lo context
    6 per byte, a bit-tree level 16 (load and clamp, split, bit, interval,
    counter update, child) and 8 levels per byte."""
    G = geom.groups
    L, sets = G * 128, geom.nstates
    S = 2 * K // sets
    R = S + 2 + geom.wrows
    kind = name.split("_")[0] if name.startswith(("o1_", "tree_")) else "o0"
    tables = {"o1": (64 + 48) * 16 * G * 4, "tree": 256 * 4,
              "o0": (16 + 256) * G * 4}[kind]
    if name in ("model", "o1_model", "tree_model"):
        nbytes = K * L + 2 * K * L * 4 + tables
        ops = L * _lane_ops(kind, geom, K, False)
    elif name == "coder":
        nbytes = sets * (S * L * (4 + 4 + 1) + 2 * L * 4)
        ops = sets * L * S * 10
    elif name == "place":
        words = glens_sum - 256 * G * sets  # emitted words = sum(emit)
        nbytes = (sets * (S * L + L * 4 + G * R * 128 * 4 + G * 4)
                  + words * 4)
        ops = sets * L * S * 6
    else:
        nbytes = glens_sum * 4 + tables + K * L + sets * L * 4
        ops = L * _lane_ops(kind, geom, K, True)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


CODEC_NAME = {"o0": "rans-cdf-o0-p", "x2": "rans-cdf-o0-p",
              "o1": "rans-cdf-r1-p", "tree": "rc-p"}


def _time_path(label: str, kind: str, corpus: str, geom, dev) -> dict:
    """Kernel times on one block of ``corpus`` (CUDA events, 3 reps on
    distinct rotations after a warm-up), each kernel against its plain
    version at these shapes, and end-to-end MB/s of the codec.  Under a
    split-state geometry the coder and place times cover both sets'
    launches."""
    import numpy as np
    import torch
    from turborc_tpu_torch import api
    from turborc_tpu_torch.utils.config import CodecConfig
    phase(label)
    codec = _codec(kind)
    names = KERNELS[kind]
    base = _corpus(corpus)
    # The warm-up's outputs are freed before the timed runs, and so are
    # each repetition's before the next, so every buffer a wrapper asks
    # for is in the allocator's cache and no cudaMalloc lands in a timed
    # span (``mallocs`` counts any that does, and fails the phase).  A
    # repetition that still held the last one's outputs made the wrappers
    # of K3 and K4 allocate their 537 MB outputs anew inside the span.
    _run_path(_stages(kind, codec.encode_args(np.roll(base, 1), geom, dev),
                      geom, kernels=True))
    ms = {k: [] for k in names}
    mallocs: dict = {}
    prep = []  # host half of encode_block, to the block on the card
    for r in range(3):
        x = np.roll(base, 7919 * (r + 1))
        t0 = time.perf_counter()
        args = codec.encode_args(x, geom, dev)
        _sync()
        prep.append(time.perf_counter() - t0)
        outs, t = _run_path(_stages(kind, args, geom, kernels=True),
                            mallocs)
        del outs
        for k, v in t.items():
            ms[k].append(v)
    grew = {k: n for k, n in mallocs.items() if n}
    if grew:
        raise AssertionError(f"{label}: cudaMalloc inside the timed spans of "
                             f"{grew}: the kernel times would include it")
    kern, _ = _run_path(_stages(kind, args, geom, kernels=True))
    plain, plain_ms = _run_path(_stages(kind, args, geom, kernels=False))
    err = _compare(kern, plain)
    log(f"kernels {geom.spec} K={args.K}: equal to plain, tolerance 0 "
        f"(max abs err {err})")
    glens_sum = sum(int(gl.to(torch.int64).sum())
                    for gl in kern["place"][1::2])
    del kern, plain
    cfg = CodecConfig(codec=CODEC_NAME[kind],
                      block_size=1 << (base.size - 1).bit_length(),
                      geom=geom)  # one block
    enc, dec, ratios = [], [], []
    for r in range(3):  # rep 0 is the warm-up
        x = np.roll(base, 104729 * (r + 1))
        t0 = time.perf_counter()
        comp = api.compress(x, cfg, device=dev)
        _sync()
        t1 = time.perf_counter()
        back = api.decompress(comp, device=dev)
        _sync()
        t2 = time.perf_counter()
        if back != x.tobytes():
            raise AssertionError(f"{label}: round trip failed")
        if r:
            enc.append(t1 - t0)
            dec.append(t2 - t1)
            ratios.append(len(comp) / x.size)
    mb = base.size / 1e6
    kms = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"{label} end-to-end " + json.dumps(dict(
        codec=cfg.codec, corpus=corpus, geom=geom.spec,
        bytes=int(base.size), K=args.K, reps=len(enc),
        encode_MBps=[mb / s for s in enc], decode_MBps=[mb / s for s in dec],
        ratio=ratios, encode_args_s=prep,
        encode_kernel_share=[sum(kms[k] for k in names[:3]) / 1e3 / s
                             for s in enc],
        decode_kernel_share=[kms[names[3]] / 1e3 / s for s in dec],
        kernel_ms_reps=ms, mallocs_in_timed_spans=mallocs,
        plain_ms=plain_ms,
        bound_ms={k: _bound_ms(k, geom, args.K, glens_sum)[0]
                  for k in names})))
    return dict(ms=kms, plain_ms=plain_ms, err=err, K=args.K,
                glens_sum=glens_sum)


def phase_before_after(dev, before: str | None, libs: dict) -> dict:
    """L5-L8 of commit ``before`` against the current ones, on one 4 MB
    block of realsrcbwt at the default CodecConfig as ids 59 and 64 shape
    it (id 59: 512 lanes, K = 8192, 16 segments; id 64: 128 lanes, K =
    32,768), and L11 and L12 at every (predictor, order) of BIT and L9
    and both L10s (ids 41 and 40) on one 4 MB block of textbwt at the
    default (512 lanes, K = 8192): the models on its bytes, the decodes on
    the streams the current models (id 40: its gather) and L2 write.  A warm-up, then 3 repetitions on distinct rotations, the two
    builds in turns (before first on odd repetitions), CUDA events around
    the bare C entry of each: outputs (and order 1's tables) are allocated
    beforehand, and a new allocator segment inside a span fails the
    phase.  Both models must write the current wrapper's probs, both
    decodes return the block's bytes.  Returns {codec: {name: {"before":
    ms per repetition, "after": ...}}}, empty without ``before``."""
    import ctypes

    import numpy as np
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.ops import build, rans
    from turborc_tpu_torch.ops import rans_bit_kernel as BK
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
    from turborc_tpu_torch.ops import rans_nibble_kernel as NK
    from turborc_tpu_torch.utils.config import CodecConfig
    label = "timing-before-after"
    phase(label)
    if not libs:
        log(f"{label}: skipped, no {BEFORE_FLAG} COMMIT")
        return {}
    fns = {}
    for name, path in libs.items():  # that commit's signatures
        entry = ENTRY.get(name, "trc_" + name)
        fn = getattr(ctypes.CDLL(str(path)), entry)
        ptrs, ints = BEFORE_ARGS[entry]
        fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    real = _corpus("realsrcbwt_16777216.bin")
    text = _corpus("textbwt_16777216.bin")
    B = CodecConfig().block_size
    ms = {c: {k: {"before": [], "after": []} for k in (m, d)}
          for c, (m, _, d) in LANE_O1.items()}
    ms.update({c: {k: {"before": [], "after": []} for k in BIT_KERNELS
                   if k != "lane_coder"} for c in BIT})
    ms.update({c: {k: {"before": [], "after": []} for k in ks
                   if k != "lane_coder"} for c, ks in NIBBLE.items()})

    def timed(fn, cargs) -> float:
        cargs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
                 for x in cargs]
        seg = _segments()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
        end.record()
        end.synchronize()
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
        if _segments() != seg:
            raise AssertionError(f"{label}: cudaMalloc inside the span")
        return start.elapsed_time(end)

    for codec, (m, _, d) in LANE_O1.items():
        for r in range(4):  # rep 0 is the warm-up
            cols, tabs, K = _o1_block(
                codec, np.roll(real, 7919 * (r + 1))[:B], dev)
            init = torch.full((cols.shape[1],), rans.ANS_LOW,
                              dtype=torch.int32, device=dev)
            probs = getattr(LO, m)(cols, *tabs)
            st, lens = LK.lane_coder(probs, init)
            words = blockio.device_words(st, lens)
            offs = LK._offsets(lens)
            del st
            order = ("before", "after") if r % 2 else ("after", "before")
            for who in order:  # the models
                out = torch.empty_like(probs)
                cargs = getattr(LO, m + "_cargs")(cols, *tabs, out)
                fn = (build.load()["trc_" + m] if who == "after"
                      else fns[m])
                t = timed(fn, cargs)
                if r:
                    ms[codec][m][who].append(t)
                if not torch.equal(out, probs):
                    raise AssertionError(f"{m} of {who} ({before}): not the "
                                         "current wrapper's probs")
                del cargs, out
            for who in order:  # the decodes
                out = torch.empty_like(cols)
                cargs = getattr(LO, d + "_cargs")(words, offs, lens, K, *tabs,
                                                  out)
                fn = (build.load()["trc_" + d] if who == "after"
                      else fns[d])
                t = timed(fn, cargs)
                if r:
                    ms[codec][d][who].append(t)
                if not torch.equal(out, cols):
                    raise AssertionError(f"{d} of {who} ({before}): not the "
                                         "block's bytes")
                del cargs, out
            del cols, probs, words, offs, lens

    def turns(codec: str, name: str, r: int, make, want) -> None:
        """The two builds of ``name`` in turns on the arguments make(out)
        gives, each output equal to ``want``."""
        for who in (("before", "after") if r % 2 else ("after", "before")):
            out = torch.empty_like(want)
            cargs = make(out)
            fn = (build.load()[ENTRY.get(name, "trc_" + name)]
                  if who == "after" else fns[name])
            t = timed(fn, cargs)
            if r:
                ms[codec][name][who].append(t)
            if not torch.equal(out, want):
                raise AssertionError(f"{name} {codec} of {who} ({before}): "
                                     "not the current wrapper's output")
            del cargs, out

    for codec, (order, pname) in BIT.items():
        for r in range(4):  # rep 0 is the warm-up
            cols, K = _default_block(np.roll(text, 7919 * (r + 1))[:B], dev)
            pred = _bit_pred(pname, None, dev)
            init = torch.full((cols.shape[1],), rans.ANS_LOW,
                              dtype=torch.int32, device=dev)
            probs = BK.lane_bit_model(cols, order, pred)
            st, lens = LK.lane_coder(probs, init)
            words = blockio.device_words(st, lens)
            offs = LK._offsets(lens)
            del st
            turns(codec, "lane_bit_model", r, lambda out: (
                BK.lane_bit_model_cargs(cols, out, order, pred)), probs)
            turns(codec, "lane_bit_decode", r, lambda out: (
                BK.lane_bit_decode_cargs(words, offs, lens, K, out, order,
                                         pred)), cols)
            del cols, probs, words, offs, lens
    for r in range(4):  # L9 and both L10s; rep 0 is the warm-up
        cols, K = _default_block(np.roll(text, 7919 * (r + 1))[:B], dev)
        init = torch.full((cols.shape[1],), rans.ANS_LOW, dtype=torch.int32,
                          device=dev)
        probs = NK.lane_nibble_model(cols)
        turns("rc4", "lane_nibble_model", r, lambda out: (
            NK.lane_nibble_model_cargs(cols, out)), probs)
        for codec, name in (("rc4", "lane_nibble_decode"),
                            ("rc4c", "lane_nibble_static_decode")):
            cdf = None
            if codec == "rc4c":
                probs, cdf = _nibble_static_probs(cols, dev)
            st, lens = LK.lane_coder(probs, init)
            words = blockio.device_words(st, lens)
            offs = LK._offsets(lens)
            del st
            turns(codec, name, r, lambda out: (NK.lane_nibble_decode_cargs(
                words, offs, lens, K, cdf, out)), cols)
            del words, offs, lens
        del cols, probs
    log(f"{label} " + json.dumps(dict(before=before, ms=ms)))
    return ms


# K4 on synthetic tiles, legal inputs of a pure compaction: (what, S, G,
# emit pattern).  "random" draws every emit with probability 0.3,
# "groups" with a probability of its own in each group.
PLACE_EDGES = (("all lanes emit at every slot", 4096, 64, "all"),
               ("no lane emits", 4096, 64, "none"),
               ("one lane emits, in the last slot only", 16384, 64, "last"),
               ("S = 4133, not a multiple of the chunk", 4133, 1, "random"),
               ("S = 100, two groups", 100, 2, "random"),
               ("G = 1", 4096, 1, "random"),
               ("G = 64, id 57's shape", 16384, 64, "groups"))
# Plans of K4 that do not fit their tile, as changes of the right one.
PLACE_BAD_PLANS = (
    ("too little scratch", lambda ln: dict(scratch=ln.grid - 1)),
    ("one chunk too few", lambda ln: dict(chunks=ln.chunks - 1,
                                          grid=ln.G * (ln.chunks - 1))),
    ("another chunk size", lambda ln: dict(chunk=ln.chunk // 2)),
    ("another thread count", lambda ln: dict(threads=ln.threads // 2)),
    ("rows too few for the slots", lambda ln: dict(R=ln.S + 1)))


def phase_place_edge(dev) -> None:
    """K4 against place_plain on the PLACE_EDGES tiles: equal streams and
    lengths (tolerance 0); then plans that ``trc_place`` must refuse
    (PLACE_BAD_PLANS) are refused, with no launch counted."""
    import dataclasses
    import torch
    from turborc_tpu_torch.ops import rans_kernel as K_
    from turborc_tpu_torch.ops.geom import Geom
    phase("place-edge")
    gen = torch.Generator(device=dev).manual_seed(20261018)
    for what, S, G, pattern in PLACE_EDGES:
        geom = Geom(groups=G)
        shape = (S, G, 128)
        words = torch.randint(0, 1 << 16, shape, generator=gen, device=dev,
                              dtype=torch.int32)
        state = torch.randint(1 << 15, 1 << 31, (G, 128), generator=gen,
                              device=dev, dtype=torch.int64).to(torch.int32)
        if pattern in ("random", "groups"):
            p = (torch.rand((1, G, 1), generator=gen, device=dev)
                 if pattern == "groups" else 0.3)
            emit = (torch.rand(shape, generator=gen, device=dev) < p)
        else:
            emit = torch.full(shape, pattern == "all", device=dev)
            if pattern == "last":
                emit[S - 1, G - 1, 127] = True
        emit = emit.to(torch.uint8)
        k = K_.place(words, emit, state, geom)
        want = K_.place_plain(words, emit, state, geom)
        err = max(_max_abs(a, b) for a, b in zip(k, want))
        if err:
            raise AssertionError(f"place-edge {what}: kernel differs from "
                                 f"plain by {err}")
        log(f"place-edge {what} (S={S}, G={G}, "
            f"{K_.place_launch(S, G, S + 2 + geom.wrows).chunks} chunks a "
            f"group, {int(emit.sum())} words): equal to plain, tolerance 0 "
            "(max abs err 0)")
    # The C entry is the plan's one guard: each bad plan must come back as
    # cudaErrorInvalidValue (1) before any launch.
    S, G = 4133, 2
    geom = Geom(groups=G)
    R = S + 2 + geom.wrows
    ln = K_.place_launch(S, G, R)
    words = torch.zeros((S, G, 128), dtype=torch.int32, device=dev)
    emit = torch.zeros((S, G, 128), dtype=torch.uint8, device=dev)
    state = torch.zeros((G, 128), dtype=torch.int32, device=dev)
    gstreams = torch.empty((G, R, 128), dtype=torch.int32, device=dev)
    glens = torch.empty((G,), dtype=torch.int32, device=dev)
    counts = torch.empty((ln.scratch,), dtype=torch.int32, device=dev)
    for what, change in PLACE_BAD_PLANS:
        bad = dataclasses.replace(ln, **change(ln))
        before = K_.launches["place"]
        try:
            K_.launch("place", "trc_place",
                      *K_.place_cargs(words, emit, state, gstreams, glens,
                                      counts, bad), kernels=2)
        except RuntimeError as e:
            if not str(e).endswith("CUDA error 1"):
                raise
        else:
            raise AssertionError(f"place-edge: trc_place took a plan with "
                                 f"{what}")
        if K_.launches["place"] != before:
            raise AssertionError(f"place-edge {what}: a launch was counted")
        log(f"place-edge: trc_place refuses a plan with {what} "
            "(CUDA error 1, no launch)")


# The lane kernels L1-L4 against their plain versions: (lanes, K, the
# geometry's fields that differ from PER_LANE's, warm-table segments).
# 4 to 8192 lanes; per-lane models (ids 56, 42's layout), spans of 8 (id
# 58's default), 32, 64 and 128 lanes (sets across warps, CTAs of 512 and
# 1024 threads; L1 and L3 at 16 threads a lane, 8 at share 128); static
# rows (arows 8, 4, 0), srows past arows; rates 7, 8 and 10; K = 0 and K
# not a multiple of the team's chunk of steps.
LANE_CASES = ((4, 64, {}, 1), (4, 0, {}, 1), (16, 64, dict(share=8), 2),
              (512, 64, {}, 1), (512, 64, dict(share=8), 64),
              (8192, 32, dict(share=64, sync=8, arows=4, srows=2), 64),
              (8192, 32, dict(share=128, arows=8, rate=10), 16),
              (128, 32, dict(share=128, arows=0, srows=0, rate=10), 1),
              (16, 32, dict(share=8, arows=4, srows=8), 2),
              (64, 37, dict(arows=5), 1),
              (256, 32, dict(share=32, sync=2, lsync=16, srows=20, rate=8),
               4))
# The codecs on the card against the CPU: (codec, lanes, bytes), at
# step_quant 256 and the default geometry: an empty block, and one of
# several K (K = 512).
LANE_CODEC_CASES = tuple((c, L, n) for c in LANE for L, n in (
    (16, 0), (16, 5000)))


def _static_probs(cols, dev):
    """id 42's encode model on the card over ``cols``, and its table: the
    byte histogram's 257-entry CDF (every byte of ``cols`` codeable)."""
    import torch
    from turborc_tpu_torch.codecs import rans_static as S42
    freqs = S42.build_freqs(cols.reshape(-1).cpu().numpy())
    cdf = torch.from_numpy(S42._cdf(freqs)).to(dev)
    return S42.slot_probs(cols, cdf), cdf


def _corrupt(words, lengths, gen, dev) -> dict:
    """Corrupt lane streams: every 16th word flipped; the lengths of a
    quarter of the lanes cut to 2 or raised past 2K + 2 and past the
    words."""
    import torch
    W, L = words.shape[0], lengths.shape[0]
    flip = words.clone()
    flip[::16] ^= torch.randint(1, 1 << 15, flip[::16].shape, generator=gen,
                                dtype=torch.int16).to(dev)
    cut, long = lengths.clone(), lengths.clone()
    cut[::4] = 2
    long[1::4] = 1 << 20
    return {"flipped words": (flip, lengths), "lengths cut": (words, cut),
            f"lengths past 2K + 2 and the {W} words": (words, long)}


def phase_lane_kernels(dev) -> None:
    """L1-L4 against their plain versions on the LANE_CASES tiles of
    textbwt, exact (tolerance 0): L1's probs, L2's streams and lengths,
    L3's and L4's bytes, which must be the input; then L3 and L4 on the
    same streams with words flipped.  Then each per-lane scan codec's
    payload written on the card equals the one written on the CPU, and
    the card decodes it (LANE_CODEC_CASES)."""
    import dataclasses

    import numpy as np
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import rans_cdf_s8 as S58
    from turborc_tpu_torch.codecs import registry
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    phase("lane-kernels-vs-plain")
    text = _corpus("textbwt_16777216.bin", 1 << 22)
    gen = torch.Generator().manual_seed(20261020)
    for i, (L, K, kw, n_seg) in enumerate(LANE_CASES):
        geom = dataclasses.replace(LK.PER_LANE, **kw)
        data = text[i * 7919:i * 7919 + K * L]
        hi, lo = S58.tables_on(*S58.segment_tables(data, n_seg), dev)
        cols = torch.from_numpy(data.reshape(K, L).copy()).to(dev)
        init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32, device=dev)
        err = {}
        probs = LK.lane_model(cols, hi, lo, geom)
        err["lane_model"] = _max_abs(probs,
                                     LK.lane_model_plain(cols, hi, lo, geom))
        streams, lengths = LK.lane_coder(probs, init)
        want = LK.lane_coder_plain(probs, init)
        err["lane_coder"] = max(_max_abs(streams, want[0]),
                                _max_abs(lengths, want[1]))
        words = blockio.device_words(streams, lengths)
        out = LK.lane_decode(words, lengths, K, hi, lo, geom)
        err["lane_decode"] = _max_abs(out, LK.lane_decode_plain(
            words, lengths, K, hi, lo, geom))
        for what, bad in _corrupt(words, lengths, gen, dev).items():
            err[f"lane_decode {what}"] = _max_abs(
                LK.lane_decode(*bad, K, hi, lo, geom),
                LK.lane_decode_plain(*bad, K, hi, lo, geom))
        sprobs, cdf = _static_probs(cols, dev)
        sstreams, slens = LK.lane_coder(sprobs, init)
        want = LK.lane_coder_plain(sprobs, init)
        err["lane_coder static"] = max(_max_abs(sstreams, want[0]),
                                       _max_abs(slens, want[1]))
        swords = blockio.device_words(sstreams, slens)
        sout = LK.lane_static_decode(swords, slens, K, cdf)
        err["lane_static_decode"] = _max_abs(
            sout, LK.lane_static_decode_plain(swords, slens, K, cdf))
        for what, bad in _corrupt(swords, slens, gen, dev).items():
            err[f"lane_static_decode {what}"] = _max_abs(
                LK.lane_static_decode(*bad, K, cdf),
                LK.lane_static_decode_plain(*bad, K, cdf))
        if any(err.values()):
            raise AssertionError(f"lane kernels L={L} K={K} {geom.spec}: kernel "
                                 f"differs from plain: {err}")
        if not (torch.equal(out, cols) and torch.equal(sout, cols)):
            raise AssertionError(f"lane kernels L={L} K={K} {geom.spec}: decode "
                                 "did not return the bytes")
        log(f"lane kernels L={L} K={K} {geom.spec} n_seg={n_seg}: equal to "
            f"plain, tolerance 0 (max abs err {err}); L3 and L4 return "
            f"the bytes; {int(lengths.sum())} + {int(slens.sum())} words")
    for codec, L, n in LANE_CODEC_CASES:
        c = registry.get(codec)
        data = np.roll(text, 104729 * n)[:n]
        kw = dict(lanes=L, step_quant=256)
        card = c.encode_block(data, device=dev, **kw)
        cpu = c.encode_block(data, device="cpu", **kw)
        if card != cpu:
            raise AssertionError(f"{codec} L={L} n={n}: payload on the card "
                                 "differs from the CPU's")
        if not np.array_equal(c.decode_block(card, n, device=dev, **kw),
                              data):
            raise AssertionError(f"{codec} L={L} n={n}: round trip failed")
        log(f"lane codec {codec} L={L} n={n}: card payload equals the CPU's "
            f"({len(card)} B), decodes on the card")


# L2 on constructed probs: (S, L, freqs).  "edge" draws half the slots'
# freq from CODER_FREQS, the rest from [1, 2^15]; "1" is freq 1 on every
# slot (a word nearly every slot: k > S / 2, so the move overlaps
# itself), "32768" freq 2^15 on every slot.  S = 0, 1 and not a multiple
# of a 64-slot stage or an 8-slot block; 1 and 2 lanes (rows under 16
# B), one CTA with dummy lanes, 2 to 16 CTAs.
LANE_CODER_EDGES = ((0, 4, "edge"), (1, 1, "edge"), (63, 2, "edge"),
                    (65, 16, "1"), (1000, 64, "32768"), (4133, 512, "edge"),
                    (4096, 128, "1"))
# L4 on CDFs at their extremes: one symbol holding all (the first, the
# last), and zero-frequency symbols beside a freq-1 one.
LANE_STATIC_CDFS = ("symbol 0 holds all", "symbol 255 holds all",
                    "zero-frequency symbols")


def _extreme_cdf(what: str, gen):
    """A 257-entry CDF of LANE_STATIC_CDFS (int32 on the CPU)."""
    import torch
    f = torch.zeros(256, dtype=torch.int64)
    if what.startswith("symbol"):
        f[int(what.split()[1])] = 1 << 15
    else:
        live = torch.randperm(256, generator=gen)[:40]
        f[live] = torch.randint(1, 500, (40,), generator=gen)
        f[live[0]] = 1
        f[live[1]] += (1 << 15) - int(f.sum())
    return torch.cat([torch.zeros(1, dtype=torch.int64),
                      f.cumsum(0)]).to(torch.int32)


def phase_lane_edge(dev) -> None:
    """L2 against lane_coder_plain on the LANE_CODER_EDGES tiles, half the
    lanes starting at a state of CODER_STATES, the rest at one drawn from
    [2^15, 2^31); then L4 against lane_static_decode_plain on streams of
    the LANE_STATIC_CDFS (K = 2048, 512 lanes), sound and corrupt.
    Streams, lengths and bytes equal (tolerance 0)."""
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    phase("lane-edge")
    gen = torch.Generator(device=dev).manual_seed(20261021)
    for S, L, kind in LANE_CODER_EDGES:
        shape = (S, L)
        if kind == "edge":
            edge = torch.tensor(CODER_FREQS, device=dev)[torch.randint(
                0, len(CODER_FREQS), shape, generator=gen, device=dev)]
            freq = torch.where(
                torch.rand(shape, generator=gen, device=dev) < 0.5, edge,
                torch.randint(1, (1 << 15) + 1, shape, generator=gen,
                              device=dev))
        else:
            freq = torch.full(shape, int(kind), device=dev)
        low = (torch.rand(shape, generator=gen, device=dev)
               * ((1 << 15) - freq + 1)).to(torch.int64).clamp(
                   max=(1 << 15) - freq)
        probs = ((low << 16) | freq).to(torch.int32)
        init = torch.randint(1 << 15, 1 << 31, (L,), generator=gen,
                             device=dev, dtype=torch.int64)
        init[::2] = torch.tensor(CODER_STATES, device=dev)[
            torch.arange(0, L, 2, device=dev) // 2 % 2]
        init = init.to(torch.int32)
        k = LK.lane_coder(probs, init)
        want = LK.lane_coder_plain(probs, init)
        err = max(_max_abs(a, b) for a, b in zip(k, want))
        if err:
            raise AssertionError(f"lane-edge L2 S={S} L={L} freq {kind}: "
                                 f"kernel differs from plain by {err}")
        words = int(k[1].sum()) - 2 * L
        log(f"lane-edge L2 S={S} L={L} freq {kind} "
            f"({-(-L // LK.CODER_LANES)} CTAs; {words} words, up to "
            f"{int(k[1].max()) - 2} a lane): equal to plain, tolerance 0 "
            "(max abs err 0)")
    cpu_gen = torch.Generator().manual_seed(20261022)
    K, L = 2048, 512
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32, device=dev)
    for what in LANE_STATIC_CDFS:
        cdf = _extreme_cdf(what, cpu_gen)
        f = (cdf[1:] - cdf[:-1]).double()
        sym = torch.multinomial(f, K * L, replacement=True,
                                generator=cpu_gen).reshape(K, L)
        c = cdf.to(torch.int64)
        probs = ((c[sym] << 16) | (c[sym + 1] - c[sym])).to(
            torch.int32).to(dev)
        st, lens = LK.lane_coder(probs, init)
        words = blockio.device_words(st, lens)
        cdf = cdf.to(dev)
        out = LK.lane_static_decode(words, lens, K, cdf)
        if not torch.equal(out.cpu(), sym.to(torch.uint8)):
            raise AssertionError(f"lane-edge L4 {what}: decode did not "
                                 "return the bytes")
        err = {"sound": _max_abs(out, LK.lane_static_decode_plain(
            words, lens, K, cdf))}
        for bad, args in _corrupt(words, lens, cpu_gen, dev).items():
            err[bad] = _max_abs(LK.lane_static_decode(*args, K, cdf),
                                LK.lane_static_decode_plain(*args, K, cdf))
        if any(err.values()):
            raise AssertionError(f"lane-edge L4 {what}: kernel differs "
                                 f"from plain: {err}")
        log(f"lane-edge L4 {what} K={K} L={L} ({int(lens.sum())} words): "
            f"equal to plain, sound and corrupt, tolerance 0 (max abs err "
            f"{err})")


# L5-L8 against their plain versions: (codec, bytes of realsrcbwt, K cut
# or None, corrupt streams too).  Id 59 on a 1 MB block at the default
# 512 lanes (4 warm-table segments) and on the tail block of 3.5 MB (14
# segments, one every 36.57 lanes, so a CTA of 8 lanes may start from
# two), id 64 on a 256 KB block (128 lanes, K = 2048); the tail and id
# 64's 4 MB block cut to K = 256 also on corrupt streams.
LANE_O1_CASES = (("rans-cdf-r1", 1 << 20, None, False),
                 ("rans-cdf-o1", 1 << 18, None, False),
                 ("rans-cdf-r1", 7 << 19, 256, True),
                 ("rans-cdf-o1", 1 << 22, 256, True))


# L5 / L7 on constructed bytes against their plain versions: (codec,
# bytes, K, L, n_seg).  "run": each lane one byte all the way (one row);
# "alternate": two bytes in turn (a row again two steps later); "cycle":
# all 256 bytes in turn (no row again within 256 steps); "random" at K =
# 1, 7 and 9 (less than a chunk of 16 steps, and across one); id 59 at 3
# and 5 segments, which divide neither 512 nor 64 lanes, so segments
# start inside its CTAs of 4 lanes.
LANE_O1_MODEL_CASES = (
    *((c, what, 512, L, n_seg)
      for c, L, n_seg in (("rans-cdf-o1", 128, 1), ("rans-cdf-r1", 512, 3))
      for what in ("run", "alternate", "cycle")),
    *((c, "random", K, L, n_seg)
      for c, L, n_seg in (("rans-cdf-o1", 128, 1), ("rans-cdf-r1", 512, 5))
      for K in (1, 7, 9)),
    ("rans-cdf-r1", "random", 300, 64, 5))


def _model_case(what: str, K: int, L: int, n_seg: int, rng, dev):
    """(cols [K, L] u8 on ``dev``, id 59's tables at n_seg segments):
    LANE_O1_MODEL_CASES' bytes; the tables as segment_cdfs makes them,
    cumulative rows from 0 with every freq >= 1."""
    import numpy as np
    import torch
    if what == "run":
        x = np.broadcast_to((np.arange(L) * 7 % 256).astype(np.uint8), (K, L))
    elif what == "alternate":
        x = rng.integers(0, 256, (2, L), dtype=np.uint8)[np.arange(K) % 2]
    elif what == "cycle":
        x = (np.arange(K)[:, None] + 37 * np.arange(L)) % 256
    else:
        x = rng.integers(0, 256, (K, L))

    def rows(n):
        cuts = np.sort(np.stack([rng.choice(np.arange(1, 1 << 15), 15, False)
                                 for _ in range(n_seg * n)]), 1)
        return torch.from_numpy(np.concatenate(
            [np.zeros((n_seg * n, 1), np.int64), cuts], 1).reshape(
                n_seg, n, 16).astype(np.int32)).to(dev)
    cols = torch.from_numpy(np.ascontiguousarray(x, np.uint8)).to(dev)
    return cols, (rows(64), rows(48))


def _o1_block(codec: str, x, dev):
    """Block ``x`` at the default CodecConfig as id 59 or id 64 shapes it:
    (cols [K, L] on ``dev``, the model's tables, K): id 59's segment
    tables, none for id 64 (which codes at most 128 lanes)."""
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import rans_cdf_o1 as O1
    from turborc_tpu_torch.codecs import rans_cdf_r1_lane as R59
    from turborc_tpu_torch.utils.config import CodecConfig
    cfg = CodecConfig()
    if codec == "rans-cdf-r1":
        a = R59.encode_args(x, cfg.lanes, cfg.step_quant, dev)
        return a.cols, (a.hi_tbl, a.lo_tbl), a.cols.shape[0]
    block, K = blockio.shape_block(x, min(cfg.lanes, O1.LANE_CAP),
                                   cfg.step_quant)
    return torch.from_numpy(block).to(dev).T.contiguous(), (), K


def phase_lane_o1_kernels(dev) -> None:
    """L5-L8 and L2 on their probs against the plain versions on the
    LANE_O1_CASES blocks of realsrcbwt, exact (tolerance 0): probs,
    streams and lengths, and bytes, which must be the input; the decoders
    also on corrupt streams.  Then L5 / L7 on LANE_O1_MODEL_CASES, exact.
    Then each codec's payload written on the card equals the CPU's, and
    the card decodes it."""
    import numpy as np
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import registry
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
    phase("lane-o1-kernels-vs-plain")
    real = _corpus("realsrcbwt_16777216.bin", 1 << 22)
    gen = torch.Generator().manual_seed(20261023)
    for codec, n, cut, corrupt in LANE_O1_CASES:
        m, _, d = LANE_O1[codec]
        cols, tabs, K = _o1_block(codec, real[:n], dev)
        if cut:
            cols, K = cols[:cut].contiguous(), cut
        L = cols.shape[1]
        init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32, device=dev)
        err = {}
        probs = getattr(LO, m)(cols, *tabs)
        err[m] = _max_abs(probs, getattr(LO, m + "_plain")(cols, *tabs))
        streams, lengths = LK.lane_coder(probs, init)
        want = LK.lane_coder_plain(probs, init)
        err["lane_coder"] = max(_max_abs(streams, want[0]),
                                _max_abs(lengths, want[1]))
        words = blockio.device_words(streams, lengths)
        out = getattr(LO, d)(words, lengths, K, *tabs)
        err[d] = _max_abs(out, getattr(LO, d + "_plain")(words, lengths, K,
                                                         *tabs))
        bad = _corrupt(words, lengths, gen, dev) if corrupt else {}
        for what, args in bad.items():
            err[f"{d} {what}"] = _max_abs(
                getattr(LO, d)(*args, K, *tabs),
                getattr(LO, d + "_plain")(*args, K, *tabs))
        segs = tabs[0].shape[0] if tabs else 0
        if any(err.values()):
            raise AssertionError(f"{codec} L={L} K={K} n_seg={segs}: kernel "
                                 f"differs from plain: {err}")
        if not torch.equal(out, cols):
            raise AssertionError(f"{codec} L={L} K={K}: decode did not "
                                 "return the bytes")
        log(f"lane o1 kernels {codec} L={L} K={K} n_seg={segs}: equal to "
            f"plain, tolerance 0 (max abs err {err}); the decode returns "
            f"the bytes; {int(lengths.sum())} words")
    rng = np.random.default_rng(20261018)
    for codec, what, K, L, n_seg in LANE_O1_MODEL_CASES:
        m = LANE_O1[codec][0]
        cols, tabs = _model_case(what, K, L, n_seg, rng, dev)
        tabs = tabs if codec == "rans-cdf-r1" else ()
        err = _max_abs(getattr(LO, m)(cols, *tabs),
                       getattr(LO, m + "_plain")(cols, *tabs))
        if err:
            raise AssertionError(f"{m} {what} K={K} L={L} n_seg={n_seg}: "
                                 f"kernel differs from plain by {err}")
        log(f"lane o1 model {m} {what} K={K} L={L} n_seg={n_seg if tabs else 0}"
            ": equal to plain, tolerance 0 (max abs err 0)")
    for codec in LANE_O1:
        c = registry.get(codec)
        for n in (0, 5000):
            data = np.roll(real, 104729 * n)[:n]
            kw = dict(lanes=16, step_quant=256)
            card = c.encode_block(data, device=dev, **kw)
            if card != c.encode_block(data, device="cpu", **kw):
                raise AssertionError(f"{codec} n={n}: payload on the card "
                                     "differs from the CPU's")
            if not np.array_equal(c.decode_block(card, n, device=dev, **kw),
                                  data):
                raise AssertionError(f"{codec} n={n}: round trip failed")
            log(f"lane codec {codec} L=16 n={n}: card payload equals the "
                f"CPU's ({len(card)} B), decodes on the card")


# Small cases of the nibble and bitwise kernels on the card against their
# plain versions on the CPU: (bytes, L, K).  "textbwt" slices of the
# corpus, "run" one byte a lane (0x00 or 0xFF), "random" uniform bytes,
# "alternate" two bytes in turn, "every byte" all 256 bytes in turn from
# a lane's own start; K = 1, and 37 (not a multiple of a team's chunk of
# 16 or of L11's unroll of 4).
LANE_NEW_EDGE = (("textbwt", 16, 37), ("textbwt", 4, 1), ("run", 64, 32),
                 ("random", 8, 100), ("alternate", 32, 48),
                 ("every byte", 16, 256))
# Cases of L11 and L12 alone: bytes whose depth-4 nodes are siblings (the
# two halves of one pair region), and K of 7 and 9 (a step of L11's
# read-ahead ring short of and past a multiple of 8); with the K = 37
# case they also take BIT_EDGE_PREDS's predictors and corrupt streams.
BIT_EDGE = (("siblings", 16, 40), ("textbwt", 8, 7), ("textbwt", 2, 9))
# Predictors beyond the codecs' own on the "textbwt" case of K = 37:
# dual-speed at rates 0 / 16 and 40 / 3 (a rate of 16 or more moves
# nothing), and an FSM of 100 random states from state 3 (probabilities
# 0 to 2^15 - 1, clamped when read).
BIT_EDGE_PREDS = (("ss", (0, 16)), ("ss", (40, 3)), ("sf", "random"))


def _edge_cols(what: str, K: int, L: int, rng, text):
    """LANE_NEW_EDGE's bytes, [K, L] uint8 (numpy)."""
    import numpy as np
    if what == "textbwt":
        off = int(rng.integers(0, text.size - K * L))
        return text[off:off + K * L].reshape(K, L).copy()
    if what == "run":
        return np.broadcast_to((np.arange(L) % 2 * 255).astype(np.uint8),
                               (K, L)).copy()
    if what == "random":
        return rng.integers(0, 256, (K, L), dtype=np.uint8)
    if what == "alternate":
        return rng.integers(0, 256, (2, L), dtype=np.uint8)[np.arange(K) % 2]
    if what == "siblings":  # depth-4 nodes 2 i and 2 i + 1 in turn
        b = rng.integers(0, 8, (K, L)) * 32 + rng.integers(0, 16, (K, L))
        return (b + 16 * (np.arange(K)[:, None] % 2)).astype(np.uint8)
    return ((np.arange(K)[:, None] + 37 * np.arange(L)) % 256).astype(
        np.uint8)


def _bit_pred(name: str, rates, dev, rng=None):
    """A bitpred predictor on ``dev``: the codecs' own at ``rates`` None,
    else BIT_EDGE_PREDS's."""
    import numpy as np
    import torch
    from turborc_tpu_torch.models import bitpred
    if rates == "random":
        S = 100
        table = torch.from_numpy(np.stack([
            rng.integers(0, 1 << 15, S), rng.integers(0, S, S),
            rng.integers(0, S, S)]).astype(np.int32)).to(dev)
        return bitpred.Fsm(table, start=3)
    return bitpred.make(name, *(rates or (None, None)), device=dev)


def host_pool():
    """Six spawned worker processes on the host CPU for the plain versions
    of L9-L12 at full shape (``_plain_job``, one thread each), which run
    while the correctness phases before ``phase_lane_nibble_kernels`` run
    on the card; the card's machine has 8 cores."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(6, multiprocessing.get_context("spawn"))


def _default_block(x, dev):
    """Block ``x`` at the default CodecConfig (512 lanes, step_quant 256):
    (cols [K, L] on ``dev``, K)."""
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.utils.config import CodecConfig
    cfg = CodecConfig()
    block, K = blockio.shape_block(x, cfg.lanes, cfg.step_quant)
    return torch.from_numpy(block).to(dev).T.contiguous(), K


def _nibble_static_probs(cols, dev):
    """id 40's encode model on the card over ``cols`` and its cdf [17]."""
    import torch
    from turborc_tpu_torch.codecs import rans_nibble as N40
    from turborc_tpu_torch.codecs import rans_static as S42
    from turborc_tpu_torch.ops import rans_nibble_kernel as NK
    freqs = N40.build_nibble_freqs(cols.reshape(-1).cpu().numpy())
    cdf = torch.from_numpy(N40._cdf(freqs)).to(dev)
    return S42.slot_probs(NK.nibbles(cols), cdf), cdf


def _full_jobs(names_args: list) -> tuple:
    """(jobs as numpy, the kernels' outputs on the host) of
    ``names_args``: (plain name, kernel output(s), arguments)."""
    import torch
    jobs, kern = [], []
    for name, out, args in names_args:
        jobs.append((name, [a.cpu().numpy() if isinstance(a, torch.Tensor)
                            else a for a in args]))
        kern.append(tuple(o.cpu() for o in (
            out if isinstance(out, tuple) else (out,))))
    return jobs, kern


def _held(label: str, jobs: list, kern: list, futures) -> tuple[dict, dict]:
    """Hold the results of ``jobs`` (``futures`` of ``_plain_job``) against
    ``kern``: (max abs err by job name, plain ms by job name)."""
    import torch
    err, ms = {}, {}
    for (name, _), outs, fut in zip(jobs, kern, futures):
        plain, sec = fut.result()
        key = name if name not in err else f"{name} {len(err)}"
        err[key] = max(_max_abs(torch.from_numpy(a), b.cpu())
                       for a, b in zip(plain, outs))
        ms[key] = sec * 1e3
    if any(err.values()):
        raise AssertionError(f"{label}: kernel differs from plain: {err}")
    return err, ms


def phase_lane_new_full_shape(dev, pool) -> dict:
    """L9, both instantiations of L10, and L11 and L12 at every
    (predictor, order) of BIT, with L2 on L9's and id 1's probs, at the
    full shape: one 4 MB block of textbwt at the default CodecConfig (512
    lanes, K = 8,192); the decodes must return the bytes.  Their plain
    versions at the same shape go to the host workers of ``pool`` (the
    decodes, the longest, first), which run them while the next phases
    run on the card; ``phase_lane_nibble_kernels`` and
    ``phase_lane_bit_kernels`` hold the kernels' outputs (kept on the
    host) against them.  Returns {"nibble" | "bit": (jobs, outputs,
    futures)}."""
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_bit_kernel as BK
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_nibble_kernel as NK
    phase("lane-new-kernels-full-shape")
    cols, K = _default_block(_corpus("textbwt_16777216.bin", 1 << 22), dev)
    L = cols.shape[1]
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32, device=dev)
    probs = NK.lane_nibble_model(cols)
    st, ln = LK.lane_coder(probs, init)
    words = blockio.device_words(st, ln)
    out = NK.lane_nibble_decode(words, ln, K)
    sprobs, cdf = _nibble_static_probs(cols, dev)
    sst, sln = LK.lane_coder(sprobs, init)
    swords = blockio.device_words(sst, sln)
    sout = NK.lane_nibble_static_decode(swords, sln, K, cdf)
    if not (torch.equal(out, cols) and torch.equal(sout, cols)):
        raise AssertionError("L10 did not return the bytes")
    todo = {"nibble": [
        ("lane_nibble_decode", out, [words, ln, K]),
        ("lane_nibble_model", probs, [cols]),
        ("lane_nibble_static_decode", sout, [swords, sln, K, cdf]),
        ("lane_coder", (st, ln), [probs, init])], "bit": []}
    for codec, (order, pred) in BIT.items():
        p = _bit_pred(pred, None, dev)
        probs = BK.lane_bit_model(cols, order, p)
        st, ln = LK.lane_coder(probs, init)
        words = blockio.device_words(st, ln)
        out = BK.lane_bit_decode(words, ln, K, order, p)
        if not torch.equal(out, cols):
            raise AssertionError(f"L12 {codec}: did not return the bytes")
        todo["bit"] += [("lane_bit_model", probs, [cols, order, pred]),
                        ("lane_bit_decode", out, [words, ln, K, order, pred])]
        if codec == "rc-o0":
            todo["bit"].append(("lane_coder", (st, ln), [probs, init]))
    todo["bit"].sort(key=lambda job: job[0] != "lane_bit_decode")
    started = {}
    for what in ("nibble", "bit"):
        jobs, kern = _full_jobs(todo[what])
        started[what] = (jobs, kern, [pool.submit(_plain_job, job)
                                      for job in jobs])
    log(f"lane new kernels L={L} K={K} (full shape): L10 and L12 return the "
        f"bytes; {sum(len(v[0]) for v in started.values())} plain versions "
        "handed to the host workers")
    return dict(started, K=K, L=L)


def phase_lane_nibble_kernels(dev, started: dict) -> dict:
    """L9 and both instantiations of L10 (and L2 on L9's probs) against
    their plain versions at the full shape (``started``, from
    ``phase_lane_new_full_shape``), exact (tolerance 0).  Then on
    LANE_NEW_EDGE's bytes, static CDFs where one symbol holds almost all
    and where some have frequency 0, and corrupt streams (``_corrupt``),
    against the plain versions on the CPU, exact.  Returns the
    full-shape errors and plain ms."""
    import numpy as np
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_nibble_kernel as NK
    phase("lane-nibble-kernels-vs-plain")
    text = _corpus("textbwt_16777216.bin", 1 << 22)
    jobs, kern, futures = started["nibble"]
    K, L = started["K"], started["L"]
    rng = np.random.default_rng(20261018)
    gen = torch.Generator().manual_seed(20261018)
    cdfs = {"symbol 0 holds all but 15": [(1 << 15) - 15] + [1] * 15,
            "frequencies 0 between": [0, 9000, 0, 0, 7000, 1] + [0] * 9
            + [(1 << 15) - 16001],
            "last frequency 0": [2048] * 14 + [(1 << 15) - 14 * 2048, 0],
            "one symbol (0)": [1 << 15] + [0] * 15,
            "one symbol (7)": [0] * 7 + [1 << 15] + [0] * 8,
            "one symbol (15)": [0] * 15 + [1 << 15]}
    # cdfs that are not non-decreasing from 0 to 2^15: the wrapper refuses
    # them on the card as on the CPU
    for bad in ([1] + [1 << 15] * 16, list(range(0, 17 * 2000, 2000)),
                [0, 9000, 8000] + [1 << 15] * 14):
        c_ = torch.tensor(bad, dtype=torch.int32, device=dev)
        try:
            NK.lane_nibble_static_decode(
                torch.zeros(8, dtype=torch.int16, device=dev),
                torch.full((4,), 2, dtype=torch.int32, device=dev), 2, c_)
        except ValueError:
            continue
        raise AssertionError(f"L10 static accepted the cdf {bad}")
    log("lane nibble kernels: L10's static wrapper refuses 3 cdfs that are "
        "not non-decreasing from 0 to 2^15")
    for what, L_, K_ in LANE_NEW_EDGE:
        x = torch.from_numpy(_edge_cols(what, K_, L_, rng, text))
        c = x.to(dev)
        i_ = torch.full((L_,), rans.ANS_LOW, dtype=torch.int32)
        err = {"lane_nibble_model": _max_abs(
            NK.lane_nibble_model(c), NK.lane_nibble_model_plain(x))}
        st, n = LK.lane_coder(NK.lane_nibble_model_plain(x), i_)
        w = blockio.device_words(st, n)
        # the streams coded on the block's CDF, decoded on each table
        sp, block_cdf = _nibble_static_probs(x, "cpu")
        sst, sn = LK.lane_coder(sp, i_)
        sw = blockio.device_words(sst, sn)
        for name, f in dict(cdfs, block=None).items():
            sc = block_cdf if f is None else torch.from_numpy(
                np.concatenate([[0], np.cumsum(f)]).astype(np.int32))
            for bad, (bw, bn) in {"sound": (sw, sn), **_corrupt(
                    sw, sn, gen, "cpu")}.items():
                err[f"lane_nibble_static_decode {name} {bad}"] = _max_abs(
                    NK.lane_nibble_static_decode(bw.to(dev), bn.to(dev), K_,
                                                 sc.to(dev)),
                    NK.lane_nibble_static_decode_plain(bw, bn, K_, sc))
        for bad, (bw, bn) in {"sound": (w, n), **_corrupt(
                w, n, gen, "cpu")}.items():
            err[f"lane_nibble_decode {bad}"] = _max_abs(
                NK.lane_nibble_decode(bw.to(dev), bn.to(dev), K_),
                NK.lane_nibble_decode_plain(bw, bn, K_))
        if any(err.values()):
            raise AssertionError(f"lane nibble {what} L={L_} K={K_}: kernel "
                                 f"differs from plain: {err}")
        log(f"lane nibble kernels {what} L={L_} K={K_}: equal to plain, "
            f"tolerance 0 (max abs err 0 on {len(err)} comparisons: L9; "
            "L10 adaptive and static on the block's CDF, one where symbol 0 "
            "holds all but 15, zero frequencies first, between and last, and "
            "one symbol (0, 7, 15); sound and corrupt streams)")
    full_err, plain_ms = _held("lane-nibble-kernels-vs-plain", jobs, kern,
                               futures)
    log(f"lane nibble kernels L={L} K={K} (full shape): equal to plain, "
        f"tolerance 0 (max abs err {full_err}); plain ms on the host "
        + json.dumps(plain_ms))
    return dict(err=full_err, plain_ms=plain_ms, K=K, L=L)


def phase_lane_bit_kernels(dev, started: dict) -> dict:
    """L11 and L12 at every (predictor, order) of BIT, and L2 on id 1's
    probs, against their plain versions at the full shape (``started``,
    from ``phase_lane_new_full_shape``), exact.  First the wrappers must
    refuse an FSM table past BIT_MAX_STATES states.  Then on
    LANE_NEW_EDGE's and BIT_EDGE's bytes at every (predictor, order), and
    on the K = 37 case and BIT_EDGE's also BIT_EDGE_PREDS's predictors and
    corrupt streams (``_corrupt``), against the plain versions on the CPU,
    exact.  Returns the full-shape errors and plain ms by codec."""
    import numpy as np
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.models import bitpred
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_bit_kernel as BK
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    phase("lane-bit-kernels-vs-plain")
    text = _corpus("textbwt_16777216.bin", 1 << 22)
    jobs, kern, futures = started["bit"]
    K, L = started["K"], started["L"]
    rng = np.random.default_rng(20261019)
    gen = torch.Generator().manual_seed(20261019)
    for order in (0, 1):  # the wrappers refuse an FSM past 32,768 states
        big = bitpred.Fsm(torch.zeros((3, BK.BIT_MAX_STATES + 1),
                                      dtype=torch.int32, device=dev))
        for name, call in (("L11", lambda: BK.lane_bit_model(
                torch.zeros((4, 4), dtype=torch.uint8, device=dev), order,
                big)), ("L12", lambda: BK.lane_bit_decode(
                    torch.zeros((40,), dtype=torch.int16, device=dev),
                    torch.full((4,), 10, dtype=torch.int32, device=dev), 4,
                    order, big))):
            try:
                call()
            except ValueError:
                continue
            raise AssertionError(f"{name} order {order}: an FSM of "
                                 f"{BK.BIT_MAX_STATES + 1} states ran")
    log("lane bit kernels: an FSM past 32768 states refused (ValueError)")
    for what, L_, K_ in LANE_NEW_EDGE + BIT_EDGE:
        x = torch.from_numpy(_edge_cols(what, K_, L_, rng, text))
        i_ = torch.full((L_,), rans.ANS_LOW, dtype=torch.int32)
        preds = [(n, None) for n in ("s", "ss", "sf")]
        hard = K_ == 37 or (what, L_, K_) in BIT_EDGE
        if hard:
            preds += list(BIT_EDGE_PREDS)
        err = {}
        for order in (0, 1):
            for name, rates in preds:
                pc = _bit_pred(name, rates, "cpu",
                               np.random.default_rng(len(err)))
                pd = _bit_pred(name, rates, dev,
                               np.random.default_rng(len(err)))
                tag = f"{name}{rates or ''} o{order}"
                probs = BK.lane_bit_model_plain(x, order, pc)
                err[f"L11 {tag}"] = _max_abs(
                    BK.lane_bit_model(x.to(dev), order, pd), probs)
                st, n = LK.lane_coder(probs, i_)
                w = blockio.device_words(st, n)
                streams = {"sound": (w, n)}
                if hard:
                    streams.update(_corrupt(w, n, gen, "cpu"))
                for bad, (bw, bn) in streams.items():
                    err[f"L12 {tag} {bad}"] = _max_abs(
                        BK.lane_bit_decode(bw.to(dev), bn.to(dev), K_, order,
                                           pd),
                        BK.lane_bit_decode_plain(bw, bn, K_, order, pc))
        if any(err.values()):
            raise AssertionError(f"lane bit {what} L={L_} K={K_}: kernel "
                                 f"differs from plain: {err}")
        log(f"lane bit kernels {what} L={L_} K={K_}: equal to plain, "
            f"tolerance 0 (max abs err 0 on {len(err)} comparisons: "
            + ", ".join(err) + ")")
    full_err, ms = _held("lane-bit-kernels-vs-plain", jobs, kern, futures)
    plain_ms, errs = {}, {}
    for (name, args), key in zip(jobs, ms):
        codec = "rc-o0" if name == "lane_coder" else next(
            c for c, v in BIT.items() if v == (args[-2], args[-1]))
        plain_ms.setdefault(codec, {})[name] = ms[key]
        errs.setdefault(codec, {})[name] = full_err[key]
    log(f"lane bit kernels L={L} K={K} (full shape), every (predictor, "
        f"order): equal to plain, tolerance 0 (max abs err {errs}); plain "
        "ms on the host " + json.dumps(plain_ms))
    return dict(plain_ms=plain_ms, err=errs, K=K, L=L)


def _lane_bound_ms(name: str, L: int, K: int, geom, n_seg: int,
                   words: int, fsm_states: int = 0) -> tuple[float, str]:
    """``_bound_ms``'s rule for the lane kernels on L lanes and K bytes a
    lane: bytes each input read once and each output written once (the
    decoders read only the ``words`` u16 words the streams hold, and a
    lane's 8-byte offset and 4-byte length), integer ops as
    ``_lane_ops`` counts them; L4 does a table load, its state step and
    fetch per byte, and builds its 2^15-entry table once (8 halvings of
    3 ops an entry): the work of the function, whatever number of CTAs
    build their own copies.  L5-L8 (ids 59 and 64) also write each lane's
    start rows, an op an entry (112 rows a lane for id 59, read from
    its ``n_seg`` segment tables; 4,352 for id 64, from cdf16.init).  L9
    and L10 (ids 41, 40) do a lookup, an update (adaptive) and, decoding,
    a search, a state step and a fetch a nibble; L11 and L12 (ids 1, 2,
    101-104) ``BIT_STEP`` ops a binary decision, 8 a byte, and decoding a
    state step and a fetch each, and read an FSM table of
    ``fsm_states`` states (3 ints each) once; the order-1 tables are
    working state, as L5-L8's rows are."""
    S = 2 * K if name != "lane_static_decode" else K
    tables = n_seg * (16 + 256) * 4
    streams = words * 2 + L * (8 + 4)
    o1 = {"lane_o1r": ("o1", 64 + 48, n_seg), "lane_o1": ("o1byte", 4352, 0)
          }.get(name.rsplit("_", 1)[0])
    if o1:
        kind, rows, segs = o1
        decode = name.endswith("_decode")
        nbytes = ((streams if decode else 2 * K * L * 4) + K * L
                  + segs * rows * 16 * 4)
        ops = L * (_lane_ops(kind, geom, K, decode) + rows * 16)
    elif name == "lane_nibble_model":
        nbytes = K * L + 2 * K * L * 4
        ops = L * K * 2 * (LOOKUP + 80)
    elif name.startswith("lane_nibble_"):
        static = name == "lane_nibble_static_decode"
        nbytes = streams + K * L + (17 * 4 if static else 0)
        ops = L * K * 2 * (LOOKUP + 30 + 6 + 6 + (0 if static else 80))
    elif name.startswith("lane_bit_"):
        model = name == "lane_bit_model"
        nbytes = (K * L + 8 * K * L * 4 if model else streams + K * L) \
            + fsm_states * 3 * 4
        ops = L * K * 8 * (BIT_STEP + (0 if model else 6 + 6))
    elif name == "lane_model":
        nbytes = K * L + 2 * K * L * 4 + tables
        ops = L * _lane_ops("o0", geom, K, False)
    elif name == "lane_coder":
        nbytes = S * L * 4 + L * 4 + L * (S + 2) * 4 + L * 4
        ops = L * S * 10
    elif name == "lane_decode":
        nbytes = streams + tables + K * L
        ops = L * _lane_ops("o0", geom, K, True)
    else:
        nbytes = streams + 257 * 4 + K * L
        ops = L * K * (2 + 6 + 6) + (1 << 15) * 24
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lane_block(codec: str, x, dev):
    """One block ``x`` of the default CodecConfig as ids 56 (share 1, one
    warm-table segment) or 58 (``rans-cdf-s8``: share 8, its segments)
    shape it: (cols [K, L] on ``dev``, hi, lo tables, geometry, K)."""
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import rans_cdf_s8 as S58
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops.geom import Geom
    from turborc_tpu_torch.utils.config import CodecConfig
    cfg = CodecConfig()
    L = cfg.lanes
    if codec == "rans-cdf-s8":
        geom = Geom(share=8)
        tabs = S58.segment_tables(x, S58._n_seg(L, 8))
        block, K = S58.shape_spans(x, L, cfg.step_quant, 8, 32)
        cols = torch.from_numpy(block).to(dev).permute(1, 0, 2)
    else:
        geom = LK.PER_LANE
        tabs = (t[None] for t in blockio.nibble_tables(x))
        block, K = blockio.shape_block(x, L, cfg.step_quant)
        cols = torch.from_numpy(block).to(dev).T
    hi, lo = S58.tables_on(*tabs, dev)
    return cols.reshape(K, L).contiguous(), hi, lo, geom, K


def _events_ms(fn, *args):
    """(output, ms) of one call between two CUDA events, and the new
    allocator segments inside the span."""
    import torch
    seg = _segments()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), _segments() - seg


def phase_lane_timing(dev, nib: dict, bit: dict) -> dict:
    """The lane kernels on one 4 MB block of textbwt at the default
    CodecConfig (512 lanes, K = 8192; id 58 at its default geometry,
    share 8, 64 segments): per kernel a warm-up, then 3 timed calls on
    distinct rotations (CUDA events; a cudaMalloc inside a span fails
    the phase), the plain version once on the card (ids 56 and 42), and
    end-to-end MB/s of ids 56, 58 and 42 on textbwt 16 MB (api round
    trips, 4 blocks, a warm-up and 2 timed on distinct rotations); then
    ids 59 and 64 on realsrcbwt likewise (``_lane_o1_timing``) and their
    end-to-end MB/s on realsrcbwt 16 MB; then L9-L12 on textbwt
    (``_lane_new_timing``, with the plain ms of ``nib`` and ``bit``) and
    ids 41, 40, 1, 2, 101-104's end-to-end MB/s on textbwt 16 MB."""
    import numpy as np
    import torch
    from turborc_tpu_torch import api
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.utils.config import CodecConfig
    phase("timing-lane")
    text = _corpus("textbwt_16777216.bin")
    cfg = CodecConfig()
    L, B = cfg.lanes, cfg.block_size
    res = {}
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32, device=dev)
    for codec in ("rans-cdf-o0", "rans-cdf-s8", "rans-static"):
        ms, grew = {k: [] for k in LANE[codec]}, 0
        for r in range(4):  # rep 0 is the warm-up
            cols, hi, lo, geom, K = _lane_block(
                codec, np.roll(text, 7919 * (r + 1))[:B], dev)
            if codec == "rans-static":
                probs, cdf = _static_probs(cols, dev)
                (st, lens), t_c, g_c = _events_ms(LK.lane_coder, probs, init)
                words = blockio.device_words(st, lens)
                out, t_d, g_d = _events_ms(LK.lane_static_decode, words,
                                           lens, K, cdf)
                times = (t_c, t_d)
            else:
                probs, t_m, g_m = _events_ms(LK.lane_model, cols, hi, lo,
                                             geom)
                (st, lens), t_c, g_c = _events_ms(LK.lane_coder, probs, init)
                words = blockio.device_words(st, lens)
                out, t_d, g_d = _events_ms(LK.lane_decode, words, lens, K,
                                           hi, lo, geom)
                times, g_c = (t_m, t_c, t_d), g_c + g_m
            if not torch.equal(out, cols):
                raise AssertionError(f"timing-lane {codec}: round trip")
            if r:
                grew += g_c + g_d
                for k, t in zip(LANE[codec], times):
                    ms[k].append(t)
            nwords = int(lens.to(torch.int64).sum())
            if r < 3:
                del probs, st, words, out
        if grew:
            raise AssertionError(f"timing-lane {codec}: {grew} cudaMallocs "
                                 "inside the timed spans")
        plain_ms, plain = {}, {}
        if codec != "rans-cdf-s8":  # the main paths' plain versions, once
            t0 = time.perf_counter()
            if codec == "rans-static":
                pst = LK.lane_coder_plain(probs, init)[0]
                _sync()
                t1 = time.perf_counter()
                pout = LK.lane_static_decode_plain(words, lens, K, cdf)
                plain = dict(lane_coder=_max_abs(pst, st),
                             lane_static_decode=_max_abs(pout, out))
            else:
                pprobs = LK.lane_model_plain(cols, hi, lo, geom)
                _sync()
                tm = time.perf_counter()
                pst = LK.lane_coder_plain(probs, init)[0]
                _sync()
                t1 = time.perf_counter()
                pout = LK.lane_decode_plain(words, lens, K, hi, lo, geom)
                plain = dict(lane_model=_max_abs(pprobs, probs),
                             lane_coder=_max_abs(pst, st),
                             lane_decode=_max_abs(pout, out))
                plain_ms["lane_model"] = (tm - t0) * 1e3
                t0 = tm
            _sync()
            t2 = time.perf_counter()
            plain_ms[LANE[codec][-2]] = (t1 - t0) * 1e3
            plain_ms[LANE[codec][-1]] = (t2 - t1) * 1e3
            if any(plain.values()):
                raise AssertionError(f"timing-lane {codec}: plain differs "
                                     f"{plain}")
        bound = {k: _lane_bound_ms(k, L, K, geom, hi.shape[0], nwords)
                 for k in LANE[codec]}
        res[codec] = dict(ms={k: sum(v) / len(v) for k, v in ms.items()},
                          ms_reps=ms, plain_ms=plain_ms, err=plain, K=K,
                          words=nwords, bound=bound)
        del probs, st, words, out
        log(f"timing-lane {codec} " + json.dumps(res[codec]))
    res.update(_lane_o1_timing(dev))
    res.update(_lane_new_timing(dev, nib, bit))
    real = _corpus("realsrcbwt_16777216.bin")
    for codec in ("rans-cdf-o0", "rans-cdf-s8", "rans-static", *LANE_O1,
                  *NIBBLE, *BIT):
        corpus = text if codec not in LANE_O1 else real
        enc, dec = [], []
        c = CodecConfig(codec=codec)
        for r in range(3):  # rep 0 is the warm-up
            x = np.roll(corpus, 104729 * (r + 1))
            t0 = time.perf_counter()
            comp = api.compress(x, c, device=dev)
            _sync()
            t1 = time.perf_counter()
            back = api.decompress(comp, device=dev)
            _sync()
            t2 = time.perf_counter()
            if back != x.tobytes():
                raise AssertionError(f"timing-lane {codec}: round trip")
            if r:
                enc.append(t1 - t0)
                dec.append(t2 - t1)
        mb = corpus.size / 1e6
        res[codec]["e2e"] = dict(encode_MBps=[mb / s for s in enc],
                                 decode_MBps=[mb / s for s in dec],
                                 ratio=len(comp) / x.size)
        log(f"timing-lane {codec} end-to-end " + json.dumps(dict(
            codec=codec, corpus=("realsrcbwt_16777216.bin"
                                 if codec in LANE_O1
                                 else "textbwt_16777216.bin"), lanes=L,
            block_size=B, **res[codec]["e2e"])))
    return res


def _plain_job(job):
    """One plain version on the host CPU, in a worker process of
    ``_lane_o1_timing`` or ``host_pool``: (wrapper name, arguments as
    numpy arrays or ints; L11 / L12's predictor by name) -> (outputs as
    numpy arrays, seconds it took)."""
    import numpy as np
    import torch
    from turborc_tpu_torch.models import bitpred
    from turborc_tpu_torch.ops import rans_bit_kernel as BK
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
    from turborc_tpu_torch.ops import rans_nibble_kernel as NK
    torch.set_num_threads(1)
    name, args = job
    mod = {"lane_coder": LK, "lane_bit": BK, "lane_nibble": NK}.get(
        "_".join(name.split("_")[:2]) if name != "lane_coder" else name, LO)
    fn = getattr(mod, name + "_plain")
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]
    if mod is BK:  # the predictor by name, on the CPU
        args[-1] = bitpred.make(args[-1], device="cpu")
    t0 = time.perf_counter()
    out = fn(*args)
    seconds = time.perf_counter() - t0
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))
            ], seconds


def _lane_o1_timing(dev) -> dict:
    """L5-L8 and L2 on one 4 MB block of realsrcbwt at the default
    CodecConfig (id 59: 512 lanes, K = 8192, 16 segments; id 64: 128
    lanes, K = 32768): a warm-up, then 3 timed calls on distinct
    rotations (CUDA events; a cudaMalloc inside a span fails the phase).
    Then the plain versions of each codec's model, L2 and decode run once
    on its last block, at the main path's shape, on the host CPU: six
    worker processes at once, one thread each, each timed by its own
    clock.  Each is held equal to its kernel's output: probs, streams and
    lengths, bytes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
    from turborc_tpu_torch.utils.config import CodecConfig
    real = _corpus("realsrcbwt_16777216.bin")
    B, res, jobs, kern = CodecConfig().block_size, {}, [], []
    for codec, (m, c, d) in LANE_O1.items():
        model, decode = getattr(LO, m), getattr(LO, d)
        ms, grew = {k: [] for k in (m, c, d)}, 0
        for r in range(4):  # rep 0 is the warm-up
            cols, tabs, K = _o1_block(codec, np.roll(real, 7919 * (r + 1))[:B],
                                      dev)
            L = cols.shape[1]
            init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32,
                              device=dev)
            probs, t_m, g_m = _events_ms(model, cols, *tabs)
            (st, lens), t_c, g_c = _events_ms(LK.lane_coder, probs, init)
            words = blockio.device_words(st, lens)
            out, t_d, g_d = _events_ms(decode, words, lens, K, *tabs)
            if not torch.equal(out, cols):
                raise AssertionError(f"timing-lane {codec}: round trip")
            if r:
                grew += g_m + g_c + g_d
                for k, t in zip((m, c, d), (t_m, t_c, t_d)):
                    ms[k].append(t)
            nwords = int(lens.to(torch.int64).sum())
        if grew:
            raise AssertionError(f"timing-lane {codec}: {grew} cudaMallocs "
                                 "inside the timed spans")
        host = [t.cpu().numpy() for t in tabs]
        jobs += [(m, [cols.cpu().numpy(), *host]),
                 (c, [probs.cpu().numpy(), init.cpu().numpy()]),
                 (d, [words.cpu().numpy(), lens.cpu().numpy(), K, *host])]
        kern += [(probs,), (st, lens), (out,)]
        segs = tabs[0].shape[0] if tabs else 0
        res[codec] = dict(
            ms={k: sum(v) / len(v) for k, v in ms.items()}, ms_reps=ms,
            K=K, L=L, n_seg=segs, words=nwords,
            bound={k: _lane_bound_ms(k, L, K, None, segs, nwords)
                   for k in (m, c, d)},
            ctas={m: LO.o1_launch(L, codec)[3], c: -(-L // LK.CODER_LANES)})
        del cols, probs, st, words, out
    with ProcessPoolExecutor(len(jobs), multiprocessing.get_context(
            "spawn")) as pool:
        plain = list(pool.map(_plain_job, jobs))
    for n, codec in enumerate(LANE_O1):
        names = LANE_O1[codec]
        res[codec]["err"] = err = {
            k: max(_max_abs(torch.from_numpy(a), b.cpu())
                   for a, b in zip(plain[3 * n + i][0], kern[3 * n + i]))
            for i, k in enumerate(names)}
        res[codec]["plain_ms"] = {k: plain[3 * n + i][1] * 1e3
                                  for i, k in enumerate(names)}
        if any(err.values()):
            raise AssertionError(f"timing-lane {codec}: plain differs {err}")
        log(f"timing-lane {codec} " + json.dumps(res[codec]))
    return res


def _lane_new_timing(dev, nib: dict, bit: dict) -> dict:
    """L9, both L10s, and L11 and L12 at every (predictor, order), with L2
    on their probs, on one 4 MB block of textbwt at the default
    CodecConfig (512 lanes, K = 8,192): a warm-up, then 3 timed calls on
    distinct rotations (CUDA events; a cudaMalloc inside a span fails the
    phase).  The plain ms and errors are those of the vs-plain phases
    (``nib``, ``bit``: the plain versions at this shape on the host)."""
    import numpy as np
    import torch
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_bit_kernel as BK
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_nibble_kernel as NK
    from turborc_tpu_torch.utils.config import CodecConfig
    text = _corpus("textbwt_16777216.bin")
    B, res = CodecConfig().block_size, {}
    for codec in (*NIBBLE, *BIT):
        names = NIBBLE.get(codec, BIT_KERNELS)
        ms, grew = {k: [] for k in names}, 0
        for r in range(4):  # rep 0 is the warm-up
            cols, K = _default_block(np.roll(text, 7919 * (r + 1))[:B], dev)
            L = cols.shape[1]
            init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32,
                              device=dev)
            timed, extra = [], ()
            if codec == "rc4":
                model, decode = (NK.lane_nibble_model,), NK.lane_nibble_decode
            elif codec == "rc4c":
                probs, cdf = _nibble_static_probs(cols, dev)
                model, decode, extra = None, NK.lane_nibble_static_decode, (
                    cdf,)
            else:
                order, pred = BIT[codec]
                extra = (order, _bit_pred(pred, None, dev))
                model, decode = (BK.lane_bit_model,), BK.lane_bit_decode
            if model:
                probs, t, g = _events_ms(model[0], cols, *extra)
                timed.append((t, g))
            (st, lens), t, g = _events_ms(LK.lane_coder, probs, init)
            timed.append((t, g))
            words = blockio.device_words(st, lens)
            out, t, g = _events_ms(decode, words, lens, K, *extra)
            timed.append((t, g))
            if not torch.equal(out, cols):
                raise AssertionError(f"timing-lane {codec}: round trip")
            if r:
                grew += sum(g for _, g in timed)
                for k, (t, _) in zip(names, timed):
                    ms[k].append(t)
            nwords = int(lens.to(torch.int64).sum())
            del cols, probs, st, lens, words, out
        if grew:
            raise AssertionError(f"timing-lane {codec}: {grew} cudaMallocs "
                                 "inside the timed spans")
        src = nib if codec in NIBBLE else dict(
            plain_ms=bit["plain_ms"][codec], err=bit["err"][codec])
        states = 1 << 15 if codec.endswith("-sf") else 0
        res[codec] = dict(
            ms={k: sum(v) / len(v) for k, v in ms.items()}, ms_reps=ms,
            K=K, L=L, words=nwords,
            plain_ms={k: v for k, v in src["plain_ms"].items()
                      if k in names},
            err={k: v for k, v in src["err"].items() if k in names},
            bound={k: _lane_bound_ms(k, L, K, None, 0, nwords, states)
                   for k in names})
        log(f"timing-lane {codec} " + json.dumps(res[codec]))
    return res


def _lane_rows(timed: dict, launches: dict) -> list:
    """The kernels-line rows of L1-L4: L1-L3 at id 56's main path (the
    default codec), L4 at id 42's; L1, L3 and L4 with T (threads a lane),
    L2 with N (lanes a CTA)."""
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    rows = []
    for name, codec in (("lane_model", "rans-cdf-o0"),
                        ("lane_coder", "rans-cdf-o0"),
                        ("lane_decode", "rans-cdf-o0"),
                        ("lane_static_decode", "rans-static")):
        t = timed[codec]
        bound, by = t["bound"][name]
        rows.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name], launches=launches[codec][name],
            max_abs_err=t["err"][name], ms=t["ms"][name],
            plain_ms=t["plain_ms"][name],
            bound_ms=bound, bound_by=by, library_ms=None))
        rows[-1].update({"lane_coder": dict(N=LK.CODER_LANES),
                         "lane_static_decode": dict(T=LK.STATIC_TEAM)}.get(
                             name, dict(T=LK.lane_team(1))))
    return rows


def _lane_o1_rows(timed: dict, launches: dict, before: dict) -> list:
    """The kernels-line rows of L5-L8 at their codecs' main paths, with T
    (threads a lane), N (lanes a CTA), CTAs and smem (shared-memory bytes
    a CTA) and, for L6 and L8, from ``before`` (timing-before-after),
    before_ms and after_ms."""
    from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
    rows = []
    for codec, (m, _, d) in LANE_O1.items():
        t = timed[codec]
        for name in (m, d):
            N, _, smem, ctas = LO.o1_launch(t["L"], codec, decode=name == d)
            bound, by = t["bound"][name]
            rows.append(dict(
                name=name, route="cuda", source=SOURCE[name],
                replaces=REPLACES[name], launches=launches[codec][name],
                max_abs_err=t["err"][name], ms=t["ms"][name],
                plain_ms=t["plain_ms"][name], bound_ms=bound, bound_by=by,
                library_ms=None, T=LO.O1_TEAM, N=N, CTAs=ctas, smem=smem))
            if name in REDESIGNED:
                pair = before.get(codec, {}).get(name, {})
                mean = {w: sum(v) / len(v) if v else None
                        for w, v in pair.items()}
                # before_ms / after_ms: bare C entries, in turns, one phase
                rows[-1].update(before_ms=mean.get("before"),
                                after_ms=mean.get("after"))
    return rows


def _lane_new_rows(timed: dict, launches: dict, before: dict) -> list:
    """The kernels-line rows of L9-L12 at their codecs' main paths: L9
    and L10 (adaptive) at id 41's, L10's static instantiation at id 40's,
    L11 and L12 at each of ids 1, 2, 101-104's (one row a template
    instantiation, ``lane_bit_model<predictor,order>``), with T (threads
    a lane) or threads (a CTA), and CTAs; L11 and L12 also with
    before_ms and after_ms from ``before`` (timing-before-after)."""
    from turborc_tpu_torch.ops import rans_bit_kernel as BK
    from turborc_tpu_torch.ops import rans_nibble_kernel as NK
    rows = []
    cases = []
    for k, c in (("lane_nibble_model", "rc4"), ("lane_nibble_decode", "rc4"),
                 ("lane_nibble_static_decode", "rc4c")):
        threads, ctas = NK.nib_launch(timed[c]["L"],
                                      decode=k != "lane_nibble_model")
        cases.append((k, k, c, dict(threads=threads, CTAs=ctas)))
    for codec, (order, pred) in BIT.items():
        for k in ("lane_bit_model", "lane_bit_decode"):
            threads, ctas = BK.bit_launch(timed[codec]["L"],
                                          decode=k == "lane_bit_decode")
            cases.append((f"{k}<{pred},{order}>", k, codec,
                          dict(threads=threads, CTAs=ctas)))
    for row_name, k, codec, extra in cases:
        t = timed[codec]
        bound, by = t["bound"][k]
        rows.append(dict(
            name=row_name, route="cuda", source=SOURCE[k],
            replaces=REPLACES[k], launches=launches[codec][k],
            max_abs_err=t["err"][k], ms=t["ms"][k],
            plain_ms=t["plain_ms"][k], bound_ms=bound, bound_by=by,
            library_ms=None, codec=codec, **extra))
        if k in REDESIGNED:
            pair = before.get(codec, {}).get(k, {})
            mean = {w: sum(v) / len(v) if v else None
                    for w, v in pair.items()}
            # before_ms / after_ms: bare C entries, in turns, one phase
            rows[-1].update(before_ms=mean.get("before"),
                            after_ms=mean.get("after"))
    return rows


def _rows(names, timed: dict, geom, launches: dict) -> list:
    from turborc_tpu_torch.ops import rans_kernel as K_
    rows = []
    for k in names:
        bound, by = _bound_ms(k, geom, timed["K"], timed["glens_sum"])
        rows.append(dict(
            name=k, route="cuda", source=SOURCE[k], replaces=REPLACES[k],
            launches=launches[k], max_abs_err=timed["err"][k],
            ms=timed["ms"][k], plain_ms=timed["plain_ms"][k],
            bound_ms=bound, bound_by=by, library_ms=None))
        if k in ("decode", "decode_x2"):  # T: threads per lane
            rows[-1].update(T=K_.decode_launch(geom).threads // K_.GLANES)
    return rows


def child(before: str | None) -> int:
    import torch
    from turborc_tpu_torch.ops.geom import Geom
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    dev = torch.device("cuda")
    log("device " + json.dumps(dict(kind=torch.cuda.get_device_name(0),
                                    count=torch.cuda.device_count())))
    before_libs = phase_build(before)
    with host_pool() as pool:
        started = phase_lane_new_full_shape(dev, pool)
        phase_kernels(dev)
        phase_decode_cases(dev)
        phase_place_edge(dev)
        phase_coder_edge(dev)
        phase_lane_kernels(dev)
        phase_lane_edge(dev)
        phase_lane_o1_kernels(dev)
        nib = phase_lane_nibble_kernels(dev, started)
        bit = phase_lane_bit_kernels(dev, started)
    golden, golden_r1 = _golden(GOLDEN), _golden(GOLDEN_R1)
    golden_rcp, golden_x2 = _golden(GOLDEN_RCP), _golden(GOLDEN_X2)
    main = _roundtrip("roundtrip-64MB-bench-geom",
                      golden["textbwt_67108864_bench"], KERNELS["o0"], dev)
    _roundtrip("roundtrip-16MB-default-config",
               golden["textbwt_16777216_default"], KERNELS["o0"], dev)
    main_r1 = _roundtrip("roundtrip-r1p-16MB-one-block",
                         golden_r1["realsrcbwt_16777216_r1p"], KERNELS["o1"],
                         dev)
    _roundtrip("roundtrip-auto-realsrcbwt-16MB",
               golden_r1["realsrcbwt_16777216_auto"], KERNELS["o1"], dev)
    _roundtrip("roundtrip-auto-textbwt-16MB",
               golden_r1["textbwt_16777216_auto"],
               KERNELS["o0"] + KERNELS["o1"], dev)
    main_x2 = _roundtrip("roundtrip-o0p-x2-64MB",
                         golden_x2["textbwt_67108864_x2"], KERNELS["x2"], dev)
    main_rcp = _roundtrip("roundtrip-rcp-16MB-one-block",
                          golden_rcp["textbwt_16777216_rcp"],
                          KERNELS["tree"], dev)
    golden_lane = _golden(GOLDEN_LANE)
    main_lane = {codec: _roundtrip(f"roundtrip-{codec}-16MB-default-config",
                                   golden_lane[f"textbwt_16777216_{codec}"],
                                   LANE[codec], dev)["launches"]
                 for codec in LANE}
    golden_lane_o1 = _golden(GOLDEN_LANE_O1)
    main_lane.update({
        codec: _roundtrip(f"roundtrip-{codec}-16MB-default-config",
                          golden_lane_o1[f"realsrcbwt_16777216_{codec}"],
                          LANE_O1[codec], dev)["launches"]
        for codec in LANE_O1})
    for case in json.loads(GOLDEN_BIT.read_text())["large"]:
        codec, mb = case["codec"], case.get("n", 1 << 24) >> 20
        main_lane[codec] = _roundtrip(
            f"roundtrip-{codec}-{mb}MB-default-config", case,
            NIBBLE.get(codec, BIT_KERNELS), dev)["launches"]
    bench, bench_x2 = Geom.parse(BENCH_GEOM), Geom.parse(BENCH_GEOM_X2)
    t0 = _time_path("timing", "o0", "textbwt_67108864.bin", bench, dev)
    t1 = _time_path("timing-o1", "o1", "realsrcbwt_16777216.bin", Geom(),
                    dev)
    tx = _time_path("timing-x2", "x2", "textbwt_67108864.bin", bench_x2,
                    dev)
    tt = _time_path("timing-tree", "tree", "textbwt_16777216.bin", Geom(),
                    dev)
    tl = phase_lane_timing(dev, nib, bit)
    timed = phase_before_after(dev, before, before_libs)
    rows = (_rows(KERNELS["o0"], t0, bench, main["launches"])
            + _rows(("o1_model", "o1_decode"), t1, Geom(),
                    main_r1["launches"])
            + _rows(("decode_x2",), tx, bench_x2, main_x2["launches"])
            + _rows(("tree_model", "tree_decode"), tt, Geom(),
                    main_rcp["launches"])
            + _lane_rows(tl, main_lane)
            + _lane_o1_rows(tl, main_lane, timed)
            + _lane_new_rows(tl, main_lane, timed))
    log("card (nvidia-smi name, power.limit):")
    log(_smi())
    log(json.dumps({"kernels": rows}))
    log(CHILD_DONE)
    return 0


# ---------------------------------------------------------------------------
# parent: watchdog
# ---------------------------------------------------------------------------

def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 2
    proc = subprocess.Popen(
        [sys.executable, "-u", str(Path(__file__).resolve()), CHILD_FLAG,
         *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), start_new_session=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    t_start = time.monotonic()
    deadline = t_start + BUDGET_S
    current, device, done = "start", None, False
    while True:
        left = deadline - time.monotonic()
        try:
            line = lines.get(timeout=max(left, 0.01))
        except queue.Empty:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            print(f"chip_smoke: FAILED, phase {current} overran the "
                  f"{BUDGET_S} s budget; child killed", file=sys.stderr)
            return 1
        if line is None:
            break
        if line.startswith("phase "):
            current = line[len("phase "):]
        elif line.startswith("device "):
            device = json.loads(line[len("device "):])
        elif line == CHILD_DONE:
            done = True
        print(line, flush=True)
    rc = proc.wait()
    if rc != 0 or not done or device is None:
        print(f"chip_smoke: FAILED in phase {current} (child exit {rc})",
              file=sys.stderr)
        return 1
    print(f"chip_smoke: every phase in {time.monotonic() - t_start:.1f} s "
          f"of the {BUDGET_S} s budget", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


def _args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(CHILD_FLAG, action="store_true", help=argparse.SUPPRESS)
    ap.add_argument(BEFORE_FLAG, metavar="COMMIT",
                    help="also time L5-L12 of the git archive of COMMIT "
                    "unpacked in _archive/COMMIT/")
    return ap.parse_args(argv)


if __name__ == "__main__":
    opt = _args(sys.argv[1:])
    if opt.child:
        sys.path.insert(0, str(ROOT))
        sys.exit(child(opt.before))
    sys.exit(main([] if opt.before is None else [BEFORE_FLAG, opt.before]))
