#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (turborc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels with nvcc, holds each kernel against its
plain PyTorch version, round-trips two corpora through the port's
``compress``/``decompress`` and checks the containers against the golden
hashes the JAX package wrote, then times the kernels.  It imports no JAX
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
BUDGET_S = 600
BENCH_GEOM = "g64c8s8y8l32a4r4"
CHILD_FLAG = "--child"
CHILD_DONE = "chip_smoke: all phases passed"
SOURCE = "turborc_tpu_torch/ops/csrc/rans_kernel.cu"
REPLACES = {
    "model": "turborc_tpu/ops/pallas/rans_kernel.py:807",
    "coder": "turborc_tpu/ops/pallas/rans_kernel.py:883",
    "place": "turborc_tpu/ops/pallas/rans_kernel.py:1017",
    "decode": "turborc_tpu/ops/pallas/rans_kernel.py:407",
}
# H100 SXM peaks: HBM3 bytes/s, and the float32 rate outside the tensor
# cores, used for 32-bit integer ops (taking the higher of the two rates
# keeps this a lower bound).
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


def log(*parts) -> None:
    print(*parts, flush=True)


def phase(name: str) -> None:
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


def phase_build() -> dict:
    import torch
    from turborc_tpu_torch.ops import build
    phase("build")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    info = build.build()
    build.load()
    log(f"build: {info['path']} built={info['built']} "
        f"nvcc {info['seconds']:.2f} s")
    # ptxas -v: "Compiling entry function 'X'" then "Used N registers ..."
    fn = None
    for line in info["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '\w*?"
                      r"(model|coder|place|decode)_kernel", line)
        if m:
            fn = m.group(1)
        elif "Used" in line and fn:
            log(f"ptxas {fn}: {line.split(':', 1)[-1].strip()}")
    return info


def _corpus(name: str, n: int | None = None):
    import numpy as np
    return np.fromfile(DATA / name, np.uint8, count=-1 if n is None else n)


def _max_abs(a, b) -> int:
    import torch
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _run_path(args, geom, kernels: bool):
    """model -> coder -> place -> decode on one block's arguments, through
    the kernels (``kernels``) or their plain versions; returns every
    output and the per-stage seconds (CUDA events)."""
    import torch
    from turborc_tpu_torch.ops import rans_kernel as K_
    G, K = geom.groups, args.K
    cols = args.block.T.contiguous().reshape(K, G, 128)
    stages = (
        ("model", K_.model if kernels else K_.model_plain,
         lambda o: (cols, args.hi_tbl, args.lo_tbl, geom)),
        ("coder", K_.coder if kernels else K_.coder_plain,
         lambda o: (o["model"], args.init_states)),
        ("place", K_.place if kernels else K_.place_plain,
         lambda o: (*o["coder"], geom)),
        ("decode", K_.decode_tile if kernels else K_.decode_plain,
         lambda o: (o["place"][0], K, args.hi_tbl, args.lo_tbl, geom)),
    )
    outs, ms = {}, {}
    for name, fn, mk in stages:
        a = mk(outs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs[name] = fn(*a)
        end.record()
        end.synchronize()
        ms[name] = start.elapsed_time(end)
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


# Geometries that drive the kernels' other branches at 64 KB: per-lane
# models (share 1), a full-warp set, shared-memory set sums (share 64,
# 128), static lo rows (arows 4, 0), srows > arows, and rate 9.
BRANCH_GEOMS = ("g2c2s1y2l4a16r4", "g4c4s32y4l8a0r0", "g1c8s64y8l32a16r4",
                "g1c8s128y8l32a8r2u9", "g2c2s8y2l4a4r4", "g2c8s16y8l16a16r20")


def phase_kernels(dev) -> None:
    import torch
    from turborc_tpu_torch.codecs import rans_cdf_o0_p as C
    from turborc_tpu_torch.ops.geom import Geom
    phase("kernels-vs-plain")
    full = _corpus("textbwt_16777216.bin", 1 << 20)
    cases = [(BENCH_GEOM, full), (Geom().spec, full)] + [
        (spec, full[:1 << 16]) for spec in BRANCH_GEOMS]
    for spec, data in cases:
        geom = Geom.parse(spec)
        args = C.encode_args(data, geom, dev)
        kern, _ = _run_path(args, geom, kernels=True)
        plain, _ = _run_path(args, geom, kernels=False)
        err = _compare(kern, plain)
        out, fstates = kern["decode"]
        if not (torch.equal(out.reshape(args.K, -1).T, args.block)
                and torch.equal(fstates, args.init_states)):
            raise AssertionError(f"kernels {spec}: decode did not return the "
                                 "block and the seeded states")
        log(f"kernels {geom.spec} K={args.K}: equal to plain, tolerance 0 "
            f"(max abs err {err}); decode returns the block")


def _golden() -> dict:
    return {c["name"]: c for c in json.loads(GOLDEN.read_text())["large"]}


def _roundtrip(label: str, case: dict, dev) -> dict:
    import numpy as np
    from turborc_tpu_torch import api
    from turborc_tpu_torch.ops import rans_kernel as K_
    from turborc_tpu_torch.ops.geom import Geom
    from turborc_tpu_torch.utils.config import CodecConfig
    phase(label)
    data = _corpus(case["file"])
    geom = Geom.parse(case["geom"]) if case["geom"] else None
    cfg = CodecConfig(codec="rans-cdf-o0-p", block_size=case["block_size"],
                      geom=geom)
    K_.reset_launches()
    t0 = time.perf_counter()
    comp = api.compress(data, cfg, device=dev)
    _sync()
    t1 = time.perf_counter()
    back = api.decompress(comp, device=dev)
    _sync()
    t2 = time.perf_counter()
    counts = dict(K_.launches)
    if back != data.tobytes():
        raise AssertionError(f"{label}: decompress(compress(x)) != x")
    sha = hashlib.sha256(comp).hexdigest()
    if (len(comp), sha) != (case["length"], case["sha256"]):
        raise AssertionError(
            f"{label}: container {len(comp)} B sha256 {sha} differs from the "
            f"JAX golden {case['length']} B {case['sha256']}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    res = dict(bytes=int(data.size), comp=len(comp),
               ratio=len(comp) / data.size,
               encode_s=t1 - t0, decode_s=t2 - t1, launches=counts,
               geom=(geom or Geom()).spec)
    log(f"{label}: ok, container equals golden sha256 {sha[:16]}..., "
        + json.dumps(res))
    return res


def _bound_ms(name: str, geom, args, glens_sum: int) -> tuple[float, str]:
    """Least time for the same work: max(bytes / HBM rate, ops / peak).

    Bytes count each input read once and each output written once; only
    the words the streams hold are read (by the decoder) or placed (by
    place, which reads the words of emitting lanes alone).  Ops count the
    algorithm's integer operations per lane and step: a CDF16 lookup is 32
    selects, a search 30, an update 80 (5 per entry), a state step 6, a
    word fetch or placement 6, a re-join 16 entries x (2 log2(share) + 6)
    per table row."""
    import math
    G, K = geom.groups, args.K
    L, S = G * 128, 2 * args.K
    R = S + 2 + geom.wrows
    tables = (16 + 256) * G * 4
    rejoin = 16 * (2 * int(math.log2(geom.share)) + 6) if geom.share > 1 \
        else 0
    hot = (K // geom.sync) * (1 + geom.hrows) * rejoin
    cold = (K // geom.lsync) * max(geom.arows - geom.srows, 0) * rejoin
    model_ops = K * 2 * (32 + 80) + hot + cold
    if name == "model":
        nbytes = K * L + S * L * 4 + tables
        ops = L * model_ops
    elif name == "coder":
        nbytes = S * L * (4 + 4 + 1) + 2 * L * 4
        ops = L * S * 10
    elif name == "place":
        words = glens_sum - 256 * G  # emitted words = sum(emit)
        nbytes = S * L + words * 4 + L * 4 + G * R * 128 * 4 + G * 4
        ops = L * S * 6
    else:
        nbytes = glens_sum * 4 + tables + K * L + L * 4
        ops = L * (model_ops + K * 2 * (30 + 6 + 6))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(dev, main_launches: dict) -> None:
    import numpy as np
    import torch
    from turborc_tpu_torch import api
    from turborc_tpu_torch.codecs import rans_cdf_o0_p as C
    from turborc_tpu_torch.ops.geom import Geom
    from turborc_tpu_torch.utils.config import CodecConfig
    phase("timing")
    geom = Geom.parse(BENCH_GEOM)
    base = _corpus("textbwt_67108864.bin")
    # Distinct inputs per repetition (the corpus rotated).  The warm-up's
    # outputs are freed before the timed runs, so every buffer they need
    # is in the allocator's cache and no cudaMalloc lands in a timed span.
    _run_path(C.encode_args(np.roll(base, 1), geom, dev), geom, kernels=True)
    ms = {k: [] for k in REPLACES}
    for r in range(3):
        args = C.encode_args(np.roll(base, 7919 * (r + 1)), geom, dev)
        _, t = _run_path(args, geom, kernels=True)
        for k, v in t.items():
            ms[k].append(v)
    # each kernel against its plain version at the main path's shapes
    kern, _ = _run_path(args, geom, kernels=True)
    plain, plain_ms = _run_path(args, geom, kernels=False)
    err = _compare(kern, plain)
    log(f"kernels {geom.spec} K={args.K}: equal to plain, tolerance 0 "
        f"(max abs err {err})")
    glens_sum = int(kern["place"][1].to(torch.int64).sum())
    del kern, plain
    cfg = CodecConfig(codec="rans-cdf-o0-p", block_size=1 << 26, geom=geom)
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
            raise AssertionError("timing: round trip failed")
        if r:
            enc.append(t1 - t0)
            dec.append(t2 - t1)
            ratios.append(len(comp) / x.size)
    mb = base.size / 1e6
    kms = {k: sum(v) / len(v) for k, v in ms.items()}
    log("timing end-to-end " + json.dumps(dict(
        geom=geom.spec, bytes=int(base.size), reps=len(enc),
        encode_MBps=[mb / s for s in enc], decode_MBps=[mb / s for s in dec],
        ratio=ratios,
        encode_kernel_share=[(kms["model"] + kms["coder"] + kms["place"])
                             / 1e3 / s for s in enc],
        decode_kernel_share=[kms["decode"] / 1e3 / s for s in dec],
        kernel_ms_reps=ms)))
    log("card (nvidia-smi name, power.limit):")
    log(_smi())
    rows = []
    for k in REPLACES:
        bound, by = _bound_ms(k, geom, args, glens_sum)
        rows.append(dict(
            name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
            launches=main_launches[k], max_abs_err=err[k],
            ms=kms[k], plain_ms=plain_ms[k],
            bound_ms=bound, bound_by=by, library_ms=None))
    log(json.dumps({"kernels": rows}))


def child() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    dev = torch.device("cuda")
    log("device " + json.dumps(dict(kind=torch.cuda.get_device_name(0),
                                    count=torch.cuda.device_count())))
    phase_build()
    phase_kernels(dev)
    golden = _golden()
    main = _roundtrip("roundtrip-64MB-bench-geom",
                      golden["textbwt_67108864_bench"], dev)
    _roundtrip("roundtrip-16MB-default-config",
               golden["textbwt_16777216_default"], dev)
    phase_timing(dev, main["launches"])
    log(CHILD_DONE)
    return 0


# ---------------------------------------------------------------------------
# parent: watchdog
# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 2
    proc = subprocess.Popen(
        [sys.executable, "-u", str(Path(__file__).resolve()), CHILD_FLAG],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), start_new_session=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + BUDGET_S
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
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    if CHILD_FLAG in sys.argv[1:]:
        sys.path.insert(0, str(ROOT))
        sys.exit(child())
    sys.exit(main())
