"""Probe of the o0 decoders K1 and K5 on one GPU: where a byte step's
cycles go, what ptxas and the SASS say, and what each part of the step
costs.  With ``--kernel model``, the o0 model K2 instead (see
``probe_model``); with ``--kernel o1_decode``, the o1 decoder K6 (the
same split, SASS and ablations on id 60's block, ``probe_split``); with
``--kernel coder``, the coder K3 (SASS and ablations on id 57's block,
``probe_coder``).  For these three ``--src`` may also be the ``csrc`` of
9ed2fbe, whose K6 and K3 each layout tells apart.  With ``--kernel
o1_model``, ``--kernel tree_decode`` or ``--kernel tree_model``, the o1
model K7 on id 60's block, the bit-tree decoder K8 or model K9 on id 8's
(the split, SASS, CTAs an SM and ablations, ``probe_split``); ``--src``
may also be the ``csrc`` of e3484f9 (K7, K8) or af41c8b (K9), whose
layouts it tells apart.

    python3 tools/decode_probe.py [--src DIR] [--ablate no-rejoin,...]
        [--label NAME] [--out FILE]
        [--kernel decode|model|o1_decode|coder|o1_model|tree_decode|
                  tree_model]

``--src`` is a ``csrc`` directory: the port's own (the default), or that
of commit ff11eb3 (a ``git archive ff11eb3`` unpacked into a git-ignored
directory), whose decoders read each stream word from device memory.
Which of the two it holds is read from the source (``LAYOUTS``).  For
that source the probe

1. builds ``rans_kernel.cu`` with ``nvcc -Xptxas -v`` and reports, for
   ``decode_kernel`` and ``decode_x2_kernel``, registers, stack, spills
   and barriers; from ``cuobjdump -sass`` the static instruction count of
   each kernel and of its byte loop (the longest backward branch), by
   opcode class; and, with ``nvdisasm``, the source lines of every
   local-memory (stack) access;
2. builds a copy of the source with ``clock64()`` stamps inserted after
   fixed source lines of K1's byte loop (the copy lives in the build
   directory), runs it on one 64 MB block of ``textbwt_67108864.bin`` at
   ``g64c8s8y8l32a4r4`` and reports the cycles that thread 0 of CTA 0
   spent in each segment of the byte step, summed over the block and per
   byte step.  A stamp first adds the segment's result to a sink, so a
   segment is charged for the latency of its own loads; the stamps cost
   time themselves, so the stamped kernel's time is reported beside the
   plain one;
3. times K1 and K5 (CUDA events around the bare C entry, a warm-up then 3
   repetitions on distinct rotations of the block), held byte for byte
   against the port's decoders on the same inputs, and, for the port's
   source, with the parts named in ``--ablate`` cut out (``ABLATIONS``:
   timed only, their output is wrong by construction).

A stamp or an ablation whose source line is gone fails the run.  It
prints one JSON object and writes it to ``--out``, with the SASS of the
base build beside it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from turborc_tpu_torch.ops import build  # noqa: E402
from turborc_tpu_torch.ops import rans_kernel as K_  # noqa: E402
from turborc_tpu_torch.ops.geom import Geom  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "turborc_tpu" / "bench" / "_data" / "textbwt_67108864.bin"
GEOM = "g64c8s8y8l32a4r4"
WORK = build.BUILD_DIR / "probe"

# The two layouts: "ff11eb3" (K1's loop in decode_kernel, words from
# device memory) and "ring" (the port's, K1 and K5 on decode_lanes), told
# apart by the function that holds the byte loop (LOOP_IN).
# Stamps: (source line after which the stamp goes, occurrence within the
# byte loop, segment, value the segment produced).  Segment names follow
# in SEGMENTS.
STAMPS = {
    "ff11eb3": [
        ("state = uint32_t(fr_h) * (state >> 15) + value - uint32_t(low_h);",
         1, 0, "state"),
        ("fetch(state, s, limit, base, sm.wsum, buf);", 1, 1, "state"),
        ("cdf_update(hi, low_h, m.rate);", 1, 2, "hi[15]"),
        ("for (int i = 0; i < 16; ++i) row[i] = sm.lo_s[lo_at(hs, i)];",
         1, 3, "row[15]"),
        ("state = uint32_t(fr_l) * (state >> 15) + value - uint32_t(low_l);",
         1, 4, "state"),
        ("fetch(state, s, limit, base, sm.wsum, buf);", 2, 5, "state"),
        ("out[size_t(t) * plane + col] = uint8_t((hs << 4) | ls);", 1, 6,
         "row[15]"),
        ("rejoin_after(t, m, hi, start_hi, sm.lo_s, sm.st_s, sm.red);", 1,
         7, "hi[15]"),
    ],
    "ring": [
        ("state[0] = uint32_t(fr_h) * (state[0] >> 15) + value - "
         "uint32_t(low_h);", 1, 0, "state[0]"),
        ("fetch_post(state, bal, b.rank, buf, nfetch);", 1, 1, "bal[0]"),
        ("ld_row(rp, half, row);", 1, 2, "row[0]"),
        ("cdf_update(hi, low_h, m.rate);", 1, 3, "hi[0]"),
        ("fetch_take(state, bal, r, limit, b.rank, buf, nfetch);", 1, 4,
         "state[0]"),
        ("uint32_t(low_l);", 1, 5, "state[NS - 1]"),
        ("fetch_post(state, bal, b.rank, buf, nfetch);", 2, 6, "bal[0]"),
        ("rejoin_batches_after(t, m, b, hi, start_hi);", 1, 7, "hi[0]"),
        ("fetch_take(state, bal, r, limit, b.rank, buf, nfetch);", 2, 8,
         "state[NS - 1]"),
    ],
}
LOOP_IN = {"ff11eb3": "decode_kernel(", "ring": "decode_lanes("}
SEGMENTS = {
    "ff11eb3": ["hi search+lookup+state", "fetch 1 (ballot, barrier, word)",
             "hi update", "lo row load", "lo search+lookup+state",
             "fetch 2 (ballot, barrier, word)",
             "lo update, store, out byte", "re-join (every 8th byte)"],
    "ring": ["hi search+lookup+state",
             "fetch 1 post (ballot, counts, barrier)", "lo row load",
             "hi update",
             "fetch 1 take (prefix, word)", "lo search+lookup+state",
             "fetch 2 post (ballot, counts, barrier)",
             "lo update, store, out byte, re-join",
             "fetch 2 take (prefix, word)"],
}
PRELUDE = r"""
__device__ unsigned long long trc_split_acc[32];
extern "C" int trc_split_read(void* out) {
  return int(cudaMemcpyFromSymbol(out, trc_split_acc, sizeof(trc_split_acc)));
}
#ifndef TRC_SECOND
#define TRC_SECOND 0
#endif
#define TRC_SPLIT_BEGIN                                                    \
  unsigned long long trc_acc[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};       \
  unsigned trc_sink = 0;                                                   \
  const bool trc_on = blockIdx.x == 0 &&                                   \
                      (threadIdx.x == 0 || threadIdx.x == TRC_SECOND);     \
  long long trc_last = clock64();
#define TRC_STAMP(k, v)                                                    \
  if (trc_on) {                                                            \
    trc_sink += unsigned(v);                                               \
    const long long trc_now = clock64();                                   \
    trc_acc[k] += trc_now - trc_last;                                      \
    trc_last = trc_now;                                                    \
  }
#define TRC_SPLIT_END                                                      \
  if (trc_on) {                                                            \
    const int trc_at = threadIdx.x == 0 ? 0 : 16;                          \
    for (int k = 0; k < 10; ++k) trc_split_acc[trc_at + k] = trc_acc[k];   \
    trc_split_acc[trc_at + 15] = trc_sink;                                 \
  }
"""


def stamped(source: str, loop_in: str, stamps: list,
            second: str | None = None) -> str:
    """The source with clock64() stamps (``STAMPS``' form) in the byte
    loop of the function that starts at ``loop_in``, for thread 0 of CTA 0
    and, with ``second`` (a C expression), that thread too (its sums at
    ``trc_split_acc[16:]``)."""
    head, sep, rest = source.partition('#include "rans_common.cuh"\n')
    if not sep:
        raise ValueError("rans_common.cuh include not found")
    start = rest.index(loop_in)
    loop = rest.index("for (int t = 0; t < K; ++t) {", start)
    end = rest.index("\n  }\n", loop) + len("\n  }\n")
    line = rest.rfind("\n", 0, loop) + 1
    pragma = rest.rfind("\n", 0, line - 1) + 1
    if rest[pragma:line].startswith("#pragma unroll"):  # stays on the loop
        loop = pragma
    body = rest[loop:end]
    for anchor, nth, seg, val in stamps:
        at = -1
        for _ in range(nth):
            at = body.index(anchor, at + 1)
        eol = body.index("\n", at)
        body = (body[:eol] + f"\n    TRC_STAMP({seg}, {val});"
                + body[eol:])
    define = f"#define TRC_SECOND {second}\n" if second else ""
    return (head + sep + define + PRELUDE + rest[:loop]
            + "TRC_SPLIT_BEGIN\n  "
            + body + "  TRC_SPLIT_END\n" + rest[end:])


def _ptxas(report: str, names: str = "decode_x2|decode|model") -> dict:
    """Per kernel whose name matches ``names`` (the o0 decoders and model
    by default): registers, stack, spills, barriers, smem."""
    res, fn = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line \
                or "Function properties for" in line:
            m = re.search(rf"(?:function '|for )\w*?({names})_kernel",
                          line)
            fn = m.group(1) if m else None
            if fn:
                res.setdefault(fn, {})
            continue
        if fn and fn in res:
            for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("barriers", r"used (\d+) barriers"),
                             ("smem", r"(\d+) bytes smem")):
                m3 = re.search(pat, line)
                if m3:
                    res[fn][key] = int(m3.group(1))
    return res


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _tool(name: str) -> str | None:
    cand = Path(build.nvcc()).parent / name
    return str(cand) if cand.exists() else shutil.which(name)


def _sass(lib: Path, names: str = "decode_x2|decode") -> dict:
    """Static SASS counts of the kernels whose name matches ``names`` (the
    o0 decoders by default) and of their loops; the SASS goes to
    ``sass.txt`` beside the library."""
    tool = _tool("cuobjdump")
    if tool is None:
        return {"error": "cuobjdump not found"}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    funcs, cur, keep = {}, None, []
    for line in text.splitlines():
        if cur is not None or "Function :" in line:
            keep.append(line)
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(rf"\d({names})_kernel", m.group(1))
            cur = k.group(1) if k else None
            if cur:
                funcs[cur] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if cur is not None and ins:
            funcs[cur].append((int(ins.group(1), 16), ins.group(2).strip()))
    out = {}
    for name, ins in funcs.items():
        at = {a: i for i, (a, _) in enumerate(ins)}
        best = (0, 0)  # the longest backward branch: the byte loop
        for i, (a, op) in enumerate(ins):
            m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", op)
            if m and m.group(1):
                t = int(m.group(1), 16)
                if t <= a and t in at and i + 1 - at[t] > best[1] - best[0]:
                    best = (at[t], i + 1)
        loop = [op for _, op in ins[best[0]:best[1]]]

        def classes(seq):
            c = {}
            for op in seq:
                word = op.split()[1] if op.startswith("@") else op.split()[0]
                c[word.split(".")[0]] = c.get(word.split(".")[0], 0) + 1
            return dict(sorted(c.items(), key=lambda kv: -kv[1]))
        out[name] = {"instructions": len(ins), "loop_instructions": len(loop),
                     "loop_by_opcode": classes(loop)}
    (lib.parent / "sass.txt").write_text("\n".join(keep))
    return out


def _stack_lines(lib: Path) -> dict:
    """Source lines of local-memory accesses (LDL/STL) per decode kernel."""
    cu, nd = _tool("cuobjdump"), _tool("nvdisasm")
    if cu is None or nd is None:
        return {"error": "cuobjdump or nvdisasm not found"}
    d = lib.parent / (lib.stem + "_cubin")
    d.mkdir(exist_ok=True)
    subprocess.run([cu, "-xelf", "all", str(lib)], cwd=d,
                   capture_output=True)
    res = {}
    for cubin in d.glob("*.cubin"):
        text = subprocess.run([nd, "-g", str(cubin)], capture_output=True,
                              text=True).stdout
        fn, line = None, None
        for row in text.splitlines():
            m = re.search(r"\.text\.(\S+):", row)
            if m:
                k = re.search(r"(decode_x2|decode)_kernel", m.group(1))
                fn = k.group(1) if k and "o1" not in m.group(1) \
                    and "tree" not in m.group(1) else None
                continue
            m = re.search(r"//## File \"(.*?)\", line (\d+)", row)
            if m:
                line = f"{Path(m.group(1)).name}:{m.group(2)}"
                continue
            if fn and re.search(r"\b(LDL|STL)\b", row):
                key = f"{fn} {line}"
                res[key] = res.get(key, 0) + 1
    return res


def _inputs(dev, geom: Geom, rot: int):
    from turborc_tpu_torch.codecs import rans_cdf_o0_p as C0
    data = np.roll(np.fromfile(CORPUS, np.uint8), rot)
    a = C0.encode_args(data, geom, dev)
    gs, _ = K_.encode_tile(a.block, a.K, a.hi_tbl, a.lo_tbl, a.init_states,
                           geom)
    return a, gs


def _cargs(layout: str, name: str, a, gs, geom: Geom):
    """Outputs and the C entry's arguments for one decode."""
    out = torch.empty((a.K, geom.groups, 128), dtype=torch.uint8,
                      device=gs.device)
    lead = (2,) if name == "decode_x2" else ()
    fs = torch.empty((*lead, geom.groups, 128), dtype=torch.int32,
                     device=gs.device)
    if layout == "ff11eb3":
        args = [gs, a.hi_tbl, a.lo_tbl, out, fs, a.K, geom.groups,
                gs.shape[-2], geom.share, geom.sync, geom.lsync, geom.arows,
                geom.srows, geom.rate]
    else:
        args = K_.decode_cargs(gs, a.K, a.hi_tbl, a.lo_tbl, geom, out, fs)
    return out, fs, [x.data_ptr() if isinstance(x, torch.Tensor) else x
                     for x in args]


def _lib(path: Path, layout: str):
    lib = ctypes.CDLL(str(path))
    for fn in ("trc_decode", "trc_decode_x2"):
        f = getattr(lib, fn)
        f.argtypes = (([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p]) if layout == "ff11eb3"
                      else build.SIGNATURES["rans_kernel.cu"][fn])
        f.restype = ctypes.c_int
    return lib


def _run(lib, layout, name, a, gs, geom):
    out, fs, args = _cargs(layout, name, a, gs, geom)
    fn = getattr(lib, "trc_" + name)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    end.record()
    end.synchronize()
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return out, fs, start.elapsed_time(end)


# Ablations (``--ablate``, ring layout only): the decoders with one part
# cut out, timed only (their output is wrong by construction), to price
# that part under the real interleaving of warps.  Each replaces every
# match inside the decoders' section of the source or, where the section
# has none, in rans_common.cuh (the ring and the fetch), and must match.
ABLATIONS = {
    "no-rejoin": [("rejoin_batches_after(t, m, b, hi, start_hi);", "")],
    "no-update": [("cdf_update(hi, low_h, m.rate);", ""),
                  ("cdf_update(row, low_l, m.rate);", "")],
    "no-word": [("p < limit ? uint32_t(r[k].buf[p & (kRingWords - 1)]) : 0u",
                 "uint32_t(p) & 0xFFFFu")],
    "no-topup": [("    if (top) ring_top_up(r[k], limit);\n", ""),
                 ("  if ((nfetch & (kRingEvery - 1)) == 0) "
                  "cp_async_wait<kRingLag>();\n", "")],
    "no-barrier": [("cp_async_wait<kRingLag>();\n  __syncthreads();\n",
                    "cp_async_wait<kRingLag>();\n")],
}
DECODERS = ("// ---- K1 and K5: the decoders", "// ---- K1: decode.")


def _layout(source: str) -> str:
    """"ring" where decode_lanes holds the byte loop, else "ff11eb3"."""
    for layout in ("ring", "ff11eb3"):
        if LOOP_IN[layout] in source:
            return layout
    raise ValueError("no decoder byte loop of a known layout")


def _ablate(name: str, base: str, header: str, section: tuple,
            changes: list) -> tuple:
    """(source, header) with each (old, new) of ``changes`` replaced in the
    part of ``base`` between the two markers of ``section`` or, where that
    part has no ``old``, in ``header``."""
    a = base.index(section[0])
    b = base.index(section[1], a)
    part = base[a:b]
    for old, new in changes:
        if old in part:
            part = part.replace(old, new)
        elif old in header:
            header = header.replace(old, new)
        else:
            raise ValueError(f"ablation {name}: {old!r} not found")
    return base[:a] + part + base[b:], header


def _variants(base: str, header: str, layout: str, ablate) -> dict:
    """name -> (source or (source, header), held against the port's
    decoder)."""
    out = {"base": (base, True),
           "stamped": (stamped(base, LOOP_IN[layout], STAMPS[layout]), True)}
    if not ablate:
        return out
    if layout != "ring":
        raise ValueError("--ablate applies to the port's own source")
    for name in ablate:
        out[name] = (_ablate(name, base, header, DECODERS, ABLATIONS[name]),
                     False)
    return out


# K2 (``--kernel model``): its section of the source, and ablations of its
# byte loop, as ABLATIONS are of the decoders'.
MODEL = ("// ---- K2: forward model pass", "// ---- K3:")
MODEL_ABLATIONS = {
    "no-rejoin": [("    rejoin_batches_after(t, m, b, hi, start_hi);\n",
                   "")],
    "no-update": [("cdf_update(hi, low_h, m.rate);", ""),
                  ("cdf_update(row, low_l, m.rate);", "")],
    "no-row": [("    ld_row(rp, adapt ? kHalf : 8, row);\n", "#pragma unroll"
                "\n    for (int e = 0; e < 16; ++e) row[e] = hi[e] + e;\n"),
               ("    if (adapt) st_row(rp, kHalf, row);\n", "")],
}


def _build_all(variants: dict, src: Path, work: Path,
               fname: str = "rans_kernel.cu"):
    """nvcc of every variant's source (file ``fname``) at once; a variant
    is the source's text, or (text, rans_common.cuh's text) where it
    changes the header too.  Returns (libraries, ptxas reports,
    seconds)."""
    t0 = time.perf_counter()
    libs, reports, procs = {}, {}, []
    for name, text in variants.items():
        (work / name).mkdir()
        cu = work / name / fname
        if isinstance(text, tuple):
            text, header = text
            (work / name / "rans_common.cuh").write_text(header)
        else:
            shutil.copy(src / "rans_common.cuh", work / name)
        cu.write_text(text)
        lib = work / name / f"lib{name}.so"
        cmd = [build.nvcc(), *build.FLAGS, "-I", str(work / name), "-o",
               str(lib), str(cu)]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, lib, p in procs:
        o, e = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{e}")
        libs[name], reports[name] = lib, o + e
    return libs, reports, time.perf_counter() - t0


def probe_model(opt, dev, res: dict, work: Path) -> dict:
    """K2 of the port's source and its ablations (``MODEL_ABLATIONS``):
    ptxas of each build, then a warm-up and 3 repetitions on distinct
    rotations of the 64 MB block at GEOM, every build in turn, CUDA events
    around the bare C entry.  The base is held byte for byte against the
    port's K2 wrapper on the same inputs; ablations are timed only."""
    src = Path(opt.src).resolve()
    base = (src / "rans_kernel.cu").read_text()
    a, b = base.index(MODEL[0]), base.index(MODEL[1])
    variants = {"base": base}
    for name in [x for x in opt.ablate.split(",") if x]:
        part = base[a:b]
        for old, new in MODEL_ABLATIONS[name]:
            if old not in part:
                raise ValueError(f"ablation {name}: {old!r} not found")
            part = part.replace(old, new)
        variants[name] = base[:a] + part + base[b:]
    libs, reports, res["nvcc_s"] = _build_all(variants, src, work)
    res["ptxas"] = {k: _ptxas(v).get("model") for k, v in reports.items()}
    from turborc_tpu_torch.codecs import rans_cdf_o0_p as C0
    geom = Geom.parse(GEOM)
    fns = {}
    for k, lib in libs.items():
        fns[k] = getattr(ctypes.CDLL(str(lib)), "trc_model")
        fns[k].argtypes = build.SIGNATURES["rans_kernel.cu"]["trc_model"]
        fns[k].restype = ctypes.c_int
    times = {k: [] for k in variants}
    data = np.fromfile(CORPUS, np.uint8)
    for r in range(4):  # rep 0 is the warm-up
        x = C0.encode_args(np.roll(data, 7919 * (r + 1)), geom, dev)
        cols = x.block.T.contiguous().reshape(x.K, geom.groups, 128)
        ref = K_.model(cols, x.hi_tbl, x.lo_tbl, geom)
        for k, fn in fns.items():
            probs = torch.empty_like(ref)
            args = [v.data_ptr() if isinstance(v, torch.Tensor) else v
                    for v in K_.model_cargs(cols, x.hi_tbl, x.lo_tbl, probs,
                                            geom)]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            end.record()
            end.synchronize()
            if err:
                raise RuntimeError(f"{k} model: CUDA error {err}")
            if k == "base" and not torch.equal(probs, ref):
                raise AssertionError(f"{k} differs from the port's K2")
            if r:
                times[k].append(start.elapsed_time(end))
            del probs
        del x, cols, ref
    res["K"] = int(data.size // geom.lanes)
    res["ms"] = times
    res["mean_ms"] = {k: sum(v) / len(v) for k, v in times.items()}
    return res


def _argtypes(source: str, fn: str) -> list:
    """The ctypes argtypes of C entry ``fn`` as ``source`` declares it: a
    pointer for every parameter with a ``*``, else an int."""
    m = re.search(rf"int {fn}\((.*?)\)\s*{{", source, re.S)
    if m is None:
        raise ValueError(f"C entry {fn} not found")
    return [ctypes.c_void_p if "*" in a else ctypes.c_int
            for a in m.group(1).split(",")]


def _bare(fn, args) -> float:
    """CUDA-event milliseconds of one call of a bare C entry."""
    args = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    end.record()
    end.synchronize()
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
    return start.elapsed_time(end)


def _section_variants(base: str, header: str, section: tuple,
                      ablations: dict, names) -> dict:
    """name -> source or (source, header): the base, and each named
    ablation (``_ablate``)."""
    out = {"base": base}
    for name in names:
        out[name] = _ablate(name, base, header, section, ablations[name])
    return out


# K6 (``--kernel o1_decode``, one of SPLIT_KERNELS): the o1 decoder of
# rans_o1_kernel.cu on id 60's main-path block.  Two layouts: "l2"
# (9ed2fbe: every row in a device scratch, each word loaded from device
# memory by ``fetch``) and "ring" (the port's).  Stamps, segments and
# ablations as for K1.
O1_CORPUS = CORPUS.parent / "realsrcbwt_16777216.bin"
O1_STAMPS = {
    "l2": [
        ("row_load(hp, c);", 1, 0, "c[15]"),
        ("uint32_t(low_h);", 1, 1, "state"),
        ("fetch(state, s, limit, base, wsum, buf);", 1, 2, "state"),
        ("cdf_update(c, low_h, rate);", 1, 3, "c[15]"),
        ("row_store(hp, c);", 1, 4, "c[0]"),
        ("row_load(lp, c);", 1, 5, "c[15]"),
        ("uint32_t(low_l);", 1, 6, "state"),
        ("fetch(state, s, limit, base, wsum, buf);", 2, 7, "state"),
        ("cdf_update(c, low_l, rate);", 1, 8, "c[15]"),
        ("out[size_t(t) * L + lane] = uint8_t(prev);", 1, 9, "prev"),
    ],
    "ring": [
        ("unpack_row(hw, hrow);", 1, 0, "hrow[15]"),
        ("uint32_t(low_h);", 1, 1, "state[0]"),
        ("fetch_post(state, bal, rank, buf, nfetch);", 1, 2, "bal[0]"),
        ("ld_row(lp, kHalf, lrow);", 1, 3, "lrow[15]"),
        ("pack_row(hrow, hw);", 1, 4, "hw[1].w"),
        ("fetch_take(state, bal, r, limit, rank, buf, nfetch);", 1, 5,
         "state[0]"),
        ("uint32_t(low_l);", 1, 6, "state[0]"),
        ("fetch_post(state, bal, rank, buf, nfetch);", 2, 7, "bal[0]"),
        ("st_row(lp, kHalf, lrow);", 1, 8, "lrow[0]"),
        ("fetch_take(state, bal, r, limit, rank, buf, nfetch);", 2, 9,
         "state[0]"),
    ],
}
O1_SEGMENTS = {
    "l2": ["hi row load", "hi search+lookup+state",
           "fetch 1 (ballot, barrier, word)", "hi update", "hi row store",
           "lo row load", "lo search+lookup+state",
           "fetch 2 (ballot, barrier, word)", "lo update",
           "lo row store, out byte"],
    "ring": ["hi row wait", "hi search+lookup+state",
             "fetch 1 post (ballot, counts, barrier)", "lo row load",
             "hi update", "fetch 1 take (prefix, word)",
             "lo search+lookup+state",
             "hi row switch (store, load issue), fetch 2 post",
             "lo update, store", "out byte, fetch 2 take (prefix, word)"],
}
O1_ABLATIONS = {
    "l2": {},
    "ring": {
        "no-hi-row": [("      q[0] = hw[0];\n      q[1] = hw[1];\n"
                       "      q = reinterpret_cast<uint4*>(tab + nctx * 16);\n"
                       "      hw[0] = q[0];\n      hw[1] = q[1];\n", "")],
        "no-update": [("cdf_update(hrow, low_h, rate);", ""),
                      ("cdf_update(lrow, low_l, rate);", "")],
        "no-word": ABLATIONS["no-word"],
        "no-barrier": ABLATIONS["no-barrier"],
    },
}


# K3 (``--kernel coder``): the backward coder of rans_kernel.cu on id 57's
# main-path block.  Layouts: "lane" (9ed2fbe: one 128-lane CTA a group,
# probs loaded from device memory at every slot) and "staged" (the
# port's).  Ablations price the probs load, the division and the stores.
CODER_SECTION = ("// ---- K3:", "// ---- K4:")
CODER_ABLATIONS = {
    "lane": {
        "no-load": [("const uint32_t pr = uint32_t(probs[at]);",
                     "const uint32_t pr = (uint32_t(t & 1023) << 16) | "
                     "(4096u + uint32_t(t & 255));")],
        "no-div": [("const uint32_t q = state / freq;",
                    "const uint32_t q = state >> 12;")],
        "no-store": [("    words[at] = int(state & 0xFFFFu);\n", ""),
                     ("    emit[at] = e ? 1 : 0;\n", "")],
    },
    "staged": {
        "no-div": [("const uint32_t q = __umulhi(x << 1, m) >> l;",
                    "const uint32_t q = x >> 12;")],
        "no-store": [("      *wp = int(state & 0xFFFFu);\n", ""),
                     ("      *ep = e ? 1 : 0;\n", "")],
        "no-table": [("    uint32_t m, l;\n    div_magic(uint32_t(f + 1), m, l);\n"
                      "    mtab[f] = m;\n", "    mtab[f] = 0x80000001u;\n")],
    },
}


def probe_coder(opt, dev, res: dict, work: Path) -> dict:
    """K3 of the source in ``--src`` and its ablations: ptxas and the SASS
    of its loop, then a warm-up and 3 repetitions on distinct rotations
    of the 64 MB block at GEOM (probs from the port's K2), every build in
    turn, CUDA events around the bare C entry.  The base is held byte for
    byte against the port's K3 wrapper; ablations are timed only."""
    from turborc_tpu_torch.codecs import rans_cdf_o0_p as C0
    src = Path(opt.src).resolve()
    base = (src / "rans_kernel.cu").read_text()
    types = _argtypes(base, "trc_coder")
    layout = "lane" if types.count(ctypes.c_int) == 2 else "staged"
    res["layout"] = layout
    variants = _section_variants(base, (src / "rans_common.cuh").read_text(),
                                 CODER_SECTION, CODER_ABLATIONS[layout],
                                 [x for x in opt.ablate.split(",") if x])
    libs, reports, res["nvcc_s"] = _build_all(variants, src, work)
    res["ptxas"] = {k: _ptxas(v, "coder").get("coder")
                    for k, v in reports.items()}
    res["sass"] = {k: _sass(lib, "coder") for k, lib in libs.items()}
    fns = {}
    for k, lib in libs.items():
        fns[k] = getattr(ctypes.CDLL(str(lib)), "trc_coder")
        fns[k].argtypes, fns[k].restype = types, ctypes.c_int
    geom = Geom.parse(GEOM)
    times = {k: [] for k in variants}
    data = np.fromfile(CORPUS, np.uint8)
    for r in range(4):  # rep 0 is the warm-up
        x = C0.encode_args(np.roll(data, 7919 * (r + 1)), geom, dev)
        cols = x.block.T.contiguous().reshape(x.K, geom.groups, 128)
        probs = K_.model(cols, x.hi_tbl, x.lo_tbl, geom)
        ref = K_.coder(probs, x.init_states)
        for k, fn in fns.items():
            outs = [torch.empty_like(v) for v in ref]
            args = ([probs, x.init_states, *outs, probs.shape[0],
                     geom.groups] if layout == "lane"
                    else K_.coder_cargs(probs, x.init_states, *outs))
            ms = _bare(fn, args)
            if k == "base" and not all(map(torch.equal, outs, ref)):
                raise AssertionError(f"{k} differs from the port's K3")
            if r:
                times[k].append(ms)
            del outs, args
        del x, cols, probs, ref
    res["S"] = int(2 * (data.size // geom.lanes))
    res["ms"] = times
    res["mean_ms"] = {k: sum(v) / len(v) for k, v in times.items()}
    return res


# K6 (``--kernel o1_decode``), K7 (``--kernel o1_model``), K8
# (``--kernel tree_decode``) and K9 (``--kernel tree_model``): the split
# of a byte step, ptxas, SASS, occupancy and ablations, on the kernel's
# main-path block (id 60's realsrcbwt 16 MB for K6 and K7, id 8's textbwt
# 16 MB for K8 and K9, one block each at the default geometry).  Layouts:
# K6 as above; K7 "l2" (e3484f9: every row in a device scratch, read
# through L2, the linear cdf_lookup) and "smem" (the port's); K8 "fetch"
# (e3484f9: each word loaded from device memory by ``fetch``, the tree
# node-major in shared memory) and "ring" (the port's); K9 "node"
# (af41c8b: the tree node-major in shared memory walked by dependent
# loads, one warp a CTA, the byte read from device memory) and "path" (the
# port's: the path nodes addressed by the known byte).  Stamps, segments
# and ablations as for K1; ``second`` names a thread stamped beside
# thread 0 (K9's hi chain), ``exact`` the variants held byte for byte like
# the base (design alternatives, not cuts); ``occupancy`` names the
# kernel, threads and shared-memory bytes whose resident CTAs an SM the
# probe asks the CUDA runtime for.
SPLIT_KERNELS = {
    "o1_decode": dict(
        source="rans_o1_kernel.cu", entry="trc_o1_decode",
        loop_in="o1_decode_kernel(",
        section=("// ---- K6: decode", "}  // namespace"),
        layout=lambda src: "l2"
        if "fetch(state, s, limit, base, wsum, buf);" in src else "ring",
        stamps=O1_STAMPS, segments=O1_SEGMENTS, ablations=O1_ABLATIONS,
        occupancy={},
    ),
    "o1_model": dict(
        source="rans_o1_kernel.cu", entry="trc_o1_model",
        loop_in="o1_model_kernel(",
        section=("// ---- K7: forward model pass", "// ---- K6: decode."),
        layout=lambda src: "l2" if "uint16_t* __restrict__ tables" in src
        else "smem",
        stamps={
            "l2": [("row_load(hp, c);", 1, 0, "c[15]"),
                   ("cdf_lookup(c, hs, low_h, fr_h);", 1, 1, "low_h"),
                   ("cdf_update(c, low_h, rate);", 1, 2, "c[15]"),
                   ("row_store(hp, c);", 1, 3, "c[0]"),
                   ("row_load(lp, c);", 1, 4, "c[15]"),
                   ("cdf_lookup(c, ls, low_l, fr_l);", 1, 5, "low_l"),
                   ("cdf_update(c, low_l, rate);", 1, 6, "c[15]"),
                   ("row_store(lp, c);", 1, 7, "c[0]"),
                   ("prev = b;", 1, 8, "prev")],
            "smem": [("              : 0;", 1, 0, "bn"),
                     ("lookup_pick(lrow, b & 15, low_l, fr_l);", 1, 1,
                      "low_h + low_l"),
                     ("ld_row(model_row(rows, ln), kModelHalf, lnext);", 1,
                      2, "hnext[15] + lnext[15]"),
                     ("cdf_update(lrow, low_l, rate);", 1, 3,
                      "hrow[15] + lrow[15]"),
                     ("out += 2 * L;", 1, 4, "low_l"),
                     ("b = bn;", 1, 5, "hrow[0] + lrow[0]")],
        },
        segments={
            "l2": ["cols load, hi row load (L2)", "hi lookup (linear)",
                   "hi update", "hi row store", "lo row load (L2)",
                   "lo lookup (linear)", "lo update", "lo row store",
                   "probs stores"],
            "smem": ["stage wait, next byte", "hi + lo lookups",
                     "next byte's rows (shared loads)", "hi + lo updates",
                     "row stores, probs stores", "forward selects"],
        },
        ablations={
            "l2": {},
            "smem": {
                "no-update": [("    cdf_update(hrow, low_h, rate);\n", ""),
                              ("    cdf_update(lrow, low_l, rate);\n", "")],
                "no-row": [
                    ("    ld_row(model_row(rows, hn), kModelHalf, hnext);\n"
                     "    ld_row(model_row(rows, ln), kModelHalf, lnext);\n",
                     "#pragma unroll\n    for (int i = 0; i < 16; ++i) {\n"
                     "      hnext[i] = hrow[i] ^ hn;\n"
                     "      lnext[i] = lrow[i] ^ ln;\n    }\n"),
                    ("    st_row(model_row(rows, hc), kModelHalf, hrow);\n"
                     "    st_row(model_row(rows, lc), kModelHalf, lrow);\n",
                     "")],
                "no-forward": [
                    ("hrow[i] = hn == hc ? hrow[i] : hnext[i];",
                     "hrow[i] = hnext[i];"),
                    ("lrow[i] = ln == lc ? lrow[i] : lnext[i];",
                     "lrow[i] = lnext[i];")],
            },
        },
        occupancy={"smem": ("o1_model_kernel", "kModelLanes", "kO1MSmem")},
    ),
    "tree_decode": dict(
        source="bittree_kernel.cu", entry="trc_tree_decode",
        loop_in="tree_decode_kernel(",
        section=("// ---- K8: decode.", "}  // namespace"),
        layout=lambda src: "fetch"
        if "fetch(state, s, limit, base, wsum, buf);" in src else "ring",
        stamps={
            "fetch": [("const int low = descend<kLanes>(tree, node, w, bit);",
                       1, 0, "low"),
                      ("state = uint32_t(w) * (state >> 15) + "
                       "uint32_t(value - low);", 1, 1, "state"),
                      ("fetch(state, s, limit, base, wsum, buf);", 1, 2,
                       "state"),
                      ("out[size_t(t) * plane + col] = uint8_t(node - 256);",
                       1, 3, "node")],
            "ring": [("state[0] = uint32_t(w) * (state[0] >> 15) + value - "
                      "uint32_t(low);", 1, 0, "state[0]"),
                     ("fetch_post(state, bal, rank, buf, nfetch);", 1, 1,
                      "bal[0]"),
                     ("ld_row(lp, kHalf, lrow);", 1, 2, "lrow[15]"),
                     ("update_path(hi, hs, p);", 1, 3, "hi[0] + hi[14]"),
                     ("fetch_take(state, bal, r, limit, rank, buf, nfetch);",
                      1, 4, "state[0]"),
                     ("state[0] = uint32_t(w) * (state[0] >> 15) + value - "
                      "uint32_t(low);", 2, 5, "state[0]"),
                     ("fetch_post(state, bal, rank, buf, nfetch);", 2, 6,
                      "bal[0]"),
                     ("update_path(lrow, ls, p);", 1, 7,
                      "lrow[0] + lrow[14]"),
                     ("out_t += plane;", 1, 8, "ls"),
                     ("fetch_take(state, bal, r, limit, rank, buf, nfetch);",
                      2, 9, "state[0]")],
        },
        segments={
            "fetch": ["descent (4 dependent shared loads, updates)",
                      "state step", "fetch (ballot, barrier, device word)",
                      "out byte"],
            "ring": ["hi descent + state",
                     "fetch 1 post (ballot, counts, barrier)",
                     "lo row load", "hi path updates",
                     "fetch 1 take (prefix, word)", "lo descent + state",
                     "fetch 2 post (ballot, counts, barrier)",
                     "lo path updates", "lo row store, out byte",
                     "fetch 2 take (prefix, word)"],
        },
        ablations={
            "fetch": {},
            "ring": {
                "no-update": [("    update_path(hi, hs, p);\n", ""),
                              ("    update_path(lrow, ls, p);\n", "")],
                "no-lo-row": [
                    ("    ld_row(lp, kHalf, lrow);\n",
                     "#pragma unroll\n    for (int i = 0; i < 16; ++i) "
                     "lrow[i] = hi[i] + hs;\n"),
                    ("    st_row(lp, kHalf, lrow);\n", "")],
                "no-word": ABLATIONS["no-word"],
                "no-barrier": ABLATIONS["no-barrier"],
            },
        },
        occupancy={"ring": ("tree_decode_kernel", "kLanes", "kTreeSmem")},
    ),
    "tree_model": dict(
        source="bittree_kernel.cu", entry="trc_tree_model",
        loop_in="tree_model_kernel(",
        section=("// ---- K9: forward model pass", "// ---- K8: decode."),
        layout=lambda src: "node"
        if "descend(tree, node, w, b >> 4)" in src else "path",
        stamps={
            "node": [("const int b = cols[size_t(t) * L + lane];", 1, 0, "b"),
                     ("int low = descend(tree, node, w, b >> 4);", 1, 1,
                      "low + w"),
                     ("probs[size_t(2 * t) * L + lane] = (low << 16) | w;",
                      1, 2, "low"),
                     ("low = descend(tree, node, w, b & 15);", 1, 3,
                      "low + w"),
                     ("probs[size_t(2 * t + 1) * L + lane] = "
                      "(low << 16) | w;", 1, 4, "low")],
            "path": [("kTreeLanes + lane] : 0;", 1, 0, "b2"),
                     ("const int sym = tree_splits(cur[k], n);", 1, 1,
                      "sym"),
                     ("tree_updates(cur[k], n, np);", 1, 2, "np[0] + np[3]"),
                     ("out[k] += 2 * L;", 1, 3, "0"),
                     ("ld[l] = nodes[tree_node(r2, n2, l)];", 1, 4, "0"),
                     ("cur[k][l] = same && (x >> (4 - l)) == 0 ? np[l] : "
                      "nxt[k][l];", 1, 5, "cur[k][0] + cur[k][3]")],
        },
        segments={
            "node": ["byte load (device memory)",
                     "hi descent (dependent shared loads, stores)",
                     "hi probs store", "lo descent", "lo probs store"],
            "path": ["stage wait, byte t + 2", "splits (the w chain)",
                     "counter updates", "node stores, probs store",
                     "read-ahead of byte t + 2's nodes (loads sent)",
                     "forward selects"],
        },
        # the hi chain's thread (warp 1), stamped beside thread 0 (lo)
        second={"path": "kTreeLanes"},
        ablations={
            "node": {},
            "path": {
                "one-thread": [("constexpr int kTreeSplit = 2;",
                                "constexpr int kTreeSplit = 1;")],
                "unroll-1": [("constexpr int kTreeUnroll = 4;",
                              "constexpr int kTreeUnroll = 1;")],
                "unroll-2": [("constexpr int kTreeUnroll = 4;",
                              "constexpr int kTreeUnroll = 2;")],
                "unroll-8": [("constexpr int kTreeUnroll = 4;",
                              "constexpr int kTreeUnroll = 8;")],
                "unroll-16": [("constexpr int kTreeUnroll = 4;",
                              "constexpr int kTreeUnroll = 16;")],
                "no-forward": [("cur[k][l] = same && (x >> (4 - l)) == 0 ? "
                                "np[l] : nxt[k][l];",
                                "cur[k][l] = nxt[k][l];")],
                "no-update": [("tree_updates(cur[k], n, np);",
                               "for (int l = 0; l < 4; ++l) np[l] = "
                               "cur[k][l];")],
                "no-store": [("      for (int l = 0; l < 4; ++l) "
                              "nodes[tree_node(r, n, l)] = np[l];\n", "")],
                "no-stage": [(
                    "    if ((u & (kTreeSteps - 1)) == 0) {\n"
                    "      cp_async_wait<0>();\n      __syncthreads();\n"
                    "      model_stage<kTreeLanes, kTreeSteps, kTreeThreads>(\n"
                    "          ring, src, u + kTreeSteps, K, L);\n"
                    "      cp_async_commit();\n    }\n"
                    "    const int b2 =\n"
                    "        u < K ? ring[(u & (2 * kTreeSteps - 1)) * "
                    "kTreeLanes + lane] : 0;\n",
                    "    const int b2 = u < K ? src[size_t(u) * L + lane] "
                    ": 0;\n")],
            },
        },
        # design alternatives: their output must be right too
        exact=("one-thread", "unroll-1", "unroll-2", "unroll-8",
               "unroll-16"),
        occupancy={"path": ("tree_model_kernel", "kTreeThreads",
                            "kTreeMSmem"),
                   "node": ("tree_model_kernel", "kModelThreads", "0")},
    ),
}


def _occupancy_entry(kernel: str, threads: str, smem: str) -> str:
    """A C entry that asks the CUDA runtime how many CTAs of ``kernel``
    an SM holds at its launch's threads and shared memory."""
    return f"""
extern "C" int trc_probe_occupancy(int* ctas) {{
  cudaError_t e = cudaFuncSetAttribute(
      {kernel}, cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute({kernel},
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, {kernel},
                                                      {threads}, {smem});
  return int(e);
}}
"""


def _split_inputs(kernel: str, dev, geom: Geom, rot: int):
    """(C arguments maker, reference outputs) of one main-path block:
    make(layout, outputs) -> the C entry's arguments."""
    if kernel == "o1_decode":
        from turborc_tpu_torch.codecs import rans_cdf_r1_p as C1
        from turborc_tpu_torch.ops import rans_o1_kernel as O1
        a = C1.encode_args(np.roll(np.fromfile(O1_CORPUS, np.uint8), rot),
                           geom, dev)
        gs, _ = O1.encode_tile(a.block, a.K, a.hi_tbl, a.lo_tbl,
                               a.init_states, geom)
        ref = O1.decode_tile(gs, a.K, a.hi_tbl, a.lo_tbl, geom)

        def make(layout, outs):
            if layout == "l2":  # all 112 rows a lane in its scratch
                rows = torch.empty((geom.lanes, 112, 16), dtype=torch.int16,
                                   device=dev)
                return [gs, a.hi_tbl, a.lo_tbl, rows, *outs, a.K,
                        geom.groups, gs.shape[1], geom.rate]
            return O1.decode_cargs(gs, a.K, a.hi_tbl, a.lo_tbl, geom,
                                   O1.hi_scratch(geom.groups, dev), *outs)
        return make, ref, a.K
    if kernel == "o1_model":
        from turborc_tpu_torch.codecs import rans_cdf_r1_p as C1
        from turborc_tpu_torch.ops import rans_o1_kernel as O1
        a = C1.encode_args(np.roll(np.fromfile(O1_CORPUS, np.uint8), rot),
                           geom, dev)
        cols = a.block.T.contiguous().reshape(a.K, geom.groups, 128)
        ref = (O1.model(cols, a.hi_tbl, a.lo_tbl, geom),)

        def make(layout, outs):
            if layout == "l2":
                rows = torch.empty((geom.lanes, 112, 16), dtype=torch.int16,
                                   device=dev)
                return [cols, a.hi_tbl, a.lo_tbl, rows, *outs, a.K,
                        geom.groups, geom.rate]
            return O1.model_cargs(cols, a.hi_tbl, a.lo_tbl, *outs, geom)
        return make, ref, a.K
    from turborc_tpu_torch.codecs import rc_tree as CT
    from turborc_tpu_torch.ops import bittree_kernel as B
    a = CT.encode_args(np.roll(np.fromfile(TREE_CORPUS, np.uint8), rot),
                       geom, dev)
    if kernel == "tree_model":  # both layouts take the tile alone
        cols = a.block.T.contiguous().reshape(a.K, geom.groups, 128)
        ref = (B.tree_model(cols, a.tree, geom),)
        return (lambda layout, outs: B.tree_model_cargs(cols, a.tree,
                                                        *outs)), ref, a.K
    gs, _ = B.encode_tile(a.block, a.K, a.tree, a.init_states, geom)
    ref = B.tree_decode_tile(gs, a.K, a.tree, geom)

    def make(layout, outs):
        return B.tree_decode_cargs(gs, a.K, a.tree, *outs)
    return make, ref, a.K


TREE_CORPUS = CORPUS.parent / "textbwt_16777216.bin"


def probe_split(opt, dev, res: dict, work: Path) -> dict:
    """K6, K7, K8 or K9 (``SPLIT_KERNELS[opt.kernel]``) of the source in
    ``--src``: ptxas and SASS, CTAs an SM, the clock64() split of its byte
    step, and the bare C entry timed (a warm-up, then 3 repetitions on
    distinct rotations of the kernel's main-path block), base, stamped and
    ``exact`` builds held byte for byte against the port's wrapper,
    ablations timed only."""
    spec = SPLIT_KERNELS[opt.kernel]
    src = Path(opt.src).resolve()
    base = (src / spec["source"]).read_text()
    layout = spec["layout"](base)
    res["layout"] = layout
    variants = _section_variants(base, (src / "rans_common.cuh").read_text(),
                                 spec["section"], spec["ablations"][layout],
                                 [x for x in opt.ablate.split(",") if x])
    second = spec.get("second", {}).get(layout)
    variants["stamped"] = stamped(base, spec["loop_in"],
                                  spec["stamps"][layout], second)
    occ = spec["occupancy"].get(layout)
    if occ:
        variants = {k: ((v[0] + _occupancy_entry(*occ), v[1])
                        if isinstance(v, tuple)
                        else v + _occupancy_entry(*occ))
                    for k, v in variants.items()}
    libs, reports, res["nvcc_s"] = _build_all(variants, src, work,
                                              spec["source"])
    res["ptxas"] = {k: _ptxas(v, opt.kernel).get(opt.kernel)
                    for k, v in reports.items()}
    res["sass"] = _sass(libs["base"], opt.kernel)
    types = _argtypes(base, spec["entry"])
    fns, loaded = {}, {}
    for k, lib in libs.items():
        loaded[k] = ctypes.CDLL(str(lib))
        fns[k] = getattr(loaded[k], spec["entry"])
        fns[k].argtypes, fns[k].restype = types, ctypes.c_int
    if occ:
        n = ctypes.c_int(0)
        err = loaded["base"].trc_probe_occupancy(ctypes.byref(n))
        res["ctas_per_sm"] = n.value if err == 0 else f"CUDA error {err}"
    geom = Geom()
    times = {k: [] for k in variants}
    segs = spec["segments"][layout]
    split, split2, K = None, None, 0
    for r in range(4):  # rep 0 is the warm-up
        make, ref, K = _split_inputs(opt.kernel, dev, geom, 7919 * (r + 1))
        for k, fn in fns.items():
            outs = [torch.empty_like(x) for x in ref]
            ms = _bare(fn, make(layout, outs))
            if (k in ("base", "stamped", *spec.get("exact", ()))
                    and not all(map(torch.equal, outs, ref))):
                raise AssertionError(f"{k} differs from the port's "
                                     f"{opt.kernel}")
            if r:
                times[k].append(ms)
            if k == "stamped":
                acc = (ctypes.c_ulonglong * 32)()
                loaded[k].trc_split_read(ctypes.cast(acc, ctypes.c_void_p))
                split = [int(x) for x in acc[:len(segs)]]
                split2 = [int(x) for x in acc[16:16 + len(segs)]]
            del outs
        del make, ref
    def report(cycles, thread):
        total = sum(cycles)
        return {"K": K, "thread": thread, "cycles_total": total,
                "cycles_per_byte": total / K,
                "segments": [{"segment": segs[i], "cycles": c,
                              "per_byte": c / K, "share": c / total}
                             for i, c in enumerate(cycles)]}
    res["split"] = report(split, "thread 0 of CTA 0")
    if second:
        res["split_second"] = report(split2, f"thread {second} of CTA 0")
    res["ms"] = times
    res["mean_ms"] = {k: sum(v) / len(v) for k, v in times.items()}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(build.CSRC))
    ap.add_argument("--ablate", default="")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--kernel", choices=("decode", "model", "coder",
                                         *SPLIT_KERNELS),
                    default="decode")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if opt.kernel != "decode":
        label = opt.label or opt.kernel
        work = WORK / label
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        res = {"label": label, "kernel": opt.kernel, "src": opt.src,
               "card": _smi(),
               "geom": GEOM if opt.kernel in ("model", "coder")
               else Geom().spec}
        probe = {"model": probe_model, "coder": probe_coder,
                 **dict.fromkeys(SPLIT_KERNELS, probe_split)}[opt.kernel]
        res = probe(opt, dev, res, work)
        text = json.dumps(res, indent=1)
        print(text)
        if opt.out:
            Path(opt.out).parent.mkdir(parents=True, exist_ok=True)
            Path(opt.out).write_text(text)
            sass = work / "base" / "sass.txt"
            if sass.exists():
                shutil.copy(sass, Path(opt.out).with_suffix(".sass.txt"))
        return 0
    src = Path(opt.src).resolve()
    base = (src / "rans_kernel.cu").read_text()
    layout = _layout(base)
    label = opt.label or layout
    work = WORK / label
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    res = {"label": label, "layout": layout, "src": str(src),
           "card": _smi(), "geom": GEOM}
    variants = _variants(base, (src / "rans_common.cuh").read_text(), layout,
                         [x for x in opt.ablate.split(",") if x])
    libs, reports, res["nvcc_s"] = _build_all(
        {k: text for k, (text, _) in variants.items()}, src, work)
    res["ptxas"] = {k: _ptxas(v) for k, v in reports.items()}
    res["sass"] = {k: _sass(libs[k]) for k in variants}
    res["stack_lines"] = {k: _stack_lines(libs[k]) for k in variants}

    geom, geom2 = Geom.parse(GEOM), Geom.parse(GEOM + "x2")
    loaded = {k: _lib(libs[k], layout) for k in variants}
    times = {f"{k} {n}": [] for k in variants
             for n in ("decode", "decode_x2")}
    split, K = None, 0
    for r in range(4):  # rep 0 is the warm-up
        for name, g in (("decode", geom), ("decode_x2", geom2)):
            a, gs = _inputs(dev, g, 7919 * (r + 1))
            ref_out, ref_fs = (K_.decode_tile if name == "decode"
                               else K_.decode_tile_x2)(
                gs, a.K, a.hi_tbl, a.lo_tbl, g)
            for k, (_, checked) in variants.items():
                out, fs, ms = _run(loaded[k], layout, name, a, gs, g)
                if checked and not (torch.equal(out, ref_out)
                                    and torch.equal(fs, ref_fs)):
                    raise AssertionError(f"{k} {name} differs from the "
                                         "port's decoder")
                if r:
                    times[f"{k} {name}"].append(ms)
                if k == "stamped" and name == "decode":
                    acc = (ctypes.c_ulonglong * 32)()
                    loaded[k].trc_split_read(ctypes.cast(acc,
                                                         ctypes.c_void_p))
                    n = len(SEGMENTS[layout])
                    split, K = [int(x) for x in acc[:n]], a.K
            del a, gs, ref_out, ref_fs
    total = sum(split)
    res["split"] = {
        "K": K, "thread": "lane 0 of warp 0 of CTA 0",
        "cycles_total": total, "cycles_per_byte": total / K,
        "segments": [{"segment": SEGMENTS[layout][i], "cycles": c,
                      "per_byte": c / K, "share": c / total}
                     for i, c in enumerate(split)]}
    res["ms"] = times
    res["mean_ms"] = {k: sum(v) / len(v) for k, v in times.items() if v}
    text = json.dumps(res, indent=1)
    print(text)
    if opt.out:
        Path(opt.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opt.out).write_text(text)
        shutil.copy(libs["base"].parent / "sass.txt",
                    Path(opt.out).with_suffix(".sass.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
