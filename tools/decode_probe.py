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
layouts it tells apart.  With ``--kernel lane_model`` or ``--kernel
lane_decode``, the lane kernels L1 or L3 (teams of T threads a lane) on a
4 MB block at ids 56's and 58's geometries: the T sweep (4, 8, 16), the
split, ptxas of each instantiation, the team launch and CTAs an SM, and
ablations (``probe_lane``; the port's source only).  With ``--kernel
lane_coder`` or ``--kernel lane_static_decode``, L2 (at id 56's and id
42's probs) or L4 (at id 42's streams) on the same block: the split,
ptxas, SASS, CTAs an SM, the sweep (L2: ``lanes-64``; L4: ``team-4``,
``team-8`` and ``sym-packed``) and ablations (``probe_io``); ``--src`` may
also be the ``csrc`` of cfdb21a, whose one-thread-a-lane L2 and L4 it
tells apart (split only).  With ``--kernel lane_o1r_decode`` or
``--kernel lane_o1_decode``, L6 or L8 (one template over two contexts) on
a 4 MB realsrcbwt block at id 59's or id 64's shape: the split, ptxas,
SASS, the variants and ablations of ``LANE_O1_STAMPS``
(``probe_lane_o1``); ``--src`` may also be the ``csrc`` of 977bf11, whose
first design it tells apart (run a copy of the probe from that tree: the
probe makes its inputs with the tree it runs from).  With ``--kernel
lane_o1r_model`` or ``--kernel lane_o1_model``, L5 or L7 on the same
blocks: the split, ptxas, SASS, the variants (held byte for byte) and
ablations of ``LANE_O1M_STAMPS`` (``probe_lane_o1_model``); ``--src`` may
also be the ``csrc`` of af5a925, whose first design it tells apart.  With
``--kernel lane_bit_model`` or ``--kernel lane_bit_decode``, L11 or L12
(``probe_lane_bit``, ``BIT_SPLIT``); with ``--kernel lane_nibble_model``
or ``--kernel lane_nibble_decode``, L9 or L10 (adaptive and static) on a
4 MB textbwt block (``probe_lane_nibble``, ``NIB_SPLIT``); run a copy of
the probe from a parent's archive to split 1b4e577's first design.

    python3 tools/decode_probe.py [--src DIR] [--ablate no-rejoin,...]
        [--label NAME] [--out FILE]
        [--kernel decode|model|o1_decode|coder|o1_model|tree_decode|
                  tree_model|lane_model|lane_decode|lane_coder|
                  lane_static_decode|lane_o1r_decode|lane_o1_decode|
                  lane_o1r_model|lane_o1_model|lane_bit_model|
                  lane_bit_decode|lane_nibble_model|lane_nibble_decode]

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
  unsigned long long trc_acc[14] = {0};                                    \
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
    for (int k = 0; k < 14; ++k) trc_split_acc[trc_at + k] = trc_acc[k];   \
    trc_split_acc[trc_at + 15] = trc_sink;                                 \
  }
"""


def stamped(source: str, loop_in: str, stamps: list,
            second: str | None = None,
            loop_head: str = "for (int t = 0; t < K; ++t) {",
            prelude: bool = True) -> str:
    """The source with clock64() stamps (``STAMPS``' form) in the byte
    loop (``loop_head``, at two spaces' indent) of the function that
    starts at ``loop_in``, for thread 0 of CTA 0 and, with ``second`` (a C
    expression), that thread too (its sums at ``trc_split_acc[16:]``).
    ``prelude`` False: a second loop of a source stamped already."""
    head, sep, rest = source.partition('#include "rans_common.cuh"\n')
    if not sep:
        raise ValueError("rans_common.cuh include not found")
    start = rest.index(loop_in)
    loop = rest.index(loop_head, start)
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
    if not prelude:
        define = ""
    return (head + sep + define + (PRELUDE if prelude else "") + rest[:loop]
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
            k = re.search(rf"\d({names})_kernel(?:I(\w*?E)EEv)?",
                          m.group(1))
            cur = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                   if k else None)
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


# L1 (``--kernel lane_model``) and L3 (``--kernel lane_decode``): the
# per-lane scan codecs' team kernels of rans_lane_kernel.cu on one 4 MB
# block of textbwt at the default CodecConfig (512 lanes, K = 8192), at id
# 56's geometry (share 1, one segment) and id 58's (share 8, 64 segments).
# Stamps and segments as for K1 (thread 0 of CTA 0: team thread 0 of lane
# 0), on the lines of the byte loop; "team-N" builds the kernels at kTeam
# = N (the T sweep, held byte for byte); ablations are timed only.
LANE_CORPUS = CORPUS.parent / "textbwt_16777216.bin"
LANE_GEOMS = {"id56": dict(share=1), "id58": dict(share=8)}
LANE_TEAMS = (4, 8, 16)
# Ablations of the team re-join (both kernels): no barrier, no prefix-max
# repair scans (the check of increasing tables stays), the scans on every
# table (no check), no sums across warps, no butterfly within a warp.
LANE_REJOIN_ABLATIONS = {
    "no-barrier": [("    __syncthreads();\n", "")],
    "no-repair": [("  if (!__all_sync(kFull, inc)) {", "  if (false) {")],
    "scan-always": [("  if (!__all_sync(kFull, inc)) {", "  if (true) {")],
    "no-cross-warp": [("  if (span > 32) {", "  if (false) {")],
    "no-butterfly": [("  for (int k = T; k < lim; k <<= 1) {",
                      "  for (int k = T; k < 0; k <<= 1) {")],
}
LANE_SPLIT = {
    "lane_model": dict(
        entry="trc_lane_model", loop_in="lane_model_kernel(",
        section=("// ---- The team of a lane", "// ---- L2:"),
        stamps=[("sym_next = __shfl_sync(kFull, cur, (t + 1) & (T - 1), T);",
                 1, 0, "sym"),
                ("ld_part<E>(rp, row);", 1, 1, "row[0]"),
                ("team_lookup<T>(hi, hs, low_h, fr_h);", 1, 2,
                 "low_h + fr_h"),
                ("team_update<T>(hi, low_h, m.rate, j);", 1, 3, "hi[0]"),
                ("team_lookup<T>(row, ls, low_l, fr_l);", 1, 4,
                 "low_l + fr_l"),
                ("slot_l = take ? (low_l << 16) | fr_l : slot_l;", 1, 5,
                 "slot_h + slot_l"),
                ("      team_rejoins_after<T>(t, m, b, n, j, buf, hi, "
                 "start_hi);", 1, 6, "hi[0]")],
        segments=["next byte (shuffle), chunk load", "lo row load",
                  "hi lookup (two shuffles)", "hi update",
                  "lo lookup (two shuffles)",
                  "lo update, row store, slot select",
                  "slot stores (every T steps), re-join"],
        ablations={
            "no-rejoin": [("    if constexpr (kShared)\n"
                           "      team_rejoins_after<T>(t, m, b, n, j, buf, "
                           "hi, start_hi);\n", "")],
            "no-update": [("    team_update<T>(hi, low_h, m.rate, j);\n", ""),
                          ("      team_update<T>(row, low_l, m.rate, j);\n",
                           "")],
            "no-row": [("    ld_part<E>(rp, row);\n",
                        "#pragma unroll\n    for (int e = 0; e < E; ++e) "
                        "row[e] = hi[e] + hs;\n"),
                       ("      st_part<E>(rp, row);\n", "")],
            **LANE_REJOIN_ABLATIONS,
        }),
    "lane_decode": dict(
        entry="trc_lane_decode", loop_in="lane_decode_kernel(",
        section=("// ---- The team of a lane", "// ---- L4:"),
        stamps=[("const int hs = team_search<T>(hi, int(value), j, mask);", 1,
                 0, "hs"),
                ("team_lookup<T>(hi, hs, low_h, fr_h);", 1, 1,
                 "low_h + fr_h"),
                ("team_words_renorm<T>(w, state, j);", 1, 2, "state"),
                ("team_update<T>(hi, low_h, m.rate, j);", 1, 3, "hi[0]"),
                ("const int ls = team_search<T>(row, int(value), j, mask);",
                 1, 4, "ls"),
                ("team_lookup<T>(row, ls, low_l, fr_l);", 1, 5,
                 "low_l + fr_l"),
                ("team_words_renorm<T>(w, state, j);", 2, 6, "state"),
                ("if (j == (t & (T - 1))) mine = uint8_t((hs << 4) | ls);", 1,
                 7, "row[0] + mine"),
                ("      team_rejoins_after<T>(t, m, b, n, j, buf, hi, "
                 "start_hi);", 1, 8, "hi[0]")],
        segments=["hi search (ballot, popc)", "hi lookup (two shuffles)",
                  "hi state step, renorm", "hi update",
                  "lo search (row load, ballot, popc)",
                  "lo lookup (two shuffles)", "lo state step, renorm",
                  "lo update, row store, byte select",
                  "byte stores (every T steps), re-join"],
        ablations={
            "no-rejoin": [("    if constexpr (kShared)\n"
                           "      team_rejoins_after<T>(t, m, b, n, j, buf, "
                           "hi, start_hi);\n", "")],
            "no-update": [("    team_update<T>(hi, low_h, m.rate, j);\n", ""),
                          ("      team_update<T>(row, low_l, m.rate, j);\n",
                           "")],
            "no-word": [("  w.next = __shfl_sync(kFull, w.cur, w.pos & (T - 1), "
                         "T);", "  w.next = uint32_t(w.pos) & 0xFFFFu;")],
            **LANE_REJOIN_ABLATIONS,
        }),
    # L6 and L8, one template over two contexts: ``probe_lane_o1``
    "lane_o1r_decode": dict(entry="trc_lane_o1r_decode",
                            codec="rans-cdf-r1", probe="o1"),
    "lane_o1_decode": dict(entry="trc_lane_o1_decode", codec="rans-cdf-o1",
                           probe="o1"),
    # L5 and L7, the model template over the same contexts:
    # ``probe_lane_o1_model``
    "lane_o1r_model": dict(entry="trc_lane_o1r_model", codec="rans-cdf-r1",
                           probe="o1m"),
    "lane_o1_model": dict(entry="trc_lane_o1_model", codec="rans-cdf-o1",
                          probe="o1m"),
}


def _lane_occupancy(kernel: str) -> str:
    """A C entry that reports, for the geometry it is given, the team
    launch (T, threads, shared memory, CTAs) and the CTAs an SM that the
    CUDA runtime's occupancy query allows for it."""
    return f"""
extern "C" int trc_probe_occupancy(int* res, int K, int L, int n_seg,
                                   int share, int sync, int lsync,
                                   int arows, int srows, int rate) {{
  Span m;
  if (!make_span(K, L, n_seg, share, sync, lsync, arows, srows, rate, m))
    return int(cudaErrorInvalidValue);
  return team_dispatch(m, [&](auto team, auto shared) {{
    constexpr int T = decltype(team)::value;
    constexpr bool S = decltype(shared)::value;
    const TeamLaunch g = team_launch(m, L, T);
    cudaError_t e = cudaFuncSetAttribute(
        {kernel}<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(res, {kernel}<T, S>,
                                                        g.threads, g.smem);
    res[1] = T;
    res[2] = g.threads;
    res[3] = g.smem;
    res[4] = g.grid;
    return int(e);
  }});
}}
"""


def _lane_ptxas(report: str, kernel: str) -> dict:
    """Registers, stack, spills of each instantiation ``kernel<T>``."""
    res, key = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line \
                or "Function properties for" in line:
            m = re.search(rf"{kernel}_kernelILi(\d+)ELb([01])E", line)
            key = f"T={m.group(1)},shared={m.group(2)}" if m else None
            if key:
                res.setdefault(key, {})
            continue
        if key:
            for k, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                           ("spill_stores", r"(\d+) bytes spill stores"),
                           ("spill_loads", r"(\d+) bytes spill loads"),
                           ("registers", r"Used (\d+) registers")):
                m3 = re.search(pat, line)
                if m3:
                    res[key][k] = int(m3.group(1))
    return res


def _lane_inputs(kernel: str, geom_name: str, dev, rot: int):
    """(geometry, C arguments maker, reference output, K) of one block:
    make(outs) -> the C entry's arguments, outs shaped like the
    reference."""
    import dataclasses

    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import rans_cdf_s8 as S58
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.utils.config import CodecConfig
    cfg = CodecConfig()
    L = cfg.lanes
    x = np.roll(np.fromfile(LANE_CORPUS, np.uint8), rot)[:cfg.block_size]
    geom = dataclasses.replace(LK.PER_LANE, **LANE_GEOMS[geom_name])
    if geom.share > 1:
        tabs = S58.segment_tables(x, S58._n_seg(L, geom.share))
        block, K = S58.shape_spans(x, L, cfg.step_quant, geom.share,
                                   geom.lsync)
        cols = torch.from_numpy(block).to(dev).permute(1, 0, 2)
    else:
        tabs = (t[None] for t in blockio.nibble_tables(x))
        block, K = blockio.shape_block(x, L, cfg.step_quant)
        cols = torch.from_numpy(block).to(dev).T
    hi, lo = S58.tables_on(*tabs, dev)
    cols = cols.reshape(K, L).contiguous()
    probs = LK.lane_model(cols, hi, lo, geom)
    if kernel == "lane_model":
        return geom, (lambda outs: LK.lane_model_cargs(
            cols, hi, lo, outs[0], geom)), probs, K
    st, lens = LK.lane_coder(probs, torch.full(
        (L,), rans.ANS_LOW, dtype=torch.int32, device=dev))
    words = blockio.device_words(st, lens)
    offs = LK._offsets(lens)
    return geom, (lambda outs: LK.lane_decode_cargs(
        words, offs, lens, K, hi, lo, outs[0], geom)), cols, K


def probe_lane(opt, dev, res: dict, work: Path) -> dict:
    """L1 or L3 (``LANE_SPLIT[opt.kernel]``) of the port's source at ids
    56's and 58's geometries: ptxas of each instantiation, the team launch
    and CTAs an SM, the clock64() split of the byte step, and the bare C
    entry timed (a warm-up, then 3 repetitions on distinct rotations of
    the block) for the base, the stamped build, the T sweep (``team-N``,
    held byte for byte like the base) and the ablations (timed only)."""
    spec = LANE_SPLIT[opt.kernel]
    src = Path(opt.src).resolve()
    base = (src / "rans_lane_kernel.cu").read_text()
    m = re.search(r"constexpr int kTeam = (\d+);", base)
    if m is None:
        raise ValueError(f"{src}: no team kernels (kTeam)")
    res["kTeam"] = int(m.group(1))
    header = (src / "rans_common.cuh").read_text()
    variants = {"base": base}
    for name in [x for x in opt.ablate.split(",") if x]:
        variants[name] = _ablate(name, base, header, spec["section"],
                                 spec["ablations"][name])
    for T in LANE_TEAMS:
        if T != res["kTeam"]:
            variants[f"team-{T}"] = base.replace(m.group(0),
                                                 f"constexpr int kTeam = {T};")
    variants["stamped"] = stamped(base, spec["loop_in"], spec["stamps"])
    exact = ("base", "stamped", *(k for k in variants
                                  if k.startswith("team-")))
    occ = _lane_occupancy(opt.kernel + "_kernel")
    variants = {k: ((v[0] + occ, v[1]) if isinstance(v, tuple) else v + occ)
                for k, v in variants.items()}
    libs, reports, res["nvcc_s"] = _build_all(variants, src, work,
                                              "rans_lane_kernel.cu")
    res["ptxas"] = {k: _lane_ptxas(v, opt.kernel) for k, v in reports.items()}
    res["sass"] = _sass(libs["base"], opt.kernel)
    # the port's kernels run first (they make the inputs), and the builds
    # load after them
    _lane_inputs(opt.kernel, "id56", dev, 0)
    types = build.SIGNATURES["rans_lane_kernel.cu"][spec["entry"]]
    fns, loaded = {}, {}
    for k, lib in libs.items():
        loaded[k] = ctypes.CDLL(str(lib))
        fns[k] = getattr(loaded[k], spec["entry"])
        fns[k].argtypes, fns[k].restype = types, ctypes.c_int
    segs = spec["segments"]
    res["geoms"] = {}
    for gname in LANE_GEOMS:
        times = {k: [] for k in variants}
        split, K, launch = None, 0, {}
        for r in range(4):  # rep 0 is the warm-up
            geom, make, ref, K = _lane_inputs(opt.kernel, gname, dev,
                                              7919 * (r + 1))
            if r == 0:
                for k, lib in loaded.items():
                    occ_res = (ctypes.c_int * 5)()
                    ints = [x for x in make([torch.empty_like(ref)])
                            if not isinstance(x, torch.Tensor)]
                    if opt.kernel == "lane_decode":
                        del ints[2]  # W
                    err = lib.trc_probe_occupancy(occ_res, *ints)
                    launch[k] = (f"CUDA error {err}" if err else dict(
                        zip(("ctas_per_sm", "T", "threads", "smem", "ctas"),
                            occ_res)))
            for k, fn in fns.items():
                print(f"probe {gname} rep {r}: {k}", file=sys.stderr,
                      flush=True)
                out = torch.empty_like(ref)
                ms = _bare(fn, make([out]))
                if k in exact and not torch.equal(out, ref):
                    raise AssertionError(f"{k} differs from the port's "
                                         f"{opt.kernel} at {gname}")
                if r:
                    times[k].append(ms)
                if k == "stamped":
                    acc = (ctypes.c_ulonglong * 32)()
                    loaded[k].trc_split_read(ctypes.cast(acc,
                                                         ctypes.c_void_p))
                    split = [int(x) for x in acc[:len(segs)]]
                del out
            del make, ref
        total = sum(split)
        res["geoms"][gname] = {
            "geom": geom.spec, "K": K, "launch": launch,
            "split": {"thread": "team thread 0 of lane 0, CTA 0",
                      "cycles_total": total, "cycles_per_byte": total / K,
                      "segments": [{"segment": segs[i], "cycles": c,
                                    "per_byte": c / K, "share": c / total}
                                   for i, c in enumerate(split)]},
            "ms": times,
            "mean_ms": {k: sum(v) / len(v) for k, v in times.items()}}
    return res


# L6 (``--kernel lane_o1r_decode``, id 59) and L8 (``--kernel
# lane_o1_decode``, id 64): the template lane_o1_decode_kernel of
# rans_lane_kernel.cu over its contexts O1Rank and O1Byte, on one 4 MB
# block of realsrcbwt at the default CodecConfig as the codecs shape it
# (id 59: 512 lanes, K = 8192, 16 segments; id 64: 128 lanes, K =
# 32,768).  Two layouts, told apart by the source: "first" (977bf11's
# design: the hi row read by the previous byte, the lo row as soon as the
# hi search gives it, a ballot + popc search and two shuffles a lookup,
# two lanes a warp) and "chain" (the port's: one reduction a search, a
# warp a lane).  Stamps and segments as for L3 (thread 0 of CTA 0: team
# thread 0 of lane 0); ``exact`` variants are held byte for byte like the
# base, ablations are timed only.
LANE_O1_LAYOUT = {
    "first": "const int hs = team_search<T>(hrow, int(value), j, mask);",
    "chain": "const int hs = o1_search(hrow, value, low_h, fr_h);"}
LANE_O1_SECTION = ("// ---- L5-L8: the order-1 per-lane scan codecs",
                   "bool pow2(int v")
# one warp round a search on the first design: low and sym by the max of
# (c << 4 | i) over the entries c <= value, the next entry by the min over
# c > value, each team of a warp on its own mask (which the compiler runs
# once a mask)
LANE_O1_REDUX = r"""
__device__ __forceinline__ int o1_redux_search(int c, int value, int j,
                                               unsigned mask, int& low,
                                               int& freq) {
  const unsigned key =
      __reduce_max_sync(mask, c <= value ? unsigned(c) << 4 | j : 0u);
  freq = int(__reduce_min_sync(mask, c > value ? unsigned(c)
                                               : unsigned(kTotal))) -
         int(key >> 4);
  low = int(key >> 4);
  return int(key & 15u);
}

"""
LANE_O1_STAMPS = {
    "first": dict(
        stamps=[("    ld_part<E>(hp, hrow);", 1, 0, "hrow[0]"),
                ("    const int hs = team_search<T>(hrow, int(value), j, "
                 "mask);", 1, 1, "hs"),
                ("    ld_part<E>(lp, lrow);", 1, 2, "lrow[0]"),
                ("    team_lookup<T>(hrow, hs, low_h, fr_h);", 1, 3,
                 "low_h + fr_h"),
                ("    team_words_renorm<T>(w, state, j);", 1, 4, "state"),
                ("    st_part<E>(hp, hrow);", 1, 5, "hrow[0]"),
                ("    const int ls = team_search<T>(lrow, int(value), j, "
                 "mask);", 1, 6, "ls"),
                ("    team_lookup<T>(lrow, ls, low_l, fr_l);", 1, 7,
                 "low_l + fr_l"),
                ("    team_words_renorm<T>(w, state, j);", 2, 8, "state"),
                ("    if (j == (t & (T - 1))) mine = uint8_t(prev);", 1, 9,
                 "lrow[0] + mine")],
        segments=["byte store (every T steps), hi address and row read",
                  "hi search (ballot, popc)", "lo address and row read",
                  "hi lookup (two shuffles)", "hi state step, renorm",
                  "hi update, row store", "lo search (ballot, popc)",
                  "lo lookup (two shuffles)", "lo state step, renorm",
                  "lo update, row store, byte keep"],
        variants={
            # the one-round search and lookup on the first design
            "redux": [
                (LANE_O1_SECTION[0], LANE_O1_REDUX + LANE_O1_SECTION[0]),
                ("    const int hs = team_search<T>(hrow, int(value), j, "
                 "mask);", "    int low_h, fr_h;\n    const int hs = "
                 "o1_redux_search(hrow[0], int(value), j, mask, low_h, "
                 "fr_h);"),
                ("    int low_h, fr_h;\n    team_lookup<T>(hrow, hs, low_h, "
                 "fr_h);\n", ""),
                ("    const int ls = team_search<T>(lrow, int(value), j, "
                 "mask);\n    int low_l, fr_l;\n    team_lookup<T>(lrow, ls, "
                 "low_l, fr_l);\n", "    int low_l, fr_l;\n    const int ls "
                 "= o1_redux_search(lrow[0], int(value), j, mask, low_l, "
                 "fr_l);\n")]},
        ablations={
            "no-word": [("    team_words_renorm<T>(w, state, j);",
                         "    state = state < kAnsLow ? state << 16 : "
                         "state;")],
            "no-hi-row": [("    ld_part<E>(hp, hrow);",
                           "    hrow[0] = (j << 11) + (prev & 7);")],
            "no-lo-row": [("    ld_part<E>(lp, lrow);",
                           "    lrow[0] = (j << 11) + hs;")],
            "no-update": [("    team_update<T>(hrow, low_h, kO1Rate, j);\n",
                           ""),
                          ("    team_update<T>(lrow, low_l, kO1Rate, j);\n",
                           "")],
            "no-store": [("    st_part<E>(hp, hrow);\n", ""),
                         ("    st_part<E>(lp, lrow);\n", "")]}),
    "chain": dict(
        loop_head="for (int t0 = 0; t0 < K; t0 += 8) {",
        stamps=[("const int hs = o1_search(hrow, value, low_h, fr_h);", 1, 0,
                 "hs + low_h + fr_h"),
                ("const O1Entry lrow = o1_entry(lp, j, dummy);", 1, 1,
                 "lrow.c + lrow.key"),
                ("value = o1_renorm(w, state);", 1, 2, "state"),
                ("*hp = uint16_t(o1_update(hrow.c, low_h, j));", 1, 3, "0"),
                ("const int ls = o1_search(lrow, value, low_l, fr_l);", 1, 4,
                 "ls + low_l + fr_l"),
                ("hrow = o1_entry(hp, j, dummy);", 1, 5, "hrow.c + hrow.key"),
                ("value = o1_renorm(w, state);", 2, 6, "state"),
                ("mine = j == (t & (kTeam - 1)) ? uint8_t(prev) : mine;", 1,
                 7, "mine"),
                ("o1_words_move(w, j);", 1, 8, "w.base")],
        segments=["hi search + lookup (a byte store every 16 steps, the "
                  "loop)",
                  "lo row: context, read (charged its latency)",
                  "hi state step, renorm", "hi update, row store",
                  "lo search + lookup",
                  "next hi row: context, read (charged its latency)",
                  "lo state step, renorm",
                  "lo update, row store, byte keep",
                  "words move (every 8 steps)"],
        # held byte for byte: the runs not unrolled; id 59 at 2 or 8 lanes
        # a CTA ("rank-" variants at id 59 only)
        variants={
            "no-unroll": [("#pragma unroll\n      for (int u = 0; u < 8; ++u) "
                           "step(t0 + u);", "#pragma unroll 1\n      for (int "
                           "u = 0; u < 8; ++u) step(t0 + u);")],
            "rank-cta-2": [("  static constexpr int kDLanes = 4;  ",
                            "  static constexpr int kDLanes = 2;  ")],
            "rank-cta-8": [("  static constexpr int kDLanes = 4;  ",
                            "  static constexpr int kDLanes = 8;  ")]},
        ablations={
            "no-word": [("  w.t.next = __shfl_sync(kFull, w.t.pos - w.base < "
                         "kTeam ? w.t.cur : w.t.nxt,\n"
                         "                         w.t.pos & (kTeam - 1), "
                         "kTeam);", "  w.t.next = uint32_t(w.t.pos) & "
                         "0xFFFFu;"),
                        ("    o1_words_move(w, j);\n", "")],
            "no-update": [("*hp = uint16_t(o1_update(hrow.c, low_h, j));",
                           "*hp = uint16_t(hrow.c);"),
                          ("*lp = uint16_t(o1_update(lrow.c, low_l, j));",
                           "*lp = uint16_t(lrow.c);")],
            "no-store": [("      *hp = uint16_t(o1_update(hrow.c, low_h, "
                          "j));\n", ""),
                         ("      *lp = uint16_t(o1_update(lrow.c, low_l, "
                          "j));\n", "")]}),
}


def _lane_o1_inputs(codec: str, dev, rot: int):
    """(C arguments maker, the bytes the decode must give, K) of one
    realsrcbwt block as ``codec`` shapes it: make(out) -> the C entry's
    arguments."""
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import rans_cdf_o1 as O1
    from turborc_tpu_torch.codecs import rans_cdf_r1_lane as R59
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
    from turborc_tpu_torch.utils.config import CodecConfig
    cfg = CodecConfig()
    x = np.roll(np.fromfile(O1_CORPUS, np.uint8), rot)[:cfg.block_size]
    if codec == "rans-cdf-r1":
        a = R59.encode_args(x, cfg.lanes, cfg.step_quant, dev)
        cols, tabs = a.cols, (a.hi_tbl, a.lo_tbl)
        probs = LO.lane_o1r_model(cols, *tabs)
    else:
        block, _ = blockio.shape_block(x, min(cfg.lanes, O1.LANE_CAP),
                                       cfg.step_quant)
        cols, tabs = torch.from_numpy(block).to(dev).T.contiguous(), ()
        probs = LO.lane_o1_model(cols)
    K, L = cols.shape
    st, lens = LK.lane_coder(probs, torch.full(
        (L,), rans.ANS_LOW, dtype=torch.int32, device=dev))
    words = blockio.device_words(st, lens)
    offs = LK._offsets(lens)
    if codec == "rans-cdf-r1":
        return (lambda out: LO.lane_o1r_decode_cargs(
            words, offs, lens, K, *tabs, out)), cols, K
    return (lambda out: LO.lane_o1_decode_cargs(words, offs, lens, K, out)
            ), cols, K


def _lane_o1_ptxas(report: str, kernel: str = "lane_o1_decode") -> dict:
    """Registers, stack, spills and smem of ``kernel``_kernel's
    instantiations (lane_o1_decode or lane_o1_model), by context."""
    res, key = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line \
                or "Function properties for" in line:
            m = re.search(kernel + r"_kernel\w*?(O1Rank|O1Byte)", line)
            key = m.group(1) if m else None
            if key:
                res.setdefault(key, {})
            continue
        if key:
            for k, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                           ("spill_stores", r"(\d+) bytes spill stores"),
                           ("registers", r"Used (\d+) registers"),
                           ("smem", r"(\d+) bytes smem")):
                m3 = re.search(pat, line)
                if m3:
                    res[key][k] = int(m3.group(1))
    return res


def probe_lane_o1(opt, dev, res: dict, work: Path) -> dict:
    """L6 or L8 (``LANE_SPLIT[opt.kernel]``) of the source in ``--src``:
    ptxas of both contexts, SASS, the clock64() split of the byte step,
    and the bare C entry timed (a warm-up, then 3 repetitions on distinct
    rotations of the block) for the base, the stamped build, the layout's
    variants (held byte for byte) and, on the port's source, the named
    ablations (timed only)."""
    spec = LANE_SPLIT[opt.kernel]
    src = Path(opt.src).resolve()
    base = (src / "rans_lane_kernel.cu").read_text()
    header = (src / "rans_common.cuh").read_text()
    layout = next(k for k, v in LANE_O1_LAYOUT.items() if v in base)
    res["layout"] = layout
    plan = LANE_O1_STAMPS[layout]
    variants = {"base": base,
                "stamped": stamped(base, "lane_o1_decode_kernel(",
                                   plan["stamps"], loop_head=plan.get(
                                       "loop_head",
                                       "for (int t = 0; t < K; ++t) {"))}
    for name, changes in plan["variants"].items():
        if name.startswith("rank-") and spec["codec"] != "rans-cdf-r1":
            continue
        variants[name] = _ablate(name, base, header, LANE_O1_SECTION,
                                 changes)
    for name in [x for x in opt.ablate.split(",") if x]:
        variants[name] = _ablate(name, base, header, LANE_O1_SECTION,
                                 plan["ablations"][name])
    exact = ("base", "stamped", *plan["variants"])  # held byte for byte
    libs, reports, res["nvcc_s"] = _build_all(variants, src, work,
                                              "rans_lane_kernel.cu")
    res["ptxas"] = {k: _lane_o1_ptxas(v) for k, v in reports.items()}
    res["sass"] = _sass(libs["base"], "lane_o1_decode")
    # the port's kernels run first (they make the inputs), and the builds
    # load after them
    _lane_o1_inputs(spec["codec"], dev, 0)
    types = build.SIGNATURES["rans_lane_kernel.cu"][spec["entry"]]
    fns, loaded = {}, {}
    for k, lib in libs.items():
        loaded[k] = ctypes.CDLL(str(lib))
        fns[k] = getattr(loaded[k], spec["entry"])
        fns[k].argtypes, fns[k].restype = types, ctypes.c_int
    segs = plan["segments"]
    times = {k: [] for k in variants}
    split, K = None, 0
    for r in range(4):  # rep 0 is the warm-up
        make, ref, K = _lane_o1_inputs(spec["codec"], dev, 7919 * (r + 1))
        for k, fn in fns.items():
            print(f"probe {spec['codec']} rep {r}: {k}", file=sys.stderr,
                  flush=True)
            out = torch.empty_like(ref)
            ms = _bare(fn, make(out))
            if k in exact and not torch.equal(out, ref):
                raise AssertionError(f"{k} differs from the bytes at "
                                     f"{spec['codec']}")
            if r:
                times[k].append(ms)
            if k == "stamped":
                acc = (ctypes.c_ulonglong * 32)()
                loaded[k].trc_split_read(ctypes.cast(acc, ctypes.c_void_p))
                split = [int(x) for x in acc[:len(segs)]]
            del out
        del make, ref
    total = sum(split)
    res.update(
        codec=spec["codec"], K=K,
        split={"thread": "team thread 0 of lane 0, CTA 0",
               "cycles_total": total, "cycles_per_byte": total / K,
               "segments": [{"segment": segs[i], "cycles": c,
                             "per_byte": c / K, "share": c / total}
                            for i, c in enumerate(split)]},
        ms=times, mean_ms={k: sum(v) / len(v) for k, v in times.items()})
    return res


# L5 (``--kernel lane_o1r_model``, id 59) and L7 (``--kernel
# lane_o1_model``, id 64): the template lane_o1_model_kernel of
# rans_lane_kernel.cu over O1Rank and O1Byte, on one 4 MB block of
# realsrcbwt at the default CodecConfig as the codecs shape it (id 59: 512
# lanes, K = 8192, 16 segments; id 64: 128 lanes, K = 32,768).  Two
# layouts, told apart by the source: "first" (af5a925's design: L1's team,
# both rows of a byte read after the last byte's stores, the lookup by
# shuffles and the update masked by its low; id 59 8 lanes a CTA, id 64
# one lane beside a dummy team) and "chain" (the port's: a warp a lane,
# its hi and lo chains on two teams, the mask by index, rows read
# kO1Ahead steps ahead and forwarded where they repeat).  Stamps and
# segments as for L6 / L8 (thread 0 of CTA 0: hi team thread 0 of lane
# 0); ``variants`` are held byte for byte against the base build, and the
# base against the port's model; ablations are timed only.
LANE_O1M_LAYOUT = {
    "first": "team_lookup<T>(hrow, hs, low_h, fr_h);",
    "chain": "const int cn = c + (((j > int(p & 15) ? hi_t : lo_t) - c) >> "
             "kO1Rate);"}
LANE_O1M_STAMPS = {
    "first": dict(
        stamps=[("    sym_next = __shfl_sync(kFull, cur, (t + 1) & (T - 1), "
                 "T);", 1, 0, "sym_next"),
                ("    uint16_t* lp = r.base + (C::kHiRows + "
                 "C::lo_row(prev, hs)) * r.stride;", 1, 1, "int(lp - hp)"),
                ("    ld_part<E>(lp, lrow);", 1, 2, "hrow[0] + lrow[0]"),
                ("    team_lookup<T>(lrow, ls, low_l, fr_l);", 1, 3,
                 "low_h + fr_h + low_l + fr_l"),
                ("    team_update<T>(lrow, low_l, kO1Rate, j);", 1, 4,
                 "hrow[0] + lrow[0]"),
                ("    st_part<E>(lp, lrow);", 1, 5, "0"),
                ("    slot_l = take ? (low_l << 16) | fr_l : slot_l;", 1, 6,
                 "slot_h + slot_l")],
        segments=["probs stores (every T steps), byte staging",
                  "row addresses", "row loads (charged their latency)",
                  "lookups (four shuffles)", "updates (masked by low)",
                  "row stores", "prev, slots kept"],
        variants={},
        ablations={
            "no-lookup": [("    team_lookup<T>(hrow, hs, low_h, fr_h);\n"
                           "    team_lookup<T>(lrow, ls, low_l, fr_l);\n",
                           "    low_h = hrow[0];\n    fr_h = hs + 1;\n"
                           "    low_l = lrow[0];\n    fr_l = ls + 1;\n")],
            "no-update": [("    team_update<T>(hrow, low_h, kO1Rate, j);\n"
                           "    team_update<T>(lrow, low_l, kO1Rate, j);\n",
                           "")],
            "no-store": [("    st_part<E>(hp, hrow);\n"
                          "    st_part<E>(lp, lrow);\n", "")]}),
    "chain": dict(
        loop_head="for (int t0 = 0; t0 < K; t0 += kTeam) {",
        stamps=[("        c = (p >> (kPlanFwd + k - 1)) & 1 ? fw[k - 1] : c;",
                 1, 0, "c"),
                ("      const int cn = c + (((j > int(p & 15) ? hi_t : lo_t) "
                 "- c) >> kO1Rate);", 1, 1, "cn"),
                ("      row(p) = uint16_t(cn);", 1, 2, "0"),
                ("      const int nx = __shfl_sync(kFull, j ? c : kTotal, p >> "
                 "kPlanNext, kTeam);", 1, 3, "low + nx"),
                ("      fw[0] = cn;", 1, 4, "slot"),
                ("      ld[D - 1] = row(pl[D - 1]);", 1, 5, "pl[D - 1]"),
                ("    if (real && t0 + j < K) out[size_t(2) * (t0 + j) * L] = "
                 "slot;", 1, 6, "0"),
                ("    b_far = b_new;", 1, 7, "p_nxt")],
        segments=["plan bits, forward select (waits on the row read "
                  "kO1Ahead steps before)",
                  "update (mask by index)", "row store",
                  "lookup (two shuffles)", "slot kept, forward shift",
                  "plan of step t + kO1Ahead (a shuffle), its row read",
                  "probs stores (every 16 steps)",
                  "plan of the chunk after next, bytes (every 16 steps)"],
        # held byte for byte: the levers off or moved
        variants={
            "ahead-1": [("constexpr int kO1Ahead = 3;",
                         "constexpr int kO1Ahead = 1;")],
            "ahead-2": [("constexpr int kO1Ahead = 3;",
                         "constexpr int kO1Ahead = 2;")],
            "ahead-4": [("constexpr int kO1Ahead = 3;",
                         "constexpr int kO1Ahead = 4;")],
            # the mask by value: the lookup's low back on the chain
            "by-value": [("const int cn = c + (((j > int(p & 15) ? hi_t : "
                          "lo_t) - c) >> kO1Rate);", "const int cn = c + "
                          "(((c > __shfl_sync(kFull, c, p, kTeam) ? hi_t : "
                          "lo_t) - c) >> kO1Rate);")],
            # the rows one after another, hi rows first (no bank groups)
            "one-group": [("  return 4 * (r / C::kHiGroups) + r % "
                           "C::kHiGroups;", "  return r;"),
                          ("  return 4 * (q / (4 - C::kHiGroups)) + "
                           "C::kHiGroups + q % (4 - C::kHiGroups);",
                           "  return C::kHiRows + q;")],
            # K9's lever: the two chains on two warps, each team beside a
            # dummy that stores nothing
            "two-warps": [("  const int n = threadIdx.x >> 5, g = "
                           "(threadIdx.x >> 4) & 1;",
                           "  const int n = threadIdx.x >> 6, g = "
                           "(threadIdx.x >> 5) & 1;\n  const bool dummy = "
                           "(threadIdx.x >> 4) & 1;"),
                          ("      row(p) = uint16_t(cn);",
                           "      if (!dummy) row(p) = uint16_t(cn);"),
                          ("    if (real && t0 + j < K) out[",
                           "    if (real && !dummy && t0 + j < K) out["),
                          ("  return C::kLanes * 32;",
                           "  return C::kLanes * 64;")],
            "rank-lanes-2": [("kHiRows = 64, kLoRows = 48, kLanes = 4;",
                              "kHiRows = 64, kLoRows = 48, kLanes = 2;")],
            "rank-lanes-8": [("kHiRows = 64, kLoRows = 48, kLanes = 4;",
                              "kHiRows = 64, kLoRows = 48, kLanes = 8;")]},
        ablations={
            "no-lookup": [("      const int low = __shfl_sync(kFull, c, p, "
                           "kTeam);\n      const int nx = __shfl_sync(kFull, "
                           "j ? c : kTotal, p >> kPlanNext, kTeam);",
                           "      const int low = c;\n      const int nx = "
                           "c + int(p & 15);")],
            "no-update": [("const int cn = c + (((j > int(p & 15) ? hi_t : "
                           "lo_t) - c) >> kO1Rate);", "const int cn = c;")],
            "no-store": [("      row(p) = uint16_t(cn);\n", "")]}),
}


def _lane_o1_model_inputs(codec: str, dev, rot: int):
    """(C arguments maker, the port's probs, K) of one realsrcbwt block as
    ``codec`` shapes it: make(out) -> the model's C arguments."""
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import rans_cdf_o1 as O1
    from turborc_tpu_torch.codecs import rans_cdf_r1_lane as R59
    from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
    from turborc_tpu_torch.utils.config import CodecConfig
    cfg = CodecConfig()
    x = np.roll(np.fromfile(O1_CORPUS, np.uint8), rot)[:cfg.block_size]
    if codec == "rans-cdf-r1":
        a = R59.encode_args(x, cfg.lanes, cfg.step_quant, dev)
        cols, tabs = a.cols, (a.hi_tbl, a.lo_tbl)
        return (lambda out: LO.lane_o1r_model_cargs(cols, *tabs, out)), \
            LO.lane_o1r_model(cols, *tabs), cols.shape[0]
    block, _ = blockio.shape_block(x, min(cfg.lanes, O1.LANE_CAP),
                                   cfg.step_quant)
    cols = torch.from_numpy(block).to(dev).T.contiguous()
    return (lambda out: LO.lane_o1_model_cargs(cols, out)), \
        LO.lane_o1_model(cols), cols.shape[0]


def probe_lane_o1_model(opt, dev, res: dict, work: Path) -> dict:
    """L5 or L7 (``LANE_SPLIT[opt.kernel]``) of the source in ``--src``:
    ptxas of both contexts, SASS, the clock64() split of the byte step,
    and the bare C entry timed (a warm-up, then 3 repetitions on distinct
    rotations of the block) for the base, the stamped build, the layout's
    variants and the named ablations.  The stamped build and the variants
    are held byte for byte against the base; ``equal_to_port`` says
    whether the base gave the port's probs (another source's model
    against this tree's)."""
    spec = LANE_SPLIT[opt.kernel]
    src = Path(opt.src).resolve()
    base = (src / "rans_lane_kernel.cu").read_text()
    header = (src / "rans_common.cuh").read_text()
    layout = next(k for k, v in LANE_O1M_LAYOUT.items() if v in base)
    res["layout"] = layout
    plan = LANE_O1M_STAMPS[layout]
    variants = {"base": base,
                "stamped": stamped(base, "lane_o1_model_kernel(",
                                   plan["stamps"], loop_head=plan.get(
                                       "loop_head",
                                       "for (int t = 0; t < K; ++t) {"))}
    for name, changes in plan["variants"].items():
        if name.startswith("rank-") and spec["codec"] != "rans-cdf-r1":
            continue
        variants[name] = _ablate(name, base, header, LANE_O1_SECTION,
                                 changes)
    for name in [x for x in opt.ablate.split(",") if x]:
        variants[name] = _ablate(name, base, header, LANE_O1_SECTION,
                                 plan["ablations"][name])
    exact = ("stamped", *plan["variants"])  # held against the base
    libs, reports, res["nvcc_s"] = _build_all(variants, src, work,
                                              "rans_lane_kernel.cu")
    res["ptxas"] = {k: _lane_o1_ptxas(v, "lane_o1_model")
                    for k, v in reports.items()}
    res["sass"] = _sass(libs["base"], "lane_o1_model")
    # the port's kernels run first (they make the inputs), and the builds
    # load after them
    _lane_o1_model_inputs(spec["codec"], dev, 0)
    types = build.SIGNATURES["rans_lane_kernel.cu"][spec["entry"]]
    fns, loaded = {}, {}
    for k, lib in libs.items():
        loaded[k] = ctypes.CDLL(str(lib))
        fns[k] = getattr(loaded[k], spec["entry"])
        fns[k].argtypes, fns[k].restype = types, ctypes.c_int
    segs = plan["segments"]
    times = {k: [] for k in variants}
    split, K, same = None, 0, True
    for r in range(4):  # rep 0 is the warm-up
        make, port, K = _lane_o1_model_inputs(spec["codec"], dev,
                                              7919 * (r + 1))
        ref = None
        for k, fn in fns.items():
            print(f"probe {spec['codec']} model rep {r}: {k}",
                  file=sys.stderr, flush=True)
            out = torch.empty_like(port)
            ms = _bare(fn, make(out))
            if k == "base":
                ref = out
                same = same and torch.equal(out, port)
            elif k in exact and not torch.equal(out, ref):
                raise AssertionError(f"{k} differs from the base's probs "
                                     f"at {spec['codec']}")
            if r:
                times[k].append(ms)
            if k == "stamped":
                acc = (ctypes.c_ulonglong * 32)()
                loaded[k].trc_split_read(ctypes.cast(acc, ctypes.c_void_p))
                split = [int(x) for x in acc[:len(segs)]]
            if k != "base":
                del out
        del make, port, ref
    total = sum(split)
    res.update(
        codec=spec["codec"], K=K, equal_to_port=same,
        split={"thread": "team thread 0 of lane 0, CTA 0",
               "cycles_total": total, "cycles_per_byte": total / K,
               "segments": [{"segment": segs[i], "cycles": c,
                             "per_byte": c / K, "share": c / total}
                            for i, c in enumerate(split)]},
        ms=times, mean_ms={k: sum(v) / len(v) for k, v in times.items()})
    return res


# L2 (``--kernel lane_coder``) and L4 (``--kernel lane_static_decode``):
# the per-lane scan codecs' coder and static-CDF decoder of
# rans_lane_kernel.cu, on one 4 MB block of textbwt at the default
# CodecConfig (512 lanes): L2 on id 56's probs (L1's, S = 2K = 16,384) and
# id 42's (the static CDF's, S = K = 8,192), L4 on id 42's streams.  Two
# layouts each, told apart by the source: L2 "queue" (cfdb21a: one thread
# a lane on CTAs of 128, probs from device memory kPre slots ahead in a
# register queue, the hardware division, the words moved one at a time by
# their lane's thread) and "staged" (the port's: K3's chain over a lane's
# row); L4 "thread" (cfdb21a: one thread a lane, sym_of then two CDF loads
# a byte, the table built by a search a value) and "team" (the port's:
# L3's team word reader, one entry load a byte on the chain, the table
# walked a run of values a thread).  A stamp marks the end of a segment
# anywhere in the kernel (``stamped_at``): thread 0 of CTA 0 (lane 0; in
# L2 its chain and then its warp's moves).  ``exact`` variants are held
# byte for byte like the base; ablations are timed only.
IO_STAMPS = {
    "queue": dict(
        begin="  if (l >= L) return;  // no barrier below",
        stamps=[
            ("    q[kPre - 1] = s - kPre >= 0 ? uint32_t(src[size_t(s - kPre)"
             " * L]) : 1u;", "p + q[0]"),
            ("      state >>= 16;\n    }", "k"),
            ("    const uint32_t quo = state / freq;", "quo"),
            ("    state = (quo << 15) + (state - quo * freq) + low;",
             "state"),
            ("  for (size_t p = max(size_t(k) + 2, M - k); p < M; ++p) "
             "row[p] = 0;", "row[2]")],
        end="  for (size_t p = max(size_t(k) + 2, M - k); p < M; ++p) "
            "row[p] = 0;",
        segments=["queue: load issue, the shift waits on the load of a "
                  "step ago", "emit", "division (hardware /)",
                  "state step", "move (one thread, a word at a time)"]),
    "staged": dict(
        begin="  const size_t M = size_t(S) + 2;",
        stamps=[("    mtab[f] = m << 1;\n  }", "mtab[threadIdx.x]"),
                ("    __syncthreads();", "0"),
                ("      continue;\n    }", "0"),
                ("      coder_recip(mtab, p1, m1, sh1);",
                 "m1[kCoderU - 1] + p2[kCoderU - 1]"),
                ("        state = x + (pr >> 16) + q * (kTotal - freq);\n"
                 "      }", "state"),
                ("        sh0[u] = sh1[u];\n      }", "p0[0]"),
                ("  __syncthreads();  // every word at its row's end",
                 "kept[0]"),
                ("      row[p] = 0;\n  }", "0")],
        end="      row[p] = 0;\n  }",
        segments=["table fill, first stages requested",
                  "stage wait (cp.async wait, barrier)",
                  "stage request",
                  "reciprocal: block b + 1's table loads and shifts, "
                  "block b + 2's probs (charged their latency)",
                  "state step and emit to the word ring (a block of "
                  "kCoderU slots)",
                  "block rotation",
                  "counts, the last flush (helpers), flush state, barriers",
                  "move and clear (warp 0's lanes)"]),
    "thread": dict(
        begin="  __shared__ uint8_t sym_of[kTotal];",
        stamps=[("    sym_of[v] = uint8_t(lo);\n  }\n  __syncthreads();",
                 "sym_of[threadIdx.x]"),
                ("  words_init(w, words, off, len, W, 2 * K + 2, l, true, "
                 "state);", "state"),
                ("    const int sym = sym_of[value];", "sym"),
                ("    const int low = c[sym], freq = c[sym + 1] - low;",
                 "low + freq"),
                ("    state = uint32_t(freq) * (state >> 15) + value - "
                 "uint32_t(low);", "state"),
                ("    words_renorm(w, state);", "state"),
                ("    dst[size_t(t) * L] = uint8_t(sym);", "sym")],
        end="    dst[size_t(t) * L] = uint8_t(sym);\n  }",
        segments=["table build (a search a value)", "words init",
                  "table load (sym_of)", "CDF loads (low, freq)",
                  "state step", "renorm (the word loaded at the last "
                  "take)", "store"]),
    "team": dict(
        begin="  const bool real = l < L;",
        stamps=[("  static_tables(c, ent, sym_of);", "ent[threadIdx.x]"),
                ("  __syncthreads();", "state", 2),
                ("      mine = j == u ? sym : mine;\n    }", "state + mine"),
                ("    static_words_chunk<T>(w, j);", "w.far"),
                ("    if (real) dst[size_t(t0) * L] = mine;", "mine"),
                ("  if (real && full + j < K) dst[size_t(full) * L] = mine;",
                 "mine")],
        end="  if (real && full + j < K) dst[size_t(full) * L] = mine;",
        segments=["table build (a run of values a thread)",
                  "words init, barrier",
                  "steps (table load, state step, renorm; T a chunk)",
                  "chunk end: the words move along (charged the far "
                  "load's latency)",
                  "store (a chunk of T)", "the last K % T steps"]),
}
IO_KERNELS = {
    "lane_coder": dict(
        entry="trc_lane_coder", fn="lane_coder_kernel(",
        layout=lambda src: "queue" if "kPre" in src else "staged",
        codecs=("rans-cdf-o0", "rans-static"),
        occupancy={"queue": ("lane_coder_kernel", "kLanes", "0"),
                   "staged": ("lane_coder_kernel", "kCoderThreads",
                              "kCoderSmem")},
        section=("// ---- L2:", "// L3's reader"),
        variants={
            "lanes-64": [("constexpr int kCoderN = 32;",
                          "constexpr int kCoderN = 64;")],
            # both steps (emit, no emit) at once, selected at the end
            "both-paths": [
                ("        const uint32_t x = e ? state >> 16 : state;\n"
                 "        const uint32_t q = (__umulhi(x, m0[u]) + x) >> "
                 "sh0[u];  // x / freq\n"
                 "        // (q << 15) + (x - q * freq) + low\n"
                 "        state = x + (pr >> 16) + q * (kTotal - freq);",
                 "        const uint32_t x1 = state >> 16, c = kTotal - "
                 "freq, lo = pr >> 16;\n"
                 "        const uint32_t q0 = (__umulhi(state, m0[u]) + "
                 "state) >> sh0[u];\n"
                 "        const uint32_t q1 = (__umulhi(x1, m0[u]) + x1) >> "
                 "sh0[u];\n"
                 "        state = e ? x1 + lo + q1 * c : state + lo + q0 * "
                 "c;")]},
        ablations={
            "no-emit": [("        wr[(k & (kCoderWords - 1)) * N] = "
                         "int(state & 0xFFFFu);\n", "")],
            "no-flush": [("      coder_flush(words, kpub + ((j + 2) % 3) * N,"
                          " kpub + (j % 3) * N,\n                  streams, "
                          "M, lane0, L);\n", "")],
            "no-div": [("(__umulhi(x, m0[u]) + x) >> sh0[u];",
                        "x >> 12;")],
            "no-move": [("    if (kc == 0) continue;  // also a dummy lane",
                         "    continue;")],
            "no-table": [("    div_magic(uint32_t(f + 1), m, sh);\n"
                          "    mtab[f] = m << 1;", "    mtab[f] = 2u;")],
        }),
    "lane_static_decode": dict(
        entry="trc_lane_static_decode", fn="lane_static_decode_kernel(",
        layout=lambda src: "thread" if "sym_of[value];\n    const int low"
        in src else "team",
        codecs=("rans-static",),
        occupancy={"thread": ("lane_static_decode_kernel", "kLanes", "0"),
                   "team": ("lane_static_decode_kernel", "kStaticThreads",
                            "kStaticSmem")},
        section=("// L3's reader", "bool pow2(int v"),
        variants={
            "team-4": [("constexpr int kStaticTeam = 16;",
                        "constexpr int kStaticTeam = 4;")],
            "team-8": [("constexpr int kStaticTeam = 16;",
                        "constexpr int kStaticTeam = 8;")],
            # sym_of[v], then a 256-entry packed (freq << 16) - low by the
            # symbol: two dependent loads a byte
            "sym-packed": [
                ("    ent[v] = (uint32_t(nx - low) << 16) | uint32_t(v - "
                 "low);", "    ent[sym] = (uint32_t(nx - low) << 16) - "
                 "uint32_t(low);"),
                ("  const uint32_t e = ent[value];\n  const uint8_t sym "
                 "= sym_of[value];", "  const uint8_t sym = "
                 "sym_of[value];\n  const uint32_t e = ent[sym] + value;")],
        },
        ablations={
            "no-word": [("  w.next = __shfl_sync(kFull, w.pos < w.edge ? "
                         "w.cur : w.nxt,\n                       w.pos & "
                         "(T - 1), T);", "  w.next = uint32_t(w.pos) & "
                         "0xFFFFu;")],
            "no-renorm": [("  const bool take = state < kAnsLow;",
                           "  const bool take = false;")],
            "no-chunk": [("    static_words_chunk<T>(w, j);\n", "")],
            "no-store": [("    if (real) dst[size_t(t0) * L] = mine;\n",
                          "")],
            "no-build": [("  static_tables(c, ent, sym_of);\n", "")],
        }),
}


def stamped_at(source: str, fn: str, spec: dict) -> str:
    """The source with clock64() stamps (``IO_STAMPS``' form) in the
    kernel that starts at ``fn``: TRC_SPLIT_BEGIN after the line ending
    ``begin``, a stamp after the line ending each anchor (its nth
    occurrence from the kernel's start, 1 unless given), TRC_SPLIT_END
    after the line ending ``end``, all in the kernel's own scope order."""
    head, sep, rest = source.partition('#include "rans_common.cuh"\n')
    if not sep:
        raise ValueError("rans_common.cuh include not found")
    start = rest.index(fn)

    def after(anchor: str, nth: int = 1) -> int:
        at = start - 1
        for _ in range(nth):
            at = rest.index(anchor, at + 1)
        return rest.index("\n", at + len(anchor)) + 1

    inserts = [(after(spec["begin"]), "  TRC_SPLIT_BEGIN\n")]
    for k, (anchor, val, *nth) in enumerate(spec["stamps"]):
        inserts.append((after(anchor, *nth), f"    TRC_STAMP({k}, {val});\n"))
    inserts.append((after(spec["end"]), "  TRC_SPLIT_END\n"))
    # at one place, the later insert goes in first so it ends up after
    for _, at, text in sorted(((i, at, text) for i, (at, text)
                               in enumerate(inserts)),
                              key=lambda x: (-x[1], -x[0])):
        rest = rest[:at] + text + rest[at:]
    return head + sep + PRELUDE + rest


def _io_inputs(kernel: str, codec: str, dev, rot: int):
    """(C arguments maker, reference outputs, S or K) of one block:
    make(outs) -> the C entry's arguments; L2's outputs are the zeroed
    streams and the lengths."""
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import rans_cdf_s8 as S58
    from turborc_tpu_torch.codecs import rans_static as S42
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.utils.config import CodecConfig
    cfg = CodecConfig()
    L = cfg.lanes
    x = np.roll(np.fromfile(LANE_CORPUS, np.uint8), rot)[:cfg.block_size]
    block, K = blockio.shape_block(x, L, cfg.step_quant)
    cols = torch.from_numpy(block).to(dev).T.contiguous()
    if codec == "rans-static":
        freqs = S42.build_freqs(block.reshape(-1))
        cdf = torch.from_numpy(S42._cdf(freqs)).to(dev)
        probs = S42.slot_probs(cols, cdf)
    else:
        hi, lo = S58.tables_on(*(t[None] for t in blockio.nibble_tables(x)),
                               dev)
        probs = LK.lane_model(cols, hi, lo)
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32, device=dev)
    st, lens = LK.lane_coder(probs, init)
    if kernel == "lane_coder":
        return (lambda outs: LK.lane_coder_cargs(probs, init, *outs)), \
            (st, lens), probs.shape[0]
    words = blockio.device_words(st, lens)
    offs = LK._offsets(lens)
    out = LK.lane_static_decode(words, lens, K, cdf)
    return (lambda outs: LK.lane_static_decode_cargs(
        words, offs, lens, K, cdf, *outs)), (out,), K


def probe_io(opt, dev, res: dict, work: Path) -> dict:
    """L2 or L4 (``IO_KERNELS[opt.kernel]``) of the source in ``--src``:
    ptxas, SASS, CTAs an SM, the clock64() split, and the bare C entry
    timed (a warm-up, then 3 repetitions on distinct rotations of the
    block) for the base, the stamped build, the sweep's variants (held
    byte for byte) and, on the port's layout, the ablations (timed
    only)."""
    spec = IO_KERNELS[opt.kernel]
    src = Path(opt.src).resolve()
    base = (src / "rans_lane_kernel.cu").read_text()
    header = (src / "rans_common.cuh").read_text()
    layout = spec["layout"](base)
    res["layout"] = layout
    variants = {"base": base,
                "stamped": stamped_at(base, spec["fn"], IO_STAMPS[layout])}
    ablate = [x for x in opt.ablate.split(",") if x]
    if layout in ("staged", "team"):
        for name, changes in spec["variants"].items():
            variants[name] = _ablate(name, base, header, spec["section"],
                                     changes)
        for name in ablate:
            variants[name] = _ablate(name, base, header, spec["section"],
                                     spec["ablations"][name])
    elif ablate:
        raise ValueError("--ablate applies to the port's own source")
    exact = ("base", "stamped", *spec["variants"])
    occ = _occupancy_entry(*spec["occupancy"][layout])
    variants = {k: ((v[0] + occ, v[1]) if isinstance(v, tuple) else v + occ)
                for k, v in variants.items()}
    libs, reports, res["nvcc_s"] = _build_all(variants, src, work,
                                              "rans_lane_kernel.cu")
    names = opt.kernel
    res["ptxas"] = {k: _ptxas(v, names).get(names)
                    for k, v in reports.items()}
    res["sass"] = _sass(libs["base"], names)
    # the port's kernels run first (they make the inputs), and the builds
    # load after them
    _io_inputs(opt.kernel, spec["codecs"][0], dev, 0)
    types = build.SIGNATURES["rans_lane_kernel.cu"][spec["entry"]]
    fns, loaded = {}, {}
    for k, lib in libs.items():
        loaded[k] = ctypes.CDLL(str(lib))
        fns[k] = getattr(loaded[k], spec["entry"])
        fns[k].argtypes, fns[k].restype = types, ctypes.c_int
    res["ctas_per_sm"] = {}
    for k, lib in loaded.items():
        c = ctypes.c_int(0)
        err = lib.trc_probe_occupancy(ctypes.byref(c))
        res["ctas_per_sm"][k] = f"CUDA error {err}" if err else c.value
    segs = IO_STAMPS[layout]["segments"]
    res["codecs"] = {}
    for codec in spec["codecs"]:
        times = {k: [] for k in variants}
        split, n = None, 0
        for r in range(4):  # rep 0 is the warm-up
            make, ref, n = _io_inputs(opt.kernel, codec, dev, 7919 * (r + 1))
            for k, fn in fns.items():
                print(f"probe {codec} rep {r}: {k}", file=sys.stderr,
                      flush=True)
                outs = [torch.zeros_like(v) for v in ref]
                ms = _bare(fn, make(outs))
                if k in exact and not all(map(torch.equal, outs, ref)):
                    raise AssertionError(f"{k} differs from the port's "
                                         f"{opt.kernel} at {codec}")
                if r:
                    times[k].append(ms)
                if k == "stamped":
                    acc = (ctypes.c_ulonglong * 32)()
                    loaded[k].trc_split_read(ctypes.cast(acc,
                                                         ctypes.c_void_p))
                    split = [int(x) for x in acc[:len(segs)]]
                del outs
            del make, ref
        total = sum(split)
        res["codecs"][codec] = {
            "steps": n,
            "split": {"thread": "thread 0 of CTA 0", "cycles_total": total,
                      "cycles_per_step": total / max(n, 1),
                      "segments": [{"segment": segs[i], "cycles": c,
                                    "per_step": c / max(n, 1),
                                    "share": c / total}
                                   for i, c in enumerate(split)]},
            "ms": times,
            "mean_ms": {k: sum(v) / len(v) for k, v in times.items()}}
    return res


# L11 (``--kernel lane_bit_model``) and L12 (``--kernel lane_bit_decode``):
# the bitwise byte-tree kernels of rans_bit_kernel.cu at every (predictor,
# order) of ids 1, 2, 101-104, on one 4 MB block of textbwt at the default
# CodecConfig (512 lanes, K = 8192).  Two layouts, told apart by the
# source: "first" (fdd1d6f's design: L11 a warp a depth on CTAs of 32
# lanes, each byte read from device memory at every step and each slot
# read after the last store; L12 a thread a lane on CTAs of 8, both
# children read while a bit resolves, the FSM's probability a table read
# on the chain) and "line" (the port's: L11 a warp of 4 lanes x 8 depths,
# the bytes a chunk ahead, the slots read kAhead steps ahead and
# forwarded; L12 4 lanes a CTA, a row read a line at a time, FSM slots
# (p << 16) | state, the tables in shared memory).  Stamps for thread 0 of
# CTA 0 (L11: depth 0 of lane 0, and the thread of depth 7 of lane 0);
# variants are held byte for byte against the base build, the base against
# the port's kernel (``equal_to_port``); ablations are timed only, and
# "rows-4" (order 1: the context taken mod 4, four rows a lane) stands in
# for the table's L2 hit rate, which the card's tools do not report here.
BIT_CASES = (("s", 0), ("ss", 0), ("sf", 0), ("s", 1), ("ss", 1),
             ("sf", 1))
BIT_LAYOUT = {"first": "const int b = src[size_t(t) * L];",
              "line": "constexpr int kAhead0 = "}
BIT_SECTION = ("constexpr int kBitLanes", "bool pow2(int v")
# The FSM read from the table in device memory (through L1 / L2) instead
# of the CTA's copy in shared memory: the same values.
BIT_FSM_GLOBAL = [
    ("return pq[v];", "return clamp_p(__ldg(tab + v));"),
    ("return nx[2 * v + bit];",
     "const uint32_t s = uint32_t(__ldg(tab + (1 + bit) * S + v));\n"
     "    return s < uint32_t(S) ? s : uint32_t(S - 1);"),
    ("return nx[2 * (v & 0xFFFFu) + bit];",
     "const uint32_t s =\n        uint32_t(__ldg(tab + (1 + bit) * S + "
     "(v & 0xFFFFu)));\n    return s < uint32_t(S) ? s : uint32_t(S - 1);"),
    ("return uint32_t(pq[s]) << 16 | s;",
     "return uint32_t(clamp_p(__ldg(tab + s))) << 16 | s;")]
BIT_SPLIT = {
    ("lane_bit_model", "first"): dict(
        second="224",
        stamps=[("const int b = src[size_t(t) * L];", 1, 0, "b"),
                ("const uint32_t v = tab[slot];", 1, 1, "int(v)"),
                ("const int p = clamp_p(pred.prob(v));", 1, 2, "p"),
                ("tab[slot] = pred.next(v, p, bit);", 1, 3, "0"),
                ("out[size_t(8) * t * L] = bit ? p : (p << 16) | "
                 "(kTotal - p);", 1, 4, "0")],
        segments=["byte read (device memory, every step)",
                  "slot read (after the last store)",
                  "prediction (sf: the FSM's prob read)",
                  "update and slot store (sf: the FSM's next read)",
                  "probs store"],
        variants={},
        ablations={
            "no-byte": [("const int b = src[size_t(t) * L];",
                         "const int b = (t * 37 + l) & 255;")],
            "no-slot-read": [("const uint32_t v = tab[slot];",
                              "const uint32_t v = pred.init() ^ "
                              "uint32_t(slot & 7);")],
            "no-fsm": [("const int p = clamp_p(pred.prob(v));",
                        "const int p = clamp_p(int(v & 32767));"),
                       ("tab[slot] = pred.next(v, p, bit);",
                        "tab[slot] = v ^ uint32_t(bit);")],
            "no-store": [("tab[slot] = pred.next(v, p, bit);", "")],
            "no-probs": [("out[size_t(8) * t * L] = bit ? p : (p << 16) | "
                          "(kTotal - p);", "if (p == -1) out[0] = 0;")],
            "rows-4": [("const int slot = (kOrder ? ctx << 8 : 0)",
                        "const int slot = (kOrder ? (ctx & 3) << 8 : 0)")]}),
    ("lane_bit_model", "line"): dict(
        second="28",
        loop_head="auto half = [&](int t0, auto hi, auto guard) {",
        stamps=[("const int p = pr.prob(v);", 1, 0, "p"),
                ("const uint32_t nv = pr.next(v, p, bit);", 1, 1, "int(nv)"),
                ("tab[sl[r]] = nv;", 1, 2, "0"),
                ("plan(kH + j + kA < 32 ? cur : nxt, (kH + j + kA) & 31, "
                 "sl[r], bt[r]);", 1, 3, "sl[r]"),
                ("rv[r] = tab[sl[r]];  // after this step's store", 1, 4,
                 "0")],
        segments=["slot value (read kAhead steps before, forward picks), "
                  "prediction (sf: a table read in shared memory)",
                  "update (sf: a table read in shared memory)",
                  "probs and slot stores",
                  "plan of step t + kAhead (a shuffle)",
                  "its slot read issued"],
        variants={
            "ahead0-1": [("constexpr int kAhead0 = 2;",
                          "constexpr int kAhead0 = 1;")],
            "ahead0-4": [("constexpr int kAhead0 = 2;",
                          "constexpr int kAhead0 = 4;")],
            "ahead1-4": [("constexpr int kAhead1 = 8;",
                          "constexpr int kAhead1 = 4;")],
            "ahead1-16": [("constexpr int kAhead1 = 8;",
                           "constexpr int kAhead1 = 16;")],
            "fsm-global": BIT_FSM_GLOBAL},
        ablations={
            "no-forward": [("v = sl[r] == fs[i] ? fv[i] : v;", "")],
            "no-read": [("rv[r] = tab[sl[r]];  // after this step's store",
                         "rv[r] = pr.init() ^ uint32_t(sl[r] & 7);")],
            "no-store": [("tab[sl[r]] = nv;", "")],
            "no-probs": [("*out = bit ? p : (p << 16) | (kTotal - p);",
                          "if (p == -1) *out = 0;")],
            "rows-4": [("slot = (kOrder ? prev << 8 : 0)",
                        "slot = (kOrder ? (prev & 3) << 8 : 0)")]}),
    ("lane_bit_decode", "first"): dict(
        stamps=[("v1 = row[2 * node + 1];", 1, 0, "int(v0 + v1)"),
                ("p1 = clamp_p(pred.prob(v1));", 1, 1, "p0 + p1"),
                (": uint32_t(kTotal - p) * (state >> 15) + value - "
                 "uint32_t(p);", 1, 2, "int(state)"),
                ("row[node] = pred.next(v, p, bit);", 1, 3, "0"),
                ("node = 2 * node + bit;", 1, 4, "int(state)"),
                ("dst[size_t(t) * L] = uint8_t(byte);", 1, 5, "byte")],
        segments=["children's slot reads (and the row's root, a byte)",
                  "children's predictions (sf: the FSM's prob reads)",
                  "bit and state step", "update and slot store (sf: the "
                  "FSM's next read)", "renorm and word read",
                  "byte store, context"],
        variants={},
        ablations={
            "no-children": [("v0 = row[2 * node];", "v0 = v + 1;"),
                            ("v1 = row[2 * node + 1];", "v1 = v + 2;")],
            "no-fsm": [("p0 = clamp_p(pred.prob(v0));",
                        "p0 = clamp_p(int(v0 & 32767));"),
                       ("p1 = clamp_p(pred.prob(v1));",
                        "p1 = clamp_p(int(v1 & 32767));")],
            "no-word": [("        next = pos < nw ? uint32_t(src[pos]) : 0u;",
                         "        next = uint32_t(pos) & 0xFFFFu;")],
            "no-store": [("row[node] = pred.next(v, p, bit);", "")],
            "no-byte-store": [("dst[size_t(t) * L] = uint8_t(byte);",
                               "if (byte == 256) dst[0] = 0;")],
            "rows-4": [("uint32_t* row = tab + (kOrder ? ctx << 8 : 0);",
                        "uint32_t* row = tab + (kOrder ? (ctx & 3) << 8 "
                        ": 0);")]}),
    ("lane_bit_decode", "line"): dict(
        stamps=[("kids(h0.z, h0.w);", 1, 0, "int(c0 + c1)"),
                ("const Upd u2{hrow + 4 + 2 * b0 + b1, pr.dnext1(v, p, b2)};",
                 1, 1, "int(u2.v)"),
                ("kids(b2 ? z.z : z.x, b2 ? z.w : z.y);", 1, 2,
                 "int(c0 + c1)"),
                ("for (int i = 0; i < 14; ++i) H[i] = b3 ? Q[14 + i] : Q[i];",
                 1, 3, "int(H[0] + H[13])"),
                ("u7 = Upd{half + 6 + 4 * b4 + 2 * b5 + b6, "
                 "pr.dnext1(v, p, b7)};", 1, 4, "int(u7.v)"),
                ("    ctx = byte;", 1, 5, "byte")],
        # order 0's loop (decode_o0), stamped too
        stamps_o0=[("const int b = st.bit(p);", 1, 0, "b"),
                   ("U = Upd{row + node, pr.dnext1(v, p, b)};", 1, 1,
                    "int(U.v)"),
                   ("p = pr.dprob(v);", 2, 2, "p"),
                   ("if (d < 5) gc = ld4(row + 4 * node);", 1, 3, "0"),
                   ("dst[size_t(t) * L] = uint8_t(node & 255);", 1, 4,
                    "node")],
        segments_o0=["bit and state step (waits on p)",
                     "update under way, the one two decisions back stored",
                     "the child picked, its prediction",
                     "grandchildren's read issued (at decision 5 the next "
                     "head's)", "byte store, ring refill"],
        segments=["byte start: head and line A issued, the root's "
                  "children (waits on the head)",
                  "decisions 0-2 (state steps, picks, updates)",
                  "pair region issued; line A's picks (waits on line A)",
                  "decision 3; the pair region's half (waits on it)",
                  "decisions 4-7", "byte store, context"],
        variants={"dlanes-8": [("constexpr int kBitDLanes = 4;",
                                "constexpr int kBitDLanes = 8;")],
                  "fsm-global": BIT_FSM_GLOBAL},
        ablations={
            "no-word": [("return uint32_t(ring[(o + i) & (kRingW - 1)]);",
                         "return uint32_t(i) & 0xFFFFu;")],
            "no-store": [(f"*{f}.at = {f}.v;", "") for f in
                         ("f6", "f7", "f0", "f1", "f2", "f3", "f4", "f5",
                          "F")],
            "no-fsm": [("return nx[2 * (v & 0xFFFFu) + bit];",
                        "return (v & 0xFFFFu) ^ uint32_t(bit);"),
                       ("return uint32_t(pq[s]) << 16 | s;",
                        "return (s & 0x3FFFu) << 16 | s;")],
            "pair-fixed": [("const uint32_t* pair = brow + kPairAt + kPair "
                            "* j3;", "const uint32_t* pair = brow + "
                            "kPairAt;")],
            "rows-4": [("uint32_t* hrow = head + ctx * kHeadSlots;",
                        "uint32_t* hrow = head + (ctx & 3) * kHeadSlots;"),
                       ("uint32_t* brow = body + ctx * kBodySlots;",
                        "uint32_t* brow = body + (ctx & 3) * kBodySlots;")]}),
}


def _bit_ptxas(report: str, kernel: str) -> dict:
    """Registers, stack, spills and smem of each instantiation of
    ``kernel`` (keys ``s,0`` ... ``sf,1``)."""
    res, key = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line \
                or "Function properties for" in line:
            t = re.search(rf"{kernel}_kernel\w*?Pred(SS|SF|S)ELi(\d)E", line)
            key = f"{t.group(1).lower()},{t.group(2)}" if t else None
            if key:
                res.setdefault(key, {})
            continue
        if key:
            for name, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                              ("spill_stores", r"(\d+) bytes spill stores"),
                              ("spill_loads", r"(\d+) bytes spill loads"),
                              ("registers", r"Used (\d+) registers"),
                              ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    res[key][name] = int(m.group(1))
    return res


def _bit_inputs(kernel: str, name: str, order: int, dev, rot: int):
    """(C arguments maker, the port's output, K) of one textbwt block at
    the default CodecConfig for (predictor ``name``, ``order``):
    make(out) -> the C entry's arguments."""
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.models import bitpred
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_bit_kernel as BK
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.utils.config import CodecConfig
    cfg = CodecConfig()
    x = np.roll(np.fromfile(LANE_CORPUS, np.uint8), rot)[:cfg.block_size]
    block, K = blockio.shape_block(x, cfg.lanes, cfg.step_quant)
    cols = torch.from_numpy(block).to(dev).T.contiguous()
    pred = bitpred.make(name, device=dev)
    probs = BK.lane_bit_model(cols, order, pred)
    if kernel == "lane_bit_model":
        return (lambda out: BK.lane_bit_model_cargs(cols, out, order,
                                                    pred)), probs, K
    init = torch.full((cfg.lanes,), rans.ANS_LOW, dtype=torch.int32,
                      device=dev)
    st, lens = LK.lane_coder(probs, init)
    words = blockio.device_words(st, lens)
    offs = LK._offsets(lens)
    return (lambda out: BK.lane_bit_decode_cargs(
        words, offs, lens, K, out, order, pred)), cols, K


def probe_lane_bit(opt, dev, res: dict, work: Path) -> dict:
    """L11 or L12 of the source in ``--src``: ptxas of every
    instantiation, SASS, then per (predictor, order) the clock64() split
    of the step and the bare C entry timed (a warm-up, then 3 repetitions
    on distinct rotations of the block, every build in turn) for the base,
    the stamped build, the layout's variants and the named ablations.  A
    build a case cannot launch (too much shared memory) is reported, not
    fatal."""
    src = Path(opt.src).resolve()
    base = (src / "rans_bit_kernel.cu").read_text()
    header = (src / "rans_common.cuh").read_text()
    layout = next(k for k, v in BIT_LAYOUT.items() if v in base)
    res["layout"] = layout
    plan = BIT_SPLIT[(opt.kernel, layout)]
    variants = {"base": base,
                "stamped": stamped(base, opt.kernel + "_kernel(",
                                   plan["stamps"], second=plan.get("second"),
                                   loop_head=plan.get(
                                       "loop_head",
                                       "for (int t = 0; t < K; ++t) {"))}
    if "stamps_o0" in plan:
        variants["stamped"] = stamped(variants["stamped"], "decode_o0(const",
                                      plan["stamps_o0"], prelude=False)
    for name, changes in plan["variants"].items():
        variants[name] = _ablate(name, base, header, BIT_SECTION, changes)
    for name in [x for x in opt.ablate.split(",") if x]:
        variants[name] = _ablate(name, base, header, BIT_SECTION,
                                 plan["ablations"][name])
    exact = ("stamped", *plan["variants"])
    libs, reports, res["nvcc_s"] = _build_all(variants, src, work,
                                              "rans_bit_kernel.cu")
    res["ptxas"] = {k: _bit_ptxas(v, opt.kernel) for k, v in reports.items()}
    res["sass"] = _sass(libs["base"], opt.kernel)
    entry = "trc_" + opt.kernel
    # the port's kernels run first (they make the inputs), and the builds
    # load after them
    _bit_inputs(opt.kernel, "s", 0, dev, 0)
    types = build.SIGNATURES["rans_bit_kernel.cu"][entry]
    fns, loaded = {}, {}
    for k, lib in libs.items():
        loaded[k] = ctypes.CDLL(str(lib))
        fns[k] = getattr(loaded[k], entry)
        fns[k].argtypes, fns[k].restype = types, ctypes.c_int
    res["cases"] = {}
    for name, order in BIT_CASES:
        segs = plan.get("segments_o0" if order == 0 else "segments",
                        plan["segments"])
        times = {k: [] for k in variants}
        split = second = None
        same, K = True, 0
        for r in range(4):  # rep 0 is the warm-up
            make, port, K = _bit_inputs(opt.kernel, name, order, dev,
                                        7919 * (r + 1))
            ref = None
            for k, fn in fns.items():
                print(f"probe {opt.kernel} {name},{order} rep {r}: {k}",
                      file=sys.stderr, flush=True)
                out = torch.empty_like(port)
                try:
                    ms = _bare(fn, make(out))
                except RuntimeError as e:
                    times[k] = str(e)
                    continue
                if k == "base":
                    ref = out
                    same = same and torch.equal(out, port)
                elif k in exact and not torch.equal(out, ref):
                    raise AssertionError(f"{k} differs from the base at "
                                         f"{name},{order}")
                if r and isinstance(times[k], list):
                    times[k].append(ms)
                if k == "stamped":
                    acc = (ctypes.c_ulonglong * 32)()
                    loaded[k].trc_split_read(ctypes.cast(acc,
                                                         ctypes.c_void_p))
                    split = [int(x) for x in acc[:len(segs)]]
                    second = [int(x) for x in acc[16:16 + len(segs)]]
                if k != "base":
                    del out
            del make, port, ref
        per = K * (8 if opt.kernel == "lane_bit_decode" else 1)

        def table(cyc):
            total = sum(cyc)
            return {"cycles_total": total, "cycles_per_step": total / K,
                    "cycles_per_decision": total / (8 * K),
                    "segments": [{"segment": segs[i], "cycles": c,
                                  "per_step": c / K,
                                  "share": c / max(total, 1)}
                                 for i, c in enumerate(cyc)]}
        case = {"K": K, "decisions": per, "equal_to_port": same,
                "split": dict(thread="thread 0 of CTA 0", **table(split)),
                "ms": times,
                "mean_ms": {k: (sum(v) / len(v) if isinstance(v, list)
                                else v) for k, v in times.items()}}
        if plan.get("second"):
            case["split_second"] = dict(
                thread=f"thread {plan['second']} of CTA 0 (depth 7)",
                **table(second))
        res["cases"][f"{name},{order}"] = case
    return res


# L9 (``--kernel lane_nibble_model``) and L10 (``--kernel
# lane_nibble_decode``): the nibble kernels of rans_lane_kernel.cu on one
# 4 MB block of textbwt at the default CodecConfig (512 lanes, K = 8192):
# L9 on its bytes (id 41), L10 adaptive (id 41) and static (id 40) on the
# streams the port's models and L2 write.  Two layouts, told apart by the
# source: "first" (1b4e577's design: L1 / L3's team of 16 threads a lane,
# 8 lanes a CTA; L9 a lookup by two shuffles and an update whose
# predicate waits on them, a byte read in a branch every 16 steps; L10 a
# ballot + popc search, two shuffles, the state step and a renorm with a
# branch at each chunk edge, then the update) and "lanes4" (the port's:
# 4 lanes a CTA; L9 the update by the known symbol, the lookups read
# from the table's rows staged in shared memory after each half of 16
# steps, a chunk's bytes one u32 read; L10 a warp a lane, the adaptive
# search one redux.sync over (c_j << 16 | c_{j-1}), both update
# candidates computed while it runs, the static step one load of a
# value-indexed table, the words moved every 8 bytes).  Stamps for thread
# 0 of CTA 0; variants are held byte for byte against the base build, the
# base against the port's kernel (``equal_to_port``); ablations are timed
# only.
NIB_CASES = {"lane_nibble_model": (("rc4", False),),
             "lane_nibble_decode": (("rc4", False), ("rc4c", True))}
NIB_LAYOUT = {"first": "int c[1] = {j << (15 - 4)};  // cdf16.init",
              "lanes4": "constexpr int kNibLanes = 4;"}
NIB_SECTION = ("// L3's reader, the same words", "bool pow2(int v")
NIB_SPLIT = {
    ("lane_nibble_model", "first"): dict(
        stamps=[("sym_next = __shfl_sync(kFull, cur, (t + 1) & (T - 1), T);",
                 1, 0, "sym_next"),
                ("team_lookup<T>(c, sym >> 4, low_h, fr_h);", 1, 1,
                 "low_h + fr_h"),
                ("team_update<T>(c, low_h, kNibRate, j);", 1, 2, "c[0]"),
                ("team_lookup<T>(c, sym & 15, low_l, fr_l);", 1, 3,
                 "low_l + fr_l"),
                ("team_update<T>(c, low_l, kNibRate, j);", 1, 4, "c[0]"),
                ("slot_l = take ? (low_l << 16) | fr_l : slot_l;", 1, 5,
                 "slot_h + slot_l")],
        segments=["byte: the last chunk's probs stored and the next chunk's "
                  "byte read (every 16 steps), the byte's shuffle",
                  "hi lookup (two shuffles)", "hi update",
                  "lo lookup (two shuffles)", "lo update", "slot selects"],
        variants={},
        ablations={
            "no-lookup": [("team_lookup<T>(c, sym >> 4, low_h, fr_h);",
                           "low_h = c[0]; fr_h = sym + 1;"),
                          ("team_lookup<T>(c, sym & 15, low_l, fr_l);",
                           "low_l = c[0]; fr_l = sym + 2;")],
            "no-update": [("team_update<T>(c, low_h, kNibRate, j);", ""),
                          ("team_update<T>(c, low_l, kNibRate, j);", "")],
            "no-byte": [("nxt = real && t + 1 + T + j < K ? "
                         "src[size_t(t + 1 + T) * L] : 0;",
                         "nxt = (t * 37 + j) & 255;")],
            "no-store": [("        out[size_t(2 * tj) * L] = slot_h;\n"
                          "        out[size_t(2 * tj + 1) * L] = slot_l;",
                          "        if (slot_h == -1) out[0] = slot_l;")]}),
    ("lane_nibble_decode", "first"): dict(
        stamps=[("s = s < 0 ? 0 : s;", 1, 0, "s"),
                ("s = team_search<T>(c, int(value), j, mask);", 1, 0, "s"),
                ("const int nx = team_pick<T>(c, (s + 1) & 15);", 1, 1,
                 "low + nx"),
                ("state = uint32_t(freq) * (state >> 15) + value - "
                 "uint32_t(low);", 1, 2, "int(state)"),
                ("team_words_renorm<T>(w, state, j);", 1, 3, "int(state)"),
                ("if constexpr (!kStatic) team_update<T>(c, low, kNibRate, "
                 "j);", 1, 4, "c[0]"),
                ("if (j == (t & (T - 1))) mine = uint8_t((nib[0] << 4) | "
                 "nib[1]);", 1, 5, "mine"),
                ("if (real && tj <= t) dst[size_t(tj) * L] = mine;", 1, 6,
                 "0")],
        segments=["search (adaptive: ballot + popc; static: one ballot), "
                  "after the last byte's loop overhead",
                  "picks (two shuffles)", "state step",
                  "renorm and word (a branch at a chunk edge, a shuffle)",
                  "update (adaptive)", "byte select",
                  "byte store (every 16 bytes)"],
        variants={},
        ablations={
            "no-search": [("s = team_search<T>(c, int(value), j, mask);",
                           "s = int(value >> 11) & 15;"),
                          ("s = __popc(__ballot_sync(kFull, uint32_t(c[0]) "
                           "<= value) & mask) - 1;",
                           "s = int(value >> 11) - 1;")],
            "no-update": [("if constexpr (!kStatic) team_update<T>(c, low, "
                           "kNibRate, j);", "")],
            "no-word": [("w.nxt = p < w.n ? uint32_t(w.src[p]) : 0u;",
                         "w.nxt = uint32_t(p) & 0xFFFFu;")],
            "no-store": [("if (real && tj <= t) dst[size_t(tj) * L] = mine;",
                          "if (real && tj <= t && mine == 1) dst[0] = "
                          "mine;")]}),
    ("lane_nibble_model", "lanes4"): dict(
        loop_head="auto half = [&](int t0, uint32_t src, int base, "
                  "auto guard) {",
        stamps=[("const int b = int(__shfl_sync(kFull, src, base + u) >> "
                 "(8 * n)) & 255;", 1, 0, "b"),
                ("update(b >> 4);", 1, 1, "c"),
                ("update(b & 15);", 1, 2, "c"),
                ("const int sl = (r[ls] << 16) | (r[ls + 1] - r[ls]);", 1, 3,
                 "sh + sl"),
                ("o[L] = sl;", 1, 4, "0"),
                ("const uint32_t nn = chunk(c0 + 64);", 1, 5, "0")],
        segments=["byte (a shuffle of the chunk's u32)",
                  "hi nibble: the entry stored, the update by j > s",
                  "lo nibble",
                  "the slots of step t0 + j read from the rows (every 16 "
                  "steps)", "probs stores (every 16 steps)",
                  "next chunk's read issued (every 32 steps)"],
        # shuffles: the lookups by two shuffles of the table as it stands,
        # thread j keeping the slots of step t0 + j (the PR's first try)
        variants={
            "shuffles": [
                ("  auto update = [&](int s) {\n",
                 "  auto pick = [&](int s) {\n"
                 "    const int low = __shfl_sync(kFull, c, s, kNibTeam);\n"
                 "    const int nx = __shfl_sync(kFull, c, (s + 1) & 15, "
                 "kNibTeam);\n"
                 "    return (low << 16) | ((s == 15 ? kTotal : nx) - low);\n"
                 "  };\n"
                 "  auto update = [&](int s) {\n"),
                ("  auto half = [&](int t0, uint32_t src, int base, auto "
                 "guard) {\n",
                 "  auto half = [&](int t0, uint32_t src, int base, auto "
                 "guard) {\n    int sh = 0, sl = 0;\n"),
                ("      rows[2 * u * 17 + j] = c;\n"
                 "      update(b >> 4);\n"
                 "      rows[(2 * u + 1) * 17 + j] = c;\n"
                 "      update(b & 15);\n"
                 "    }\n"
                 "    __syncwarp();\n"
                 "    // the slots of step t0 + j\n"
                 "    const int b = int(__shfl_sync(kFull, src, base + j) >> "
                 "(8 * n)) & 255;\n"
                 "    const int* r = rows + 2 * j * 17;\n"
                 "    const int hs = b >> 4, ls = 17 + (b & 15);\n"
                 "    const int sh = (r[hs] << 16) | (r[hs + 1] - r[hs]);\n"
                 "    const int sl = (r[ls] << 16) | (r[ls + 1] - r[ls]);\n"
                 "    __syncwarp();  // read before the next half's stores\n",
                 "      const int ph = pick(b >> 4);\n"
                 "      update(b >> 4);\n"
                 "      const int pl = pick(b & 15);\n"
                 "      update(b & 15);\n"
                 "      sh = j == u ? ph : sh;\n"
                 "      sl = j == u ? pl : sl;\n"
                 "    }\n")]},
        ablations={
            "no-update": [("    c += (ic + (j > s ? kMixd : 0) - c) >> "
                           "kNibRate;\n", "    c += s;\n")],
            "no-rows": [("      rows[2 * u * 17 + j] = c;\n", ""),
                        ("      rows[(2 * u + 1) * 17 + j] = c;\n", "")],
            "no-byte": [("if (vec) return ld_u32_if(t < K, p);",
                         "if (vec) return uint32_t(t) * 0x01010101u;")],
            "no-store": [("      o[0] = sh;\n      o[L] = sl;",
                          "      if (sh == -1) o[0] = sl;")]}),
    ("lane_nibble_decode", "lanes4"): dict(
        loop_head="auto nibble = [&]() {",
        stamps=[("const uint32_t e = ent[value];", 1, 0, "int(e)"),
                ("__reduce_min_sync(kFull, uint32_t(hi) > value ? key : "
                 "~0u);", 1, 0, "int(kmin)"),
                ("s = __popc(__ballot_sync(kFull, uint32_t(hi) <= value) & "
                 "0xFFFEu);", 1, 1, "s"),
                ("state = ((kmin >> 16) - low) * (state >> 15) + value - "
                 "low;", 1, 2, "int(state)"),
                ("state = (e >> 16) * (state >> 15) + (e & 0xFFFFu);", 1, 2,
                 "int(state)"),
                ("key = uint32_t(hi) << 16 | uint32_t(lo);", 1, 3,
                 "int(key)"),
                ("value = o1_renorm(w, state);", 1, 4, "int(value)"),
                ("mine = j == (t & 15) ? uint8_t(b) : mine;", 1, 5, "mine"),
                ("o1_words_move(w, j);", 1, 6, "0"),
                ("if (real && i < 16 && tj < t1) dst[size_t(tj) * L] = "
                 "mine;", 1, 7, "0")],
        segments=["search (adaptive: one redux.sync, the update's candidates"
                  " before it) / table load (static), after the last step's "
                  "overhead", "symbol (adaptive: a ballot)", "state step",
                  "update picked by i > s, the next key (adaptive)",
                  "renorm and the next word (a shuffle)", "byte select",
                  "words moved (every 8 bytes)",
                  "byte store (every 16 bytes)"],
        variants={
            "lanes-8": [("constexpr int kNibLanes = 4;",
                         "constexpr int kNibLanes = 8;")],
            "by-low": [("hi = j == 0 ? kTotal : ih > s ? ha : hb;",
                        "hi = j == 0 ? kTotal : uint32_t(hi) > low ? ha : "
                        "hb;"),
                       ("lo = il > s ? la : lb;",
                        "lo = uint32_t(lo) > low ? la : lb;")]},
        ablations={
            "no-update": [("      hi = j == 0 ? kTotal : ih > s ? ha : hb;\n"
                           "      lo = il > s ? la : lb;\n"
                           "      key = uint32_t(hi) << 16 | uint32_t(lo);\n",
                           "")],
            "no-word": [("w.far = w.t.src[w.far_ok ? p : 0];",
                         "w.far = uint32_t(p) & 0xFFFFu;")],
            "no-store": [("if (real && i < 16 && tj < t1) dst[size_t(tj) * "
                          "L] = mine;", "if (real && i < 16 && tj < t1 && "
                          "mine == 1) dst[0] = mine;")],
            "no-build": [("    nib_static_tables(cs, ent, sym_of);\n", "")],
            "no-sym": [("s = sym_of[value];", "s = int(e & 15);")]}),
}


def _nib_ptxas(report: str, kernel: str) -> dict:
    """Registers, stack, spills and smem of each instantiation of
    ``kernel`` (L9: ``model``; L10: ``adaptive``, ``static``)."""
    res, key = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line \
                or "Function properties for" in line:
            key = None
            if f"{kernel}_kernel" in line:
                key = ("model" if kernel == "lane_nibble_model"
                       else "static" if "ILb1E" in line else "adaptive")
                res.setdefault(key, {})
            continue
        if key:
            for name, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                              ("spill_stores", r"(\d+) bytes spill stores"),
                              ("spill_loads", r"(\d+) bytes spill loads"),
                              ("registers", r"Used (\d+) registers"),
                              ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    res[key][name] = int(m.group(1))
    return res


def _nib_inputs(kernel: str, static: bool, dev, rot: int):
    """(C arguments maker, the port's output, K) of one textbwt block at
    the default CodecConfig: make(out) -> the C entry's arguments."""
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import rans_nibble as N
    from turborc_tpu_torch.codecs import rans_static as S42
    from turborc_tpu_torch.ops import rans
    from turborc_tpu_torch.ops import rans_lane_kernel as LK
    from turborc_tpu_torch.ops import rans_nibble_kernel as NK
    from turborc_tpu_torch.utils.config import CodecConfig
    cfg = CodecConfig()
    x = np.roll(np.fromfile(LANE_CORPUS, np.uint8), rot)[:cfg.block_size]
    block, K = blockio.shape_block(x, cfg.lanes, cfg.step_quant)
    cols = torch.from_numpy(block).to(dev).T.contiguous()
    if kernel == "lane_nibble_model":
        return (lambda out: NK.lane_nibble_model_cargs(cols, out)), \
            NK.lane_nibble_model(cols), K
    cdf = None
    if static:
        cdf = torch.from_numpy(N._cdf(N.build_nibble_freqs(x))).to(dev)
        probs = S42.slot_probs(NK.nibbles(cols), cdf)
    else:
        probs = NK.lane_nibble_model(cols)
    init = torch.full((cfg.lanes,), rans.ANS_LOW, dtype=torch.int32,
                      device=dev)
    st, lens = LK.lane_coder(probs, init)
    words = blockio.device_words(st, lens)
    offs = LK._offsets(lens)
    return (lambda out: NK.lane_nibble_decode_cargs(
        words, offs, lens, K, cdf, out)), cols, K


def probe_lane_nibble(opt, dev, res: dict, work: Path) -> dict:
    """L9 or L10 of the source in ``--src``: ptxas of every
    instantiation, SASS, then per case (L9: id 41; L10: ids 41 and 40) the
    clock64() split of the byte step and the bare C entry timed (a
    warm-up, then 3 repetitions on distinct rotations of the block, every
    build in turn) for the base, the stamped build, the layout's variants
    and the named ablations."""
    src = Path(opt.src).resolve()
    base = (src / "rans_lane_kernel.cu").read_text()
    header = (src / "rans_common.cuh").read_text()
    layout = next(k for k, v in NIB_LAYOUT.items() if v in base)
    res["layout"] = layout
    plan = NIB_SPLIT[(opt.kernel, layout)]
    variants = {"base": base,
                "stamped": stamped(base, opt.kernel + "_kernel(",
                                   plan["stamps"], loop_head=plan.get(
                                       "loop_head",
                                       "for (int t = 0; t < K; ++t) {"))}
    for name, changes in plan["variants"].items():
        variants[name] = _ablate(name, base, header, NIB_SECTION, changes)
    for name in [x for x in opt.ablate.split(",") if x]:
        variants[name] = _ablate(name, base, header, NIB_SECTION,
                                 plan["ablations"][name])
    exact = ("stamped", *plan["variants"])
    libs, reports, res["nvcc_s"] = _build_all(variants, src, work,
                                              "rans_lane_kernel.cu")
    res["ptxas"] = {k: _nib_ptxas(v, opt.kernel) for k, v in reports.items()}
    res["sass"] = _sass(libs["base"], opt.kernel)
    entry = "trc_" + opt.kernel
    # the port's kernels run first (they make the inputs), and the builds
    # load after them
    _nib_inputs(opt.kernel, False, dev, 0)
    types = build.SIGNATURES["rans_lane_kernel.cu"][entry]
    fns, loaded = {}, {}
    for k, lib in libs.items():
        loaded[k] = ctypes.CDLL(str(lib))
        fns[k] = getattr(loaded[k], entry)
        fns[k].argtypes, fns[k].restype = types, ctypes.c_int
    res["cases"] = {}
    segs = plan["segments"]
    for codec, static in NIB_CASES[opt.kernel]:
        times = {k: [] for k in variants}
        split = None
        same, K = True, 0
        for r in range(4):  # rep 0 is the warm-up
            make, port, K = _nib_inputs(opt.kernel, static, dev,
                                        7919 * (r + 1))
            ref = None
            for k, fn in fns.items():
                print(f"probe {opt.kernel} {codec} rep {r}: {k}",
                      file=sys.stderr, flush=True)
                out = torch.empty_like(port)
                ms = _bare(fn, make(out))
                if k == "base":
                    ref = out
                    same = same and torch.equal(out, port)
                elif k in exact and not torch.equal(out, ref):
                    raise AssertionError(f"{k} differs from the base at "
                                         f"{codec}")
                if r:
                    times[k].append(ms)
                if k == "stamped":
                    acc = (ctypes.c_ulonglong * 32)()
                    loaded[k].trc_split_read(ctypes.cast(acc,
                                                         ctypes.c_void_p))
                    split = [int(x) for x in acc[:len(segs)]]
                if k != "base":
                    del out
            del make, port, ref
        total = sum(split)
        res["cases"][codec] = {
            "K": K, "equal_to_port": same,
            "split": {"thread": "thread 0 of CTA 0", "cycles_total": total,
                      "cycles_per_byte": total / K,
                      "segments": [{"segment": segs[i], "cycles": c,
                                    "per_byte": c / K,
                                    "share": c / max(total, 1)}
                                   for i, c in enumerate(split)]},
            "ms": times,
            "mean_ms": {k: sum(v) / len(v) for k, v in times.items()}}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(build.CSRC))
    ap.add_argument("--ablate", default="")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--kernel", choices=("decode", "model", "coder",
                                         *SPLIT_KERNELS, *LANE_SPLIT,
                                         *IO_KERNELS, "lane_bit_model",
                                         "lane_bit_decode", *NIB_CASES),
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
               else "CodecConfig()" if opt.kernel in (
                   *LANE_SPLIT, *IO_KERNELS, "lane_bit_model",
                   "lane_bit_decode", *NIB_CASES)
               else Geom().spec}
        probe = {"model": probe_model, "coder": probe_coder,
                 **dict.fromkeys(SPLIT_KERNELS, probe_split),
                 **{k: {"o1": probe_lane_o1, "o1m": probe_lane_o1_model}.get(
                     v.get("probe"), probe_lane)
                    for k, v in LANE_SPLIT.items()},
                 **dict.fromkeys(IO_KERNELS, probe_io),
                 **dict.fromkeys(("lane_bit_model", "lane_bit_decode"),
                                 probe_lane_bit),
                 **dict.fromkeys(NIB_CASES, probe_lane_nibble)}[opt.kernel]
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
