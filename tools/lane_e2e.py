"""End-to-end MB/s of a per-lane scan codec on one GPU, for this tree's
port or another tree's.

    python3 tools/lane_e2e.py [--root DIR] [--codec NAME] [--reps N]
        [--corpus FILE]

Imports ``turborc_tpu_torch`` from DIR (a tree holding the port, for
example a ``git archive`` of a parent commit unpacked under
``_archive/``; this tree by default), then round-trips the corpus
(``textbwt_16777216.bin`` by default, or the FILE of this tree's
``turborc_tpu/bench/_data/``, such as ``realsrcbwt_16777216.bin`` for the
order-1 codecs) through ``api.compress`` and ``api.decompress`` at the
default ``CodecConfig`` with the codec: a
warm-up, then N timed round trips on distinct rotations, each ending in
``torch.cuda.synchronize()``, checked byte for byte.  Prints one JSON line
with the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DATA = HERE / "turborc_tpu" / "bench" / "_data"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--codec", default="rans-static")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--corpus", default="textbwt_16777216.bin")
    opt = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lane_e2e: no CUDA device", file=sys.stderr)
        return 2
    root = Path(opt.root).resolve()
    sys.path.insert(0, str(root))
    from turborc_tpu_torch import api
    from turborc_tpu_torch.utils.config import CodecConfig
    corpus = DATA / opt.corpus
    text = np.fromfile(corpus, np.uint8)
    cfg = CodecConfig(codec=opt.codec)
    enc, dec = [], []
    for r in range(opt.reps + 1):  # rep 0 is the warm-up
        x = np.roll(text, 104729 * (r + 1))
        t0 = time.perf_counter()
        blob = api.compress(x, cfg, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = api.decompress(blob, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if back != x.tobytes():
            raise AssertionError(f"{opt.codec}: round trip failed")
        if r:
            enc.append(t1 - t0)
            dec.append(t2 - t1)
    mb = text.size / 1e6
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps(dict(
        root=str(root), codec=opt.codec, corpus=corpus.name,
        lanes=cfg.lanes, block_size=cfg.block_size, card=card,
        encode_MBps=[mb / s for s in enc],
        decode_MBps=[mb / s for s in dec],
        round_trip_MBps=[mb / (a + b) for a, b in zip(enc, dec)],
        ratio=len(blob) / x.size)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
