"""How the bytes of a lane fall on the order-1 models' rows, on the CPU.

    python3 tools/row_occupancy.py [--corpus FILE]

For each 4 MB block of the corpus (``realsrcbwt_16777216.bin`` of
``turborc_tpu/bench/_data/`` by default), shaped as ids 64
(``rans-cdf-o1``: 128 lanes of 32,768 bytes) and 59 (``rans-cdf-r1``: 512
lanes of 8,192 rank-remapped bytes) shape it at the default
``CodecConfig``, counts per lane the bytes coded from each hi row
(``hi_row(prev)``) and lo row (``lo_row(prev, hi)``) and prints, per block
and codec, the busiest row's count in the worst lane and in the median
lane, as one JSON line.  A model that walks rows instead of bytes runs as
long as its busiest row: this says how far such a walk could shorten a
lane's chain.  Needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from turborc_tpu_torch.codecs import blockio  # noqa: E402
from turborc_tpu_torch.codecs import rans_cdf_o1 as O1  # noqa: E402
from turborc_tpu_torch.codecs import rans_cdf_r1 as R1  # noqa: E402
from turborc_tpu_torch.codecs import rans_cdf_r1_lane as R59  # noqa: E402
from turborc_tpu_torch.utils.config import CodecConfig  # noqa: E402

DATA = ROOT / "turborc_tpu" / "bench" / "_data"


def busiest(rows: np.ndarray, n: int) -> np.ndarray:
    """rows [L, K] row indices < n -> the busiest row's count a lane."""
    L = rows.shape[0]
    flat = rows + n * np.arange(L)[:, None]
    return np.bincount(flat.ravel(), minlength=n * L).reshape(L, n).max(1)


def occupancy(lanes: np.ndarray, hi_row, lo_row, n_hi: int,
              n_lo: int) -> dict:
    """lanes [L, K] bytes -> the busiest hi and lo row of the worst and
    the median lane."""
    b = lanes.astype(np.int64)
    prev = np.concatenate([np.zeros((b.shape[0], 1), np.int64), b[:, :-1]],
                          1)
    res = {"lanes": b.shape[0], "K": b.shape[1]}
    for name, rows, n in (("hi", hi_row(prev), n_hi),
                          ("lo", lo_row(prev, b >> 4), n_lo)):
        top = busiest(rows, n)
        res[name] = {"worst": int(top.max()),
                     "median": int(np.median(top))}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", default="realsrcbwt_16777216.bin")
    opt = ap.parse_args()
    cfg = CodecConfig()
    data = np.fromfile(DATA / opt.corpus, np.uint8)
    out = []
    for i in range(0, data.size, cfg.block_size):
        x = data[i:i + cfg.block_size]
        block, _ = blockio.shape_block(x, min(cfg.lanes, O1.LANE_CAP),
                                       cfg.step_quant)
        r64 = occupancy(np.asarray(block), lambda p: p,
                        lambda p, h: p * 16 + h, R1.BYTE_HROWS,
                        R1.BYTE_LROWS)
        a = R59.encode_args(x, cfg.lanes, cfg.step_quant, "cpu")
        r59 = occupancy(a.cols.T.numpy(), R1.np_hictx, R1.np_locx, R1.NCTX,
                        R1.LROWS)
        out.append({"block": i // cfg.block_size, "id64": r64, "id59": r59})
    print(json.dumps({"corpus": opt.corpus, "blocks": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
