"""Golden containers of the order-1 per-lane scan codecs rans-cdf-r1 (id 59)
and rans-cdf-o1 (id 64), frozen from the JAX package.

``turborc_tpu_torch/golden/lane_o1.json`` holds
  small: whole containers (hex) of small inputs (one block, three blocks
         with a short last one, none; id 64 also at 256 lanes, which it
         codes as 128), the rest of ``CodecConfig`` at its defaults;
  segments: the sha256 of id 59's payload of realsrcbwt's first 3 x 2^18
         + 1,000 bytes at 2,048 lanes, three warm-table segments whose
         boundaries fall inside CTAs of 8 lanes, which the port's plain
         path must write and read back;
  large: sha256 + length of realsrcbwt 16 MB under each codec at the
         default ``CodecConfig`` (4 MB blocks, 512 lanes in the header),
         which ``chip_smoke.py`` checks on the GPU, where there is no JAX.

The JAX package registers both codecs on the CPU, so the oracle is
``turborc_tpu.api.compress`` itself (and id 59's ``encode_block`` for the
segments case).  Every comparison is exact.

Regenerate (about a minute of CPU, most of it the large cases):

    JAX_PLATFORMS=cpu python tests/test_torch_golden_lane_o1.py --regen
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_golden import DATA, case_data

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "turborc_tpu_torch" / "golden" / "lane_o1.json"
CODECS = ("rans-cdf-r1", "rans-cdf-o1")

SMALL = [dict(name=f"{codec}_{what}", codec=codec, lanes=lanes,
              step_quant=256, **case)
         for codec in CODECS for what, lanes, case in (
             ("textbwt16000", 64, dict(file="textbwt_65536.bin", offset=0,
                                       n=16000, block_size=1 << 22)),
             ("textbwt40000_3blocks", 64, dict(file="textbwt_65536.bin",
                                               offset=20000, n=40000,
                                               block_size=16384)),
             ("empty", 64, dict(seed=0, n=0, block_size=1 << 22)),
             ("textbwt40000_256lanes", 256, dict(file="textbwt_65536.bin",
                                                 offset=5000, n=40000,
                                                 block_size=1 << 22)))]
SEGMENTS = dict(name="realsrcbwt_787432_3segments", file=
                "realsrcbwt_16777216.bin", n=3 * (1 << 18) + 1000,
                lanes=2048, step_quant=64)
LARGE = [dict(name=f"realsrcbwt_16777216_{codec}", codec=codec,
              file="realsrcbwt_16777216.bin", block_size=1 << 22)
         for codec in CODECS]
FIELDS = ("codec", "block_size", "lanes", "step_quant")


def jax_container(case: dict) -> bytes:
    from turborc_tpu import api
    from turborc_tpu.utils.config import CodecConfig
    return api.compress(case_data(case), CodecConfig(
        **{k: case[k] for k in FIELDS if k in case}))


def port_config(case: dict):
    from turborc_tpu_torch import CodecConfig
    return CodecConfig(**{k: case[k] for k in FIELDS if k in case})


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("case", SMALL, ids=[c["name"] for c in SMALL])
def test_small_golden_rederives_from_jax(case, golden):
    """Exact: the JAX package still writes the committed container."""
    want = {c["name"]: c for c in golden["small"]}[case["name"]]
    assert jax_container(case).hex() == want["hex"]


@pytest.mark.parametrize("case", SMALL, ids=[c["name"] for c in SMALL])
def test_small_golden_port_writes_and_reads(case, golden):
    """Exact: the port writes the committed container byte for byte and
    decodes it back to the input."""
    from turborc_tpu_torch import api
    want = bytes.fromhex({c["name"]: c
                          for c in golden["small"]}[case["name"]]["hex"])
    data = case_data(case)
    assert api.compress(data, port_config(case), device="cpu") == want
    assert api.decompress(want, device="cpu") == data.tobytes()


def test_segments_not_aligned_to_ctas(golden):
    """Exact: at three warm-table segments over 2,048 lanes (lane l from
    segment 3 l // 2048: boundaries at lanes 682.7 and 1365.3, inside
    L5's and L6's CTAs of 8 lanes) the port's plain path writes the JAX
    package's payload and reads it back."""
    from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
    from turborc_tpu_torch.codecs import rans_cdf_r1_lane as T59
    from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
    case = golden["segments"]
    assert {k: case[k] for k in SEGMENTS} == SEGMENTS
    data = case_data(SEGMENTS)
    kw = dict(lanes=SEGMENTS["lanes"], step_quant=SEGMENTS["step_quant"],
              device="cpu")
    assert R1.n_segments(data.size, SEGMENTS["lanes"]) == 3
    assert LO.O1R_LANES * 85 < 682 < LO.O1R_LANES * 86  # inside CTA 85
    payload = T59.encode_block(data, **kw)
    assert len(payload) == case["length"]
    assert hashlib.sha256(payload).hexdigest() == case["sha256"]
    assert np.array_equal(T59.decode_block(payload, data.size, **kw), data)


def test_large_golden_entries(golden):
    """The full-size entries chip_smoke.py checks name an existing corpus
    and hold a sha256 and a length."""
    assert [c["name"] for c in golden["large"]] == [c["name"] for c in LARGE]
    for entry, case in zip(golden["large"], LARGE):
        assert {k: entry[k] for k in case} == case
        assert (DATA / case["file"]).is_file()
        assert len(entry["sha256"]) == 64 and 0 < entry["length"]


def regen() -> None:
    from turborc_tpu.codecs import rans_cdf_r1 as J59
    doc = {"about": "rans-cdf-r1 / rans-cdf-o1 containers written by "
                    "turborc_tpu.api.compress (segments: id 59's "
                    "encode_block payload); regenerate with python "
                    "tests/test_torch_golden_lane_o1.py --regen",
           "small": [], "large": []}
    for case in SMALL:
        c = jax_container(case)
        doc["small"].append(dict(case, length=len(c), hex=c.hex()))
    p = J59.encode_block(case_data(SEGMENTS), lanes=SEGMENTS["lanes"],
                         step_quant=SEGMENTS["step_quant"])
    doc["segments"] = dict(SEGMENTS, length=len(p),
                           sha256=hashlib.sha256(p).hexdigest())
    for case in LARGE:
        c = jax_container(case)
        doc["large"].append(dict(case, length=len(c),
                                 sha256=hashlib.sha256(c).hexdigest(),
                                 ratio=len(c) / case_data(case).size))
        print(case["name"], len(c), flush=True)
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--regen"]:
        sys.exit("usage: python tests/test_torch_golden_lane_o1.py --regen")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    regen()
