"""Golden containers of the per-lane scan codecs rans-static (id 42),
rans-cdf-o0 (id 56) and rans-cdf-s8 (id 58), frozen from the JAX package.

``turborc_tpu_torch/golden/lane.json`` holds
  small: whole containers (hex) of small inputs at 64 lanes (one
         block, three blocks, the last one short, and none), the rest of
         ``CodecConfig`` at its defaults;
  large: sha256 + length of textbwt 16 MB under each codec at the
         default ``CodecConfig`` (4 MB blocks), which ``chip_smoke.py``
         checks on the GPU, where there is no JAX.

The JAX package registers all three codecs on the CPU, so the oracle is
``turborc_tpu.api.compress`` itself.  Every comparison is exact.

Regenerate (about two minutes of CPU, most of it the large cases):

    JAX_PLATFORMS=cpu python tests/test_torch_golden_lane.py --regen
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import pytest

from test_torch_golden import DATA, case_data

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "turborc_tpu_torch" / "golden" / "lane.json"
CODECS = ("rans-static", "rans-cdf-o0", "rans-cdf-s8")

# 64 lanes, step_quant 256: every block of every case at K = 256, one
# compile of each JAX encoder
SMALL = [dict(name=f"{codec}_{what}", codec=codec, lanes=64, step_quant=256,
              **case)
         for codec in CODECS for what, case in (
             ("textbwt16000", dict(file="textbwt_65536.bin", offset=0,
                                   n=16000, block_size=1 << 22)),
             ("textbwt40000_3blocks", dict(file="textbwt_65536.bin",
                                           offset=20000, n=40000,
                                           block_size=16384)),
             ("empty", dict(seed=0, n=0, block_size=1 << 22)))]
LARGE = [dict(name=f"textbwt_16777216_{codec}", codec=codec,
              file="textbwt_16777216.bin", block_size=1 << 22)
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


def test_large_golden_entries(golden):
    """The full-size entries chip_smoke.py checks name an existing corpus
    and hold a sha256 and a length."""
    assert [c["name"] for c in golden["large"]] == [c["name"] for c in LARGE]
    for entry, case in zip(golden["large"], LARGE):
        assert {k: entry[k] for k in case} == case
        assert (DATA / case["file"]).is_file()
        assert len(entry["sha256"]) == 64 and 0 < entry["length"]


def regen() -> None:
    doc = {"about": "rans-static / rans-cdf-o0 / rans-cdf-s8 containers "
                    "written by turborc_tpu.api.compress; regenerate with "
                    "python tests/test_torch_golden_lane.py --regen",
           "small": [], "large": []}
    for case in SMALL:
        c = jax_container(case)
        doc["small"].append(dict(case, length=len(c), hex=c.hex()))
    for case in LARGE:
        c = jax_container(case)
        doc["large"].append(dict(case, length=len(c),
                                 sha256=hashlib.sha256(c).hexdigest(),
                                 ratio=len(c) / case_data(case).size))
        print(case["name"], len(c), flush=True)
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--regen"]:
        sys.exit("usage: python tests/test_torch_golden_lane.py --regen")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    regen()
