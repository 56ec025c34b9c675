"""Golden containers of split-state rans-cdf-o0-p (id 57, geometry
suffix ``x2``), frozen from the JAX package.

``turborc_tpu_torch/golden/o0p_x2.json`` holds
  small: whole containers (hex) of small inputs at tiny x2 geometries;
  large: sha256 + length of textbwt 64 MB as one block at
         ``g64c8s8y8l32a4r4x2``, which ``chip_smoke.py`` checks on the
         GPU, where there is no JAX.

The oracle is the JAX package's XLA twin, written into the container as
``turborc_tpu.api.compress`` does (``test_torch_golden.jax_container``).
Every comparison is exact (byte-identical).

Regenerate (about a minute of CPU for the large case):

    JAX_PLATFORMS=cpu python tests/test_torch_golden_x2.py --regen
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import pytest

from test_torch_golden import DATA, case_data, jax_container

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "turborc_tpu_torch" / "golden" / "o0p_x2.json"

SMALL = [
    dict(name="x2_textbwt3000_g2s8", file="textbwt_32768.bin", offset=0,
         n=3000, geom="g2c2s8y2l4a16r4x2", block_size=1 << 22),
    dict(name="x2_skewed6000_g2s1", seed=7, n=6000,
         geom="g2c2s1y2l4a16r4x2", block_size=1 << 22),
    dict(name="x2_textbwt10000_g2a4_3blocks", file="textbwt_32768.bin",
         offset=8192, n=10000, geom="g2c2s8y2l4a4r4x2", block_size=4096),
    dict(name="x2_seedonly700_g2s8", file="textbwt_32768.bin",
         offset=20000, n=700, geom="g2c2s8y2l4a16r4x2",
         block_size=1 << 22),
    dict(name="x2_empty_g2s8", seed=0, n=0, geom="g2c2s8y2l4a16r4x2",
         block_size=1 << 22),
]
LARGE = [
    dict(name="textbwt_67108864_x2", file="textbwt_67108864.bin",
         geom="g64c8s8y8l32a4r4x2", block_size=1 << 26),
]


def port_config(case: dict):
    from turborc_tpu_torch import CodecConfig, Geom
    return CodecConfig(codec="rans-cdf-o0-p", block_size=case["block_size"],
                       geom=Geom.parse(case["geom"]))


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("case", SMALL, ids=[c["name"] for c in SMALL])
def test_small_golden_rederives_from_jax(case, golden):
    """Exact: the JAX package still writes the committed container."""
    want = {c["name"]: c for c in golden["small"]}[case["name"]]
    got = jax_container(case_data(case), case["geom"], case["block_size"])
    assert got.hex() == want["hex"]


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
    """The full-size entry chip_smoke.py checks names an existing corpus
    and holds a sha256 and a length."""
    assert [c["name"] for c in golden["large"]] == [c["name"] for c in LARGE]
    for entry, case in zip(golden["large"], LARGE):
        assert {k: entry[k] for k in case} == case
        assert (DATA / case["file"]).is_file()
        assert len(entry["sha256"]) == 64 and 0 < entry["length"]


def regen() -> None:
    doc = {"about": "split-state rans-cdf-o0-p containers written by the "
                    "JAX package (XLA twin); regenerate with "
                    "python tests/test_torch_golden_x2.py --regen",
           "small": [], "large": []}
    for case in SMALL:
        c = jax_container(case_data(case), case["geom"], case["block_size"])
        doc["small"].append(dict(case, length=len(c), hex=c.hex()))
    for case in LARGE:
        data = case_data(case)
        c = jax_container(data, case["geom"], case["block_size"])
        doc["large"].append(dict(case, length=len(c),
                                 sha256=hashlib.sha256(c).hexdigest(),
                                 ratio=len(c) / data.size))
        print(case["name"], len(c), flush=True)
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--regen"]:
        sys.exit("usage: python tests/test_torch_golden_x2.py --regen")
    sys.path.insert(0, str(ROOT))
    regen()
