"""Golden containers of the bit-tree codec rc-p (id 8), frozen from the
JAX package.

``turborc_tpu_torch/golden/rcp.json`` holds
  small: whole containers (hex) of small inputs at tiny geometries;
  large: sha256 + length of textbwt 16 MB as one id-8 block at the
         default geometry, which ``chip_smoke.py`` checks on the GPU,
         where there is no JAX.

The JAX package registers id 8 only off the CPU, so the oracle here is
the XLA twin of its kernel codec,
``rc_tree.encode_block(..., use_pallas_encoder=False)``, wrapped in the
container exactly as ``turborc_tpu.api.compress`` does.  Every comparison
is exact (byte-identical).

Regenerate (about a minute of CPU for the large case):

    JAX_PLATFORMS=cpu python tests/test_torch_golden_rcp.py --regen
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
GOLDEN = ROOT / "turborc_tpu_torch" / "golden" / "rcp.json"

SMALL = [
    dict(name="rcp_textbwt3000_g2", codec="rc-p", file="textbwt_32768.bin",
         offset=0, n=3000, geom="g2c2s8y2l4a16r4", block_size=1 << 22),
    dict(name="rcp_skewed6000_g1c8", codec="rc-p", seed=7, n=6000,
         geom="g1c8s8y4l32a16r4", block_size=1 << 22),
    dict(name="rcp_textbwt10000_g2_3blocks", codec="rc-p",
         file="textbwt_32768.bin", offset=8192, n=10000,
         geom="g2c2s8y2l4a16r4", block_size=4096),
    dict(name="rcp_seedonly300_g2", codec="rc-p", file="textbwt_32768.bin",
         offset=20000, n=300, geom="g2c2s8y2l4a16r4", block_size=1 << 22),
    dict(name="rcp_empty_g2", codec="rc-p", seed=0, n=0,
         geom="g2c2s8y2l4a16r4", block_size=1 << 22),
]
LARGE = [
    dict(name="textbwt_16777216_rcp", codec="rc-p",
         file="textbwt_16777216.bin", geom=None, block_size=1 << 24),
]


def jax_container(data: np.ndarray, spec: str | None,
                  block_size: int) -> bytes:
    """The container ``turborc_tpu.api.compress`` writes for codec 8
    (default CodecConfig fields), its payloads from the XLA twin."""
    from turborc_tpu.codecs import rc_tree
    from turborc_tpu.container import format as fmt
    from turborc_tpu.ops.pallas.geom import Geom
    geom = Geom.parse(spec) if spec else Geom()
    out = [fmt.write_header(8, 512, 256, block_size, data.shape[0], 5, 8, 8,
                            geom=geom)]
    for off in range(0, max(data.shape[0], 1), block_size):
        blk = data[off:off + block_size]
        payload = rc_tree.encode_block(blk, use_pallas_encoder=False,
                                       geom=geom)
        stored = len(payload) >= blk.shape[0]
        out.append(fmt.write_block(blk.tobytes() if stored else payload,
                                   blk, stored))
    return b"".join(out)


def port_config(case: dict):
    from turborc_tpu_torch import CodecConfig, Geom
    return CodecConfig(codec="rc-p", block_size=case["block_size"],
                       geom=Geom.parse(case["geom"]) if case["geom"] else None)


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
    doc = {"about": "rc-p containers written by the JAX package (XLA twin); "
                    "regenerate with "
                    "python tests/test_torch_golden_rcp.py --regen",
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
        sys.exit("usage: python tests/test_torch_golden_rcp.py --regen")
    sys.path.insert(0, str(ROOT))
    regen()
