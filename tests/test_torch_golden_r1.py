"""Golden containers of rans-cdf-r1-p (id 60) and rans-auto (id 61),
frozen from the JAX package.

``turborc_tpu_torch/golden/r1p.json`` holds
  small: whole containers (hex) of small inputs at tiny geometries;
  large: sha256 + length of three full-size containers, which
         ``chip_smoke.py`` checks on the GPU, where there is no JAX:
         realsrcbwt 16 MB as one id-60 block at the default geometry,
         and realsrcbwt and textbwt 16 MB under id 61 at the default
         configuration (4 MB blocks).

The JAX package registers ids 60 and 61 with kernel arms only off the
CPU, so the oracle here is the XLA twin of its kernel codec,
``rans_pallas_r1.encode_block(..., use_pallas_encoder=False)``, and
``rans_auto.encode_block`` with its arms set to the kernel codecs' twins;
each is wrapped in the container exactly as ``turborc_tpu.api.compress``
does.  Every comparison is exact (byte-identical).

Regenerate (a few minutes of CPU for the large cases):

    JAX_PLATFORMS=cpu python tests/test_torch_golden_r1.py --regen
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "turborc_tpu" / "bench" / "_data"
GOLDEN = ROOT / "turborc_tpu_torch" / "golden" / "r1p.json"
CODEC_IDS = {"rans-cdf-r1-p": 60, "rans-auto": 61}

SMALL = [
    dict(name="r1p_realsrc9000_g2", codec="rans-cdf-r1-p",
         file="realsrcbwt_16777216.bin", offset=100_000, n=9000,
         geom="g2c2s8y2l4a16r4", block_size=1 << 22),
    dict(name="r1p_textbwt10000_g1_3blocks", codec="rans-cdf-r1-p",
         file="textbwt_32768.bin", offset=8192, n=10000,
         geom="g1c2s8y2l4a16r4", block_size=4096),
    dict(name="r1p_seedonly300_g2", codec="rans-cdf-r1-p",
         file="textbwt_32768.bin", offset=20000, n=300,
         geom="g2c2s8y2l4a16r4", block_size=1 << 22),
    dict(name="r1p_empty_g2", codec="rans-cdf-r1-p", seed=0, n=0,
         geom="g2c2s8y2l4a16r4", block_size=1 << 22),
    dict(name="auto_tag1_realsrc9000_g2", codec="rans-auto",
         file="realsrcbwt_16777216.bin", offset=100_000, n=9000,
         geom="g2c2s8y2l4a16r4", block_size=1 << 22),
    dict(name="auto_tag0_skewed6000_g2", codec="rans-auto", seed=2,
         n=6000, geom="g2c2s8y2l4a16r4", block_size=1 << 22),
    dict(name="auto_tag2_realsrc6000_g2", codec="rans-auto",
         file="realsrcbwt_16777216.bin", offset=0, n=6000,
         geom="g2c2s8y2l4a16r4", block_size=1 << 22),
]
LARGE = [
    dict(name="realsrcbwt_16777216_r1p", codec="rans-cdf-r1-p",
         file="realsrcbwt_16777216.bin", geom=None, block_size=1 << 24),
    dict(name="realsrcbwt_16777216_auto", codec="rans-auto",
         file="realsrcbwt_16777216.bin", geom=None, block_size=1 << 22),
    dict(name="textbwt_16777216_auto", codec="rans-auto",
         file="textbwt_16777216.bin", geom=None, block_size=1 << 22),
]


def case_data(case: dict) -> np.ndarray:
    """The input bytes of a case: a corpus slice, or seeded skewed bytes."""
    if "file" in case:
        return np.fromfile(DATA / case["file"], np.uint8,
                           count=case.get("n", -1),
                           offset=case.get("offset", 0))
    rng = np.random.default_rng(case["seed"])
    p = 1.0 / np.arange(1, 257) ** 1.3
    return rng.choice(256, size=case["n"], p=p / p.sum()).astype(np.uint8)


def jax_container(data: np.ndarray, codec: str, spec: str | None,
                  block_size: int) -> bytes:
    """The container ``turborc_tpu.api.compress`` writes (default
    CodecConfig fields), its payloads from the kernel codecs' XLA twins."""
    from turborc_tpu.codecs import rans_auto, rans_pallas, rans_pallas_r1
    from turborc_tpu.container import format as fmt
    from turborc_tpu.ops.pallas.geom import Geom
    geom = Geom.parse(spec) if spec else Geom()
    encode = (rans_pallas_r1.encode_block if codec == "rans-cdf-r1-p"
              else rans_auto.encode_block)
    out = [fmt.write_header(CODEC_IDS[codec], 512, 256, block_size,
                            data.shape[0], 5, 8, 8, geom=geom)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rans_auto, "_impls",
                   lambda: (rans_pallas, rans_pallas_r1))
        for off in range(0, max(data.shape[0], 1), block_size):
            blk = data[off:off + block_size]
            payload = encode(blk, use_pallas_encoder=False, geom=geom)
            stored = len(payload) >= blk.shape[0]
            out.append(fmt.write_block(blk.tobytes() if stored else payload,
                                       blk, stored))
    return b"".join(out)


def port_config(case: dict):
    from turborc_tpu_torch import CodecConfig, Geom
    return CodecConfig(codec=case["codec"], block_size=case["block_size"],
                       geom=Geom.parse(case["geom"]) if case["geom"] else None)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("case", SMALL, ids=[c["name"] for c in SMALL])
def test_small_golden_rederives_from_jax(case, golden):
    """Exact: the JAX package still writes the committed container."""
    want = {c["name"]: c for c in golden["small"]}[case["name"]]
    got = jax_container(case_data(case), case["codec"], case["geom"],
                        case["block_size"])
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
    """The full-size entries chip_smoke.py checks name existing corpora and
    hold a sha256 and a length."""
    assert [c["name"] for c in golden["large"]] == [c["name"] for c in LARGE]
    for entry, case in zip(golden["large"], LARGE):
        assert {k: entry[k] for k in case} == case
        assert (DATA / case["file"]).is_file()
        assert len(entry["sha256"]) == 64 and 0 < entry["length"]


def regen() -> None:
    doc = {"about": "rans-cdf-r1-p and rans-auto containers written by the "
                    "JAX package (XLA twins); regenerate with "
                    "python tests/test_torch_golden_r1.py --regen",
           "small": [], "large": []}
    for case in SMALL:
        c = jax_container(case_data(case), case["codec"], case["geom"],
                          case["block_size"])
        doc["small"].append(dict(case, length=len(c), hex=c.hex()))
    for case in LARGE:
        data = case_data(case)
        c = jax_container(data, case["codec"], case["geom"],
                          case["block_size"])
        doc["large"].append(dict(case, length=len(c),
                                 sha256=hashlib.sha256(c).hexdigest(),
                                 ratio=len(c) / data.size))
        print(case["name"], len(c), flush=True)
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--regen"]:
        sys.exit("usage: python tests/test_torch_golden_r1.py --regen")
    sys.path.insert(0, str(ROOT))
    regen()
