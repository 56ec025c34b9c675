"""Golden containers of the nibble codecs rc4 (id 41) and rc4c (id 40) and
the bitwise byte-tree codecs rc-o0 (id 1), rcc-o1 (id 2), rc-o0-ss (101),
rcc-o1-ss (102), rc-o0-sf (103) and rcc-o1-sf (104), frozen from the JAX
package.

``turborc_tpu_torch/golden/bit.json`` holds
  small: whole containers (hex) of small inputs at 16 lanes (one block,
         three blocks with a short last one, none; ids 101 and 102 also
         at the rates prm0 = 4, prm1 = 6), which the port must write
         byte for byte and decode: the JAX package's bitwise decode takes
         minutes to compile on the CPU, so these stand in for it;
  large: sha256 + length of textbwt 16 MB under each codec at the
         default ``CodecConfig`` (4 MB blocks, 512 lanes), which
         ``chip_smoke.py`` checks on the GPU, where there is no JAX.  The
         order-1 bitwise codecs (ids 2, 102, 104) freeze the file's first
         4 MB, one whole default block: their JAX encode on the CPU is
         slow and large (the scan rewrites a lane's 65,536-slot table at
         every bit).

The oracle is ``turborc_tpu.api.compress`` itself, which registers all
eight codecs on the CPU.  For the large order-1 cases the regeneration
runs the JAX package's ``rc_bit.encode_device`` on 32 lanes at a time
and joins the lanes' streams: the lanes are independent, so the result
is the call's on all lanes (the regeneration first checks that on a small
block), at a memory the machine can hold.  Every comparison is exact.

Regenerate (about 20 minutes of CPU wall time, most of it the order-1
cases, three processes at once):

    JAX_PLATFORMS=cpu python tests/test_torch_golden_bit.py --regen
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
GOLDEN = ROOT / "turborc_tpu_torch" / "golden" / "bit.json"
NIBBLE = ("rc4", "rc4c")
BIT = ("rc-o0", "rcc-o1", "rc-o0-ss", "rcc-o1-ss", "rc-o0-sf", "rcc-o1-sf")
ORDER1 = ("rcc-o1", "rcc-o1-ss", "rcc-o1-sf")
CODECS = NIBBLE + BIT
CHUNK_LANES = 32  # lanes a JAX encode_device call of the large cases

SMALL = [dict(name=f"{codec}_{what}", codec=codec, lanes=16, step_quant=64,
              **case)
         for codec in CODECS for what, case in (
             ("textbwt3000", dict(file="textbwt_65536.bin", offset=0,
                                  n=3000, block_size=1 << 22)),
             ("textbwt2500_3blocks", dict(file="textbwt_65536.bin",
                                          offset=9000, n=2500,
                                          block_size=1024)),
             ("empty", dict(seed=0, n=0, block_size=1 << 22)))] + [
    dict(name=f"{codec}_textbwt3000_prm4_6", codec=codec, lanes=16,
         step_quant=64, prm0=4, prm1=6, file="textbwt_65536.bin",
         offset=30000, n=3000, block_size=1 << 22)
    for codec in ("rc-o0-ss", "rcc-o1-ss")]
LARGE = [dict(name=f"textbwt_16777216_{codec}", codec=codec,
              file="textbwt_16777216.bin", block_size=1 << 22)
         if codec not in ORDER1 else
         dict(name=f"textbwt_4194304_{codec}", codec=codec,
              file="textbwt_16777216.bin", n=1 << 22, block_size=1 << 22)
         for codec in CODECS]
FIELDS = ("codec", "block_size", "lanes", "step_quant", "prm0", "prm1")


def config(case: dict, cls):
    return cls(**{k: case[k] for k in FIELDS if k in case})


def jax_container(case: dict) -> bytes:
    from turborc_tpu import api
    from turborc_tpu.utils.config import CodecConfig
    return api.compress(case_data(case), config(case, CodecConfig))


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("case", SMALL, ids=[c["name"] for c in SMALL])
def test_small_golden_port_writes_and_reads(case, golden):
    """Exact: the port writes the committed container byte for byte and
    decodes it back to the input."""
    from turborc_tpu_torch import CodecConfig, api
    want = bytes.fromhex({c["name"]: c
                          for c in golden["small"]}[case["name"]]["hex"])
    data = case_data(case)
    assert api.compress(data, config(case, CodecConfig),
                        device="cpu") == want
    assert api.decompress(want, device="cpu") == data.tobytes()


@pytest.mark.parametrize("case", [c for c in SMALL if c["codec"] in NIBBLE],
                         ids=[c["name"] for c in SMALL
                              if c["codec"] in NIBBLE])
def test_small_nibble_golden_rederives_from_jax(case, golden):
    """Exact: the JAX package still writes the committed nibble-codec
    containers (a second each; the bitwise codecs' JAX payloads are held
    in tests/test_torch_rc_bit.py at a shape that compiles in a second)."""
    want = {c["name"]: c for c in golden["small"]}[case["name"]]
    assert jax_container(case).hex() == want["hex"]


def test_rates_are_in_the_header(golden):
    """The prm4_6 containers carry rates 4 / 6 in their headers and differ
    from the same input's at the default rates 5 / 8."""
    from turborc_tpu_torch import CodecConfig, api
    from turborc_tpu_torch.container import format as fmt
    small = {c["name"]: c for c in golden["small"]}
    for codec in ("rc-o0-ss", "rcc-o1-ss"):
        case = small[f"{codec}_textbwt3000_prm4_6"]
        blob = bytes.fromhex(case["hex"])
        hdr = fmt.read_header(blob)
        assert (hdr["prm0"], hdr["prm1"]) == (4, 6)
        default = dict(case, prm0=5, prm1=8)
        assert api.compress(case_data(case), config(default, CodecConfig),
                            device="cpu") != blob


def test_large_golden_entries(golden):
    """The full-size entries chip_smoke.py checks name an existing corpus
    and hold a sha256 and a length."""
    assert [c["name"] for c in golden["large"]] == [c["name"] for c in LARGE]
    for entry, case in zip(golden["large"], LARGE):
        assert {k: entry[k] for k in case} == case
        assert (DATA / case["file"]).is_file()
        assert len(entry["sha256"]) == 64 and 0 < entry["length"]


def _lane_chunked(encode_device, chunk: int):
    """``rc_bit.encode_device`` run on ``chunk`` lanes at a time, the
    lanes' streams and lengths joined in lane order."""
    import jax.numpy as jnp

    def run(block, K, *args):
        parts = [encode_device(block[i:i + chunk], K, *args)
                 for i in range(0, block.shape[0], chunk)]
        return (jnp.concatenate([p[0] for p in parts]),
                jnp.concatenate([p[1] for p in parts]))
    return run


def _large_entry(case: dict) -> dict:
    """The large entry of ``case``, in a worker process of ``regen``."""
    from turborc_tpu.codecs import rc_bit
    if case["codec"] in ORDER1:
        rc_bit.encode_device = _lane_chunked(rc_bit.encode_device,
                                             CHUNK_LANES)
    c = jax_container(case)
    print(case["name"], len(c), flush=True)
    return dict(case, length=len(c), sha256=hashlib.sha256(c).hexdigest(),
                ratio=len(c) / case_data(case).size)


def _check_chunking() -> None:
    """The lane-chunked encode equals the whole call, on 64 lanes."""
    import jax.numpy as jnp
    from turborc_tpu.codecs import blockio, rc_bit
    data = case_data(dict(file="textbwt_65536.bin", offset=0, n=20000))
    block, K = blockio.shape_block(data, 64, 64)
    for pred in ("s", "ss", "sf"):
        whole = rc_bit.encode_device(jnp.asarray(block), K, 1, pred, 5, 8)
        part = _lane_chunked(rc_bit.encode_device, 16)(
            jnp.asarray(block), K, 1, pred, 5, 8)
        assert all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(whole, part)), pred


def regen() -> None:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    _check_chunking()
    doc = {"about": "rc4 / rc4c / rc-o0 / rcc-o1 / -ss / -sf containers "
                    "written by turborc_tpu.api.compress (the large "
                    "order-1 cases on lane chunks of rc_bit.encode_device,"
                    " their first 4 MB); regenerate with python "
                    "tests/test_torch_golden_bit.py --regen",
           "small": []}
    for case in SMALL:
        c = jax_container(case)
        doc["small"].append(dict(case, length=len(c), hex=c.hex()))
    with ProcessPoolExecutor(3, multiprocessing.get_context(
            "spawn")) as pool:
        doc["large"] = list(pool.map(_large_entry, LARGE))
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--regen"]:
        sys.exit("usage: python tests/test_torch_golden_bit.py --regen")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    regen()
