"""Golden containers of the W-bit tree codecs rc-16 (id 6) and rc{W}b (ids
142, 143, 145, 146, 147, 150, 152), the order-2 byte tree rcc2 (id 3) and
the bitwise ANS ansb (id 66), frozen from the JAX package.

``turborc_tpu_torch/golden/bit_w.json`` holds
  small: whole containers (hex) of small inputs, which the port must write
         byte for byte and decode: the JAX package's bitwise decodes take
         minutes to compile on the CPU, so these stand in for them.  The
         rc{W}b inputs below 8 bits are bytes shifted right by 8 - W (the
         api hands a codec bytes); rc10b and rc12b decode to u16 elements,
         so their containers fail the block crc in ``decompress``, in the
         port as in the JAX package; rcc2 at 1 and 2 lanes (K = 256); ansb
         with one short sub-block, with two (the second short) and empty;
  block: block-API payloads (hex) of each rc{W}b on seeded elements over
         the whole W-bit alphabet, 0 and 2^W - 1 among them;
  large: sha256 + length of full-size cases, which ``chip_smoke.py``
         checks on the GPU, where there is no JAX: textbwt's first 4 MB
         through the api at the default ``CodecConfig`` under rc-16, ansb
         and rc{W}b for W < 8 (bytes shifted right by 8 - W); the same
         4 MB read as <u2 and shifted right by 16 - W through the block
         API (512 lanes, step_quant 64) under rc10b and rc12b; and
         textbwt's first 64 KB through the api under rcc2 (16 lanes,
         K = 4,096).

The oracle is ``turborc_tpu.api.compress`` (and, for block payloads,
``rc_bit.make_nbit_block_api``), which registers all ten codecs on the
CPU.  For rc-16 the regeneration runs ``rc_bit.encoden_device`` on 64
lanes at a time, and for rcc2 ``rc_bit.encode_device`` on one lane at a
time in worker processes (its scan copies a lane's 64 MB table at every
decision), joining the lanes' streams: the lanes are independent, so the
result is the call's on all lanes (the regeneration first checks that on
small blocks).  Every comparison is exact.

Regenerate (about 22 minutes of CPU wall time, four worker processes
at once, two of them on rcc2's lanes, about 15 GB in all):

    JAX_PLATFORMS=cpu python tests/test_torch_golden_bit_w.py --regen
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
GOLDEN = ROOT / "turborc_tpu_torch" / "golden" / "bit_w.json"
WIDTH = {"rc-16": 16, "rc2b": 2, "rc3b": 3, "rc5b": 5, "rc6b": 6,
         "rc7b": 7, "rc10b": 10, "rc12b": 12}
SUB_BYTE = ("rc2b", "rc3b", "rc5b", "rc6b", "rc7b")
WIDE = ("rc10b", "rc12b")  # decode to u16: the api's block crc fails
WIDE_LANES = 64  # lanes a JAX encoden_device call of the large rc-16 case
TEXT = dict(file="textbwt_65536.bin", lanes=16, step_quant=64)
BIG = "textbwt_16777216.bin"

SMALL = (
    [dict(name="rc-16_" + what, codec="rc-16", **TEXT, **case)
     for what, case in (
         ("textbwt3000", dict(offset=0, n=3000, block_size=1 << 22)),
         ("textbwt2501_3blocks", dict(offset=9000, n=2501,
                                      block_size=1024)),
         ("one_byte", dict(offset=777, n=1, block_size=1 << 22)))]
    + [dict(name="rc-16_empty", codec="rc-16", lanes=16, step_quant=64,
            seed=0, n=0, block_size=1 << 22)]
    + [dict(name=f"{c}_{what}", codec=c, shift=8 - WIDTH[c], **TEXT, **case)
       for c in SUB_BYTE for what, case in (
           ("textbwt3000", dict(offset=3000, n=3000, block_size=1 << 22)),
           ("textbwt2500_3blocks", dict(offset=20000, n=2500,
                                        block_size=1024)))]
    + [dict(name=f"{c}_empty", codec=c, lanes=16, step_quant=64, seed=0,
            n=0, block_size=1 << 22) for c in SUB_BYTE]
    + [dict(name=f"{c}_textbwt3000", codec=c, **TEXT, offset=6000, n=3000,
            block_size=1 << 22) for c in WIDE]
    + [dict(name="rcc2_textbwt256_1lane", codec="rcc2", file=TEXT["file"],
            lanes=1, step_quant=64, offset=100, n=256, block_size=1 << 22),
       dict(name="rcc2_textbwt500_2lanes", codec="rcc2", file=TEXT["file"],
            lanes=2, step_quant=64, offset=20000, n=500,
            block_size=1 << 22),
       dict(name="rcc2_empty", codec="rcc2", lanes=1, step_quant=64, seed=0,
            n=0, block_size=1 << 22)]
    + [dict(name="ansb_textbwt3000", codec="ansb", **TEXT, offset=40000,
            n=3000, block_size=1 << 22),
       dict(name="ansb_textbwt68536_2subblocks", codec="ansb", file=BIG,
            lanes=16, step_quant=64, offset=0, n=(1 << 16) + 3000,
            block_size=1 << 22),
       dict(name="ansb_empty", codec="ansb", lanes=16, step_quant=64,
            seed=0, n=0, block_size=1 << 22)])
BLOCK = [dict(name=f"{c}_block", codec=c, lanes=8, step_quant=16,
              seed=WIDTH[c], n=700) for c in (*SUB_BYTE, *WIDE)]
LARGE = (
    [dict(name="textbwt_4194304_rc-16", kind="api", codec="rc-16", file=BIG,
          n=1 << 22, block_size=1 << 22)]
    + [dict(name=f"textbwt_4194304_{c}", kind="api", codec=c, file=BIG,
            n=1 << 22, shift=8 - WIDTH[c], block_size=1 << 22)
       for c in SUB_BYTE]
    + [dict(name=f"textbwt_4194304_u2_{c}", kind="block", codec=c,
            file=BIG, n=1 << 22, view="<u2", shift=16 - WIDTH[c],
            lanes=512, step_quant=64) for c in WIDE]
    + [dict(name="textbwt_4194304_ansb", kind="api", codec="ansb",
            file=BIG, n=1 << 22, block_size=1 << 22),
       dict(name="textbwt_65536_rcc2", kind="api", codec="rcc2", file=BIG,
            n=1 << 16, block_size=1 << 22)])
FIELDS = ("codec", "block_size", "lanes", "step_quant")


def w_data(case: dict) -> np.ndarray:
    """The input of a small or large case: its bytes (``case_data``),
    read as <u2 where it says so, shifted right by its ``shift``."""
    x = case_data(case)
    if case.get("view"):
        x = x.view(case["view"])
    return x >> case.get("shift", 0)


def block_data(case: dict) -> np.ndarray:
    """A block case's elements: seeded, skewed over the W-bit alphabet,
    the first three 2^W - 1 and the next one 0; u8 for W <= 8, else
    u16."""
    W = WIDTH[case["codec"]]
    rng = np.random.default_rng(case["seed"])
    p = 1.0 / np.arange(1, (1 << W) + 1) ** 1.1
    v = rng.choice(1 << W, case["n"], p=p / p.sum())
    v[:3], v[3] = (1 << W) - 1, 0
    return v.astype(np.uint8 if W <= 8 else np.uint16)


def config(case: dict, cls):
    return cls(**{k: case[k] for k in FIELDS if k in case})


def jax_container(case: dict) -> bytes:
    from turborc_tpu import api
    from turborc_tpu.utils.config import CodecConfig
    return api.compress(w_data(case), config(case, CodecConfig))


def jax_block(case: dict, data: np.ndarray) -> bytes:
    from turborc_tpu.codecs import rc_bit
    enc = rc_bit.make_nbit_block_api(WIDTH[case["codec"]])[0]
    return enc(data, lanes=case["lanes"], step_quant=case["step_quant"])


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def _by_name(golden, part: str) -> dict:
    return {c["name"]: c for c in golden[part]}


# ansb's case of two sub-blocks codes a whole 64 KB sub-block, about 40 s
# of the plain versions on the CPU: chip_smoke.py writes and decodes it on
# the card, and test_ansb_two_sub_blocks_golden holds its frames here
TWO_SUB_BLOCKS = "ansb_textbwt68536_2subblocks"
ON_CPU = [c for c in SMALL if c["name"] != TWO_SUB_BLOCKS]


@pytest.mark.parametrize("case", ON_CPU, ids=[c["name"] for c in ON_CPU])
def test_small_golden_port_writes_and_reads(case, golden):
    """Exact: the port writes the committed container byte for byte and
    decodes it back to the input; rc10b's and rc12b's decode fails the
    block crc as the JAX package's does (their elements are u16), and
    their block API returns the input as u16 elements."""
    from turborc_tpu_torch import CodecConfig, api
    from turborc_tpu_torch.codecs import registry
    from turborc_tpu_torch.container import format as fmt
    want = bytes.fromhex(_by_name(golden, "small")[case["name"]]["hex"])
    data = w_data(case)
    assert api.compress(data, config(case, CodecConfig),
                        device="cpu") == want
    if case["codec"] not in WIDE:
        assert api.decompress(want, device="cpu") == data.tobytes()
        return
    with pytest.raises(ValueError, match="block crc mismatch"):
        api.decompress(want, device="cpu")
    hdr = fmt.read_header(want)
    payload = next(fmt.iter_blocks(want, hdr["data_off"]))[0]
    out = registry.get(case["codec"]).decode_block(
        payload, data.size, lanes=case["lanes"],
        step_quant=case["step_quant"], device="cpu")
    assert out.dtype == np.uint16 and np.array_equal(out, data)


def test_ansb_two_sub_blocks_golden(golden):
    """The committed container of two sub-blocks holds two <u4-framed
    sub-payloads and nothing after: the first a consistent lane table of
    4 lanes at K = 16,384, the second (3,000 bytes) the port's id-1
    payload of the short sub-block byte for byte, which decodes to it."""
    import struct
    from turborc_tpu_torch.codecs import blockio
    from turborc_tpu_torch.codecs import rc_bit as RB
    from turborc_tpu_torch.container import format as fmt
    case = next(c for c in SMALL if c["name"] == TWO_SUB_BLOCKS)
    blob = bytes.fromhex(_by_name(golden, "small")[TWO_SUB_BLOCKS]["hex"])
    data = w_data(case)
    payload, stored, _ = next(fmt.iter_blocks(blob, fmt.read_header(blob)[
        "data_off"]))
    assert not stored
    n1 = struct.unpack_from("<I", payload, 0)[0]
    first = payload[4:4 + n1]
    n2 = struct.unpack_from("<I", payload, 4 + n1)[0]
    second = payload[8 + n1:]
    assert len(second) == n2
    blockio.lane_table(first, RB.ANSB_LANES, 8 * (RB.ANSB_BLOCK // 4) + 2)
    tail = data[RB.ANSB_BLOCK:]
    assert RB.rc_s_encode(tail, lanes=4, step_quant=256,
                          device="cpu") == second
    assert np.array_equal(RB.rc_s_decode(second, tail.size, lanes=4,
                                         step_quant=256, device="cpu"), tail)


@pytest.mark.parametrize("case", BLOCK, ids=[c["name"] for c in BLOCK])
def test_block_golden_port_writes_and_reads(case, golden):
    """Exact: the port's block API writes the committed payload of
    elements over the whole alphabet and decodes it, u8 for W <= 8 and
    u16 above."""
    from turborc_tpu_torch.codecs import registry
    want = bytes.fromhex(_by_name(golden, "block")[case["name"]]["hex"])
    data = block_data(case)
    c = registry.get(case["codec"])
    shape = dict(lanes=case["lanes"], step_quant=case["step_quant"])
    assert c.encode_block(data, device="cpu", **shape) == want
    out = c.decode_block(want, data.size, device="cpu", **shape)
    assert out.dtype == data.dtype and np.array_equal(out, data)


def test_large_golden_entries(golden):
    """The full-size entries chip_smoke.py checks name an existing corpus
    and hold a sha256 and a length."""
    assert [c["name"] for c in golden["large"]] == [c["name"] for c in LARGE]
    for entry, case in zip(golden["large"], LARGE):
        assert {k: entry[k] for k in case} == case
        assert (DATA / case["file"]).is_file()
        assert len(entry["sha256"]) == 64 and 0 < entry["length"]


# ---------------------------------------------------------------------------
# regeneration
# ---------------------------------------------------------------------------

def _lane_chunked(fn, chunk: int):
    """A JAX ``rc_bit`` device encode run on ``chunk`` lanes at a time, the
    lanes' streams and lengths joined in lane order."""
    import jax.numpy as jnp

    def run(block, K, *args):
        parts = [fn(block[i:i + chunk], K, *args)
                 for i in range(0, block.shape[0], chunk)]
        return (jnp.concatenate([p[0] for p in parts]),
                jnp.concatenate([p[1] for p in parts]))
    return run


def _rcc2_lane(job):
    """One lane of the large rcc2 case, in a worker process: (block row
    [1, K], K) -> (streams, lengths) as numpy."""
    import jax.numpy as jnp
    from turborc_tpu.codecs import rc_bit
    row, K = job
    st, ln = rc_bit.encode_device(jnp.asarray(row), K, 2, "s", 5, 8)
    return np.asarray(st), np.asarray(ln)


def _entry(case: dict, digest: bytes) -> dict:
    return dict(case, length=len(digest),
                sha256=hashlib.sha256(digest).hexdigest(),
                ratio=len(digest) / w_data(case).nbytes)


def _large_entry(case: dict) -> dict:
    """The large entry of ``case`` (not rcc2), in a worker process."""
    from turborc_tpu.codecs import rc_bit
    if case["codec"] == "rc-16":
        rc_bit.encoden_device = _lane_chunked(rc_bit.encoden_device,
                                              WIDE_LANES)
    if case["kind"] == "block":
        out = jax_block(case, w_data(case))
    else:
        out = jax_container(case)
    print(case["name"], len(out), flush=True)
    return _entry(case, out)


def _check_chunking() -> None:
    """The lane-chunked encodes equal the whole call: W = 16 on 64 lanes,
    order 2 on 2 lanes."""
    import jax.numpy as jnp
    from turborc_tpu.codecs import blockio, rc_bit
    data = case_data(dict(file="textbwt_65536.bin", offset=0, n=8000))
    block, K = blockio.shape_block(data, 64, 64)
    whole = rc_bit.encoden_device(jnp.asarray(block), K, 16, "s", 5, 8)
    part = _lane_chunked(rc_bit.encoden_device, 16)(
        jnp.asarray(block), K, 16, "s", 5, 8)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(whole, part))
    block, K = blockio.shape_block(data[:400], 2, 256)
    whole = rc_bit.encode_device(jnp.asarray(block), K, 2, "s", 5, 8)
    part = _lane_chunked(rc_bit.encode_device, 1)(jnp.asarray(block), K, 2,
                                                  "s", 5, 8)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(whole, part))


def regen() -> None:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import jax.numpy as jnp
    from turborc_tpu.codecs import blockio, rc_bit
    _check_chunking()
    doc = {"about": "rc-16 / rc{W}b / rcc2 / ansb containers written by "
                    "turborc_tpu.api.compress and rc{W}b block payloads by "
                    "rc_bit.make_nbit_block_api (the large rc-16 case on "
                    "lane chunks of rc_bit.encoden_device, rcc2 on single "
                    "lanes of rc_bit.encode_device); regenerate with python "
                    "tests/test_torch_golden_bit_w.py --regen",
           "small": [], "block": []}
    rcc2 = next(c for c in LARGE if c["codec"] == "rcc2")
    block, K = blockio.shape_block(w_data(rcc2), 16, 256)
    ctx = multiprocessing.get_context("spawn")
    # two pools of two: an rcc2 lane's process holds about 4.5 GB
    with ProcessPoolExecutor(2, ctx) as pool, \
            ProcessPoolExecutor(2, ctx) as lane_pool:
        lanes = [lane_pool.submit(_rcc2_lane, (block[i:i + 1], K))
                 for i in range(block.shape[0])]
        others = [pool.submit(_large_entry, c) for c in LARGE
                  if c is not rcc2]
        for case in SMALL:
            c = jax_container(case)
            doc["small"].append(dict(case, length=len(c), hex=c.hex()))
            print(case["name"], len(c), flush=True)
        for case in BLOCK:
            c = jax_block(case, block_data(case))
            doc["block"].append(dict(case, length=len(c), hex=c.hex()))
        parts = [f.result() for f in lanes]
        streams = np.concatenate([p[0] for p in parts])
        lengths = np.concatenate([p[1] for p in parts])

        def joined(blk, K_, order, *args):
            assert order == 2 and K_ == K
            assert np.array_equal(np.asarray(blk), block)
            return jnp.asarray(streams), jnp.asarray(lengths)
        rc_bit.encode_device = joined
        entry = _entry(rcc2, jax_container(rcc2))
        doc["large"] = [f.result() for f in others]
    doc["large"].insert(LARGE.index(rcc2), entry)
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--regen"]:
        sys.exit("usage: python tests/test_torch_golden_bit_w.py --regen")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    regen()
