"""The port's order-1 per-lane scan codecs against the JAX package:
rans-cdf-r1 (id 59) and rans-cdf-o1 (id 64).

Payloads from the port's ``encode_block(..., device="cpu")`` (the plain
versions of L5 + L2 and L7 + L2) must equal the JAX package's byte for
byte, the port must decode the JAX package's payloads (L6, L8), and the
JAX package must decode the port's.  The plain L5 and L6 are held
against the JAX ``model_pass`` and ``decode_device``, the plain L7 + L2
and L8 against the JAX ``encode_device`` and ``decode_device``; corrupt
payloads must raise ValueError, the wrappers must refuse what the
kernels do not take, and the api must round-trip both codecs.  Every
comparison is exact.

The JAX scans compile once per (lanes, K), so the cases share three
shapes a codec: 4 lanes at K = 64, 16 lanes at K = 256 and 256 lanes
(id 64: its clamp to 128) at K = 256 (id 64: 512).  Id 59 at a segment
count that does not divide the lanes into whole CTAs is frozen in
``golden/lane_o1.json`` (``tests/test_torch_golden_lane_o1.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turborc_tpu.codecs import rans_cdf_o1 as J64
from turborc_tpu.codecs import rans_cdf_r1 as J59
from turborc_tpu_torch import CodecConfig, api, convert
from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs import rans_cdf_o1 as T64
from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.codecs import rans_cdf_r1_lane as T59
from turborc_tpu_torch.container import format as fmt
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO

TEXT = np.fromfile(J59.__file__.replace("codecs/rans_cdf_r1.py",
                                        "bench/_data/textbwt_65536.bin"),
                   np.uint8)


def _skewed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.3
    return rng.choice(256, size=n, p=p / p.sum()).astype(np.uint8)


# (codec, lanes, step_quant, data): n = 0, 1, 255, not a multiple of the
# lanes, 64 KB; 256 lanes drive id 64's clamp to 128
CASES = [(c, L, q, d) for c in ("59", "64") for L, q, d in (
    (4, 64, TEXT[:0]),
    (4, 64, TEXT[:1]),
    (4, 64, _skewed(255, 3)),
    (16, 256, TEXT[1000:2001]),
    (256, 256, TEXT))]
IDS = [f"id{c}-L{L}-q{q}-n{d.size}" for c, L, q, d in CASES]
JMOD = {"59": J59, "64": J64}
TMOD = {"59": T59, "64": T64}


@pytest.fixture(scope="module")
def jax_payloads():
    """The JAX package's payload of every case."""
    return [JMOD[c].encode_block(d, lanes=L, step_quant=q)
            for c, L, q, d in CASES]


@pytest.fixture(scope="module")
def port_payloads():
    """The port's payload of every case (the plain versions)."""
    return [TMOD[c].encode_block(d, lanes=L, step_quant=q, device="cpu")
            for c, L, q, d in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_encode_block_byte_identical(i, jax_payloads, port_payloads):
    """Exact: the port's payload equals the JAX package's."""
    assert port_payloads[i] == jax_payloads[i]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_decode_jax_payload(i, jax_payloads):
    """Exact: the port decodes the JAX package's payload to the input."""
    c, L, q, d = CASES[i]
    out = TMOD[c].decode_block(jax_payloads[i], d.size, lanes=L,
                               step_quant=q, device="cpu")
    assert np.array_equal(out, d)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_jax_decodes_port_payload(i, port_payloads):
    """Exact: the JAX package decodes the port's payload to the input."""
    c, L, q, d = CASES[i]
    assert np.array_equal(JMOD[c].decode_block(port_payloads[i], d.size,
                                               lanes=L, step_quant=q), d)


def _jax_streams(streams, lengths):
    """JAX [L, M] streams and [L] lengths -> the port's (words, lengths)."""
    lengths = torch.from_numpy(np.array(lengths))
    return blockio.device_words(torch.from_numpy(np.array(streams)),
                                lengths), lengths


def test_id59_passes_against_jax():
    """Exact, 16 lanes at K = 256: convert.r1_tables_from_jax of the JAX
    segment tables gives the port's, and R1.lane_tables of them the JAX
    ``_lane_tables``; the plain L5 equals
    ``model_pass``, L2 on its probs ``encode_device``'s streams and
    lengths, and the plain L6 ``decode_device``."""
    data, L, K = TEXT[1000:2001], 16, 256
    a = T59.encode_args(data, L, 256, "cpu")
    padded = a.cols.T.contiguous().reshape(-1).numpy()
    _, (hi_q, lo_q) = J59.quantize_tables(*J59.group_tables(
        padded, R1.n_segments(data.size, L)))
    seg = convert.r1_tables_from_jax(hi_q, lo_q, device="cpu")
    assert torch.equal(seg[0], a.hi_tbl) and torch.equal(seg[1], a.lo_tbl)
    hi0, lo0 = J59._lane_tables(hi_q, lo_q, L)
    for mine, theirs in zip(R1.lane_tables(*seg, L), (hi0, lo0)):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    block = jnp.asarray(a.cols.T.numpy().astype(np.int32))
    jp = np.asarray(J59.model_pass(block, K, hi0, lo0)).astype(np.int64)
    probs = LO.lane_o1r_model_plain(a.cols, a.hi_tbl, a.lo_tbl)
    assert np.array_equal(probs.numpy(), (jp[:, 0] << 16) | jp[:, 1])
    js, jl = J59.encode_device(block, K, hi0, lo0)
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32)
    ts, tl = LK.lane_coder_plain(probs, init)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    out = LO.lane_o1r_decode_plain(*_jax_streams(js, jl), K, a.hi_tbl,
                                   a.lo_tbl)
    jout = np.asarray(J59.decode_device(js, K, hi0, lo0))
    assert np.array_equal(out.numpy().T, jout)
    assert torch.equal(out, a.cols)


def test_id64_passes_against_jax():
    """Exact, 16 lanes at K = 256: the plain L7's probs through L2 equal
    ``encode_device``'s streams and lengths (the model half has no JAX
    function of its own), and the plain L8 equals ``decode_device``."""
    data, L, q = TEXT[1000:2001], 16, 256
    block, K = blockio.shape_block(data, L, q)
    cols = torch.from_numpy(block).T.contiguous()
    js, jl = J64.encode_device(jnp.asarray(block.astype(np.int32)), K)
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32)
    ts, tl = LK.lane_coder_plain(LO.lane_o1_model_plain(cols), init)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    out = LO.lane_o1_decode_plain(*_jax_streams(js, jl), K)
    assert np.array_equal(out.numpy().T, np.asarray(J64.decode_device(js, K)))
    assert torch.equal(out, cols)


def test_o1_launch_matches_source():
    """The launch shape the wrapper reports is the source's: kTeam, the
    contexts' rows and lanes a CTA, and what fits a CTA."""
    from pathlib import Path
    src = (Path(LO.__file__).parent / "csrc"
           / "rans_lane_kernel.cu").read_text()
    assert "constexpr int kTeam = 16;" in src and LO.O1_TEAM == 16
    assert "kHiRows = 64, kLoRows = 48, kLanes = 4;" in src
    assert "kHiRows = 256, kLoRows = 4096, kLanes = 1;" in src
    assert LO.o1_launch(512, "rans-cdf-r1") == (4, 128, 16_384, 128)
    assert LO.o1_launch(128, "rans-cdf-o1") == (1, 32, 174_848, 128)
    assert LO.o1_launch(4, "rans-cdf-r1")[3] == 1


# ---------------------------------------------------------------------------
# corrupt payloads and the wrappers' refusals
# ---------------------------------------------------------------------------

def _case(codec: str) -> tuple:
    i = next(i for i, c in enumerate(CASES) if c[0] == codec
             and c[1] == 16)
    c, L, q, d = CASES[i]
    return i, d, dict(lanes=L, step_quant=q, device="cpu")


@pytest.mark.parametrize("codec", ["59", "64"])
def test_corrupt_payloads_raise(codec, jax_payloads):
    """A truncated header (id 59), an inconsistent or truncated lane
    length table raise ValueError; a flipped stream word decodes to other
    bytes."""
    i, d, kw = _case(codec)
    good = jax_payloads[i]
    dec = TMOD[codec].decode_block
    head = 256 + 4 + R1.N_ENTRIES if codec == "59" else 0  # one segment
    if codec == "59":
        with pytest.raises(ValueError, match="truncated header"):
            dec(good[:256 + 4 + R1.N_ENTRIES - 1], d.size, **kw)
    with pytest.raises(ValueError, match="truncated lane length"):
        dec(good[:head + 2 * kw["lanes"] - 2], d.size, **kw)
    with pytest.raises(ValueError, match="inconsistent"):
        dec(good[:-2], d.size, **kw)
    bad = bytearray(good)
    bad[head:head + 2] = (1).to_bytes(2, "little")  # lane 0: 1 word < 2
    with pytest.raises(ValueError, match="inconsistent"):
        dec(bytes(bad), d.size, **kw)
    bad = bytearray(good)
    at = head + 2 * kw["lanes"] + 8
    bad[at:at + 2] = (int.from_bytes(bad[at:at + 2], "little")
                      ^ 0x5A5A).to_bytes(2, "little")
    assert not np.array_equal(dec(bytes(bad), d.size, **kw), d)


def test_id59_bad_codes_raise(jax_payloads):
    """Warm-table codes that do not decode raise ValueError before any
    pass runs: an escape count the nibbles do not hold (one segment), and
    codes driven past 255 by their deltas (two segments, n = 2^19)."""
    i, d, kw = _case("59")
    bad = bytearray(jax_payloads[i])
    bad[256:260] = (2).to_bytes(4, "little")
    with pytest.raises(ValueError, match="escape count"):
        T59.decode_block(bytes(bad), d.size, **kw)
    # codes 255 in segment 0, then +1 (zigzag 2) for every entry
    payload = (bytes(256) + bytes(4) + bytes([255]) * R1.N_ENTRIES
               + bytes([0x22]) * (R1.N_ENTRIES // 2))
    with pytest.raises(ValueError, match="out of range"):
        T59.decode_block(payload, 1 << 19, **kw)


def _r1_tables(n_seg=1, **kw):
    hi = torch.zeros((n_seg, 64, 16), dtype=torch.int32, **kw)
    return hi, torch.zeros((n_seg, 48, 16), dtype=torch.int32, **kw)


def _misaligned(n: int, dtype) -> torch.Tensor:
    """A CPU tensor of n elements starting one byte into its buffer."""
    size = torch.tensor([], dtype=dtype).element_size()
    buf = bytearray(n * size + 1)
    return torch.frombuffer(buf, dtype=dtype, count=n, offset=1)


_WORDS = torch.zeros((40,), dtype=torch.int16)
_LENS = torch.full((4,), 10, dtype=torch.int32)


@pytest.mark.parametrize("what,call", [
    ("L5 cols dtype", lambda: LO.lane_o1r_model(
        torch.zeros((32, 8), dtype=torch.int32), *_r1_tables())),
    ("L7 cols rank", lambda: LO.lane_o1_model(
        torch.zeros((32, 8, 1), dtype=torch.uint8))),
    ("L7 lanes not 2^n", lambda: LO.lane_o1_model(
        torch.zeros((32, 12), dtype=torch.uint8))),
    ("L5 hi table rows", lambda: LO.lane_o1r_model(
        torch.zeros((32, 8), dtype=torch.uint8),
        torch.zeros((1, 63, 16), dtype=torch.int32), _r1_tables()[1])),
    ("L5 lo table dtype", lambda: LO.lane_o1r_model(
        torch.zeros((32, 8), dtype=torch.uint8), _r1_tables()[0],
        torch.zeros((1, 48, 16), dtype=torch.int64))),
    ("L5 more segments than lanes", lambda: LO.lane_o1r_model(
        torch.zeros((32, 4), dtype=torch.uint8), *_r1_tables(5))),
    ("L5 tables on another device", lambda: LO.lane_o1r_model(
        torch.zeros((32, 8), dtype=torch.uint8),
        *_r1_tables(device="meta"))),
    ("L6 misaligned words", lambda: LO.lane_o1r_decode(
        _misaligned(40, torch.int16), _LENS, 4, *_r1_tables())),
    ("L6 misaligned tables", lambda: LO.lane_o1r_decode(
        _WORDS, _LENS, 4, _misaligned(64 * 16, torch.int32).view(1, 64, 16),
        _r1_tables()[1])),
    ("L8 misaligned lengths", lambda: LO.lane_o1_decode(
        _WORDS, _misaligned(4, torch.int32), 4)),
    ("L6 K past the stream rows", lambda: LO.lane_o1r_decode(
        _WORDS, _LENS, 1 << 30, *_r1_tables())),
    ("L8 K past the stream rows", lambda: LO.lane_o1_decode(
        _WORDS, _LENS, 1 << 30)),
    ("L8 words dtype", lambda: LO.lane_o1_decode(
        torch.zeros((40,), dtype=torch.int32), _LENS, 4)),
    ("L8 lengths rank", lambda: LO.lane_o1_decode(
        _WORDS, _LENS.reshape(2, 2), 4)),
    ("converted tables not freq rows", lambda:
        convert.r1_tables_from_jax(np.ones((1, 64, 16)), np.ones((1, 48, 16)),
                                   device="cpu")),
    ("converted tables' shapes", lambda: convert.r1_tables_from_jax(
        np.ones((2, 64, 16)), np.ones((1, 48, 16)), device="cpu")),
])
def test_wrappers_refuse(what, call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("codec,lanes", [("rans-cdf-r1", 16),
                                         ("rans-cdf-o1", 256)])
def test_api_round_trip(codec, lanes):
    """The api writes the caller's lanes into the header (id 64 codes at
    most 128) and round-trips three blocks, the last one short."""
    data = TEXT[3000:13000].tobytes()
    cfg = CodecConfig(codec=codec, lanes=lanes, block_size=4096)
    blob = api.compress(data, cfg, device="cpu")
    hdr = fmt.read_header(blob)
    assert (hdr["codec_id"], hdr["lanes"]) == (
        {"rans-cdf-r1": 59, "rans-cdf-o1": 64}[codec], lanes)
    assert api.decompress(blob, device="cpu") == data
