"""The nibble codecs rc4 (id 41) and rc4c (id 40) of the port against the
JAX package, on the CPU.

Payloads both ways (the port writes the JAX package's bytes and decodes
them; the JAX package decodes the port's) at n = 0, 1, below one lane's
K, not a multiple of the lanes and several K; the plain L9 and L10
against the JAX package's scans; corrupt payloads and bad arguments
raise ValueError; L10's static symbol rule and the kernels' constants
and C entries match the wrappers.  Every comparison is exact.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from turborc_tpu_torch import CodecConfig, api
from turborc_tpu_torch.codecs import blockio, registry
from turborc_tpu_torch.codecs import rans_nibble as P
from turborc_tpu_torch.ops import build, rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops import rans_nibble_kernel as NK

ROOT = Path(__file__).resolve().parents[1]
TEXT = np.fromfile(ROOT / "turborc_tpu" / "bench" / "_data" /
                   "textbwt_65536.bin", np.uint8)
SRC = (Path(build.__file__).resolve().parent / "csrc" /
       "rans_lane_kernel.cu").read_text()
LANES, STEP = 16, 64
SHAPE = dict(lanes=LANES, step_quant=STEP)
# n: none, one byte, below one lane's K (64), not a multiple of the
# lanes, several K (K = 192)
SIZES = (0, 1, 50, 1001, 3 * LANES * STEP - 5)
CODECS = ("rc4", "rc4c")
CASES = [(c, n) for c in CODECS for n in SIZES]
IDS = [f"{c}-n{n}" for c, n in CASES]


def _data(n: int) -> np.ndarray:
    return TEXT[7000:7000 + n].copy()


@pytest.fixture(scope="module")
def jax_payloads():
    from turborc_tpu.codecs import registry as JR
    JR._lazy_init()
    return [JR.get(c).encode_block(_data(n), **SHAPE) for c, n in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_payload_equals_jax(i, jax_payloads):
    codec, n = CASES[i]
    c = registry.get(codec)
    assert c.encode_block(_data(n), device="cpu", **SHAPE) == jax_payloads[i]
    assert np.array_equal(c.decode_block(jax_payloads[i], n, device="cpu",
                                         **SHAPE), _data(n))


@pytest.mark.parametrize("i", [i for i, (_, n) in enumerate(CASES) if n in
                               (1, 1001)],
                         ids=[IDS[i] for i, (_, n) in enumerate(CASES)
                              if n in (1, 1001)])
def test_jax_decodes_port_payload(i):
    from turborc_tpu.codecs import registry as JR
    JR._lazy_init()
    codec, n = CASES[i]
    payload = registry.get(codec).encode_block(_data(n), device="cpu",
                                               **SHAPE)
    assert np.array_equal(np.asarray(JR.get(codec).decode_block(
        payload, n, **SHAPE)), _data(n))


def test_registry_ids():
    assert registry.get("rc4").codec_id == 41
    assert registry.get("rc4c").codec_id == 40
    assert registry.get(41).encode_block is P.encode_block
    assert registry.get(40).decode_block is P.decode_block_static


def _block(L: int, K: int, seed: int) -> np.ndarray:
    """[L, K] bytes: textbwt, one lane of one byte, one of 0/1 bytes."""
    rng = np.random.default_rng(seed)
    x = TEXT[seed * 101: seed * 101 + L * K].reshape(L, K).copy()
    x[0] = 0xA7
    x[1] = rng.integers(0, 2, K)
    return x


@pytest.mark.parametrize("L,K", [(4, 1), (8, 37), (16, 64)])
def test_plain_kernels_equal_jax_scans(L, K):
    """L9 + L2 give encode_adaptive's streams and lengths, and the static
    gather + L2 encode_static's; L10's two decodes give back the bytes
    decode_adaptive and decode_static give."""
    import jax.numpy as jnp
    from turborc_tpu.codecs import rans_nibble as J
    x = _block(L, K, K)
    cols = torch.from_numpy(x.T.copy())
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32)
    st, ln = LK.lane_coder(NK.lane_nibble_model(cols), init)
    js, jl = J.encode_adaptive(jnp.asarray(x.astype(np.int32)), K)
    assert np.array_equal(np.asarray(js), st.numpy())
    assert np.array_equal(np.asarray(jl), ln.numpy())
    words = blockio.device_words(st, ln)
    got = NK.lane_nibble_decode(words, ln, K)
    assert np.array_equal(np.asarray(J.decode_adaptive(js, K)).T,
                          got.numpy())
    assert torch.equal(got, cols)
    freqs = P.build_nibble_freqs(x.reshape(-1))
    cdf = np.zeros(17, np.int32)
    np.cumsum(freqs, out=cdf[1:])
    js, jl = J.encode_static(jnp.asarray(x.astype(np.int32)),
                             jnp.asarray(cdf), K)
    jl = torch.from_numpy(np.array(jl))
    words = blockio.device_words(torch.from_numpy(np.array(js)), jl)
    got = NK.lane_nibble_static_decode(words, jl, K, torch.from_numpy(cdf))
    assert torch.equal(got, cols)


@pytest.mark.parametrize("what", ["empty", "one byte", "0xF0 run",
                                  "uniform", "textbwt"])
def test_nibble_freqs_equal_jax(what):
    """build_nibble_freqs (hi and lo counts from one byte histogram)
    equals the JAX package's _build_nibble_freqs (from the 2n nibbles)."""
    from turborc_tpu.codecs import rans_nibble as J
    x = {"empty": np.zeros(0, np.uint8), "one byte": np.full(1, 0x3C,
                                                             np.uint8),
         "0xF0 run": np.full(5000, 0xF0, np.uint8),
         "uniform": np.random.default_rng(1).integers(0, 256, 70000).astype(
             np.uint8), "textbwt": TEXT}[what]
    assert np.array_equal(P.build_nibble_freqs(x), J._build_nibble_freqs(x))


def test_static_symbol_rule():
    """L10's static symbol, max(#{i < 16: cdf_i <= v} - 1, 0) by one
    ballot, is the JAX package's 15 - #{i < 16: cdf_i > v} on every value
    of CDFs with zero frequencies (ties) and one symbol holding all."""
    rng = np.random.default_rng(5)
    v = np.arange(1 << 15)
    for _ in range(20):
        f = rng.integers(0, 5, 16) * rng.integers(0, 4000, 16)
        f[rng.integers(0, 16)] += 1
        f = np.maximum(f * (1 << 15) // f.sum(), 0)
        f[np.argmax(f)] += (1 << 15) - f.sum()
        cdf = np.concatenate([[0], np.cumsum(f)])[:16]
        jax_rule = 15 - (cdf[None, :] > v[:, None]).sum(-1)
        ballot = np.maximum((cdf[None, :] <= v[:, None]).sum(-1) - 1, 0)
        assert np.array_equal(jax_rule, ballot)
        assert (f[ballot] > 0).all()  # the symbol found is codeable


def test_padding_stays_codeable():
    """rc4c's table gives every nibble a frequency >= 1 (the +1), so the
    zero padding of a block of 0xFF bytes codes."""
    x = np.full(1001, 0xFF, np.uint8)
    assert (P.build_nibble_freqs(x) >= 1).all()
    payload = P.encode_block_static(x, device="cpu", **SHAPE)
    assert np.array_equal(P.decode_block_static(payload, x.size,
                                                device="cpu", **SHAPE), x)


@pytest.mark.parametrize("codec", CODECS)
def test_corrupt_payloads_raise(codec, jax_payloads):
    n = 1001
    payload = jax_payloads[CASES.index((codec, n))]
    dec = registry.get(codec).decode_block
    head = 32 if codec == "rc4c" else 0
    bad = [payload[:head + 2 * LANES - 2],          # truncated length table
           payload[:-2],                            # the words cut short
           payload[:head] + b"\x01\x00" + payload[head + 2:]]  # length < 2
    if codec == "rc4c":
        f = bytearray(payload)
        f[0] ^= 1                                   # freqs not summing 2^15
        bad += [bytes(f), payload[:31]]
    for b in bad:
        with pytest.raises(ValueError):
            dec(b, n, device="cpu", **SHAPE)


def test_api_round_trip():
    """Three blocks, the last one short, under each codec."""
    data = TEXT[100:2600].tobytes()
    for codec in CODECS:
        cfg = CodecConfig(codec=codec, lanes=16, step_quant=16,
                          block_size=1024)
        assert api.decompress(api.compress(data, cfg, device="cpu"),
                              device="cpu") == data


def test_constants_match_source():
    for name, value in (("kNibTeam", NK.NIB_TEAM),
                        ("kNibLanes", NK.NIB_LANES)):
        m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
        assert m and int(m.group(1)) == value, name
    for name, value in (("kNibModelThreads", "kNibLanes * kNibTeam"),
                        ("kNibDecodeThreads", "kNibLanes * 32")):
        m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
        assert m and m.group(1) == value, name
    assert NK.nib_launch(512) == (64, 128)
    assert NK.nib_launch(512, decode=True) == (128, 128)
    assert NK.nib_launch(2) == (64, 1)


def test_cargs_fit_the_signatures():
    K, L = 8, 16
    cols = torch.zeros((K, L), dtype=torch.uint8)
    probs = torch.zeros((2 * K, L), dtype=torch.int32)
    words = torch.zeros((40,), dtype=torch.int16)
    lens = torch.zeros((L,), dtype=torch.int32)
    offs = torch.zeros((L,), dtype=torch.int64)
    out = torch.zeros((K, L), dtype=torch.uint8)
    cdf = torch.zeros((17,), dtype=torch.int32)
    sig = build.SIGNATURES["rans_lane_kernel.cu"]
    for name, args in (
            ("trc_lane_nibble_model", NK.lane_nibble_model_cargs(cols, probs)),
            ("trc_lane_nibble_decode", NK.lane_nibble_decode_cargs(
                words, offs, lens, K, cdf, out)),
            ("trc_lane_nibble_decode", NK.lane_nibble_decode_cargs(
                words, offs, lens, K, None, out))):
        want = sig[name][:-1]
        assert len(args) == len(want)
        for a, t in zip(args, want):
            if t is build._P:
                assert a is None or isinstance(a, torch.Tensor)
            else:
                assert isinstance(a, int)


_W = torch.zeros((40,), dtype=torch.int16)
_LN = torch.full((8,), 5, dtype=torch.int32)


@pytest.mark.parametrize("what,call", [
    ("L9 cols dtype", lambda: NK.lane_nibble_model(
        torch.zeros((8, 8), dtype=torch.int32))),
    ("L9 cols rank", lambda: NK.lane_nibble_model(
        torch.zeros((8, 8, 1), dtype=torch.uint8))),
    ("L9 lanes not 2^n", lambda: NK.lane_nibble_model(
        torch.zeros((8, 12), dtype=torch.uint8))),
    ("L10 K past the stream rows", lambda: NK.lane_nibble_decode(
        _W, _LN, 1 << 30)),
    ("L10 words dtype", lambda: NK.lane_nibble_decode(
        _W.to(torch.int32), _LN, 4)),
    ("L10 static cdf shape", lambda: NK.lane_nibble_static_decode(
        _W, _LN, 4, torch.zeros((16,), dtype=torch.int32))),
    ("L10 static cdf dtype", lambda: NK.lane_nibble_static_decode(
        _W, _LN, 4, torch.zeros((17,), dtype=torch.int64))),
    ("L10 static cdf not from 0", lambda: NK.lane_nibble_static_decode(
        _W, _LN, 4, torch.arange(17, dtype=torch.int32) * 2048 + 1)),
    ("L10 static cdf not to 2^15", lambda: NK.lane_nibble_static_decode(
        _W, _LN, 4, torch.arange(17, dtype=torch.int32) * 2000)),
    ("L10 static cdf decreasing", lambda: NK.lane_nibble_static_decode(
        _W, _LN, 4, torch.tensor([0, 9000, 8000] + [1 << 15] * 14,
                                 dtype=torch.int32))),
])
def test_wrappers_refuse(what, call):
    with pytest.raises(ValueError):
        call()
