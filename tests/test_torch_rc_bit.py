"""The bitwise byte-tree codecs (ids 1, 2, 101-104) of the port against the
JAX package, on the CPU, and the api's predictor rates.

- ``api.compress`` / ``decompress`` pass the predictor rates prm0 / prm1
  (and level, ctx_bits) as the JAX package's do: a rc-o0-ss container at
  rates 4 / 6 is the JAX package's byte for byte; every earlier codec
  takes them and ignores them;
- ``models/bitpred.py``'s predictor steps and ``models/fsm.py``'s tables
  equal the JAX package's;
- the payloads of ids 1, 2, 101-104 equal the JAX package's
  ``encode_block`` (encode only: its decode takes minutes to compile on
  the CPU; the golden containers of ``tests/test_torch_golden_bit.py``
  stand in for it) and decode back; corrupt payloads raise;
- numpy mirrors of L11's eight depth chains and L12's read of both
  children equal the plain versions, with negative controls; the C
  entries, constants and refusals match the wrappers.

Every comparison is exact.  The JAX encodes run at K = 12 bytes a lane,
which ``rc_bit.encode_device`` scans a byte a step (K not a multiple of
its unroll of 8): a second of compile each.
"""
from __future__ import annotations

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from turborc_tpu_torch import CodecConfig, api, convert
from turborc_tpu_torch.codecs import blockio, registry
from turborc_tpu_torch.codecs import rc_bit as P
from turborc_tpu_torch.models import bitpred, fsm
from turborc_tpu_torch.ops import binary, build, rans
from turborc_tpu_torch.ops import rans_bit_kernel as BK
from turborc_tpu_torch.ops import rans_lane_kernel as LK

ROOT = Path(__file__).resolve().parents[1]
TEXT = np.fromfile(ROOT / "turborc_tpu" / "bench" / "_data" /
                   "textbwt_65536.bin", np.uint8)
SRC = (Path(build.__file__).resolve().parent / "csrc" /
       "rans_bit_kernel.cu").read_text()

# (codec, order, predictor, prm0, prm1): every (order, predictor), and the
# dual-speed ones also at the rates 4 / 6
CASES = [(c, o, p, 5, 8) for c, o, p in (
    ("rc-o0", 0, "s"), ("rcc-o1", 1, "s"), ("rc-o0-ss", 0, "ss"),
    ("rcc-o1-ss", 1, "ss"), ("rc-o0-sf", 0, "sf"), ("rcc-o1-sf", 1, "sf"))
] + [("rc-o0-ss", 0, "ss", 4, 6), ("rcc-o1-ss", 1, "ss", 4, 6)]
IDS = [f"{c}-{a}-{b}" for c, _, _, a, b in CASES]
LANES, STEP = 8, 4
# 90 bytes: K = 12 at 8 lanes, a run of one byte inside
DATA = np.concatenate([TEXT[500:540], np.full(20, 7, np.uint8),
                       TEXT[9000:9030]])
SHAPE = dict(lanes=LANES, step_quant=STEP)


@pytest.fixture(scope="module")
def jax_payloads():
    """(DATA, the JAX package's payload of it) under every case."""
    from turborc_tpu.codecs import registry as JR
    JR._lazy_init()
    return [(DATA, JR.get(codec).encode_block(DATA, prm0=prm0, prm1=prm1,
                                              **SHAPE))
            for codec, _, _, prm0, prm1 in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_payload_equals_jax(i, jax_payloads):
    codec, _, _, prm0, prm1 = CASES[i]
    data, want = jax_payloads[i]
    assert blockio.K_for(data.size, LANES, STEP) % 8  # a byte a scan step
    enc, dec = registry.get(codec).encode_block, registry.get(
        codec).decode_block
    assert enc is getattr(P, {"rc-o0": "rc_s", "rcc-o1": "rcc_s",
                              "rc-o0-ss": "rc_ss", "rcc-o1-ss": "rcc_ss",
                              "rc-o0-sf": "rc_sf", "rcc-o1-sf": "rcc_sf"
                              }[codec] + "_encode")
    got = enc(data, prm0=prm0, prm1=prm1, device="cpu", **SHAPE)
    assert got == want
    assert np.array_equal(dec(want, data.size, prm0=prm0, prm1=prm1,
                              device="cpu", **SHAPE), data)


def test_rates_change_the_payload(jax_payloads):
    """Rates 4 / 6 give another payload than 5 / 8 (so a port that coded
    at the defaults would not match), and decoding at the wrong rates
    does not return the bytes."""
    by = {(c, a): p for (c, _, _, a, _), (_, p) in zip(CASES, jax_payloads)}
    data = jax_payloads[0][0]
    for codec in ("rc-o0-ss", "rcc-o1-ss"):
        assert by[(codec, 4)] != by[(codec, 5)]
        dec = registry.get(codec).decode_block
        assert not np.array_equal(
            dec(by[(codec, 4)], data.size, device="cpu", **SHAPE), data)


def test_api_passes_the_rates():
    """api.compress with prm0 = 4, prm1 = 6 writes the JAX package's
    container, not the one at the default rates; api.decompress reads the
    rates from the header."""
    from turborc_tpu import api as japi
    from turborc_tpu.utils.config import CodecConfig as JConfig
    data = DATA.tobytes()
    cfg = dict(codec="rc-o0-ss", lanes=LANES, step_quant=STEP)
    blob = api.compress(data, CodecConfig(prm0=4, prm1=6, **cfg),
                        device="cpu")
    assert blob == japi.compress(data, JConfig(prm0=4, prm1=6, **cfg))
    assert blob != api.compress(data, CodecConfig(**cfg), device="cpu")
    assert api.decompress(blob, device="cpu") == data


EARLIER = ("rans-static", "rans-cdf-o0", "rans-cdf-o0-p", "rans-cdf-s8",
           "rans-cdf-r1", "rans-cdf-r1-p", "rans-auto", "rans-cdf-o1",
           "rc-p")


@pytest.mark.parametrize("codec", EARLIER)
def test_earlier_codecs_take_the_api_arguments(codec):
    """The nine earlier codecs take prm0, prm1, level and ctx_bits as the
    api now passes them, into ``**_unused``: none names them."""
    c = registry.get(codec)
    for fn in (c.encode_block, c.decode_block):
        params = inspect.signature(fn).parameters
        assert any(p.kind is p.VAR_KEYWORD for p in params.values())
        assert not {"prm0", "prm1", "level", "ctx_bits"} & set(params)


def test_api_arguments_leave_id56_unchanged():
    """Id 56's container at other rates, level and ctx_bits differs from
    the default one only in the header's fields."""
    data = TEXT[:3000].tobytes()
    base = dict(codec="rans-cdf-o0", lanes=16, step_quant=64)
    a = api.compress(data, CodecConfig(**base), device="cpu")
    b = api.compress(data, CodecConfig(prm0=2, prm1=3, level=1, ctx_bits=4,
                                       **base), device="cpu")
    from turborc_tpu_torch.container import format as fmt
    ha, hb = fmt.read_header(a), fmt.read_header(b)
    assert a[ha["data_off"]:] == b[hb["data_off"]:]
    assert api.decompress(b, device="cpu") == data


# ---------------------------------------------------------------------------
# predictors and the FSM tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,prm0,prm1", [("s", 5, 8), ("ss", 5, 8),
                                            ("ss", 4, 6), ("ss", 0, 40),
                                            ("sf", 5, 8)])
def test_bitpred_steps_equal_jax(name, prm0, prm1):
    """Predict (clamped) and update on seeded random tables and slots,
    twenty steps, against the JAX package's predictor."""
    import jax.numpy as jnp
    from turborc_tpu.models import bitpred as JB
    from turborc_tpu.ops import binary as JBin
    rng = np.random.default_rng([len(name), prm0, prm1])
    L, N = 7, 300
    jp, pp = JB.make(name, prm0, prm1), bitpred.make(name, prm0, prm1,
                                                    device="cpu")
    hi = {"s": 33791, "ss": 1 << 16, "sf": fsm.N_STATES}[name]
    st = rng.integers(0, hi, (L, N, 2) if name == "ss" else (L, N)
                      ).astype(np.int32)
    for _ in range(20):
        idx = rng.integers(0, N, L).astype(np.int32)
        bit = rng.integers(0, 2, L).astype(bool)
        pj = JBin.clamp_p(jp.predict(jnp.asarray(st), jnp.asarray(idx)))
        pt = binary.clamp_p(pp.predict(torch.from_numpy(st.copy()),
                                       torch.from_numpy(idx)))
        assert np.array_equal(np.asarray(pj), pt.numpy())
        sj = np.asarray(jp.update(jnp.asarray(st), jnp.asarray(idx), pj,
                                  jnp.asarray(bit)))
        sp = pp.update(torch.from_numpy(st.copy()), torch.from_numpy(idx),
                       pt, torch.from_numpy(bit)).numpy()
        assert np.array_equal(sj, sp)
        st = sj
    init = pp.init(2, 3, "cpu").numpy()
    assert np.array_equal(np.asarray(jp.init(2, 3)), init)


def test_binary_mapping_equals_jax():
    import jax.numpy as jnp
    from turborc_tpu.ops import binary as JBin
    rng = np.random.default_rng(3)
    p = rng.integers(-5, 1 << 15 + 1, 200).astype(np.int32)
    bit = rng.integers(0, 2, 200).astype(bool)
    state = rng.integers(1 << 15, 1 << 31, 200).astype(np.int64)
    assert np.array_equal(np.asarray(JBin.clamp_p(jnp.asarray(p))),
                          binary.clamp_p(torch.from_numpy(p)).numpy())
    pc = np.clip(p, 1, 32767)
    for a, b in zip(JBin.to_low_freq(jnp.asarray(pc), jnp.asarray(bit)),
                    binary.to_low_freq(torch.from_numpy(pc),
                                       torch.from_numpy(bit))):
        assert np.array_equal(np.asarray(a), b.numpy())
    jb, js = JBin.dec_bit(jnp.asarray(state.astype(np.uint32)),
                          jnp.asarray(pc))
    tb, ts = binary.dec_bit(torch.from_numpy(state), torch.from_numpy(pc))
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())


FSM_TEXT = """\
1,2,16384
3, 0, 20000
7 8
40000 -3 0
2,1
0 0 32767
"""


def test_fsm_tables_equal_jax():
    """build_table (every state), initial_state, and the reference
    format's parse and load (clamps, zero fill) on a small text."""
    from turborc_tpu.models import fsm as JF
    for a, b in zip(JF.build_table(), fsm.build_table()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(JF.build_table(64, 7, 8), fsm.build_table(64, 7, 8)):
        assert np.array_equal(a, b)
    assert fsm.initial_state() == JF.initial_state() == 512
    assert fsm.reference_initial_state() == JF.reference_initial_state()
    for a, b in zip(JF.parse_reference_format(FSM_TEXT),
                    fsm.parse_reference_format(FSM_TEXT)):
        assert np.array_equal(a, b)
    for a, b in zip(JF.load_reference_table(FSM_TEXT),
                    fsm.load_reference_table(FSM_TEXT)):
        assert a.shape == (fsm.N_STATES,) and np.array_equal(a, b)


def test_fsm_table_from_jax():
    from turborc_tpu.models import fsm as JF
    t = convert.fsm_table_from_jax(*JF.build_table(), device="cpu")
    assert t.dtype == torch.int32 and torch.equal(t,
                                                  bitpred.fsm_table("cpu"))
    loaded = convert.fsm_table_from_jax(*JF.load_reference_table(FSM_TEXT),
                                        device="cpu")
    assert loaded.shape == (3, fsm.N_STATES)


# ---------------------------------------------------------------------------
# numpy mirrors of the kernels' designs
# ---------------------------------------------------------------------------

def _np_pred(name: str, prm0: int = 5, prm1: int = 8):
    """(init, prob, next) of a predictor on one u32 slot, as the kernels
    hold it (ss: c0 | c1 << 16)."""
    if name == "s":
        return (16384, lambda v: v,
                lambda v, p, b: p - (((p - (b << 15)) >> 5) + b))
    if name == "ss":
        def nxt(v, p, b):
            c = [v & 0xFFFF, v >> 16]
            r = [min(prm0, 16), min(prm1, 16)]
            c = [x + ((x ^ 0xFFFF) >> k) if b else x - (x >> k)
                 for x, k in zip(c, r)]
            return c[0] | (c[1] << 16)
        return 0x80008000, lambda v: ((v & 0xFFFF) + (v >> 16)) >> 2, nxt
    prob, n0, n1 = fsm.build_table()
    return (fsm.initial_state(), lambda v: int(prob[v]),
            lambda v, p, b: int((n1 if b else n0)[v]))


def _clamp(p: int) -> int:
    return min(max(p, 1), 32767)


def model_mirror(cols: np.ndarray, order: int, name: str,
                 depths=range(8)) -> np.ndarray:
    """L11's design: lane l's depth d is its own chain over all K bytes
    (the thread (d, l)), on its own slots; probs [8K, L]."""
    init, prob, nxt = _np_pred(name)
    K, L = cols.shape
    probs = np.zeros((8 * K, L), np.int64)
    for l in range(L):
        for d in depths:
            tab = {}
            ctx = 0
            for t in range(K):
                b = int(cols[t, l])
                slot = (ctx << 8 if order else 0) | ((256 | b) >> (8 - d))
                v = tab.get(slot, init)
                p = _clamp(prob(v))
                bit = (b >> (7 - d)) & 1
                tab[slot] = nxt(v, p, bit)
                probs[8 * t + d, l] = p if bit else (p << 16) | (32768 - p)
                if order:
                    ctx = b
    return probs


def decode_mirror(words: np.ndarray, lengths: np.ndarray, K: int,
                  order: int, name: str, stale_root: bool = False
                  ) -> np.ndarray:
    """L12's design, one lane at a time: the children's values and
    predictions read before the bit resolves and the parent's store,
    which is sound because a byte's 8 slots are distinct.  The negative
    control (``stale_root``) reads a byte's root as it stood before the
    byte before it, a read across bytes moved too early."""
    init, prob, nxt = _np_pred(name)
    L = lengths.size
    off = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    out = np.zeros((K, L), np.uint8)
    for l in range(L):
        n = int(max(0, min(lengths[l], 8 * K + 2, words.size - off[l])))
        src = words[off[l]:off[l] + n].astype(np.int64) & 0xFFFF

        def w(p):
            return int(src[p]) if p < n else 0
        state, pos, nxtw = (w(0) << 16) | w(1), 2, w(2)
        tab, ctx, before = {}, 0, {}
        for t in range(K):
            base = ctx << 8 if order else 0
            v = (before if stale_root else tab).get(base | 1, init)
            before = dict(tab)
            p = _clamp(prob(v))
            node = 1
            for d in range(8):
                if d < 7:
                    v0 = tab.get(base | 2 * node, init)
                    v1 = tab.get(base | 2 * node + 1, init)
                value = state & 0x7FFF
                bit = int(value < p)
                f, lo = (p, 0) if bit else (32768 - p, p)
                state = (f * (state >> 15) + value - lo) & 0xFFFFFFFF
                tab[base | node] = nxt(v, p, bit)
                if state < 1 << 15:
                    state = ((state << 16) | nxtw) & 0xFFFFFFFF
                    pos += 1
                    nxtw = w(pos)
                node = 2 * node + bit
                if d < 7:
                    v = v1 if bit else v0
                    p = _clamp(prob(v))
            out[t, l] = node & 255
            if order:
                ctx = node & 255
    return out


MIRROR = [(o, n) for o in (0, 1) for n in ("s", "ss", "sf")]


def _mirror_cols(K: int, L: int, seed: int) -> np.ndarray:
    """[K, L] bytes: textbwt, lane 0 a run of one byte, lane 1 random."""
    rng = np.random.default_rng(seed)
    x = TEXT[seed * 997: seed * 997 + K * L].reshape(L, K).T.copy()
    x[:, 0] = 200
    x[:, 1] = rng.integers(0, 256, K)
    return np.ascontiguousarray(x)


@pytest.mark.parametrize("order,name", MIRROR)
def test_model_depth_chains_equal_plain(order, name):
    """L11's eight chains, one a depth, each on its own slots, give the
    plain model's probs exactly (the decisions of a byte touch disjoint
    slot sets); a negative control mixing two depths' chains into one
    table per lane does not."""
    K, L = 24, 4
    cols = _mirror_cols(K, L, 3)
    pred = bitpred.make(name, device="cpu")
    want = BK.lane_bit_model_plain(torch.from_numpy(cols), order, pred)
    got = model_mirror(cols, order, name)
    assert np.array_equal(got, want.numpy().astype(np.int64))
    # the slots of depth d are its own: a node index off by a depth
    # (node >> 1, the parent's slot) shares slots between chains
    init, prob, nxt = _np_pred(name)
    bad = np.zeros_like(got)
    tab = {}
    for t in range(K):
        b = int(cols[t, 0])
        for d in range(8):
            slot = max(1, ((256 | b) >> (8 - d)) >> 1)
            v = tab.get(slot, init)
            p = _clamp(prob(v))
            bit = (b >> (7 - d)) & 1
            tab[slot] = nxt(v, p, bit)
            bad[8 * t + d, 0] = p if bit else (p << 16) | (32768 - p)
    assert not np.array_equal(bad[:, 0], got[:, 0])


@pytest.mark.parametrize("order,name", MIRROR)
def test_decode_children_read_equal_plain(order, name):
    """L12's read of both children before the bit resolves decodes the
    plain decode's bytes, on a sound stream and on corrupt ones (flipped
    words, a length table cut short)."""
    K, L = 16, 4
    cols = torch.from_numpy(_mirror_cols(K, L, 5))
    pred = bitpred.make(name, device="cpu")
    probs = BK.lane_bit_model_plain(cols, order, pred)
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32)
    st, ln = LK.lane_coder_plain(probs, init)
    words = blockio.device_words(st, ln)
    gen = np.random.default_rng(9)
    flipped = words.clone()
    flipped[gen.integers(0, words.numel(), 6)] ^= 0x5A5A
    short = ln.clone()
    short[1] = 1
    for w, lens in ((words, ln), (flipped, ln), (words, short)):
        want = BK.lane_bit_decode_plain(w, lens, K, order, pred)
        got = decode_mirror(w.numpy(), lens.numpy().astype(np.int64), K,
                            order, name)
        assert np.array_equal(got, want.numpy())
    assert torch.equal(BK.lane_bit_decode_plain(words, ln, K, order, pred),
                       cols)
    bad = decode_mirror(words.numpy(), ln.numpy().astype(np.int64), K,
                        order, name, stale_root=True)
    assert not np.array_equal(bad, cols.numpy())


# ---------------------------------------------------------------------------
# codecs: corrupt payloads, api, wrappers, sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["rc-o0", "rcc-o1-sf"])
def test_corrupt_payloads_raise(codec, jax_payloads):
    data, payload = jax_payloads[[c for c, *_ in CASES].index(codec)]
    dec = registry.get(codec).decode_block
    for bad in (payload[:2 * LANES - 1],                # truncated lengths
                payload[:-2],                           # words cut short
                b"\xff\xff" + payload[2:]):             # a length too large
        with pytest.raises(ValueError):
            dec(bad, data.size, device="cpu", **SHAPE)


@pytest.mark.parametrize("codec", ["rc-o0", "rcc-o1-ss", "rc-o0-sf"])
def test_api_round_trip(codec):
    """Three blocks, the last one short, through the container."""
    data = TEXT[3000:5500].tobytes()
    cfg = CodecConfig(codec=codec, lanes=16, step_quant=16, block_size=1024)
    blob = api.compress(data, cfg, device="cpu")
    assert api.decompress(blob, device="cpu") == data


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert m, name
    return int(m.group(1))


def test_constants_match_source():
    assert _const("kBitLanes") == BK.BIT_LANES
    assert _const("kBitDLanes") == BK.BIT_DECODE_LANES
    assert _const("kCtxSlots") == BK.BIT_CTX_SLOTS
    assert _const("kMaxRate") == bitpred.MAX_RATE
    assert BK.bit_launch(512) == (256, 16)
    assert BK.bit_launch(512, decode=True) == (8, 64)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES[
    "rans_bit_kernel.cu"]))
def test_c_signatures_match_build(name):
    m = re.search(rf"int {name}\(([^)]*)\)", SRC)
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1].startswith("cudaStream_t")
    kinds = ["P" if "*" in p else "I" for p in params[:-1]] + ["P"]
    want = build.SIGNATURES["rans_bit_kernel.cu"][name]
    assert kinds == ["P" if t is build._P else "I" for t in want]


def test_cargs_fit_the_signatures():
    K, L = 12, 8
    cols = torch.zeros((K, L), dtype=torch.uint8)
    probs = torch.zeros((8 * K, L), dtype=torch.int32)
    words = torch.zeros((40,), dtype=torch.int16)
    lens = torch.zeros((L,), dtype=torch.int32)
    offs = torch.zeros((L,), dtype=torch.int64)
    out = torch.zeros((K, L), dtype=torch.uint8)
    for order in (0, 1):
        for pred in (bitpred.Simple(), bitpred.DualSpeed(40, 3),
                     bitpred.Fsm(device="cpu")):
            cases = {
                "trc_lane_bit_model": BK.lane_bit_model_cargs(
                    cols, probs, order, pred),
                "trc_lane_bit_decode": BK.lane_bit_decode_cargs(
                    words, offs, lens, K, out, order, pred)}
            for name, args in cases.items():
                want = build.SIGNATURES["rans_bit_kernel.cu"][name][:-1]
                assert len(args) == len(want)
                for a, t in zip(args, want):
                    if t is build._P:
                        assert a is None or isinstance(a, torch.Tensor)
                    else:
                        assert isinstance(a, int)
                tables = args[2] if name == "trc_lane_bit_model" else args[4]
                assert (tables is None) == (order == 0)
                if order:
                    assert tables.shape == (L, BK.BIT_CTX_SLOTS)
            ints = cases["trc_lane_bit_model"][-6:]
            if isinstance(pred, bitpred.DualSpeed):
                assert ints[2:4] == [16, 3]  # rate 40 acts as 16


_C = torch.zeros((12, 8), dtype=torch.uint8)
_W = torch.zeros((40,), dtype=torch.int16)
_LN = torch.full((8,), 5, dtype=torch.int32)


@pytest.mark.parametrize("what,call", [
    ("order 2", lambda: BK.lane_bit_model(_C, 2, bitpred.Simple())),
    ("not a predictor", lambda: BK.lane_bit_model(_C, 0, "s")),
    ("cols dtype", lambda: BK.lane_bit_model(_C.to(torch.int32), 0,
                                             bitpred.Simple())),
    ("lanes not 2^n", lambda: BK.lane_bit_model(
        torch.zeros((12, 6), dtype=torch.uint8), 0, bitpred.Simple())),
    ("order-1 tables too large", lambda: BK.lane_bit_model(
        torch.zeros((0, 1 << 15), dtype=torch.uint8), 1, bitpred.Simple())),
    ("fsm table shape", lambda: BK.lane_bit_model(_C, 0, bitpred.Fsm(
        torch.zeros((2, 10), dtype=torch.int32)))),
    ("fsm table dtype", lambda: BK.lane_bit_model(_C, 0, bitpred.Fsm(
        torch.zeros((3, 10), dtype=torch.int64)))),
    ("fsm start past the states", lambda: BK.lane_bit_model(
        _C, 0, bitpred.Fsm(torch.zeros((3, 10), dtype=torch.int32),
                           start=10))),
    ("negative rate", lambda: BK.lane_bit_model(_C, 0,
                                                bitpred.DualSpeed(-1, 4))),
    ("K past the stream rows", lambda: BK.lane_bit_decode(
        _W, _LN, 1 << 28, 0, bitpred.Simple())),
    ("decode order", lambda: BK.lane_bit_decode(_W, _LN, 4, 3,
                                                bitpred.Simple())),
    ("words dtype", lambda: BK.lane_bit_decode(_W.to(torch.int32), _LN, 4,
                                               0, bitpred.Simple())),
    ("fsm probabilities", lambda: convert.fsm_table_from_jax(
        np.full(4, 1 << 15), np.zeros(4), np.zeros(4), device="cpu")),
    ("fsm next states", lambda: convert.fsm_table_from_jax(
        np.ones(4), np.full(4, 4), np.zeros(4), device="cpu")),
    ("fsm shapes", lambda: convert.fsm_table_from_jax(
        np.ones(4), np.zeros(3), np.zeros(4), device="cpu")),
    ("unknown predictor", lambda: bitpred.make("x")),
])
def test_wrappers_refuse(what, call):
    with pytest.raises(ValueError):
        call()
