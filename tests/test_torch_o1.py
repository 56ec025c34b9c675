"""The port's order-1 flagship (rans-cdf-r1-p, id 60) against the JAX package.

The context wiring, the conditional warm tables, the kernels' plain
versions (through the wrappers in ``turborc_tpu_torch.ops.rans_o1_kernel``,
which take them for CPU tensors) and the codec's payloads must equal the
JAX package's, whose oracle here is its XLA twin
(``rans_o1_kernel.encode_tile``, ``rans_pallas_r1.encode_block(...,
use_pallas_encoder=False)``).  The CUDA kernels are held against the same
plain versions on the GPU by ``chip_smoke.py``.  Inputs are seeded numpy
data or slices of the committed corpora.  Every comparison is exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turborc_tpu.codecs import rans_cdf_r1 as JR
from turborc_tpu.codecs import rans_pallas_r1 as J
from turborc_tpu.ops.pallas import rans_o1_kernel as JK
from turborc_tpu.ops.pallas.geom import Geom as JGeom
from turborc_tpu_torch import convert
from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.codecs import rans_cdf_r1_p as T
from turborc_tpu_torch.ops import rans_o1_kernel as TK
from turborc_tpu_torch.ops.geom import Geom

DATA = J.__file__.replace("codecs/rans_pallas_r1.py", "bench/_data/")
REAL = np.fromfile(DATA + "realsrcbwt_16777216.bin", np.uint8,
                   count=600_000)
TEXT = np.fromfile(DATA + "textbwt_65536.bin", np.uint8)
TINY = "g2c2s8y2l4a16r4"       # 256 lanes, 480 seed bytes


@pytest.fixture(scope="module", autouse=True)
def nctx_guard():
    """The JAX package reads NCTX from the environment; every comparison
    here assumes the default 64 rows that the port fixes."""
    assert JR.NCTX == R1.NCTX == 64
    assert (JR.LROWS, JR.LIN, JR.N_ENTRIES) == (R1.LROWS, R1.LIN,
                                                R1.N_ENTRIES)


def test_contexts_match_jax():
    """Exact over all 256 x 16 (prev, hi) pairs: hictx and locx_of
    against the JAX package's numpy and jnp versions."""
    prev, hi = np.meshgrid(np.arange(256), np.arange(16), indexing="ij")
    prev, hi = prev.reshape(-1), hi.reshape(-1)
    pt, ht = torch.from_numpy(prev), torch.from_numpy(hi)
    want_ctx = JR.np_hictx(prev)
    assert np.array_equal(np.asarray(JR.hictx(jnp.asarray(prev))), want_ctx)
    assert np.array_equal(R1.hictx(pt).numpy(), want_ctx)
    assert np.array_equal(R1.np_hictx(prev), want_ctx)
    want_locx = JR.np_locx(prev, hi)
    assert np.array_equal(
        np.asarray(JR.locx_of(jnp.asarray(prev), jnp.asarray(hi))),
        want_locx)
    assert np.array_equal(R1.locx_of(pt, ht).numpy(), want_locx)
    assert np.array_equal(R1.np_locx(prev, hi), want_locx)
    assert want_ctx.max() == R1.NCTX - 1 and want_locx.max() == R1.LROWS - 1


def test_warm_tables_match_jax():
    """Exact: counts, per-segment freqs, codes and dequantized tables of
    a realsrcbwt slice in three segments."""
    seg = REAL[:300_000]
    for got, want in zip(R1.o1_counts(seg), JR.o1_counts(seg)):
        assert np.array_equal(got, want)
    got_f, want_f = R1.group_tables(seg, 3), JR.group_tables(seg, 3)
    for got, want in zip(got_f, want_f):
        assert np.array_equal(got, want)
    codes, tables = R1.quantize_tables(*got_f)
    jcodes, jtables = JR.quantize_tables(*want_f)
    assert np.array_equal(codes, jcodes)
    for got, want in zip(tables + R1.codes_to_tables(codes), jtables * 2):
        assert np.array_equal(got, want)
    assert [R1.n_segments(n, 4) for n in (0, 1 << 18, 600_000, 1 << 30)] \
        == [JR.n_segments(n, 4) for n in (0, 1 << 18, 600_000, 1 << 30)] \
        == [1, 1, 2, 4]


# ---------------------------------------------------------------------------
# kernels (plain versions) against the XLA twin
# ---------------------------------------------------------------------------

TILES = [("g2c2s8y2l4a16r4", 24, 3), ("g1c8s8y4l32a16r4", 40, 4)]


def _tile_args(spec: str, K: int, seed: int):
    """A block of realsrcbwt bytes [L, K], its warm tables in the JAX
    kernels' layout [R, 16, G] and seeded initial states [G, 128]."""
    g = JGeom.parse(spec)
    rng = np.random.default_rng(seed)
    off = int(rng.integers(0, REAL.size - g.lanes * K))
    block = REAL[off:off + g.lanes * K]
    hi_q, lo_q = JR.codes_to_tables(
        JR.quantize_tables(*JR.group_tables(block, g.groups))[0])
    hi = np.transpose(blockio.cumulative(hi_q), (1, 2, 0)).copy()
    lo = np.transpose(blockio.cumulative(lo_q), (1, 2, 0)).copy()
    init = ((1 << 15) | rng.integers(0, 1 << 15, (g.groups, 128)))
    return block.reshape(g.lanes, K), hi, lo, init.astype(np.int32)


@pytest.fixture(scope="module")
def jax_tiles():
    out = []
    for spec, K, seed in TILES:
        block, hi, lo, init = _tile_args(spec, K, seed)
        gs, gl = JK.encode_tile(jnp.asarray(block), K, jnp.asarray(hi),
                                jnp.asarray(lo), jnp.asarray(init),
                                geom=JGeom.parse(spec))
        out.append((block, hi, lo, init, np.asarray(gs), np.asarray(gl)))
    return out


@pytest.mark.parametrize("i", range(len(TILES)),
                         ids=[t[0] for t in TILES])
def test_encode_tile_matches_jax(i, jax_tiles):
    """Exact: model (K7 plain) -> coder -> place gives the JAX twin's
    group streams and lengths."""
    spec, K, _ = TILES[i]
    block, hi, lo, init, jgs, jgl = jax_tiles[i]
    hi_t, lo_t, init_t = convert.o1_kernel_args_from_jax(hi, lo, init,
                                                         device="cpu")
    gs, gl = TK.encode_tile(torch.from_numpy(block), K, hi_t, lo_t, init_t,
                            Geom.parse(spec))
    assert np.array_equal(gs.numpy(), jgs)
    assert np.array_equal(gl.numpy(), jgl)


@pytest.mark.parametrize("i", range(len(TILES)),
                         ids=[t[0] for t in TILES])
def test_decode_tile_on_jax_streams(i, jax_tiles):
    """Exact: decode (K6 plain) of the JAX twin's streams returns the
    block and, as final states, the seeded initial states."""
    spec, K, _ = TILES[i]
    block, hi, lo, init, jgs, _ = jax_tiles[i]
    hi_t, lo_t, _ = convert.o1_kernel_args_from_jax(hi, lo, init,
                                                    device="cpu")
    out, fstates = TK.decode_tile(torch.from_numpy(jgs.copy()), K, hi_t,
                                  lo_t, Geom.parse(spec))
    assert np.array_equal(out.numpy().reshape(K, -1).T, block)
    assert np.array_equal(fstates.numpy(), init)


def test_model_plain_matches_model_pass():
    """Exact: the K7 plain version is the JAX model scan's trajectory,
    packed (low << 16) | freq per slot."""
    spec, K, seed = TILES[0]
    block, hi, lo, init = _tile_args(spec, K, seed)
    L = block.shape[0]
    hi0 = jnp.repeat(jnp.transpose(jnp.asarray(hi), (2, 0, 1)), 128, 0)
    lo0 = jnp.repeat(jnp.transpose(jnp.asarray(lo), (2, 0, 1)), 128, 0)
    want = np.asarray(JR.model_pass(jnp.asarray(block), K, hi0, lo0))
    hi_t, lo_t, _ = convert.o1_kernel_args_from_jax(hi, lo, init,
                                                    device="cpu")
    cols = torch.from_numpy(block.T.copy()).reshape(K, L // 128, 128)
    got = TK.model(cols, hi_t, lo_t, Geom.parse(spec)).numpy()
    assert np.array_equal(got.reshape(2 * K, L),
                          (want[:, 0] << 16) | want[:, 1])


def test_wrappers_check_inputs():
    g = Geom.parse(TINY)
    cols = torch.zeros((2, 2, 128), dtype=torch.uint8)
    hi = torch.zeros((R1.NCTX, 16, 2), dtype=torch.int32)
    lo = torch.zeros((R1.LROWS, 16, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="lo_tbl: shape"):
        TK.model(cols, hi, lo[:16], g)
    with pytest.raises(ValueError, match="hi_tbl: dtype"):
        TK.model(cols, hi.long(), lo, g)
    with pytest.raises(ValueError, match="cols: shape"):
        TK.model(cols, hi, lo, Geom.parse("g4c2s8y2l4a16r4"))
    with pytest.raises(ValueError, match="split-state"):
        TK.decode_tile(torch.zeros((2, 8, 128), dtype=torch.int32), 2, hi,
                       lo, Geom.parse(TINY + "x2"))
    with pytest.raises(ValueError, match="flush-state rows"):
        TK.decode_tile(torch.zeros((2, 1, 128), dtype=torch.int32), 2, hi,
                       lo, g)
    with pytest.raises(ValueError, match="expected"):
        convert.o1_kernel_args_from_jax(np.zeros((16, 2)), lo.numpy(),
                                        np.zeros((2, 128)), device="cpu")


def test_cpu_runs_launch_no_kernel():
    TK.reset_launches()
    T.encode_block(TEXT[:2000], geom=Geom.parse(TINY), device="cpu")
    assert all(v == 0 for v in TK.launches.values())


# ---------------------------------------------------------------------------
# codec payloads
# ---------------------------------------------------------------------------

CASES = [  # (spec, data)
    (TINY, TEXT[:0]),                  # n = 0
    (TINY, TEXT[1000:1300]),           # n < seed bytes
    (TINY, REAL[100_000:105_001]),     # n not a multiple of lanes
    ("g1c8s8y4l32a16r4", TEXT[:9999]),
    ("g2c2s8y2l4a16r4u9", TEXT[20000:27000]),  # rate 9
    (TINY, REAL),                      # >= 512 KB at groups=2: G_eff = 2
]
IDS = [f"{s}-n{d.size}" for s, d in CASES]


@pytest.fixture(scope="module")
def jax_payloads():
    return [J.encode_block(d, use_pallas_encoder=False,
                           geom=JGeom.parse(s)) for s, d in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_encode_block_byte_identical(i, jax_payloads):
    """Exact: the port's payload equals the JAX package's."""
    spec, data = CASES[i]
    got = T.encode_block(data, geom=Geom.parse(spec), device="cpu")
    assert got == jax_payloads[i]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_decode_jax_payload(i, jax_payloads):
    """Exact: the port decodes the JAX package's payload to the input."""
    spec, data = CASES[i]
    out = T.decode_block(jax_payloads[i], data.size, geom=Geom.parse(spec),
                         device="cpu")
    assert np.array_equal(out, data)


def test_corrupt_payloads_raise(jax_payloads):
    spec, data = CASES[2]
    g = Geom.parse(spec)
    good = jax_payloads[2]
    with pytest.raises(ValueError, match="truncated"):
        T.decode_block(good[:2000], data.size, geom=g, device="cpu")
    _, used = blockio.unpack_codes(good[256:], 1, n_entries=R1.N_ENTRIES)
    off = 256 + used  # the glens table
    bad = bytearray(good)
    bad[off:off + 4] = (10 ** 6).to_bytes(4, "little")
    with pytest.raises(ValueError, match="group length"):
        T.decode_block(bytes(bad), data.size, geom=g, device="cpu")
    with pytest.raises(ValueError, match="group length"):
        T.decode_block(good[:-2], data.size, geom=g, device="cpu")
    bad = bytearray(good)
    bad[off + 8:off + 10] = b"\xff\xff"  # group 0, lane 0: flush state hi16
    with pytest.raises(ValueError, match="final coder states"):
        T.decode_block(bytes(bad), data.size, geom=g, device="cpu")


def test_split_state_raises_value_error():
    """As in the JAX package, the o1 format has no nstates=2: both entry
    points raise ValueError."""
    g = Geom.parse(TINY + "x2")
    with pytest.raises(ValueError, match="split-state"):
        T.encode_block(TEXT[:100], geom=g, device="cpu")
    with pytest.raises(ValueError, match="split-state"):
        T.decode_block(b"\0" * 4000, 100, geom=g, device="cpu")
