"""The port's bit-tree codec rc-p (id 8) against the JAX package.

On the CPU the wrappers in ``turborc_tpu_torch.ops.bittree_kernel`` run
their kernels' plain versions; the CUDA kernels are held against the same
plain versions on the GPU by ``chip_smoke.py``.  The oracle is the JAX
package's XLA twin (``bittree_kernel.encode_tile``,
``rc_tree.encode_block(..., use_pallas_encoder=False)``); it has no twin
of the decode kernel, so the port decodes the JAX package's payloads.
No Pallas kernel runs here.  Every comparison is exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turborc_tpu.codecs import rc_tree as J
from turborc_tpu.ops import rans as jrans
from turborc_tpu.ops.pallas import bittree_kernel as JB
from turborc_tpu.ops.pallas.geom import Geom as JGeom
from turborc_tpu_torch import CodecConfig, api, convert
from turborc_tpu_torch.codecs import rc_tree as T
from turborc_tpu_torch.codecs import registry
from turborc_tpu_torch.ops import bittree_kernel as TB
from turborc_tpu_torch.ops.geom import Geom

TINY = "g2c2s8y2l4a16r4"       # 256 lanes, 480 seed bytes
TEXT = np.fromfile(J.__file__.replace("codecs/rc_tree.py",
                                      "bench/_data/textbwt_65536.bin"),
                   np.uint8)


def _skewed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.3
    return rng.choice(256, size=n, p=p / p.sum()).astype(np.uint8)


CASES = [  # (spec, data): groups 1, 2 and 4, chunk 2 and 8, n = 0,
    (TINY, _skewed(3000, 3)),             # n < seed bytes, several K
    ("g1c8s8y4l32a16r4", TEXT[:9000]),
    ("g4c2s8y2l4a16r4", TEXT[5000:12001]),
    ("g2c8s8y4l32a16r4", TEXT[20000:26000]),
    (TINY, TEXT[100:400]),
    (TINY, TEXT[:0]),
]
IDS = [f"{s}-n{d.size}" for s, d in CASES]
TILE_K, TILE_SPEC = 8, TINY


def _twin_probs(block, tree, spec):
    """The JAX XLA twin's slot probabilities ((low<<16)|w, [2K, L]): its
    body runs eagerly and its call to ``rans.encode_backward`` is
    captured."""
    got = {}

    def capture(lows, freqs, init_state=None):
        got["probs"] = (np.asarray(lows) << 16) | np.asarray(freqs)
        raise StopIteration

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jrans, "encode_backward", capture)
        with pytest.raises(StopIteration):
            JB.encode_tile(jnp.asarray(block.astype(np.int32)),
                           block.shape[1], jnp.asarray(tree),
                           geom=JGeom.parse(spec))
    return got["probs"]


@pytest.fixture(scope="module")
def jax_ref():
    """Every live JAX call of this file, at tiny geometries: the payloads
    of CASES, and one seeded tile's warm tree, slot probabilities, group
    streams and initial states."""
    rng = np.random.default_rng(5)
    g = Geom.parse(TILE_SPEC)
    block = _skewed(g.lanes * TILE_K, 9).reshape(g.lanes, TILE_K)
    tree = JB.warm_tree(block.reshape(-1))
    init = ((1 << 15) | rng.integers(0, 1 << 15, (g.groups, 128))).astype(
        np.int32)
    gs, gl = JB.encode_tile(jnp.asarray(block.astype(np.int32)), TILE_K,
                            jnp.asarray(tree), jnp.asarray(init),
                            geom=JGeom.parse(TILE_SPEC))
    return dict(
        payloads=[J.encode_block(d, use_pallas_encoder=False,
                                 geom=JGeom.parse(s)) for s, d in CASES],
        block=block, tree=tree, init=init, gstreams=np.asarray(gs),
        glens=np.asarray(gl), probs=_twin_probs(block, tree, TILE_SPEC))


WARM = [TEXT[:0], TEXT[:1], np.full(5000, 200, np.uint8), _skewed(4000, 1),
        np.arange(256, dtype=np.uint8), TEXT]


@pytest.mark.parametrize("i", range(len(WARM)),
                         ids=[f"warm{i}" for i in range(len(WARM))])
def test_warm_tree_equals_jax(i):
    """Exact: the port's copy of warm_tree gives the JAX package's tree."""
    got = TB.warm_tree(WARM[i])
    assert got.dtype == np.int32
    assert np.array_equal(got, JB.warm_tree(WARM[i]))


def _cols(block: np.ndarray, G: int) -> torch.Tensor:
    return torch.from_numpy(block.T.copy().reshape(block.shape[1], G, 128))


def test_tree_model_plain_equals_twin_probs(jax_ref):
    """Exact: K9's plain version gives the XLA twin's slot probabilities."""
    g = Geom.parse(TILE_SPEC)
    probs = TB.tree_model(_cols(jax_ref["block"], g.groups),
                          convert.tree_from_jax(jax_ref["tree"],
                                                device="cpu"), g)
    assert np.array_equal(probs.numpy().reshape(2 * TILE_K, -1),
                          jax_ref["probs"])


def test_encode_tile_equals_twin(jax_ref):
    """Exact: K9 -> K3 -> K4 gives the twin's group streams (every row) and
    lengths."""
    g = Geom.parse(TILE_SPEC)
    gs, gl = TB.encode_tile(torch.from_numpy(jax_ref["block"]), TILE_K,
                            convert.tree_from_jax(jax_ref["tree"],
                                                  device="cpu"),
                            torch.from_numpy(jax_ref["init"]), g)
    assert np.array_equal(gs.numpy(), jax_ref["gstreams"])
    assert np.array_equal(gl.numpy(), jax_ref["glens"])


def test_tree_decode_of_twin_streams(jax_ref):
    """Exact: K8's plain version decodes the twin's streams to the block,
    and its final states are the seeded initial states."""
    g = Geom.parse(TILE_SPEC)
    out, fstates = TB.tree_decode_tile(
        torch.from_numpy(jax_ref["gstreams"].astype(np.int32)), TILE_K,
        convert.tree_from_jax(jax_ref["tree"], device="cpu"), g)
    assert np.array_equal(out.numpy().reshape(TILE_K, -1).T,
                          jax_ref["block"])
    assert np.array_equal(fstates.numpy(), jax_ref["init"])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_encode_block_byte_identical(i, jax_ref):
    """Exact: the port's payload equals the JAX package's."""
    spec, data = CASES[i]
    got = T.encode_block(data, geom=Geom.parse(spec), device="cpu")
    assert got == jax_ref["payloads"][i]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_decode_jax_payload(i, jax_ref):
    """Exact: the port decodes the JAX package's payload to the input."""
    spec, data = CASES[i]
    out = T.decode_block(jax_ref["payloads"][i], data.size,
                         geom=Geom.parse(spec), device="cpu")
    assert np.array_equal(out, data)


def test_corrupt_payloads_raise(jax_ref):
    """The reference's checks: header length, tree range, the group length
    table against R*128, 256 and the word count, and the final states."""
    spec, data = CASES[0]
    g = Geom.parse(spec)
    good = jax_ref["payloads"][0]

    def dec(p):
        return T.decode_block(bytes(p), data.size, geom=g, device="cpu")

    with pytest.raises(ValueError, match="truncated header"):
        dec(good[:510 + 4 * g.groups - 1])
    for node_word in (b"\x00\x00", b"\x00\x80"):  # 0 and 32768
        bad = bytearray(good)
        bad[20:22] = node_word
        with pytest.raises(ValueError, match="bad warm-start tree"):
            dec(bad)
    K = T._K_for(data.size - 480, g)
    for glen in ((2 * K + 2 + g.wrows) * 128 + 1, 255):
        bad = bytearray(good)
        bad[510:514] = glen.to_bytes(4, "little")
        with pytest.raises(ValueError, match="group length"):
            dec(bad)
    with pytest.raises(ValueError, match="group length"):
        dec(good[:-2])
    bad = bytearray(good)
    word0 = 510 + 4 * g.groups  # group 0, lane 0: flush state hi16
    bad[word0:word0 + 2] = b"\xff\xff"
    with pytest.raises(ValueError, match="final coder states"):
        dec(bad)


@pytest.mark.parametrize("spec", [TINY + "x2", TINY + "u9"])
def test_format_errors_match_jax(spec):
    """x2 and rate != 7 raise the reference's ValueError, on both sides."""
    data = TEXT[:1000]
    with pytest.raises(ValueError) as jerr:
        J.encode_block(data, use_pallas_encoder=False, geom=JGeom.parse(spec))
    for call in (lambda: T.encode_block(data, geom=Geom.parse(spec),
                                        device="cpu"),
                 lambda: T.decode_block(b"\0" * 600, 1000,
                                        geom=Geom.parse(spec),
                                        device="cpu")):
        with pytest.raises(ValueError) as err:
            call()
        assert str(err.value) == str(jerr.value)


def test_tree_entries_stay_in_range():
    """Every entry after an update lies in [1, 32767] (so the kernels'
    u16 trees are exact): each p in [1, 32767] (and values the clamp
    brings there) with each bit, down all four levels."""
    ps = np.concatenate([np.arange(1, 1 << 15), [0, -5, 1 << 15, 40000]])
    for bit in (0, 1):
        tree = torch.from_numpy(np.repeat(ps, 256).reshape(-1, 256))
        node = torch.ones(ps.size, dtype=torch.int64)
        TB._descend(tree, node, lambda lvl, low, s: torch.full_like(s, bit))
        path = [1, 2 + bit, 4 + 3 * bit, 8 + 7 * bit]
        upd = tree[:, path]
        assert int(upd.min()) >= 1 and int(upd.max()) <= (1 << 15) - 1
        p = torch.from_numpy(ps).clamp(1, (1 << 15) - 1)[:, None]
        assert torch.equal(upd, (p - (((p - (bit << 15)) >> 5) + bit))
                           .expand(-1, 4))


def test_tree_from_jax():
    tree = JB.warm_tree(TEXT)
    t = convert.tree_from_jax(tree, device="cpu")
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), tree)
    with pytest.raises(ValueError, match="shape"):
        convert.tree_from_jax(tree[1:], device="cpu")
    for v in (0, 1 << 15):
        bad = tree.copy()
        bad[7] = v
        with pytest.raises(ValueError, match=r"\[1, 32767\]"):
            convert.tree_from_jax(bad, device="cpu")


def test_wrappers_reject_bad_inputs_and_launch_nothing(jax_ref):
    g = Geom.parse(TILE_SPEC)
    tree = convert.tree_from_jax(jax_ref["tree"], device="cpu")
    cols = _cols(jax_ref["block"], g.groups)
    TB.reset_launches()
    with pytest.raises(ValueError):
        TB.tree_model(cols.to(torch.int32), tree, g)
    with pytest.raises(ValueError):
        TB.tree_model(cols, tree[1:], g)
    with pytest.raises(ValueError):
        TB.tree_model(cols, tree, Geom.parse("g4c2s8y2l4a16r4"))
    with pytest.raises(ValueError, match="split-state"):
        TB.tree_model(cols, tree, Geom.parse(TINY + "x2"))
    with pytest.raises(ValueError, match="flush-state rows"):
        TB.tree_decode_tile(torch.zeros((2, 1, 128), dtype=torch.int32), 2,
                            tree, g)
    TB.encode_tile(torch.from_numpy(jax_ref["block"]), TILE_K, tree,
                   torch.from_numpy(jax_ref["init"]), g)
    assert all(v == 0 for v in TB.launches.values())


def test_api_round_trip_and_registry():
    """Through the public API, several blocks, as id 8."""
    data = TEXT[:9000]
    cfg = CodecConfig(codec="rc-p", block_size=4096, geom=Geom.parse(TINY))
    blob = api.compress(data, cfg, device="cpu")
    assert api.decompress(blob, device="cpu") == data.tobytes()
    assert registry.get(8) is registry.get("rc-p")
