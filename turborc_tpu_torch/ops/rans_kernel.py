"""The flagship's four kernels: wrappers, launch counts and plain versions.

Counterpart of ``turborc_tpu/ops/pallas/rans_kernel.py``.  Tiles are
``[*, G, 128]``: G = ``Geom.groups`` groups of 128 lanes.  Each group owns
one stream of u16 words (held in int32) in consumption order: rows 0/1 are
the lanes' flush states (hi16, lo16), data words follow from word 256 in
the order the group's lanes renormalise, step-major and lane-minor.

Kernel (CUDA, ``csrc/rans_kernel.cu``)   replaces (TPU)        plain version
  model   K2: bytes -> slot probs         _make_model_kernel    model_plain
  coder   K3: backward rANS               _make_coder_kernel    coder_plain
  place   K4: words -> group streams      _make_place_kernel    place_plain
  decode  K1: group streams -> bytes      _make_decode_kernel   decode_plain
  decode_x2  K5: split-state decode       _make_decode_kernel_x2
                                                                decode_x2_plain

Under a split-state geometry (``Geom.nstates == 2``, spec suffix ``x2``)
each lane has two coder states: state 0 codes the hi nibbles into stream
set 0, state 1 the lo nibbles into set 1, one shared model.  The encode
side runs the same model, then coder and placement once per set on the
even and odd slots.
A wrapper validates its inputs, then runs the plain version when they lie
on the CPU and launches the kernel when they lie on a CUDA device; there
is no fallback from one to the other.  ``launches[name]`` counts kernel
launches only.  The plain versions follow the JAX package's XLA twin
(``encode_tile`` / ``_group_stitch``) step for step; the decoder has no
XLA twin there and is written from the decode kernel's semantics.
"""
from __future__ import annotations

import dataclasses

import torch

from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.models import span as S8
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops.geom import DEFAULT, Geom

GLANES = 128

# The launches of K1, K2 and K5 (csrc/rans_kernel.cu): one thread per lane,
# one CTA per group, the tables in shared memory as decode_launch and
# model_launch carve it.  The decoders stage, per stream set, a ring of
# RING_WORDS stream words, topped up every RING_EVERY fetches with at most
# RING_LAG top-ups in flight; K2 stages its input bytes COL_STEPS byte
# steps at a time, one stage ahead (a ring of two stages).  K4 runs two
# launches over G x chunks CTAs of PLACE_THREADS threads, PLACE_CHUNK
# slots each (place_launch).  The sources (csrc/rans_kernel.cu; the ring's
# numbers and SMEM_MAX in csrc/rans_common.cuh) hold the same numbers
# (kRingWords, kRingEvery, kRingLag, kColSteps, kPlaceChunk,
# kPlaceThreads); their C entries refuse a launch that does not match.
# K3 plans its own launch from S and G: CTAs of CODER_LANES lanes, each
# staging its probs CODER_SLOTS slots at a time in CODER_BUFS buffers
# beside a table of the reciprocals of every 15-bit frequency (div_magic);
# the numbers here are the source's kCoderLanes, kCoderSlots, kCoderBufs,
# for the tests' mirror of the plan.  The o1 decoder K6 and the bit-tree
# decoder K8 share the ring (ops/rans_o1_kernel.py, ops/bittree_kernel.py).
RING_WORDS = 4096
RING_EVERY = 8
RING_LAG = 1
FETCH_WORDS = GLANES   # most words one fetch takes from one stream set
COL_STEPS = 64
PLACE_CHUNK = 64
PLACE_THREADS = 256
CODER_LANES = 64
CODER_SLOTS = 64
CODER_BUFS = 3
SMEM_MAX = 232_448     # shared-memory bytes a CTA may have on the H100
REGIONS = ("ring", "lo", "st", "fixed", "red", "rank")
MODEL_REGIONS = ("cols", "lo", "st", "fixed", "red")
INT32_MAX = 2**31 - 1

launches = dict.fromkeys(("model", "coder", "place", "decode", "decode_x2"),
                         0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain versions (torch, any device)
# ---------------------------------------------------------------------------

def _lane_tables(hi_tbl: torch.Tensor, lo_tbl: torch.Tensor):
    """Per-group warm tables hi [16, G], lo [16, 16, G] -> per-lane
    hi [L, 16], lo [L, 16, 16] int64 (lane l is in group l // 128)."""
    hi = hi_tbl.to(torch.int64).T.repeat_interleave(GLANES, 0)
    lo = lo_tbl.to(torch.int64).permute(2, 0, 1).repeat_interleave(GLANES, 0)
    return hi, lo


def _rejoin(t: int, g: Geom, hi, lo, start_hi, start_lo):
    """Cross-lane re-joins after byte t (hot every sync bytes, cold every
    lsync bytes), as the XLA twin's win/fwd scans order them."""
    if g.share == 1:
        return hi, lo, start_hi, start_lo
    if t % g.sync == g.sync - 1:
        hi = S8._sync(hi, start_hi, g.share)
        start_hi = hi
        lo, start_lo = S8._sync_lo_hot(lo, start_lo, g.share, g.srows)
    if (t + 1) % g.lsync == 0:
        if g.arows > g.srows:
            lo = S8._sync_lo_cold(lo, start_lo, g.share, g.srows)
        start_lo = lo
    return hi, lo, start_hi, start_lo


def model_plain(cols: torch.Tensor, hi_tbl: torch.Tensor,
                lo_tbl: torch.Tensor, geom: Geom = DEFAULT) -> torch.Tensor:
    """cols [K, G, 128] bytes -> probs [2K, G, 128] int32 ((low<<16)|freq;
    hi nibble at slot 2t, lo nibble at 2t+1)."""
    K, G, _ = cols.shape
    L = G * GLANES
    hi, lo = _lane_tables(hi_tbl, lo_tbl)
    start_hi, start_lo = hi, lo
    probs = torch.empty((2 * K, L), dtype=torch.int64, device=cols.device)
    for t in range(K):
        hi, lo, low_h, fr_h, low_l, fr_l = S8._code_byte(
            hi, lo, cols[t].reshape(L).to(torch.int64), geom.arows,
            geom.rate)
        probs[2 * t] = (low_h << 16) | fr_h
        probs[2 * t + 1] = (low_l << 16) | fr_l
        hi, lo, start_hi, start_lo = _rejoin(t, geom, hi, lo, start_hi,
                                             start_lo)
    return probs.reshape(2 * K, G, GLANES).to(torch.int32)


def coder_plain(probs: torch.Tensor, init_states: torch.Tensor):
    """probs [S, G, 128], init [G, 128] -> (words [S, G, 128] int32, emit
    [S, G, 128] uint8, flush states [G, 128] int32)."""
    S, G, _ = probs.shape
    p = probs.reshape(S, G * GLANES).to(torch.int64)
    words, emit, state = rans.encode_backward(p >> 16, p & 0xFFFF,
                                              init_states.reshape(-1))
    return (words.reshape(S, G, GLANES).to(torch.int32),
            emit.reshape(S, G, GLANES).to(torch.uint8),
            state.reshape(G, GLANES).to(torch.int32))


def place_plain(words: torch.Tensor, emit: torch.Tensor,
                state: torch.Tensor, geom: Geom = DEFAULT):
    """words/emit [S, G, 128], flush states [G, 128] -> (gstreams
    [G, R, 128] int32, glens [G] int32), R = S + 2 + wrows (JAX
    ``_group_stitch``)."""
    S, G, _ = words.shape
    R = S + 2 + geom.wrows
    dev = words.device
    e = emit.to(torch.int64).permute(1, 0, 2).reshape(G, S * GLANES)
    pos = 256 + torch.cumsum(e, 1) - e
    w = words.to(torch.int32).permute(1, 0, 2).reshape(G, S * GLANES)
    m = e != 0
    gi = torch.arange(G, device=dev)[:, None].expand(G, S * GLANES)
    out = torch.zeros((G, R * GLANES), dtype=torch.int32, device=dev)
    out[gi[m], pos[m]] = w[m]
    st = state.to(torch.int64).reshape(G, GLANES) & rans.MASK32
    out[:, :GLANES] = (st >> 16).to(torch.int32)
    out[:, GLANES:2 * GLANES] = (st & 0xFFFF).to(torch.int32)
    glens = (256 + e.sum(1)).to(torch.int32)
    return out.reshape(G, R, GLANES), glens


def stream_reader(gstreams: torch.Tensor):
    """Group streams [G, R, 128] -> (initial states [G*128] int64,
    fetch): ``fetch(state)`` renormalises the lanes with state < 2^15,
    each taking the next word of its group's stream in lane order across
    all 128 lanes (reads past R*128 words give 0), and returns the new
    states.  The decoders' plain versions share it."""
    G, R, _ = gstreams.shape
    flat = gstreams.reshape(G, R * GLANES).to(torch.int64)
    limit = R * GLANES
    state = ((flat[:, :GLANES] << 16) | flat[:, GLANES:2 * GLANES]) \
        & rans.MASK32
    pos = torch.full((G, 1), 256, dtype=torch.int64, device=flat.device)

    def fetch(state):
        nonlocal pos
        need = (state < rans.ANS_LOW).reshape(G, GLANES).to(torch.int64)
        idx = pos + torch.cumsum(need, 1) - need
        word = torch.gather(flat, 1, idx.clamp(max=limit - 1))
        word = torch.where(idx < limit, word, 0).reshape(-1)
        pos = pos + need.sum(1, keepdim=True)
        return rans.dec_renorm(state, word)

    return state.reshape(-1), fetch


def decode_plain(gstreams: torch.Tensor, K: int, hi_tbl: torch.Tensor,
                 lo_tbl: torch.Tensor, geom: Geom = DEFAULT):
    """gstreams [G, R, 128] -> (bytes [K, G, 128] uint8, final states
    [G, 128] int32).  Per nibble: search, state transition, then the
    group-ordered word fetch of ``stream_reader``."""
    G = gstreams.shape[0]
    L = G * GLANES
    dev = gstreams.device
    state, fetch = stream_reader(gstreams)
    hi, lo = _lane_tables(hi_tbl, lo_tbl)
    start_hi, start_lo = hi, lo
    out = torch.empty((K, L), dtype=torch.uint8, device=dev)
    for t in range(K):
        hs, low_h, fr_h = cdf16.search(hi, state & rans.MASK15)
        state = fetch(rans.dec_update(state, low_h, fr_h))
        hi = cdf16.update_rate(hi, low_h, geom.rate)
        row = S8._lo_row(lo, hs)
        ls, low_l, fr_l = cdf16.search(row, state & rans.MASK15)
        state = fetch(rans.dec_update(state, low_l, fr_l))
        new_row = cdf16.update_rate(row, low_l, geom.rate)
        if geom.arows < 16:
            new_row = torch.where((hs < geom.arows)[:, None], new_row, row)
        lo = S8._lo_put(lo, hs, new_row)
        out[t] = ((hs << 4) | ls).to(torch.uint8)
        hi, lo, start_hi, start_lo = _rejoin(t, geom, hi, lo, start_hi,
                                             start_lo)
    return (out.reshape(K, G, GLANES),
            state.reshape(G, GLANES).to(torch.int32))


def decode_x2_plain(gstreams: torch.Tensor, K: int, hi_tbl: torch.Tensor,
                    lo_tbl: torch.Tensor, geom: Geom = DEFAULT):
    """Split-state decode: gstreams [2, G, R, 128] (hi set first) ->
    (bytes [K, G, 128] uint8, final states [2, G, 128] int32).  Per byte:
    the hi search, state step and fetch on state 0 / set 0, then the lo
    search in the row that hi selects, state step and fetch on state 1 /
    set 1; model and re-joins as ``decode_plain``."""
    G = gstreams.shape[1]
    L = G * GLANES
    (st_h, fetch_h), (st_l, fetch_l) = map(stream_reader, gstreams)
    hi, lo = _lane_tables(hi_tbl, lo_tbl)
    start_hi, start_lo = hi, lo
    out = torch.empty((K, L), dtype=torch.uint8, device=gstreams.device)
    for t in range(K):
        hs, low_h, fr_h = cdf16.search(hi, st_h & rans.MASK15)
        st_h = fetch_h(rans.dec_update(st_h, low_h, fr_h))
        hi = cdf16.update_rate(hi, low_h, geom.rate)
        row = S8._lo_row(lo, hs)
        ls, low_l, fr_l = cdf16.search(row, st_l & rans.MASK15)
        st_l = fetch_l(rans.dec_update(st_l, low_l, fr_l))
        new_row = cdf16.update_rate(row, low_l, geom.rate)
        if geom.arows < 16:
            new_row = torch.where((hs < geom.arows)[:, None], new_row, row)
        lo = S8._lo_put(lo, hs, new_row)
        out[t] = ((hs << 4) | ls).to(torch.uint8)
        hi, lo, start_hi, start_lo = _rejoin(t, geom, hi, lo, start_hi,
                                             start_lo)
    return (out.reshape(K, G, GLANES),
            torch.stack([st_h, st_l]).reshape(2, G, GLANES).to(torch.int32))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_tables(hi_tbl, lo_tbl, G: int, device) -> None:
    _check("hi_tbl", hi_tbl, torch.int32, (16, G), device)
    _check("lo_tbl", lo_tbl, torch.int32, (16, 16, G), device)


def _check_geom(geom: Geom, G: int) -> None:
    if geom.groups != G:
        raise ValueError(f"tile has {G} groups, geometry {geom.spec} "
                         f"has {geom.groups}")


def launch(name: str, fn: str, *args, counts: dict = launches,
           kernels: int = 1) -> None:
    """Launch C entry ``fn`` on the current stream (tensors are passed as
    device pointers), raise on a CUDA error, count its ``kernels`` kernel
    launches in ``counts[name]``."""
    from turborc_tpu_torch.ops import build
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = build.load()[fn](*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counts[name] += kernels


def model(cols: torch.Tensor, hi_tbl: torch.Tensor, lo_tbl: torch.Tensor,
          geom: Geom = DEFAULT) -> torch.Tensor:
    """K2: cols [K, G, 128] uint8 -> probs [2K, G, 128] int32."""
    K, G = cols.shape[0], geom.groups
    _check("cols", cols, torch.uint8, (K, G, GLANES), cols.device)
    _check_tables(hi_tbl, lo_tbl, G, cols.device)
    _check_geom(geom, G)
    if not cols.is_cuda:
        return model_plain(cols, hi_tbl, lo_tbl, geom)
    if cols.data_ptr() % 16:  # the stage copies 16 bytes at a time
        raise ValueError("cols: must be 16-byte aligned")
    probs = torch.empty((2 * K, G, GLANES), dtype=torch.int32,
                        device=cols.device)
    launch("model", "trc_model",
           *model_cargs(cols, hi_tbl, lo_tbl, probs, geom))
    return probs


def coder(probs: torch.Tensor, init_states: torch.Tensor):
    """K3: probs [S, G, 128] int32, init [G, 128] int32 -> (words int32,
    emit uint8, flush states int32)."""
    S, G = probs.shape[0], probs.shape[1]
    _check("probs", probs, torch.int32, (S, G, GLANES), probs.device)
    _check("init_states", init_states, torch.int32, (G, GLANES),
           probs.device)
    if not probs.is_cuda:
        return coder_plain(probs, init_states)
    if probs.data_ptr() % 16:  # the stages copy 16 bytes at a time
        raise ValueError("probs: must be 16-byte aligned")
    words = torch.empty((S, G, GLANES), dtype=torch.int32,
                        device=probs.device)
    emit = torch.empty((S, G, GLANES), dtype=torch.uint8,
                       device=probs.device)
    state = torch.empty((G, GLANES), dtype=torch.int32, device=probs.device)
    launch("coder", "trc_coder",
           *coder_cargs(probs, init_states, words, emit, state))
    return words, emit, state


def div_magic(freq):
    """K3's reciprocal of ``freq`` (1 to 2^15, an int or an int64 array):
    (m, l) such that ``x // freq == ((2 * x * m) >> 32) >> l`` for every
    0 <= x < 2^31.  l = ceil(log2 freq), m = floor(2^47 / dn) + 1 with dn
    = freq << (16 - l), from two 32-bit divisions (a mirror of
    ``csrc/rans_common.cuh``'s ``div_magic``, which K3 and L2 share)."""
    l = sum(((freq - 1) >> k) > 0 for k in range(16))  # bit length
    dn = freq << (16 - l)
    q1 = (1 << 31) // dn
    m = (q1 << 16) + ((((1 << 31) - q1 * dn) << 16) // dn) + 1
    return m, l


def coder_cargs(probs, init_states, words, emit, state) -> list:
    """The arguments of ``trc_coder`` (without the stream): the tile, S
    and G (the C entry derives its launch from them)."""
    return [probs, init_states, words, emit, state, probs.shape[0],
            probs.shape[1]]


def place(words: torch.Tensor, emit: torch.Tensor, state: torch.Tensor,
          geom: Geom = DEFAULT):
    """K4: words [S, G, 128] int32, emit uint8, flush states [G, 128] ->
    (gstreams [G, R, 128] int32, glens [G] int32)."""
    S, G = words.shape[0], geom.groups
    dev = words.device
    _check("words", words, torch.int32, (S, G, GLANES), dev)
    _check("emit", emit, torch.uint8, (S, G, GLANES), dev)
    _check("state", state, torch.int32, (G, GLANES), dev)
    if not words.is_cuda:
        return place_plain(words, emit, state, geom)
    R = S + 2 + geom.wrows
    if R * GLANES > INT32_MAX:  # glens and stream positions are int32
        raise ValueError(f"{S} slots exceed the int32 stream positions")
    ln = place_launch(S, G, R)
    if emit.data_ptr() % 16:  # 16-byte loads of emit
        raise ValueError("emit: must be 16-byte aligned")
    gstreams = torch.empty((G, R, GLANES), dtype=torch.int32, device=dev)
    glens = torch.empty((G,), dtype=torch.int32, device=dev)
    counts = torch.empty((ln.scratch,), dtype=torch.int32, device=dev)
    launch("place", "trc_place",
           *place_cargs(words, emit, state, gstreams, glens, counts, ln),
           kernels=2)  # count, then place
    return gstreams, glens


@dataclasses.dataclass(frozen=True)
class PlaceLaunch:
    """K4's launch over S slots of G groups: ``chunk`` slots a CTA,
    ``chunks`` CTAs a group, ``grid`` = G x chunks CTAs of ``threads``
    threads in each of its two launches (count, then place), and
    ``scratch`` int32 chunk counts, allocated by the wrapper."""
    S: int
    G: int
    R: int
    chunk: int
    chunks: int
    threads: int
    grid: int
    scratch: int


def place_launch(S: int, G: int, R: int) -> PlaceLaunch:
    """K4's launch plan (the C entry ``trc_place`` re-checks it)."""
    chunks = max(1, -(-S // PLACE_CHUNK))
    return PlaceLaunch(S, G, R, PLACE_CHUNK, chunks, PLACE_THREADS,
                       G * chunks, G * chunks)


def place_cargs(words, emit, state, gstreams, glens, counts,
                ln: PlaceLaunch) -> list:
    """The arguments of ``trc_place`` (without the stream)."""
    return [words, emit, state, gstreams, glens, counts, ln.S, ln.G, ln.R,
            ln.chunk, ln.chunks, ln.threads, ln.scratch]


def decode_tile(gstreams: torch.Tensor, K: int, hi_tbl: torch.Tensor,
                lo_tbl: torch.Tensor, geom: Geom = DEFAULT):
    """K1: gstreams [G, R, 128] int32 -> (bytes [K, G, 128] uint8, final
    states [G, 128] int32; the final states carry the 15-bit seeds)."""
    if geom.nstates != 1:
        raise ValueError(f"geometry {geom.spec} is split-state: decode it "
                         "with decode_tile_x2")
    return _decode(gstreams, K, hi_tbl, lo_tbl, geom)


def decode_tile_x2(gstreams: torch.Tensor, K: int, hi_tbl: torch.Tensor,
                   lo_tbl: torch.Tensor, geom: Geom = DEFAULT):
    """K5: gstreams [2, G, R, 128] int32 (hi set first) -> (bytes
    [K, G, 128] uint8, final states [2, G, 128] int32)."""
    if geom.nstates != 2:
        raise ValueError(f"geometry {geom.spec} has one state: decode it "
                         "with decode_tile")
    return _decode(gstreams, K, hi_tbl, lo_tbl, geom)


@dataclasses.dataclass(frozen=True)
class TableLaunch:
    """The launch of K1, K5 (``REGIONS``) or K2 (``MODEL_REGIONS``):
    threads per CTA, dynamic shared-memory bytes, and the byte offset and
    size of each region: the stage (the decoders' stream rings, K2's
    ring of input bytes), the adaptive lo rows per lane, their re-join
    start copies, the static lo rows (once per group), the cross-warp set
    sums and, for the decoders, the per-warp rank counts (one byte a
    warp, double-buffered)."""
    threads: int
    smem: int
    offsets: tuple
    sizes: tuple


def table_launch(sizes: tuple) -> TableLaunch:
    """One thread a lane, and regions of ``sizes`` bytes in order, each at
    a 16-byte-aligned offset (K1, K2, K5 and the o1 decoder K6)."""
    offsets, end = [], 0
    for size in sizes:
        offsets.append(end)
        end += -(-size // 16) * 16
    return TableLaunch(GLANES, end, tuple(offsets), tuple(sizes))


def _carve(geom: Geom, stage: int, rank: tuple) -> TableLaunch:
    warps = GLANES // 32
    return table_launch((stage,
                         geom.arows * GLANES * 32,
                         (geom.arows if geom.share > 1 else 0) * GLANES * 32,
                         (16 - geom.arows) * 32,
                         warps * 16 * 4 if geom.share > 32 else 0,
                         *rank))


def decode_launch(geom: Geom) -> TableLaunch:
    """The decoders' launch for ``geom``."""
    ns = geom.nstates
    return _carve(geom, ns * RING_WORDS * 4, (2 * ns * (GLANES // 32),))


def model_launch(geom: Geom) -> TableLaunch:
    """K2's launch for ``geom`` (one model for one or two stream sets):
    a ring of two stages of COL_STEPS byte steps x 128 lanes."""
    return _carve(geom, 2 * COL_STEPS * GLANES, ())


def model_cargs(cols, hi_tbl, lo_tbl, probs, geom: Geom) -> list:
    """The arguments of ``trc_model`` (without the stream): the tile, the
    geometry and ``model_launch``'s numbers."""
    ln = model_launch(geom)
    return [cols, hi_tbl, lo_tbl, probs, cols.shape[0], geom.groups,
            geom.share, geom.sync, geom.lsync, geom.arows, geom.srows,
            geom.rate, ln.threads, ln.smem, *ln.offsets]


def ring_top_up(base: int, limit: int, ring: int = RING_WORDS) -> int:
    """The ring's frontier after a top-up at a fetch that starts at stream
    position ``base``: every position below it has been requested."""
    return min((base + ring) & ~3, limit)


def ring_check(takes, limit: int, ring: int = RING_WORDS,
               every: int = RING_EVERY, lag: int = RING_LAG) -> None:
    """Replay the decoders' ring on one stream set (a mirror of
    ``csrc/rans_common.cuh``'s ``Ring``): ``takes[f]`` words (0-128) are
    read at fetch f from a stream of ``limit`` words.  Raises
    AssertionError where a fetch would read a word that has not arrived,
    or a top-up would overwrite a word that a fetch may still read.

    The kernel prefills positions [256, 256 + ring).  Fetch f is a top-up
    fetch when f % every == 0: before its barrier the CTA waits until at
    most ``lag`` of its copy groups are in flight.  The lanes read
    [base, base + take) after the barrier (positions at or past ``limit``
    read 0 and need no slot); a top-up fetch then requests
    [frontier, ring_top_up(base)) as one group; base advances."""
    slot = {}        # ring slot -> stream position it holds
    arrived = set()  # slots whose word is visible to every thread
    hi = min(256 + ring, limit)
    for p in range(256, hi):
        slot[p % ring] = p
        arrived.add(p % ring)
    base, groups = 256, []
    for f, take in enumerate(takes):
        assert 0 <= take <= FETCH_WORDS
        top = f % every == 0
        if top:
            while len(groups) > lag:
                arrived.update(groups.pop(0))
        for p in range(base, min(base + take, limit)):
            s = p % ring
            assert slot.get(s) == p and s in arrived, \
                f"position {p} read before it arrived"
        if top:
            to = ring_top_up(base, limit, ring)
            assert to - hi <= FETCH_WORDS * every, "top-up too large"
            group = []
            for q in range(hi, to):
                s = q % ring
                assert slot.get(s, -1) < base, \
                    f"position {q} overwrites unread position {slot[s]}"
                slot[s] = q
                arrived.discard(s)
                group.append(s)
            groups.append(group)
            hi = max(hi, to)
        base = min(base + take, limit)


def check_ring_stream(gstreams: torch.Tensor) -> None:
    """What a decoder on the ring (K1, K5, K6, K8) needs of its streams
    [..., R, 128] int32, on every device alike: int32 stream positions
    (R * 128 and two rings past it) and 16-byte alignment (the ring copies
    16 bytes at a time).  Raises ValueError otherwise."""
    R = gstreams.shape[-2]
    if R * GLANES > INT32_MAX - 2 * RING_WORDS:
        raise ValueError(f"gstreams: {R} rows exceed the int32 positions")
    if gstreams.data_ptr() % 16:
        raise ValueError("gstreams: must be 16-byte aligned")


def decode_cargs(gstreams, K: int, hi_tbl, lo_tbl, geom: Geom, out,
                 fstates) -> list:
    """The arguments of ``trc_decode`` / ``trc_decode_x2`` (without the
    stream): the tile, the geometry and ``decode_launch``'s numbers."""
    ln = decode_launch(geom)
    return [gstreams, hi_tbl, lo_tbl, out, fstates, K, geom.groups,
            gstreams.shape[-2], geom.share, geom.sync, geom.lsync,
            geom.arows, geom.srows, geom.rate, ln.threads, ln.smem,
            *ln.offsets]


def _decode(gstreams, K, hi_tbl, lo_tbl, geom):
    """K1 (one state) or K5 (two): the checks and the dispatch."""
    G, R, ns = geom.groups, gstreams.shape[-2], geom.nstates
    dev = gstreams.device
    lead = (ns,) if ns == 2 else ()
    _check("gstreams", gstreams, torch.int32, (*lead, G, R, GLANES), dev)
    _check_tables(hi_tbl, lo_tbl, G, dev)
    _check_geom(geom, G)
    if R < 2:
        raise ValueError("gstreams: needs the two flush-state rows")
    check_ring_stream(gstreams)
    plain, name = ((decode_plain, "decode") if ns == 1
                   else (decode_x2_plain, "decode_x2"))
    if not gstreams.is_cuda:
        return plain(gstreams, K, hi_tbl, lo_tbl, geom)
    out = torch.empty((K, G, GLANES), dtype=torch.uint8, device=dev)
    fstates = torch.empty((*lead, G, GLANES), dtype=torch.int32, device=dev)
    launch(name, "trc_" + name,
           *decode_cargs(gstreams, K, hi_tbl, lo_tbl, geom, out, fstates))
    return out, fstates


def encode_tile(block: torch.Tensor, K: int, hi_tbl: torch.Tensor,
                lo_tbl: torch.Tensor, init_states: torch.Tensor,
                geom: Geom = DEFAULT):
    """block [L, K] bytes in kernel lane order -> (gstreams [G, R, 128],
    glens [G]): model, then coder, then place (JAX ``encode_tile``).
    Split-state: init [2, G, 128] -> (gstreams [2, G, R, 128], glens
    [2, G]), coder and place once per set, on the hi (even) and the lo
    (odd) slots."""
    cols = block.to(torch.uint8).T.contiguous().reshape(K, geom.groups,
                                                        GLANES)
    probs = model(cols, hi_tbl, lo_tbl, geom)
    if geom.nstates == 1:
        return place(*coder(probs, init_states), geom)
    sets = [place(*coder(probs[k::2].contiguous(), init_states[k]), geom)
            for k in range(2)]
    return (torch.stack([gs for gs, _ in sets]),
            torch.stack([gl for _, gl in sets]))
