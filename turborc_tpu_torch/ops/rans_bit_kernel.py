"""The bitwise tree codecs' kernels L11 and L12: wrappers, launch counts
and plain versions.

The JAX package runs ids 1, 2, 3 and 101-104 (``rc-o0``, ``rcc-o1``,
``rcc2`` and their dual-speed and FSM variants) and the W-bit trees of ids
6 and 142-152 (``rc-16``, ``rc{W}b``) as ``lax.scan``s over lanes
(``turborc_tpu/codecs/rc_bit.py`` ``encode_device``, ``decode_device``,
``encoden_device``, ``decoden_device``); they reach no Pallas kernel.
Each device loop is one hand-written kernel in
``csrc/rans_bit_kernel.cu``, templates on the predictor, the order and
the tree's width W; the coder is L2 (``rans_lane_kernel.lane_coder``) over
W K slots a lane:

Kernel (wrapper)        computes                    JAX pass
  L11 lane_bit_model    elements -> slot probs      encode_device's scan,
                                                    encoden_device's
  L12 lane_bit_decode   streams -> elements         decode_device,
                                                    decoden_device

Each wrapper's plain versions are ``<wrapper>_plain`` (the byte tree, W =
8) and ``lane_bitw_model_plain`` / ``lane_bitw_decode_plain`` (a W-bit
tree).  An element v of W bits is W binary decisions, MSB first; decision
d reads the predictor's slot ``ctx * 256 + node``, ``node = (2^W | v) >>
(W - d)``, with ``ctx`` the lane's previous byte at order 1, ``(previous
<< 8) | the one before`` at order 2 (0 before the first) and 0 at order 0,
and codes ``p = clamp(predict, 1, 2^15 - 1)`` as ``ops/binary.py`` maps a
bit.  Orders 1 and 2 are the byte tree's (W = 8); a tree of another W, in
2..16, is of order 0 on the ``Simple`` predictor, the only one the W-bit
codecs use.  Layouts: elements ``[K, L]`` (uint8 for W <= 8, int16 holding
the u16 bits above), slot probs ``[W K, L]`` int32 ``(low << 16) | freq``
(decision d of element t at slot W t + d), lane streams as ``words`` [n]
int16 and ``lengths`` [L] int32, read as L3 reads them (``M = W K + 2``).
The predictor is a ``models.bitpred`` object: ``Simple``, ``DualSpeed``
(its rates) or ``Fsm`` (its table [3, S] int32 and start state, on the
tensors' device).

A CTA of either kernel has ``BIT_SETUP`` threads, which load the FSM
table into shared memory (at most ``BIT_MAX_STATES`` states, as u16)
and set the shared slots; then L11 runs one warp, a thread a lane and
depth, ``bit_lanes(W)`` lanes a CTA, and L12 a thread a lane,
``BIT_DECODE_LANES`` lanes a CTA.  Where a kernel's slots do not lie in
shared memory (order 1, order 2, W above ``BIT_MAX_SHARED_W``; L12 also
at W = 16) they lie in a scratch table the wrapper allocates
(``model_slots`` / ``decode_slots`` int32 slots a lane; order 2 64 MB)
and the C entry fills before its kernel; the wrappers refuse more than
``BIT_MAX_TABLE`` bytes of it.  Each kernel lays its slots out its own way
(``csrc/rans_bit_kernel.cu``).  A wrapper validates its inputs, then runs
the plain version when they lie on the CPU and launches the kernel when
they lie on a CUDA device; there is no fallback from one to the other.
``launches[name]`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from turborc_tpu_torch.models import bitpred
from turborc_tpu_torch.ops import binary
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops.rans_kernel import INT32_MAX, _check, launch

# kBitLanes lanes a CTA of L11 at W <= 8 (a warp: 4 lanes x W depths; 2
# lanes above); kBitDLanes lanes a CTA of L12; kBitSetup threads a CTA of
# either; kCtxSlots / kCtx2Slots slots a lane at order 1 / 2; kMaxSharedW
# the widest order-0 tree whose slots lie in shared memory; kTopRow L12's
# row of the hi byte at W = 16, after the 256 rows of the lo byte;
# kMaxStates FSM states (u16 in shared memory)
BIT_LANES = 4
BIT_DECODE_LANES = 4
BIT_SETUP = 256
BIT_CTX_SLOTS = 65536
BIT_CTX2_SLOTS = 1 << 24
BIT_MAX_SHARED_W = 12
BIT_TOP_ROW = 256
BIT_BODY_SLOTS = 256
BIT_MAX_STATES = 32768
BIT_MAX_TABLE = 1 << 32  # bytes of scratch table a launch may take
WIDTHS = range(2, 17)  # the tree widths W
KINDS = {bitpred.Simple: 0, bitpred.DualSpeed: 1, bitpred.Fsm: 2}

launches = dict.fromkeys(("lane_bit_model", "lane_bit_decode"), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def ctx_slots(order: int) -> int:
    """Predictor slots a lane of the byte tree: 256 a context."""
    return 256 * (1, 256, 65536)[order]


def bit_lanes(W: int = 8) -> int:
    """Lanes a CTA of L11 at width W: a u32 holds a step's elements."""
    return BIT_LANES if W <= 8 else 2


def elem_dtype(W: int) -> torch.dtype:
    """The elements' dtype at width W: uint8, or int16 holding u16."""
    return torch.uint8 if W <= 8 else torch.int16


def model_slots(order: int, W: int = 8) -> int:
    """int32 slots a lane of L11's scratch table (0: none, the slots lie
    in shared memory)."""
    if order:
        return (BIT_CTX_SLOTS, BIT_CTX2_SLOTS)[order - 1]
    return 1 << W if W > BIT_MAX_SHARED_W else 0


def decode_slots(order: int, W: int = 8) -> int:
    """int32 slots a lane of L12's scratch table: order 1's and 2's rows,
    W = 16's 257 rows (the lo byte's by the hi byte, then the hi byte's),
    a row of 2^W past ``BIT_MAX_SHARED_W`` (0: none)."""
    if W == 16:
        return (BIT_TOP_ROW + 1) * BIT_BODY_SLOTS
    return model_slots(order, W)


def bit_launch(L: int, decode: bool = False, W: int = 8) -> tuple[int, int]:
    """(threads a CTA, CTAs) of L11 (or, with ``decode``, L12) on L lanes
    at width W."""
    return BIT_SETUP, -(-L // (BIT_DECODE_LANES if decode else bit_lanes(W)))


# ---------------------------------------------------------------------------
# plain versions (torch, any device)
# ---------------------------------------------------------------------------

def _context(b: torch.Tensor, order: int):
    """The contexts of bytes b [K, L, 1] int64: 0 at order 0, the previous
    byte at order 1, (previous << 8) | the one before at order 2, 0 before
    a lane's first byte."""
    if not order:
        return 0
    zero = torch.zeros_like(b[:1])
    prev = torch.cat([zero, b[:-1]])
    if order == 1:
        return prev
    return (prev << 8) | torch.cat([zero, prev[:-1]])


def _tree_model(v: torch.Tensor, W: int, ctx, state, pred) -> torch.Tensor:
    """probs [W K, L] of elements v [K, L, 1] int64 (< 2^W) down a W-bit
    tree at contexts ``ctx`` over the predictor table ``state``.  The W
    decisions of an element read and write W distinct slots, one a tree
    depth, with nothing but the element between them, so each element is
    one step over its W slots (the JAX scan runs them one after another:
    the same values)."""
    K, L = v.shape[:2]
    depth = torch.arange(W, device=v.device)
    bits = (v >> (W - 1 - depth)) & 1                       # [K, L, W]
    idx = ctx * 256 + (((1 << W) | v) >> (W - depth))       # [K, L, W]
    p = torch.empty((K, L, W), dtype=torch.int64, device=v.device)
    for t in range(K):
        p[t] = binary.clamp_p(pred.predict(state, idx[t]))
        state = pred.update(state, idx[t], p[t], bits[t].to(torch.bool))
    low, freq = binary.to_low_freq(p, bits.to(torch.bool))
    return ((low << 16) | freq).permute(0, 2, 1).reshape(W * K, L).to(
        torch.int32).contiguous()


def lane_bit_model_plain(cols: torch.Tensor, order: int,
                         pred) -> torch.Tensor:
    """cols [K, L] bytes -> probs [8K, L] int32 ((low << 16) | freq)."""
    b = cols.to(torch.int64)[..., None]                     # [K, L, 1]
    state = pred.init(cols.shape[1], ctx_slots(order), cols.device)
    return _tree_model(b, 8, _context(b, order), state, pred)


def lane_bitw_model_plain(cols: torch.Tensor, W: int,
                          pred) -> torch.Tensor:
    """cols [K, L] elements (uint8, or int16 holding u16) -> probs [W K,
    L] int32 down a W-bit tree of order 0; an element's bits past W are
    not read (``encoden_device`` reads bits W - 1 .. 0)."""
    v = (cols.to(torch.int64) & ((1 << W) - 1))[..., None]
    state = pred.init(cols.shape[1], 1 << W, cols.device)
    return _tree_model(v, W, 0, state, pred)


def _tree_decode(words, lengths, K: int, W: int, order: int, slots: int,
                 pred) -> torch.Tensor:
    """Lane streams -> elements [K, L] int64 down a W-bit tree at order
    ``order`` over ``slots`` predictor slots a lane."""
    L = lengths.shape[0]
    ans, fetch = LK.stream_reader(words, lengths, W * K + 2)
    state = pred.init(L, slots, words.device)
    ctx = torch.zeros(L, dtype=torch.int64, device=words.device)
    out = torch.empty((K, L), dtype=torch.int64, device=words.device)
    for t in range(K):
        node = torch.ones_like(ctx)
        for _ in range(W):
            idx = ctx * 256 + node
            p = binary.clamp_p(pred.predict(state, idx)).to(torch.int64)
            bit, ans = binary.dec_bit(ans, p)
            state = pred.update(state, idx, p, bit)
            ans = fetch(ans)
            node = (node << 1) | bit.to(torch.int64)
        out[t] = node & ((1 << W) - 1)
        if order == 1:
            ctx = out[t]
        elif order == 2:
            ctx = (out[t] << 8) | (ctx >> 8)
    return out


def lane_bit_decode_plain(words: torch.Tensor, lengths: torch.Tensor,
                          K: int, order: int, pred) -> torch.Tensor:
    """Lane streams (words, lengths) -> bytes [K, L] uint8."""
    return _tree_decode(words, lengths, K, 8, order, ctx_slots(order),
                        pred).to(torch.uint8)


def lane_bitw_decode_plain(words: torch.Tensor, lengths: torch.Tensor,
                           K: int, W: int, pred) -> torch.Tensor:
    """Lane streams (words, lengths) -> elements [K, L] of a W-bit tree of
    order 0: uint8 for W <= 8, int16 holding the u16 bits above."""
    out = _tree_decode(words, lengths, K, W, 0, 1 << W, pred)
    if W > 8:
        out = (out ^ 0x8000) - 0x8000  # the u16 bits as int16
    return out.to(elem_dtype(W))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_tree(order: int, W: int, pred, L: int, device) -> None:
    if W not in WIDTHS:
        raise ValueError(f"W = {W}: a tree of 2 to 16 bits")
    if order not in (0, 1, 2):
        raise ValueError(f"order {order}: must be 0, 1 or 2")
    if order and W != 8:
        raise ValueError(f"order {order} at W = {W}: orders 1 and 2 are "
                         "the byte tree's")
    if (order == 2 or W != 8) and type(pred) is not bitpred.Simple:
        raise ValueError(f"order {order}, W = {W}: the kernels take the "
                         "Simple predictor only")
    _check_pred(order, pred, L, device, W)


def _check_pred(order: int, pred, L: int, device, W: int = 8) -> None:
    if type(pred) not in KINDS:
        raise ValueError(f"predictor {pred!r}: expected a bitpred Simple, "
                         "DualSpeed or Fsm")
    if isinstance(pred, bitpred.DualSpeed) and \
            min(pred.rate0, pred.rate1) < 0:
        raise ValueError("DualSpeed rates must be >= 0")
    if isinstance(pred, bitpred.Fsm):
        t = pred.table
        if not isinstance(t, torch.Tensor) or t.dim() != 2 or \
                t.shape[0] != 3 or t.shape[1] < 1:
            raise ValueError("Fsm table: expected a [3, S] tensor")
        if t.shape[1] > BIT_MAX_STATES:
            raise ValueError(f"Fsm table of {t.shape[1]} states: the kernels "
                             f"hold at most {BIT_MAX_STATES}")
        _check("Fsm table", t, torch.int32, tuple(t.shape), device)
        if not 0 <= pred.start < t.shape[1]:
            raise ValueError(f"Fsm start state {pred.start}: not a state")
    table = L * max(model_slots(order, W), decode_slots(order, W)) * 4
    if table > BIT_MAX_TABLE:
        raise ValueError(f"{L} lanes at order {order}, W = {W}: the tables "
                         f"would take {table} bytes, more than "
                         f"{BIT_MAX_TABLE}")


def _check_K(K: int, W: int) -> None:
    if K < 0 or W * K + 2 > INT32_MAX:
        raise ValueError(f"K = {K} at W = {W}: out of range")


def _pred_cargs(order: int, pred, L: int, device) -> list:
    """(tables, fsm) pointers' tensors and the ints after K, L (W)."""
    tables = (torch.empty((L, model_slots(order)), dtype=torch.int32,
                          device=device) if order else None)
    rates = ((min(pred.rate0, bitpred.MAX_RATE),
              min(pred.rate1, bitpred.MAX_RATE))
             if isinstance(pred, bitpred.DualSpeed) else (0, 0))
    fsm = pred.table if isinstance(pred, bitpred.Fsm) else None
    S, start = ((pred.table.shape[1], pred.start)
                if isinstance(pred, bitpred.Fsm) else (0, 0))
    return [tables, fsm, order, KINDS[type(pred)], *rates, S, start]


def _table(slots: int, L: int, device):
    return (torch.empty((L, slots), dtype=torch.int32, device=device)
            if slots else None)


def lane_bit_model(cols: torch.Tensor, order: int, pred,
                   W: int = 8) -> torch.Tensor:
    """L11: cols [K, L] (uint8; int16 holding u16 for W > 8) -> probs
    [W K, L] int32."""
    if not isinstance(cols, torch.Tensor) or cols.dim() != 2:
        raise ValueError("cols: expected a [K, L] tensor")
    if W not in WIDTHS:
        raise ValueError(f"W = {W}: a tree of 2 to 16 bits")
    K, L = cols.shape
    _check("cols", cols, elem_dtype(W), (K, L), cols.device)
    LK._check_lanes(L)
    _check_K(K, W)
    _check_tree(order, W, pred, L, cols.device)
    if not cols.is_cuda:
        return (lane_bit_model_plain(cols, order, pred) if W == 8
                else lane_bitw_model_plain(cols, W, pred))
    probs = torch.empty((W * K, L), dtype=torch.int32, device=cols.device)
    if W == 8:
        launch("lane_bit_model", "trc_lane_bit_model",
               *lane_bit_model_cargs(cols, probs, order, pred),
               counts=launches)
    else:
        launch("lane_bit_model", "trc_lane_bitw_model",
               *lane_bitw_model_cargs(cols, probs, W), counts=launches)
    return probs


def lane_bit_model_cargs(cols, probs, order: int, pred) -> list:
    """The arguments of ``trc_lane_bit_model`` (without the stream)."""
    K, L = cols.shape
    tables, fsm, *ints = _pred_cargs(order, pred, L, cols.device)
    return [cols, probs, tables, fsm, K, L, *ints]


def lane_bitw_model_cargs(cols, probs, W: int) -> list:
    """The arguments of ``trc_lane_bitw_model`` (without the stream)."""
    K, L = cols.shape
    return [cols, probs, _table(model_slots(0, W), L, cols.device), K, L, W]


def lane_bit_decode(words: torch.Tensor, lengths: torch.Tensor, K: int,
                    order: int, pred, W: int = 8) -> torch.Tensor:
    """L12: lane streams (words [n] int16, lengths [L] int32) -> elements
    [K, L] (uint8; int16 holding u16 for W > 8).  The kernel reads
    ``words`` 16 bytes at a time: words on the card that do not start on
    16 bytes are copied first."""
    L = LK._check_streams(words, lengths, K)
    if W not in WIDTHS:
        raise ValueError(f"W = {W}: a tree of 2 to 16 bits")
    _check_K(K, W)
    _check_tree(order, W, pred, L, words.device)
    if not words.is_cuda:
        return (lane_bit_decode_plain(words, lengths, K, order, pred)
                if W == 8 else
                lane_bitw_decode_plain(words, lengths, K, W, pred))
    if words.data_ptr() % 16:  # the kernel copies 16-byte units of words
        words = words.clone()
    out = torch.empty((K, L), dtype=elem_dtype(W), device=words.device)
    offsets = LK._offsets(lengths)
    if W == 8:
        launch("lane_bit_decode", "trc_lane_bit_decode",
               *lane_bit_decode_cargs(words, offsets, lengths, K, out, order,
                                      pred), counts=launches)
    else:
        launch("lane_bit_decode", "trc_lane_bitw_decode",
               *lane_bitw_decode_cargs(words, offsets, lengths, K, out, W),
               counts=launches)
    return out


def lane_bit_decode_cargs(words, offsets, lengths, K: int, out, order: int,
                          pred) -> list:
    """The arguments of ``trc_lane_bit_decode`` (without the stream)."""
    L = lengths.shape[0]
    tables, fsm, *ints = _pred_cargs(order, pred, L, words.device)
    return [words, offsets, lengths, out, tables, fsm, K, L, words.shape[0],
            *ints]


def lane_bitw_decode_cargs(words, offsets, lengths, K: int, out,
                           W: int) -> list:
    """The arguments of ``trc_lane_bitw_decode`` (without the stream)."""
    L = lengths.shape[0]
    return [words, offsets, lengths, out,
            _table(decode_slots(0, W), L, words.device), K, L,
            words.shape[0], W]
