"""The bitwise byte-tree codecs' kernels L11 and L12: wrappers, launch
counts and plain versions.

The JAX package runs ids 1, 2 and 101-104 (``rc-o0``, ``rcc-o1`` and
their dual-speed and FSM variants) as ``lax.scan``s over lanes
(``turborc_tpu/codecs/rc_bit.py`` ``encode_device``, ``decode_device``);
they reach no Pallas kernel.  Each device loop is one hand-written kernel
in ``csrc/rans_bit_kernel.cu``, templates on the predictor and the
order; the coder is L2 (``rans_lane_kernel.lane_coder``) over 8K slots a
lane:

Kernel (wrapper)        computes                 JAX pass
  L11 lane_bit_model    bytes -> slot probs      encode_device's scan
  L12 lane_bit_decode   streams -> bytes         decode_device

Each wrapper's plain version is ``<wrapper>_plain``.  A byte b is 8
binary decisions, MSB first; decision d reads the predictor's slot ``ctx
* 256 + node``, ``node = (256 | b) >> (8 - d)``, with ``ctx`` the lane's
previous byte at order 1 (0 before its first) and 0 at order 0, and codes
``p = clamp(predict, 1, 2^15 - 1)`` as ``ops/binary.py`` maps a bit.
Layouts: bytes ``[K, L]``, slot probs ``[8K, L]`` int32 ``(low << 16) |
freq`` (decision d of byte t at slot 8t + d), lane streams as ``words``
[W] int16 and ``lengths`` [L] int32, read as L3 reads them (``M = 8K +
2``).  The predictor is a ``models.bitpred`` object: ``Simple``,
``DualSpeed`` (its rates) or ``Fsm`` (its table [3, S] int32 and start
state, on the tensors' device).

L11 runs a thread a lane and depth, a warp a depth, ``BIT_LANES`` lanes
a CTA; L12 a thread a lane, ``BIT_DECODE_LANES`` lanes a CTA.  At order
0 the slots lie in shared memory, at order 1 in a ``[L, 65536]`` int32
scratch table the wrapper allocates (``BIT_CTX_SLOTS`` slots a lane,
256 KB) and the C entry fills before its kernel; the wrappers refuse
more than ``BIT_MAX_TABLE`` bytes of it.  A wrapper validates its
inputs, then runs the plain version when they lie on the CPU and
launches the kernel when they lie on a CUDA device; there is no fallback
from one to the other.  ``launches[name]`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from turborc_tpu_torch.models import bitpred
from turborc_tpu_torch.ops import binary
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops.rans_kernel import INT32_MAX, _check, launch

# kBitLanes lanes a CTA of L11 (8 warps, one a depth); kBitDLanes lanes a
# CTA of L12; kCtxSlots slots a lane at order 1
BIT_LANES = 32
BIT_DECODE_LANES = 8
BIT_CTX_SLOTS = 65536
BIT_MAX_TABLE = 1 << 32  # bytes of order-1 scratch a launch may take
KINDS = {bitpred.Simple: 0, bitpred.DualSpeed: 1, bitpred.Fsm: 2}

launches = dict.fromkeys(("lane_bit_model", "lane_bit_decode"), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def ctx_slots(order: int) -> int:
    """Predictor slots a lane: 256 a byte context."""
    return 256 if order == 0 else 256 * 256


def bit_launch(L: int, decode: bool = False) -> tuple[int, int]:
    """(threads a CTA, CTAs) of L11 (or, with ``decode``, L12) on L
    lanes."""
    if decode:
        return BIT_DECODE_LANES, -(-L // BIT_DECODE_LANES)
    return BIT_LANES * 8, -(-L // BIT_LANES)


# ---------------------------------------------------------------------------
# plain versions (torch, any device)
# ---------------------------------------------------------------------------

def lane_bit_model_plain(cols: torch.Tensor, order: int,
                         pred) -> torch.Tensor:
    """cols [K, L] bytes -> probs [8K, L] int32 ((low << 16) | freq).  The
    8 decisions of a byte read and write 8 distinct slots, one a tree
    depth, with nothing but the byte between them, so each byte is one
    step over its 8 slots (``encode_device`` runs them one after
    another: the same values)."""
    K, L = cols.shape
    b = cols.to(torch.int64)[..., None]                     # [K, L, 1]
    depth = torch.arange(8, device=cols.device)
    bits = (b >> (7 - depth)) & 1                           # [K, L, 8]
    ctx = torch.cat([torch.zeros_like(b[:1]), b[:-1]]) if order else 0
    idx = ctx * 256 + ((256 | b) >> (8 - depth))            # [K, L, 8]
    state = pred.init(L, ctx_slots(order), cols.device)
    p = torch.empty((K, L, 8), dtype=torch.int64, device=cols.device)
    for t in range(K):
        p[t] = binary.clamp_p(pred.predict(state, idx[t]))
        state = pred.update(state, idx[t], p[t], bits[t].to(torch.bool))
    low, freq = binary.to_low_freq(p, bits.to(torch.bool))
    return ((low << 16) | freq).permute(0, 2, 1).reshape(8 * K, L).to(
        torch.int32).contiguous()


def lane_bit_decode_plain(words: torch.Tensor, lengths: torch.Tensor,
                          K: int, order: int, pred) -> torch.Tensor:
    """Lane streams (words, lengths) -> bytes [K, L] uint8."""
    L = lengths.shape[0]
    ans, fetch = LK.stream_reader(words, lengths, 8 * K + 2)
    state = pred.init(L, ctx_slots(order), words.device)
    ctx = torch.zeros(L, dtype=torch.int64, device=words.device)
    out = torch.empty((K, L), dtype=torch.uint8, device=words.device)
    for t in range(K):
        node = torch.ones_like(ctx)
        for _ in range(8):
            idx = ctx * 256 + node
            p = binary.clamp_p(pred.predict(state, idx)).to(torch.int64)
            bit, ans = binary.dec_bit(ans, p)
            state = pred.update(state, idx, p, bit)
            ans = fetch(ans)
            node = (node << 1) | bit.to(torch.int64)
        out[t] = (node & 0xFF).to(torch.uint8)
        if order:
            ctx = node & 0xFF
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_pred(order: int, pred, L: int, device) -> None:
    if order not in (0, 1):
        raise ValueError(f"order {order}: must be 0 or 1")
    if type(pred) not in KINDS:
        raise ValueError(f"predictor {pred!r}: expected a bitpred Simple, "
                         "DualSpeed or Fsm")
    if isinstance(pred, bitpred.DualSpeed) and \
            min(pred.rate0, pred.rate1) < 0:
        raise ValueError("DualSpeed rates must be >= 0")
    if isinstance(pred, bitpred.Fsm):
        t = pred.table
        if not isinstance(t, torch.Tensor) or t.dim() != 2 or \
                t.shape[0] != 3 or not 1 <= t.shape[1] <= INT32_MAX // 3:
            raise ValueError("Fsm table: expected a [3, S] tensor")
        _check("Fsm table", t, torch.int32, tuple(t.shape), device)
        if not 0 <= pred.start < t.shape[1]:
            raise ValueError(f"Fsm start state {pred.start}: not a state")
    if order and L * BIT_CTX_SLOTS * 4 > BIT_MAX_TABLE:
        raise ValueError(f"{L} lanes at order 1: the tables would take "
                         f"{L * BIT_CTX_SLOTS * 4} bytes, more than "
                         f"{BIT_MAX_TABLE}")


def _pred_cargs(order: int, pred, L: int, device) -> list:
    """(tables, fsm) pointers' tensors and the ints after K, L (W)."""
    tables = (torch.empty((L, BIT_CTX_SLOTS), dtype=torch.int32,
                          device=device) if order else None)
    rates = ((min(pred.rate0, bitpred.MAX_RATE),
              min(pred.rate1, bitpred.MAX_RATE))
             if isinstance(pred, bitpred.DualSpeed) else (0, 0))
    fsm = pred.table if isinstance(pred, bitpred.Fsm) else None
    S, start = ((pred.table.shape[1], pred.start)
                if isinstance(pred, bitpred.Fsm) else (0, 0))
    return [tables, fsm, order, KINDS[type(pred)], *rates, S, start]


def lane_bit_model(cols: torch.Tensor, order: int, pred) -> torch.Tensor:
    """L11: cols [K, L] uint8 -> probs [8K, L] int32."""
    if not isinstance(cols, torch.Tensor) or cols.dim() != 2:
        raise ValueError("cols: expected a [K, L] tensor")
    K, L = cols.shape
    _check("cols", cols, torch.uint8, (K, L), cols.device)
    LK._check_lanes(L)
    if 8 * K + 2 > INT32_MAX:
        raise ValueError(f"K = {K}: out of range")
    _check_pred(order, pred, L, cols.device)
    if not cols.is_cuda:
        return lane_bit_model_plain(cols, order, pred)
    probs = torch.empty((8 * K, L), dtype=torch.int32, device=cols.device)
    launch("lane_bit_model", "trc_lane_bit_model",
           *lane_bit_model_cargs(cols, probs, order, pred), counts=launches)
    return probs


def lane_bit_model_cargs(cols, probs, order: int, pred) -> list:
    """The arguments of ``trc_lane_bit_model`` (without the stream)."""
    K, L = cols.shape
    tables, fsm, *ints = _pred_cargs(order, pred, L, cols.device)
    return [cols, probs, tables, fsm, K, L, *ints]


def lane_bit_decode(words: torch.Tensor, lengths: torch.Tensor, K: int,
                    order: int, pred) -> torch.Tensor:
    """L12: lane streams (words [W] int16, lengths [L] int32) -> bytes
    [K, L] uint8."""
    L = LK._check_streams(words, lengths, K)
    if 8 * K + 2 > INT32_MAX:
        raise ValueError(f"K = {K}: out of range")
    _check_pred(order, pred, L, words.device)
    if not words.is_cuda:
        return lane_bit_decode_plain(words, lengths, K, order, pred)
    out = torch.empty((K, L), dtype=torch.uint8, device=words.device)
    launch("lane_bit_decode", "trc_lane_bit_decode",
           *lane_bit_decode_cargs(words, LK._offsets(lengths), lengths, K,
                                  out, order, pred), counts=launches)
    return out


def lane_bit_decode_cargs(words, offsets, lengths, K: int, out, order: int,
                          pred) -> list:
    """The arguments of ``trc_lane_bit_decode`` (without the stream)."""
    L = lengths.shape[0]
    tables, fsm, *ints = _pred_cargs(order, pred, L, words.device)
    return [words, offsets, lengths, out, tables, fsm, K, L, words.shape[0],
            *ints]
