"""Kernel/format geometry for the flagship rANS family.

Counterpart of ``turborc_tpu/ops/pallas/geom.py``.  Every field is
format-relevant: a payload written at one geometry decodes only at the
same geometry, so the geometry rides in the container header
(``Geom.pack``, 4 bytes).  Unlike the reference, nothing is read from the
environment: ``DEFAULT`` is ``Geom()``, and ``wsteps`` is the fixed 1
(it feeds ``wrows``, which sizes the stream buffers and the
``glens`` bound that ``decode_block`` checks).
"""
from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class Geom:
    """Flagship kernel geometry (all format-relevant)."""
    groups: int = 64   # 128-lane groups per tile (stream count)
    chunk: int = 8     # byte steps per alignment unit
    share: int = 8     # lanes per shared model span (1 = per-lane models)
    sync: int = 4      # bytes between hot-row cross-lane re-joins
    lsync: int = 32    # bytes between cold-row re-joins
    arows: int = 16    # adaptive lo-table rows (>= arows are static)
    srows: int = 4     # lo rows re-joined at the fast cadence
    nstates: int = 1   # rANS states per lane (2 = split hi/lo streams)
    rate: int = 7      # CDF16 adaptation rate

    def __post_init__(self):
        # The 4-byte header stores groups/chunk/share/sync/lsync as log2
        # exponents and srows in 5 bits: reject what it cannot represent.
        for name, v, cap in (("groups", self.groups, 1 << 15),
                             ("chunk", self.chunk, 1 << 15),
                             ("share", self.share, 128),
                             ("sync", self.sync, 128),
                             ("lsync", self.lsync, 128)):
            if v < 1 or v & (v - 1) or v > cap:
                raise ValueError(
                    f"geometry {name}={v} must be a power of two <= {cap}"
                    " (container header stores log2 exponents)")
        if not 0 <= self.srows < 32:
            raise ValueError("geometry srows must be in [0, 32)")
        if self.chunk % self.sync != 0:
            raise ValueError("sync cadence must divide the grid-step chunk")
        if self.lsync % self.chunk or self.lsync % self.sync:
            raise ValueError(
                "cold-row cadence must be a multiple of the grid-step chunk")
        if not 0 <= self.arows <= 16:
            raise ValueError("geometry arows must be in [0, 16]")
        if self.nstates not in (1, 2):
            raise ValueError("geometry nstates must be 1 or 2")
        if not 7 <= self.rate <= 10:
            # rates < 7 would need a monotone repair after every update
            raise ValueError("geometry rate must be in [7, 10]")

    # ---- derived (not independent format knobs)
    @property
    def lanes(self) -> int:
        return self.groups * 128

    @property
    def rows_per_step(self) -> int:
        """Worst-case stream rows one chunk can consume per stream."""
        return 2 * self.chunk if self.nstates == 1 else self.chunk

    @property
    def wsteps(self) -> int:
        return 1

    @property
    def wrows(self) -> int:
        return self.rows_per_step * self.wsteps + 8

    @property
    def hrows(self) -> int:
        return min(self.srows, self.arows)

    @property
    def step_quant(self) -> int:
        """Per-lane symbol count alignment (chunk AND cold sync)."""
        return max(self.chunk, self.lsync)

    @classmethod
    def parse(cls, spec: str) -> "Geom":
        """Parse g<groups>c<chunk>s<share>y<sync>l<lsync>a<arows>[r<srows>]
        [x2][u<rate>]."""
        m = re.fullmatch(
            r"g(\d+)c(\d+)s(\d+)y(\d+)l(\d+)a(\d+)(?:r(\d+))?(x2)?"
            r"(?:u(\d+))?", spec)
        if not m:
            raise ValueError(f"bad geometry spec {spec!r}")
        g, c, s, y, l, a = map(int, m.groups()[:6])
        r = int(m.group(7)) if m.group(7) else 4
        u = int(m.group(9)) if m.group(9) else 7
        return cls(groups=g, chunk=c, share=s, sync=y, lsync=l, arows=a,
                   srows=r, nstates=2 if m.group(8) else 1, rate=u)

    @property
    def spec(self) -> str:
        return (f"g{self.groups}c{self.chunk}s{self.share}y{self.sync}"
                f"l{self.lsync}a{self.arows}r{self.srows}"
                + ("x2" if self.nstates == 2 else "")
                + (f"u{self.rate}" if self.rate != 7 else ""))

    # ---- container header wire format (4 bytes; format v3)
    WIRE_LEN = 4

    def pack(self) -> bytes:
        a = ((self.groups.bit_length() - 1)
             | ((self.chunk.bit_length() - 1) << 4))
        b = ((self.share.bit_length() - 1)
             | ((self.sync.bit_length() - 1) << 3)
             | ((self.nstates - 1) << 6))
        c = (self.lsync.bit_length() - 1) | (self.srows << 3)
        d = self.arows | ((self.rate - 7) << 5)   # arows 5 bits, rate 2
        return bytes([a, b, c, d])

    @classmethod
    def unpack(cls, raw: bytes) -> "Geom":
        if len(raw) != cls.WIRE_LEN:
            raise ValueError("corrupt container: bad geometry field")
        a, b, c, d = raw
        return cls(groups=1 << (a & 15), chunk=1 << (a >> 4),
                   share=1 << (b & 7), sync=1 << ((b >> 3) & 7),
                   nstates=1 + ((b >> 6) & 1),
                   lsync=1 << (c & 7), srows=c >> 3, arows=d & 31,
                   rate=7 + (d >> 5))


DEFAULT = Geom()
