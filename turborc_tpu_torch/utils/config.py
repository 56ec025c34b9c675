"""Codec configuration (counterpart of ``turborc_tpu/utils/config.py``).

Same fields and defaults as the reference, so a configuration means the
same container header in both packages.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Configuration written into the container header.

    Attributes:
      codec:      registered codec name (ported: "rans-static",
                  "rans-cdf-o0", "rans-cdf-o0-p", "rans-cdf-s8",
                  "rans-cdf-r1", "rans-cdf-r1-p", "rans-auto",
                  "rans-cdf-o1", "rc-p").
      lanes:      lane count recorded in the header (power of two).
      block_size: bytes per independently decodable block.
      step_quant: per-lane symbol-count alignment recorded in the header.
      prm0/prm1:  predictor rate parameters recorded in the header.
      ctx_bits:   sliding-context size recorded in the header.
      level:      pipeline level (BWT entropy-stage selector).
      geom:       flagship kernel geometry (ops.geom.Geom); None = Geom().
    """

    codec: str = "rans-cdf-o0"
    lanes: int = 512
    block_size: int = 1 << 22
    step_quant: int = 256
    prm0: int = 5
    prm1: int = 8
    ctx_bits: int = 8
    level: int = 8
    geom: object = None

    def __post_init__(self):
        if self.lanes & (self.lanes - 1):
            raise ValueError(f"lanes must be a power of two, got {self.lanes}")
        if self.step_quant & (self.step_quant - 1):
            raise ValueError("step_quant must be a power of two")
        if self.block_size % self.lanes:
            raise ValueError("block_size must be a multiple of lanes")


def resolve_device(device=None):
    """The device the port runs on: ``None`` means the CUDA card.

    There is no silent fallback: without a card, ``None`` or a CUDA device
    raises, and a caller who wants the CPU versions asks for "cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev
