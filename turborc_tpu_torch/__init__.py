"""TurboRC on PyTorch + CUDA: the port of ``turborc_tpu`` to an NVIDIA H100.

The JAX package ``turborc_tpu`` stays the reference; this package writes
the same container bytes.  It imports torch and numpy only, never JAX and
nothing of ``turborc_tpu``.  Ported so far: the flagship codecs
``rans-cdf-o0-p`` (id 57, one or two coder states a lane) and
``rans-cdf-r1-p`` (id 60), the dispatch between them, ``rans-auto``
(id 61), the bit-tree codec ``rc-p`` (id 8), and the per-lane scan codecs
``rans-cdf-o0`` (id 56, the default), ``rans-cdf-s8`` (id 58),
``rans-static`` (id 42), ``rans-cdf-r1`` (id 59) and ``rans-cdf-o1``
(id 64), the nibble codecs ``rc4`` (id 41) and ``rc4c`` (id 40) and the
bitwise byte-tree codecs ``rc-o0`` (id 1), ``rcc-o1`` (id 2) and their
predictor variants (ids 101-104), on twenty-one hand-written CUDA
kernels (``ops/csrc/rans_kernel.cu``, ``ops/csrc/rans_o1_kernel.cu``,
``ops/csrc/bittree_kernel.cu``, ``ops/csrc/rans_lane_kernel.cu``,
``ops/csrc/rans_bit_kernel.cu``), built by nvcc at first use.
"""
from turborc_tpu_torch.api import compress, decompress
from turborc_tpu_torch.ops.geom import Geom
from turborc_tpu_torch.utils.config import CodecConfig

__all__ = ["compress", "decompress", "CodecConfig", "Geom"]
__version__ = "0.1.0"
