"""Boundaries of the PyTorch port.

The port, ``chip_smoke.py`` and the GPU tools under ``tools/`` import
neither JAX nor the JAX package (the GPU machine has no JAX), and the
port's entry points run on the card unless asked for the CPU: with no
card they raise, they never fall back.
"""
from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "turborc_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "turborc_tpu")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            names.append(node.args[0].value)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_closure_has_no_jax():
    """Importing the whole port loads no JAX module."""
    code = ("import sys, turborc_tpu_torch.api, turborc_tpu_torch.convert, "
            "turborc_tpu_torch.ops.build, turborc_tpu_torch.codecs.rc_tree, "
            "turborc_tpu_torch.ops.bittree_kernel, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'turborc_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_device_means_cuda_and_raises(monkeypatch):
    from turborc_tpu_torch import CodecConfig, api
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CodecConfig(codec="rans-cdf-o0-p")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.compress(b"abc", cfg)
    blob = api.compress(b"abc", cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decompress(blob)
    assert api.decompress(blob, device="cpu") == b"abc"


def test_convert_no_device_means_cuda_and_raises(monkeypatch):
    from turborc_tpu_torch import convert
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (np.zeros((16, 2)), np.zeros((16, 16, 2)), np.zeros((2, 128)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.kernel_args_from_jax(*args)
    hi, lo, init = convert.kernel_args_from_jax(*args, device="cpu")
    assert {t.device.type for t in (hi, lo, init)} == {"cpu"}


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """chip_smoke.py in a directory holding nothing else of the repo exits
    non-zero and prints no result line (here it also finds no card)."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("codec", ["rans-cdf-r1-p", "rans-auto"])
def test_o1_codecs_no_device_means_cuda_and_raises(codec, monkeypatch):
    """The order-1 codec and the dispatch default to the card too."""
    from turborc_tpu_torch import CodecConfig, api
    from turborc_tpu_torch.codecs import registry
    from turborc_tpu_torch.ops.geom import Geom
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CodecConfig(codec=codec, geom=Geom.parse("g1c2s8y2l4a16r4"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.compress(b"abc", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.get(codec).encode_block(np.zeros(10, np.uint8))
    blob = api.compress(b"abc", cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decompress(blob)
    assert api.decompress(blob, device="cpu") == b"abc"


@pytest.mark.parametrize("codec", ["rans-cdf-r1", "rans-cdf-o1"])
def test_lane_o1_codecs_no_device_means_cuda_and_raises(codec, monkeypatch):
    """The order-1 per-lane scan codecs default to the card too."""
    from turborc_tpu_torch import CodecConfig, api
    from turborc_tpu_torch.codecs import registry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CodecConfig(codec=codec, lanes=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.compress(b"abc", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.get(codec).encode_block(np.zeros(10, np.uint8), lanes=16)
    blob = api.compress(b"abc", cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decompress(blob)
    assert api.decompress(blob, device="cpu") == b"abc"


def test_r1_tables_convert_no_device_means_cuda_and_raises(monkeypatch):
    from turborc_tpu_torch import convert
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (np.full((1, 64, 16), 2048), np.full((1, 48, 16), 2048))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.r1_tables_from_jax(*args)
    hi, lo = convert.r1_tables_from_jax(*args, device="cpu")
    assert (hi.shape, lo.shape) == ((1, 64, 16), (1, 48, 16))


def test_o1_convert_no_device_means_cuda_and_raises(monkeypatch):
    from turborc_tpu_torch import convert
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (np.zeros((64, 16, 2)), np.zeros((48, 16, 2)), np.zeros((2, 128)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.o1_kernel_args_from_jax(*args)
    hi, lo, init = convert.o1_kernel_args_from_jax(*args, device="cpu")
    assert (hi.shape, lo.shape) == ((64, 16, 2), (48, 16, 2))


def test_rcp_no_device_means_cuda_and_raises(monkeypatch):
    """The bit-tree codec, and split-state id 57, default to the card."""
    from turborc_tpu_torch import CodecConfig, api
    from turborc_tpu_torch.codecs import registry
    from turborc_tpu_torch.ops.geom import Geom
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for codec, spec in (("rc-p", "g1c2s8y2l4a16r4"),
                        ("rans-cdf-o0-p", "g1c2s8y2l4a16r4x2")):
        cfg = CodecConfig(codec=codec, geom=Geom.parse(spec))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.compress(b"abc", cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.get(codec).encode_block(np.zeros(10, np.uint8),
                                             geom=Geom.parse(spec))
        blob = api.compress(b"abc", cfg, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.decompress(blob)
        assert api.decompress(blob, device="cpu") == b"abc"


def test_tree_convert_no_device_means_cuda_and_raises(monkeypatch):
    from turborc_tpu_torch import convert
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = np.full(256, 16384, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tree_from_jax(tree)
    assert convert.tree_from_jax(tree, device="cpu").device.type == "cpu"
