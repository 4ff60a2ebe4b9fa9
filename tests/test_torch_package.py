"""The PyTorch port stands alone: no JAX, nothing of ``repro``, the card
by default, and no fallback that hides the device or the kernel."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import SSMConfig, get_config  # noqa: E402
from repro_torch.kernels.flash_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_prefill import ops as prefill_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s]|$)",
                       re.M)


def test_import_loads_neither_jax_nor_repro():
    """A fresh interpreter imports every module of the port; afterwards
    no ``jax`` and no ``repro``/``repro.*`` module is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_sources_never_import_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 16
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device every entry point raises unless the caller
    asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_paged_cache(cfg, 4, 4)
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced",
                    "--requests", "1", "--max-new", "1"])
    eng = ServingEngine(cfg, params, device="cpu")
    assert eng.device.type == "cpu"


def test_kernel_on_with_cpu_tensors_raises():
    """attn_kernel='on' never falls back to the plain version: a CUDA
    kernel has no CPU or interpret mode."""
    B, H, Hk, D, N, bs, T = 2, 8, 1, 64, 5, 4, 2
    q = torch.zeros(B, H, D)
    pool = torch.zeros(N, bs, Hk, D, dtype=torch.bfloat16)
    lens = torch.ones(B, dtype=torch.int32)
    tbl = torch.ones(B, T, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        decode_ops.decode_attention(q, pool, pool, lens, tbl, kernel="on")
    qs = torch.zeros(B, 3, H, D)
    kn = torch.zeros(B, 3, Hk, D)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        prefill_ops.prefill_attention(qs, kn, kn, pool, pool, lens, tbl,
                                      kernel="on")
    cfg = get_config("tinyllama-1.1b").reduced()
    eng = ServingEngine(cfg, M.init_params(cfg, 0, device="cpu"),
                        attn_kernel="on", device="cpu")
    eng.submit(np.arange(1, 6), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        eng.run()


def test_unported_options_raise():
    cfg = get_config("tinyllama-1.1b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    for kw in (dict(spec_decode="ngram"), dict(mesh=object()),
               dict(kv_dtype="f8"), dict(kv_dtype="f8", mode="wave")):
        with pytest.raises(NotImplementedError):
            ServingEngine(cfg, params, device="cpu", **kw)
    ssm = dataclasses.replace(cfg, family="ssm", ssm=SSMConfig())
    for mode in ("auto", "wave"):
        with pytest.raises(NotImplementedError, match="ssm"):
            ServingEngine(ssm, params, device="cpu", mode=mode)


def test_params_from_numpy_bf16_round_trip_is_bit_exact():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 16, size=(7, 5), dtype=np.uint16)
    bits[bits & 0x7F80 == 0x7F80] = 0  # keep it free of NaN/inf patterns
    arr = bits.view(ml_dtypes.bfloat16)
    t = tensor_from_numpy(arr)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), bits)

    cfg = get_config("tinyllama-1.1b").reduced()
    shapes = M.param_shapes(cfg)

    def tree(s):
        if isinstance(s, dict):
            return {k: tree(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(ml_dtypes.bfloat16)

    np_tree = tree(shapes)
    params = params_from_numpy(cfg, np_tree, device="cpu")
    w = np_tree["blocks"]["attn"]["wq"]
    got = params["blocks"]["attn"]["wq"]
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          w.view(np.uint16))
    f32 = params_from_numpy(cfg, np_tree, device="cpu", dtype=torch.float32)
    assert f32["embed"].dtype == torch.float32
    bad = dict(np_tree, embed=np_tree["embed"][:-1])
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, bad, device="cpu")
