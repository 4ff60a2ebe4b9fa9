"""The port's SCLD pieces against the JAX package: the numpy block codec,
the plain SCLD matmul, ``SCLDLinear`` on the CPU, the ``core`` copies the
SCLD example's system half runs on, and the example itself.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances:

* ``block_compress`` / ``decompress`` and the ``core`` copies: bitwise;
* plain matmul vs JAX's ``sclad_matmul_ref``, fp32 x: atol 1e-4, rtol
  1e-5 — the same fp32 products, summed in another order;
* bf16 x: 2e-2 — the fp32 results round to bf16 in both, and a sum an
  ulp apart can round to the neighbouring bf16 value;
* the CUDA kernel's bf16 rounding, written out in torch, against the
  plain version: the JAX suite's bf16 SCLD tolerance, atol 1e-1 and rtol
  5e-2 (the one the kernel is held to on the card).

The Pallas ``sclad_matmul`` is not called: its body does not trace on
the installed jax (``pl.store``).
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import hardware as jax_hardware  # noqa: E402
from repro.core import perf as jax_perf  # noqa: E402
from repro.core import sparsity as jax_sparsity  # noqa: E402
from repro.core.workloads import PAPER_MODELS as JAX_MODELS  # noqa: E402
from repro.kernels.sclad_matmul import sclad_matmul as jax_sclad  # noqa: E402
from repro.kernels.sclad_matmul.ref import \
    sclad_matmul_ref as jax_sclad_ref  # noqa: E402
from repro_torch.core import hardware, perf, sparsity  # noqa: E402
from repro_torch.core.workloads import PAPER_MODELS  # noqa: E402
from repro_torch.examples import sclad_sparsity  # noqa: E402
from repro_torch.kernels.sclad_matmul.ops import SCLDLinear  # noqa: E402
from repro_torch.kernels.sclad_matmul.ref import (  # noqa: E402
    decompress_torch, sclad_matmul_ref)
from repro_torch.kernels.sclad_matmul.sclad_matmul import (  # noqa: E402
    SM_COUNT, TC_BLOCK_M, TC_BLOCK_N, block_compress, decompress, k_ranges,
    k_split, sclad_matmul)

SHAPES = [(128, 256, 128, 6), (256, 128, 256, 16), (128, 384, 256, 4),
          (384, 128, 128, 1)]
SPARSITIES = (0.0, 0.3, 0.5, 0.6, 0.7)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


@pytest.mark.parametrize("K,N,C,seed", [(256, 256, 16, 1), (384, 128, 6, 2),
                                        (128, 384, 1, 3)])
def test_block_codec_is_bitwise_jax(K, N, C, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[:8, :128] = 0.0  # a tie: an all-zero unit beside the others
    vals, rows = block_compress(w, C)
    jvals, jrows = jax_sclad.block_compress(w, C)
    assert rows.dtype == jrows.dtype == np.int32
    assert np.array_equal(rows, jrows)
    assert np.array_equal(_bits(vals), _bits(jvals))
    dense = decompress(vals, rows)
    assert np.array_equal(_bits(dense), _bits(jax_sclad.decompress(jvals,
                                                                   jrows)))
    t = decompress_torch(torch.from_numpy(vals), torch.from_numpy(rows))
    assert np.array_equal(_bits(t.numpy()), _bits(dense))


def test_block_compress_cases_of_the_jax_suite():
    """tests/test_kernels.py's round trip at full capacity and its
    largest-units case, on the port's codec."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    vals, rows = block_compress(w, 16)
    assert np.allclose(decompress(vals, rows), w)
    w = np.zeros((128, 128), np.float32)
    w[0:8] = 100.0
    w[64:72] = 50.0
    vals, rows = block_compress(w, 2)
    assert set(rows[0, 0].tolist()) == {0, 8}
    assert np.allclose(decompress(vals, rows), w)
    jv, jr = jax_sclad.block_compress(w, 2)
    assert np.array_equal(rows, jr) and np.array_equal(vals, jv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,C", SHAPES)
def test_plain_sclad_matmul_matches_jax_ref(M, K, N, C, dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((K, N)).astype(np.float32)
    vals, rows = block_compress(w, C)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jax_sclad_ref(jx, vals, rows), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # the port's wrapper on CPU tensors runs the plain version
    for got in (sclad_matmul_ref(tx, torch.from_numpy(vals),
                                 torch.from_numpy(rows)),
                sclad_matmul(tx, torch.from_numpy(vals),
                             torch.from_numpy(rows))):
        assert got.dtype == tx.dtype and got.shape == (M, N)
        atol, rtol = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 2e-2)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                                   rtol=rtol)


def test_sclad_matmul_contract():
    x = torch.zeros(100, 256)
    vals = torch.zeros(2, 1, 4, 8, 128)
    rows = torch.zeros(2, 1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_m"):
        sclad_matmul(x, vals, rows)
    with pytest.raises(ValueError, match="K =="):
        sclad_matmul(torch.zeros(128, 384), vals, rows)
    assert sclad_matmul(x, vals, rows, block_m=4).shape == (100, 128)


def test_scld_linear_on_the_cpu():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((384, 256)).astype(np.float32)
    x = rng.standard_normal((128, 384)).astype(np.float32)
    lin = SCLDLinear.from_dense(w, 6, device="cpu")
    jv, jr = jax_sclad.block_compress(w, 6)
    assert np.array_equal(lin.vals.numpy(), jv)
    assert np.array_equal(lin.rows.numpy(), jr)
    assert lin.sparsity == 1.0 - 6 / 16
    assert set(dict(lin.named_buffers())) == {"vals", "rows"}
    want = np.asarray(jax_sclad_ref(jnp.asarray(x), jv, jr))
    got = lin(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    off = SCLDLinear(lin.vals, lin.rows, kernel="off")
    assert torch.equal(off(torch.from_numpy(x)), got)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        SCLDLinear(lin.vals, lin.rows, kernel="on")(torch.from_numpy(x))


def _server(hw):
    chip = hw.ChipConfig(die_mm2=140, sram_mb=226, tflops=5.5)
    return hw.ServerConfig(chip=chip, chips_per_lane=17)


def test_core_copies_are_bitwise_jax():
    """The example's system half on the port's copies and on repro.core:
    every number equal, float for float."""
    wl, jwl = PAPER_MODELS["gpt3-175b"], JAX_MODELS["gpt3-175b"]
    assert dataclasses.asdict(wl) == dataclasses.asdict(jwl)
    server, jserver = _server(hardware), _server(jax_hardware)
    for s in SPARSITIES:
        f, jf = sparsity.storage_factor(s), jax_sparsity.storage_factor(s)
        assert f == jf
        assert sparsity.max_model_scale(s) == jax_sparsity.max_model_scale(s)
        dp = perf.best_mapping(server, dataclasses.replace(
            wl, weight_storage_factor=f), ctx=2048)
        jdp = jax_perf.best_mapping(jserver, dataclasses.replace(
            jwl, weight_storage_factor=jf), ctx=2048)
        assert dp.tco_per_mtoken == jdp.tco_per_mtoken
        assert dp.servers == jdp.servers
        assert dataclasses.asdict(dp.perf) == dataclasses.asdict(jdp.perf)
    assert sparsity.OPT175B_PERPLEXITY == jax_sparsity.OPT175B_PERPLEXITY


def _jax_system_lines():
    """The JAX example's system section, on repro.core."""
    wl = JAX_MODELS["gpt3-175b"]
    server = _server(jax_hardware)
    base = jax_perf.best_mapping(server, wl, ctx=2048).tco_per_mtoken
    lines = []
    for s in SPARSITIES:
        wls = dataclasses.replace(
            wl, weight_storage_factor=jax_sparsity.storage_factor(s))
        dp = jax_perf.best_mapping(server, wls, ctx=2048)
        ppl = jax_sparsity.OPT175B_PERPLEXITY.get(s)
        lines.append(f"  sparsity={s:.1f} tco_delta="
                     f"{100 * (dp.tco_per_mtoken - base) / base:+5.1f}% "
                     f"perplexity={ppl}")
    lines.append(f"  max model scale at 60%: "
                 f"{jax_sparsity.max_model_scale(0.6):.2f}x")
    return lines


def test_sclad_example_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = sclad_sparsity.main(["--device", "cpu"])
    text = out.getvalue().splitlines()
    assert list(res["kernel"]) == [16, 8, 6]
    for y, ref in res["kernel"].values():  # plain vs plain on the CPU
        assert y.shape == (128, 512) and torch.equal(y, ref)
    want = _jax_system_lines()
    assert res["system"] == want
    assert text[-len(want):] == want
    assert "  sparsity=0.5 tco_delta=-16.9% perplexity=8.4" in want
    assert text[0] == "== kernel: block-SCLD matmul =="
    assert any("units= 6 sparsity=0.62 traffic=0.38x dense" in t
               for t in text)


#: tinyllama-1.1b's MLP projections at M = 128, as chip_smoke.py times
#: them: (M, K, N) of gate/up and of down.
CHIP_SHAPES = [(128, 2048, 5632), (128, 5632, 2048)]
SCLD_TOL_BF16 = (1e-1, 5e-2)


@pytest.mark.parametrize("M,K,N", CHIP_SHAPES)
def test_k_split_plan_covers_k_once_and_fills_the_card(M, K, N):
    nk, nn = K // 128, N // 128
    split, wide = k_split(M, nk, nn)
    tiles = -(-M // TC_BLOCK_M) * (N // TC_BLOCK_N)
    blocks = 0
    for tile in range(tiles):  # the first `wide` tiles take one slice more
        ranges = k_ranges(nk, split + (tile < wide))
        assert [t for lo, hi in ranges for t in range(lo, hi)] \
            == list(range(nk))
        assert all(hi > lo for lo, hi in ranges)
        blocks += len(ranges)
    # one block for each SM: every SM busy, one wave
    assert blocks == SM_COUNT == 132


@pytest.mark.parametrize("vals_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,C", [
    (128, 2048, 5632, 6), (128, 5632, 2048, 6), (128, 5632, 2048, 16),
    (96, 2048, 640, 6)])
def test_bf16_body_rounding_stays_within_tolerance(M, K, N, C, vals_dtype):
    """The bf16 body's arithmetic: each weight rounded to bf16, bf16
    products (exact in fp32), fp32 sums over each K slice of the
    wrapper's plan, the slices' partials added in slice order, then a
    cast to bf16."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    vals, rows = block_compress(w, C)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).bfloat16()
    v = torch.from_numpy(vals).to(vals_dtype)
    r = torch.from_numpy(rows)
    wb = decompress_torch(v, r).bfloat16().float()
    nk, nn = K // 128, N // 128
    split, wide = k_split(M, nk, nn)
    y = None  # the first output tile's slices: the most of any tile
    for lo, hi in k_ranges(nk, split + (wide > 0)):
        part = x[:, lo * 128:hi * 128].float() @ wb[lo * 128:hi * 128]
        y = part if y is None else y + part
    atol, rtol = SCLD_TOL_BF16
    torch.testing.assert_close(y.bfloat16().float(),
                               sclad_matmul_ref(x, v, r).float(), atol=atol,
                               rtol=rtol)
