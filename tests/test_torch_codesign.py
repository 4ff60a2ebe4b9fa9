"""The port's co-design search (``repro_torch.core.ccmem``,
``core.explore``, ``examples.codesign_search``) against the reference
package's.

All three are host-side analytics over numpy and the standard library,
copied with their imports pointed at ``repro_torch.core``: so every check
here is exact equality (dicts, dataclass fields, printed lines), not a
tolerance.  Phase 2 runs on every 20th phase-1 design to keep the file
within a few seconds.
"""
import contextlib
import dataclasses
import importlib.util
import io
import sys
from pathlib import Path

import pytest

from repro.core import ccmem as jax_ccmem
from repro.core import explore as jax_explore
from repro.core.workloads import PAPER_MODELS as JAX_MODELS
from repro_torch.core import ccmem, explore
from repro_torch.core.workloads import PAPER_MODELS
from repro_torch.examples import codesign_search

ROOT = Path(__file__).resolve().parents[1]
STRIDE = 20  # phase-1 designs kept for phase 2


def _streams(mod, case):
    """The stream sets of ``tests/test_ccmem.py`` and the two pattern
    builders, made with package ``mod``'s classes."""
    S = mod.AccessStream
    return {
        "one_burst": [S(words=1 << 20, kind="burst")],
        "many_bursts": [S(words=1 << 16, kind="burst") for _ in range(16)],
        "random": [S(words=1 << 16, kind="random") for _ in range(8)],
        "sparse60": [S(words=1 << 20, kind="burst", sparsity=0.6)],
        "sparse20": [S(words=1 << 20, kind="burst", sparsity=0.2)],
        "tails": [S(words=3, kind="burst", burst_len=512),
                  S(words=1, kind="random", burst_len=32),
                  S(words=513, kind="burst", burst_len=512),
                  S(words=700, kind="strided", burst_len=512)],
        "gemm": mod.gemm_streams(128, 4096, 4096),
        "gemm_sparse": mod.gemm_streams(64, 2048, 1024, sparsity=0.5),
        "decode": mod.attention_decode_streams(32768, 4096, 8, 128),
    }[case]


@pytest.mark.parametrize("groups", [64, 16, 2])
@pytest.mark.parametrize("case", ["one_burst", "many_bursts", "random",
                                  "sparse60", "sparse20", "tails", "gemm",
                                  "gemm_sparse", "decode"])
def test_ccmem_simulate_equals_reference(case, groups):
    for seed in (0, 3):
        got = ccmem.simulate(_streams(ccmem, case),
                             ccmem.CCMEMConfig(num_bank_groups=groups),
                             seed=seed)
        want = jax_ccmem.simulate(_streams(jax_ccmem, case),
                                  jax_ccmem.CCMEMConfig(
                                      num_bank_groups=groups), seed=seed)
        assert got == want


@pytest.fixture(scope="module")
def servers():
    got, want = explore.phase1_servers(), jax_explore.phase1_servers()
    return got, want


def test_phase1_has_the_reference_designs(servers):
    got, want = servers
    assert len(got) == len(want) == 1347
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]


@pytest.mark.parametrize("model", ["gpt2-1.5b", "llama2-70b"])
def test_explore_rows_equal_reference(servers, model):
    got_s, want_s = servers
    got = explore.explore(PAPER_MODELS[model], servers=got_s[::STRIDE])
    want = jax_explore.explore(JAX_MODELS[model], servers=want_s[::STRIDE])
    assert got.best.table_row() == want.best.table_row()
    assert [p.table_row() for p in got.frontier] == \
        [p.table_row() for p in want.frontier]
    assert dataclasses.asdict(got.best) == dataclasses.asdict(want.best)


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_codesign_search", ROOT / "examples" / "codesign_search.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("args", [["--model", "gpt2-1.5b"],
                                  ["--arch", "tinyllama-1.1b", "--ctx",
                                   "1024"]])
def test_codesign_example_prints_the_reference_lines(monkeypatch, args):
    cut = jax_explore.phase1_servers()[::STRIDE]
    cut_t = explore.phase1_servers()[::STRIDE]
    monkeypatch.setattr(jax_explore, "phase1_servers", lambda **kw: cut)
    monkeypatch.setattr(explore, "phase1_servers", lambda **kw: cut_t)
    ref = _reference_example()
    want = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["codesign_search.py"] + args)
    with contextlib.redirect_stdout(want):
        ref.main()
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        row = codesign_search.main(args)
    assert got.getvalue() == want.getvalue()
    assert f"phase 1: {len(cut)} feasible server designs" in got.getvalue()
    assert row["tco_per_mtoken"] > 0
