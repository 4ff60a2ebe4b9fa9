"""The port's configs against the JAX package's, and the three dense
configs beyond tinyllama — stablelm-1.6b (layernorm, quarter rotary,
MHA), phi3-medium-14b (rep 4 at head dim 128 at full width) and
granite-3-8b (tied embeddings) — served by the port as by the JAX
package.

Configs: every field equal, full and ``.reduced()``.  Models and
engines on the reduced configs with fp32 params: logits ``TOL`` (1e-4,
``torch_parity``), greedy outputs and scheduler counters identical, on a
mixed continuous trace and in wave mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.base import list_archs as jax_archs  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402

from torch_parity import (MIXED_KW, STATS, TOL, WAVE_STATS,  # noqa: E402
                          both_engines, mixed_trace, model_steps, pair,
                          stats_of, wave_trace)

PORTED = ("granite-3-8b", "internvl2-26b", "phi3-medium-14b",
          "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "stablelm-1.6b",
          "tinyllama-1.1b")
DENSE = ("stablelm-1.6b", "phi3-medium-14b", "granite-3-8b")


def test_registry():
    assert tuple(list_archs()) == PORTED
    assert set(PORTED) < set(jax_archs())


@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_jax(arch):
    for t, j in ((get_config(arch), jax_config(arch)),
                 (get_config(arch).reduced(), jax_config(arch).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()


@pytest.fixture(scope="module", params=DENSE)
def models(request):
    return pair(request.param)


def test_model_steps_match_jax(models):
    steps, _, _ = model_steps(models)
    for what, want, got in steps:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=what)


def test_engine_matches_jax(models):
    (jout, jstats), (tout, tstats) = both_engines(models, mixed_trace(),
                                                  **MIXED_KW)
    assert tout == jout
    assert stats_of(tstats, STATS) == stats_of(jstats, STATS)


def test_wave_mode_matches_jax(models):
    (jout, jstats), (tout, tstats) = both_engines(models, wave_trace(),
                                                  max_batch=2, mode="wave")
    assert tout == jout
    assert stats_of(tstats, WAVE_STATS) == stats_of(jstats, WAVE_STATS)
