"""The port's dry run (``launch.dryrun``) and roofline
(``core.roofline``).

  * a reduced train cell's record: status "ok", the reference's keys,
    each a number or null with its ``basis``; a serving cell's
    collective terms null; ``--kv-dtype f8`` refused until it is ported;
  * ``run_serving_smoke``: greedy tokens and scheduler stats of a
    2-way sharded engine identical to the meshless one (fp32);
  * the roofline: twins of ``tests/test_sharding.py``'s HLO parsing and
    terms, with the H100's constants.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import roofline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors (the suite runs
    several workers on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: The reference's record keys for an "ok" cell (repro.launch.dryrun).
REF_KEYS = {"arch", "shape", "mesh", "kind", "seq_len", "global_batch",
            "status", "devices", "compile_s", "total_s", "params",
            "params_active", "tokens", "model_flops", "flops_hlo_global",
            "bytes_hlo_global", "wire_bytes_global", "attention_correction",
            "useful_flops_ratio", "memory_analysis", "collectives",
            "roofline"}


def test_reduced_train_cell(tmp_path):
    rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", "single", tmp_path,
                          reduced=True)
    assert rec["status"] == "ok", rec.get("error")
    assert REF_KEYS <= set(rec)
    assert json.loads((tmp_path / "tinyllama-1.1b__train_4k__single__"
                       "reduced.json").read_text()) == rec
    for key in REF_KEYS - {"arch", "shape", "mesh", "kind", "status"}:
        v = rec[key]
        if v is None:
            assert key in rec["basis"], key
        elif isinstance(v, dict):
            for k, x in v.items():
                assert x is None or isinstance(x, (int, float, dict, str)), k
                if x is None:
                    assert key in rec["basis"], (key, k)
        else:
            assert isinstance(v, (int, float)), key
    assert rec["devices"] == 256 and rec["tokens"] == 256 * 4096
    assert rec["flops_hlo_global"] > rec["model_flops"] > 0
    assert rec["wire_bytes_global"] == pytest.approx(sum(
        c["wire_bytes_global"] for c in rec["collectives"].values()))
    assert {"all_gather", "all_gather/bwd", "psum", "psum/bwd",
            "grad_sum"} <= set(rec["collectives"])
    r = rec["roofline"]
    assert r["t_compute_s"] == pytest.approx(
        rec["flops_hlo_global"] / (256 * 989e12))
    assert rec["fits_one_card"] is True


def test_serving_cell_and_refusals(tmp_path):
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "multi", tmp_path,
                          reduced=True)
    assert rec["status"] == "ok" and rec["devices"] == 512
    assert rec["wire_bytes_global"] is None and rec["collectives"] is None
    assert "wire_bytes_global" in rec["basis"]
    skip = dryrun.run_cell("qwen2-moe-a2.7b", "long_500k", "single",
                           tmp_path, reduced=True)
    assert skip["status"] == "skipped"
    # --kv-dtype f8 (it once raised) writes its __kvf8 record; its cache
    # bytes are half the bf16 record's.
    dryrun.main(["--arch", "qwen2-moe-a2.7b", "--shape", "long_500k",
                 "--kv-dtype", "f8", "--out", str(tmp_path)])
    assert (tmp_path / "qwen2-moe-a2.7b__long_500k__single__kvf8.json"
            ).exists()
    f8 = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "multi", tmp_path,
                         reduced=True, kv_dtype="f8")
    assert f8["status"] == "ok"
    cache = [r["memory_analysis"]["cache_size_in_bytes"] for r in (rec, f8)]
    assert cache[0] > 0 and cache[1] * 2 == cache[0]
    assert (tmp_path / "tinyllama-1.1b__decode_32k__multi__kvf8__reduced"
            ".json").exists()


def test_serving_smoke(tmp_path):
    rec = dryrun.run_serving_smoke(tmp_path, model_parallel=2, device="cpu")
    assert rec["status"] == "ok"
    assert rec["greedy_identical"] and rec["stats_identical"]
    assert (tmp_path / "serving_smoke__mp2.json").exists()


def test_serving_smoke_cli_takes_model_parallel(tmp_path, capsys):
    """The reference's ``--model-parallel`` reaches ``run_serving_smoke``
    through the port's CLI: the smoke at 4 model shards on the CPU."""
    rc = dryrun.main(["--serving-smoke", "--model-parallel", "4",
                      "--device", "cpu", "--out", str(tmp_path)])
    rec = json.loads(capsys.readouterr().out)
    assert rc == 0 and rec["status"] == "ok"
    assert rec["greedy_identical"] and rec["stats_identical"]
    assert (tmp_path / "serving_smoke__mp4.json").exists()
    assert not (tmp_path / "serving_smoke__mp2.json").exists()


# ---------------------------------------------------------------------------
# Roofline (twins of tests/test_sharding.py's)
# ---------------------------------------------------------------------------

def test_parse_collectives_synthetic():
    hlo = """
  %ar = f32[16,128]{1,0} all-reduce(%x), replica_groups=[16,16]<=[256]
  %ag = bf16[256,64]{1,0} all-gather(%y), replica_groups={{0,1,2,3}}
  %cp = f32[8]{0} collective-permute(%z)
  %other = f32[4]{0} add(%a, %b)
"""
    stats = roofline.parse_collectives(hlo, total_devices=256)
    assert set(stats.by_op) == {"all-reduce", "all-gather",
                                "collective-permute"}
    ar = stats.by_op["all-reduce"]
    assert ar[1] == 16 * 128 * 4
    assert np.isclose(ar[2], 16 * 128 * 4 * 2 * 15 / 16 * 256)
    ag = stats.by_op["all-gather"]
    assert ag[1] == 256 * 64 * 2
    assert np.isclose(ag[2], 256 * 64 * 2 * 3 / 4 * 256)


def test_roofline_terms_bottleneck():
    """The H100's constants: 989 TFLOP/s, 3.35 TB/s, 450 GB/s."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    t = roofline.RooflineTerms(flops=989e12 * 256, bytes_hbm=0.0,
                               wire_bytes=0.0, chips=256)
    assert np.isclose(t.t_compute, 1.0)
    assert t.bottleneck == "compute"
    t2 = roofline.RooflineTerms(flops=0, bytes_hbm=3.35e12 * 256 * 2,
                                wire_bytes=0, chips=256)
    assert t2.bottleneck == "memory" and np.isclose(t2.t_memory, 2.0)
    t3 = roofline.RooflineTerms(flops=0, bytes_hbm=0,
                                wire_bytes=450e9 * 256 * 3, chips=256)
    assert t3.bottleneck == "collective" and np.isclose(t3.t_collective, 3)


@settings(deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.floats(1, 1e18), st.floats(1, 1e18), st.floats(1, 1e18))
def test_roofline_bound_is_max(f, b, w):
    t = roofline.RooflineTerms(flops=f, bytes_hbm=b, wire_bytes=w, chips=256)
    assert np.isclose(t.t_bound,
                      max(t.t_compute, t.t_memory, t.t_collective))


def test_model_flops():
    assert roofline.model_flops(10, 100, train=True) == 6000.0
    assert roofline.model_flops(10, 100, train=False) == 2000.0
