"""The port's plain paged-attention versions against the JAX references
and the interpret-mode Pallas kernels.

Inputs are made with numpy from a seed and handed to both frameworks.
Head geometry is tinyllama's (rep = 8 query heads per kv head, D = 64)
at small batch and table sizes; prefill also runs internvl2-26b's rep 6
at D = 128 and a patch prefix.  Tolerances:

* plain vs JAX reference, fp32: 1e-5 — the same arithmetic, summed in
  another order;
* plain vs JAX reference, bf16: 2e-2 — the same arithmetic, but the two
  frameworks round bf16 products at different places (about one bf16
  ulp);
* plain vs Pallas kernel: 2e-2 — the kernel rounds its probabilities to
  the bf16 pool dtype before P @ V where the reference keeps fp32;
* pools after the scatter: bitwise, in every comparison.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode.flash_decode import \
    paged_flash_decode as pallas_decode  # noqa: E402
from repro.kernels.flash_decode.ref import \
    paged_decode_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_prefill.flash_prefill import \
    paged_flash_prefill as pallas_prefill  # noqa: E402
from repro.kernels.flash_prefill.ref import \
    prefill_attention_ref as jax_prefill_ref  # noqa: E402
from repro_torch.kernels.flash_decode.flash_decode import \
    paged_flash_decode  # noqa: E402
from repro_torch.kernels.flash_decode.ref import \
    paged_decode_ref  # noqa: E402
from repro_torch.kernels.flash_prefill.flash_prefill import \
    paged_flash_prefill  # noqa: E402
from repro_torch.kernels.flash_prefill.ref import \
    prefill_attention_ref  # noqa: E402

HK, REP, D = 2, 8, 64
H = HK * REP
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}
TOL_REF = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_PALLAS = 2e-2


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _pool(rng, N, bs, hk=HK, d=D):
    """A bf16 pool as (jax array, torch tensor) holding the same bits."""
    x = rng.standard_normal((N, bs, hk, d)).astype(np.float32)
    j = jnp.asarray(x, jnp.bfloat16)
    t = torch.from_numpy(_bf16_bits(j).copy().view(np.int16)) \
        .view(torch.bfloat16)
    return j, t


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    _, jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(a, b, tol, mask=None):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()
    b = np.asarray(jnp.asarray(b).astype(jnp.float32)) \
        if not isinstance(b, torch.Tensor) else b.float().numpy()
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


# Decode: (bs, T, lengths, table rewrites).  Dead lanes (length 0 or
# stale lengths over all-trash tables), a block shared by two lanes, and
# Pallas ``block_k`` tiles smaller than the pool block.
DECODE_CASES = {
    "trash_lanes": (8, 5, [13, 0, 40, 7], {1: "trash", 3: "trash"}),
    "shared_blocks": (8, 5, [16, 24, 9, 33], {1: "share0"}),
    "block_k_lt_bs": (8, 5, [1, 17, 40, 30], {}),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_paged_decode_plain_matches_jax(case, dtype):
    bs, T, lens, rewrite = DECODE_CASES[case]
    B = len(lens)
    rng = np.random.default_rng(list(DECODE_CASES).index(case))
    N = B * T + 1
    qj, qt = _pair(rng, (B, H, D), dtype)
    kj, kt = _pool(rng, N, bs)
    vj, vt = _pool(rng, N, bs)
    tbl = (1 + np.arange(B * T)).reshape(B, T).astype(np.int32)
    for b, how in rewrite.items():
        if how == "trash":
            tbl[b] = 0
        else:
            tbl[b, 0] = tbl[0, 0]
    lens = np.array(lens, np.int32)
    want = jax_decode_ref(qj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl))
    got = paged_flash_decode(qt, kt, vt, torch.from_numpy(lens),
                             torch.from_numpy(tbl))
    assert got.dtype == DTYPES[dtype][2]
    live = (lens > 0) & (tbl[:, 0] != 0)
    _close(want, got, TOL_REF[dtype], live)
    block_k = bs // 2 if case == "block_k_lt_bs" else 0
    kernel = pallas_decode(qj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl),
                           block_k=block_k, interpret=True)
    _close(kernel, got, TOL_PALLAS, live)
    assert paged_decode_ref(qt, kt, vt, torch.from_numpy(lens),
                            torch.from_numpy(tbl)).shape == (B, H, D)


# Prefill: (S, lengths, start or None, patch prefix, (Hk, rep, D)) over
# 4-token blocks, 6 per table.
PREFILL_BS, PREFILL_T = 4, 6
PREFILL_CASES = {
    "first_chunk": (8, [8, 3, 5], None, 0, (HK, REP, D)),
    "continuation": (8, [8, 2, 6], [8, 4, 12], 0, (HK, REP, D)),
    "start_straddles_block": (8, [6, 5, 4], [3, 9, 13], 0, (HK, REP, D)),
    "single_token": (1, [1, 1, 1], [5, 16, 23], 0, (HK, REP, D)),
    "patch_prefix": (11, [8, 3, 5], None, 3, (HK, REP, D)),
    "rep6_first_chunk": (8, [8, 3, 5], None, 0, (2, 6, 128)),
    "rep6_continuation": (8, [8, 2, 6], [3, 9, 12], 0, (2, 6, 128)),
    "rep6_patch_prefix": (10, [7, 1, 4], None, 2, (2, 6, 128)),
}


def _real_rows(S, prefix, lens):
    """Rows whose output is defined: the patch prefix and the real
    (right-aligned) prompt tokens; left-pad rows are junk by contract."""
    pad = (S - prefix - lens)[:, None]
    idx = np.arange(S)[None]
    return (idx < prefix) | (idx >= prefix + pad)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_paged_prefill_plain_matches_jax(case, dtype):
    S, lens, start, prefix, (hk, rep, d) = PREFILL_CASES[case]
    bs, T = PREFILL_BS, PREFILL_T
    B = len(lens)
    rng = np.random.default_rng(10 + list(PREFILL_CASES).index(case))
    N = B * T + 1
    qj, qt = _pair(rng, (B, S, hk * rep, d), dtype)
    knj, knt = _pair(rng, (B, S, hk, d), dtype)
    vnj, vnt = _pair(rng, (B, S, hk, d), dtype)
    kj, kt = _pool(rng, N, bs, hk, d)
    vj, vt = _pool(rng, N, bs, hk, d)
    lens = np.array(lens, np.int32)
    st = None if start is None else np.array(start, np.int32)
    tbl = (1 + np.arange(B * T)).reshape(B, T).astype(np.int32)
    # Unallocated table tails point at the trash block.
    used = (0 if st is None else st) + prefix + lens
    tbl[np.arange(T)[None] * bs >= used[:, None]] = 0
    if st is not None:
        tbl[1, 0] = tbl[0, 0]  # a shared (read-only) context block
    real = _real_rows(S, prefix, lens)

    jstart = None if st is None else jnp.asarray(st)
    want, kw, vw = jax_prefill_ref(qj, knj, vnj, kj, vj, jnp.asarray(lens),
                                   jnp.asarray(tbl), start=jstart,
                                   prefix=prefix)
    k_in, v_in = kt.clone(), vt.clone()
    got, kg, vg = paged_flash_prefill(
        qt, knt, vnt, k_in, v_in, torch.from_numpy(lens),
        torch.from_numpy(tbl),
        start=None if st is None else torch.from_numpy(st), prefix=prefix)
    assert kg is k_in and vg is v_in  # updated in place
    _close(want, got, TOL_REF[dtype], real)
    assert np.array_equal(_bf16_bits(kw), _bf16_bits(kg))
    assert np.array_equal(_bf16_bits(vw), _bf16_bits(vg))

    kernel, kk, vk = pallas_prefill(
        qj, knj, vnj, kj, vj, jnp.asarray(lens), jnp.asarray(tbl),
        jnp.zeros(B, jnp.int32) if st is None else jstart,
        prefix=prefix, has_ctx=st is not None, interpret=True)
    _close(kernel, got, TOL_PALLAS, real)
    assert np.array_equal(_bf16_bits(kk), _bf16_bits(kg))
    assert np.array_equal(_bf16_bits(vk), _bf16_bits(vg))
    # The plain version is what the wrapper runs on the CPU.
    again, _, _ = prefill_attention_ref(
        qt, knt, vnt, kt.clone(), vt.clone(), torch.from_numpy(lens),
        torch.from_numpy(tbl),
        start=None if st is None else torch.from_numpy(st), prefix=prefix)
    assert torch.equal(again, got)
