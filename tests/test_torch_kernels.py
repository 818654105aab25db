"""Port parity for the modules that hold kernels: the eq-1 aggregation
and the transport quantization, against the reference (its jnp refs and
its Pallas kernels in interpret mode, as ``tests/test_kernels.py`` runs
them on the CPU). On CPU tensors the port's wrappers compute their plain
versions; the CUDA kernels themselves are held against those on the card
by ``test_torch_cuda.py`` and by ``chip_smoke.py``.

Tolerances:
* aggregation: atol=1e-5 (float32, different summation order);
* quantization: the reference's own kernel-vs-ref bar
  (``tests/test_kernels.py:24-36``): int codes differ by at most one step
  on fewer than 1e-3 of the elements, scales to rtol=1e-6, dequantized
  values to rtol=1e-3 / atol=1.01 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregate as jagg  # noqa: E402
from repro.core import quantize as jqz  # noqa: E402
from repro.kernels.quantize import ops as jqops  # noqa: E402
from repro.kernels.quantize import ref as jqref  # noqa: E402
from repro.kernels.weighted_agg import ops as jwops  # noqa: E402
from repro.kernels.weighted_agg import ref as jwref  # noqa: E402
from repro_torch.core import aggregate as tagg  # noqa: E402
from repro_torch.core import quantize as tqz  # noqa: E402
from repro_torch.kernels.quantize import ops as tqops  # noqa: E402
from repro_torch.kernels.quantize import ref as tqref  # noqa: E402
from repro_torch.kernels.weighted_agg import ops as twops  # noqa: E402

SHAPES = [(8,), (128,), (3, 130), (256, 512), (300, 777), (2, 3, 65)]
AGG_CASES = [(1, 4, (33,)), (3, 8, (64, 32)), (5, 17, (2, 5, 7))]


def _agg_inputs(m, b, shape, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 1, (b,) + shape).astype(np.float32)
    w = rng.uniform(0, 1, (m, b)).astype(np.float32)
    w *= rng.uniform(0, 1, (1, b)) > 0.2      # padding-pair columns
    d = np.maximum(w.sum(axis=1), 1e-12).astype(np.float32)
    return u, w, d


def _assert_quant_bar(qa, sa, qb, sb):
    dq = np.abs(np.asarray(qa, np.int32) - np.asarray(qb, np.int32))
    assert dq.max(initial=0) <= 1 and (dq != 0).mean() < 1e-3
    np.testing.assert_allclose(np.asarray(sa), np.asarray(sb), rtol=1e-6)


@pytest.mark.parametrize("m,b,shape", AGG_CASES)
def test_multi_weighted_agg_matches_reference(m, b, shape):
    u, w, d = _agg_inputs(m, b, shape, seed=b)
    out = twops.multi_weighted_agg(torch.from_numpy(u.reshape(b, -1)),
                                   torch.from_numpy(w), torch.from_numpy(d))
    ref = jwref.multi_weighted_agg_ref(u.reshape(b, -1), w, d)
    pallas = jwops.multi_weighted_agg(jnp.asarray(u), w, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(pallas).reshape(m, -1), atol=1e-5)


def test_multi_weighted_average_pytree_matches_reference():
    """core/aggregate over a param dict, incl. the one-model form."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(0, 1, (6, 5, 4)).astype(np.float32),
            "b": rng.normal(0, 1, (6, 9)).astype(np.float32)}
    w = np.zeros((2, 6), np.float32)
    w[0, :3] = [0.5, 0.2, 0.3]
    w[1, 3:5] = [0.7, 0.3]
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    multi = tagg.multi_weighted_average(tt, torch.from_numpy(w))
    jmulti = jagg.multi_weighted_average(tree, w)
    for k in tree:
        np.testing.assert_allclose(multi[k].numpy(), np.asarray(jmulti[k]),
                                   atol=1e-5)
    single = tagg.weighted_average(tt, torch.from_numpy(w[1]))
    jsingle = jagg.weighted_average(tree, w[1])
    for k in tree:
        np.testing.assert_allclose(single[k].numpy(), np.asarray(jsingle[k]),
                                   atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_ref_matches_reference(shape, dtype, bits):
    rng = np.random.default_rng(abs(hash(shape)) % 997)
    x = (rng.normal(0, 1, shape) * 3).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qr, sr = jqref.quantize_ref(xj, bits=bits)
    x2, _ = tqref.to_2d(xt)
    qt, st = tqops.quantize(x2, bits)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(qt.shape) == qr.shape and tuple(st.shape) == sr.shape
    _assert_quant_bar(qt.numpy(), st.numpy(), qr, sr)
    # dequantize the reference's codes on both sides
    xr = jqref.dequantize_ref(qr, sr, shape, xj.dtype)
    xd = tqref.dequantize_ref(torch.from_numpy(np.array(qr)),
                              torch.from_numpy(np.array(sr)), shape,
                              xt.dtype)
    assert xd.dtype == xt.dtype and tuple(xd.shape) == shape
    step = float(np.asarray(sr).max())
    np.testing.assert_allclose(xd.float().numpy(),
                               np.asarray(xr, np.float32), rtol=1e-3,
                               atol=1.01 * step)
    flat = tqops.dequantize(torch.from_numpy(np.array(qr)),
                            torch.from_numpy(np.array(sr)), x2.shape[1])
    np.testing.assert_allclose(flat.numpy().reshape(shape),
                               np.asarray(xr, np.float32), rtol=1e-3,
                               atol=1.01 * step)


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_pallas_interpret(shape):
    rng = np.random.default_rng(7)
    x = (rng.normal(0, 1, shape) * 3).astype(np.float32)
    qk, sk = jqops.quantize(jnp.asarray(x))
    x2, _ = tqref.to_2d(torch.from_numpy(x))
    qt, st = tqops.quantize(x2, 8)
    _assert_quant_bar(qt.numpy(), st.numpy(), qk, sk)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_rounds_half_to_even(bits):
    """Exact .5 quotients round to the even code, as jnp.round does
    (round-half-away-from-zero would give 1, 2, 3, -1, -2, -3)."""
    qmax = (1 << (bits - 1)) - 1
    halves = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    x = np.zeros((1, 128), np.float32)
    x[0, 0] = qmax                      # block max -> scale exactly 1.0
    x[0, 1:1 + len(halves)] = halves
    qt, st = tqops.quantize(torch.from_numpy(x), bits)
    qr, sr = jqref.quantize_ref(jnp.asarray(x), bits=bits)
    assert float(st[0, 0]) == 1.0 == float(sr[0, 0])
    expect = [0, 2, 2, 0, -2, -2]
    assert qt[0, 1:1 + len(halves)].tolist() == expect
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))


def test_roundtrip_and_compressed_bytes_match_reference():
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(0, 1, (40, 300)).astype(np.float32),
            "b": rng.normal(0, 1, (37,)).astype(np.float32)}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    a = tqz.roundtrip(tt, bits=8)
    b = jqz.roundtrip(tree, bits=8)
    for k in tree:
        q, s = jqz.quantize_leaf(tree[k])
        np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                   atol=1.01 * float(np.asarray(s).max()))
    assert tqz.roundtrip(tt, bits=0) is tt
    assert tqz.compressed_bytes(tt, 8) == jqz.compressed_bytes(tree, 8)
    assert tqz.compressed_bytes(tt, 4) == jqz.compressed_bytes(tree, 4)
    q, s = tqz.quantize_leaf(tt["w"])
    assert tuple(q.shape) == (1, 12032) and tuple(s.shape) == (1, 94)
    back = tqz.dequantize_leaf(q, s, (40, 300), torch.float32)
    np.testing.assert_allclose(back.numpy(), a["w"].numpy())


def test_roundtrip_rows_equals_per_row_roundtrip():
    """The round's batched transport (one launch per leaf over the A
    aggregated rows) blocks each row as its own payload — the
    reference's vmap of roundtrip."""
    rng = np.random.default_rng(4)
    stacked = {"w": rng.normal(0, 1, (3, 5, 70)).astype(np.float32)}
    jrows = jax.vmap(lambda t: jqz.roundtrip(t, 8))(stacked)
    rows = tqz.roundtrip_rows({"w": torch.from_numpy(stacked["w"])}, 8)
    np.testing.assert_array_equal(rows["w"].numpy(), np.asarray(jrows["w"]))
    for i in range(3):
        one = tqz.roundtrip({"w": torch.from_numpy(stacked["w"][i])}, 8)
        np.testing.assert_array_equal(rows["w"][i].numpy(), one["w"].numpy())


def test_wrappers_reject_bad_input():
    u = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        twops.multi_weighted_agg(u, torch.zeros(2, 3), torch.ones(2))
    with pytest.raises(ValueError):
        tqops.quantize(torch.zeros(8), 8)
    with pytest.raises(ValueError):
        tqops.quantize(torch.zeros(2, 8), 9)
    with pytest.raises(ValueError):
        tqops.dequantize(torch.zeros(2, 128, dtype=torch.int8),
                         torch.ones(2, 2), 100)
