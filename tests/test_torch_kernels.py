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
from repro_torch.kernels import group as tgroup  # noqa: E402
from repro_torch.kernels.quantize import ops as tqops  # noqa: E402
from repro_torch.kernels.quantize import ref as tqref  # noqa: E402
from repro_torch.kernels.weighted_agg import ops as twops  # noqa: E402
from repro_torch.kernels.weighted_agg import ref as twref  # noqa: E402

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
    """The round's batched transport (one grouped call over the A
    aggregated rows of every leaf) blocks each row as its own payload —
    the reference's vmap of roundtrip."""
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


# -- single-model eq 1 and the fused dequantize-aggregate ---------------------
# (port of weighted_agg_2d and dequant_agg_2d; atol=1e-5, float32 sums in
# another order)

SINGLE_CASES = [(3, (17,)), (8, (64, 32)), (2, (1, 5, 7)), (30, (2303,)),
                (1, (5,))]


def _single_inputs(n, shape, seed, zero_some=True):
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 1, (n,) + shape).astype(np.float32)
    w = (rng.uniform(0, 1, n) + 0.1).astype(np.float32)
    if zero_some and n > 1:
        w[rng.uniform(0, 1, n) < 0.3] = 0.0     # non-holders
        w[0] = max(w[0], 0.1)
    return u, w, np.float32(max(w.sum(), 1e-12))


@pytest.mark.parametrize("n,shape", SINGLE_CASES)
def test_weighted_agg_matches_reference(n, shape):
    u, w, d = _single_inputs(n, shape, seed=n)
    flat = u.reshape(n, -1)
    out = twops.weighted_agg(torch.from_numpy(flat), torch.from_numpy(w),
                             torch.tensor(d))
    ref = jwref.weighted_agg_ref(flat, w, d)
    pallas = jwops.weighted_agg(jnp.asarray(u), w, d)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(out.numpy().reshape(shape),
                               np.asarray(pallas), atol=1e-5)


@pytest.mark.parametrize("block", [128, 64])
@pytest.mark.parametrize("n,d", [(1, 128), (6, 1024), (30, 640), (5, 2304)])
def test_dequant_agg_matches_reference(block, n, d):
    rng = np.random.default_rng(n * d + block)
    q = rng.integers(-127, 128, (n, d)).astype(np.int8)
    s = rng.uniform(1e-3, 0.05, (n, d // block)).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    w[rng.uniform(0, 1, n) < 0.3] = 0.0
    den = np.float32(max(w.sum(), 1e-12))
    out = twops.dequant_agg(torch.from_numpy(q), torch.from_numpy(s),
                            torch.from_numpy(w), torch.tensor(den), block)
    ref = jwref.dequant_agg_ref(q, s, w, den, block=block)
    pallas = jwops.dequant_agg(jnp.asarray(q), jnp.asarray(s), w, den,
                               block=block)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5)


def test_dequant_agg_of_quantized_updates_matches_two_step():
    """Codes and scales from the port's quantize, as the chip check feeds
    the kernel: the fused form equals dequantize-then-aggregate."""
    rng = np.random.default_rng(3)
    u = torch.from_numpy((rng.normal(0, 2, (6, 1024))).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 1, 6).astype(np.float32))
    q, s = tqops.quantize(u, 8)
    fused = twops.dequant_agg(q, s, w, w.sum())
    two = twops.weighted_agg(tqops.dequantize(q, s, 1024), w, w.sum())
    jfused = jwops.dequant_agg(jnp.asarray(q.numpy()),
                               jnp.asarray(s.numpy()), w.numpy(),
                               np.float32(w.sum()))
    np.testing.assert_allclose(fused.numpy(), two.numpy(), atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), atol=1e-5)


@pytest.mark.parametrize("block", [128, 64])
@pytest.mark.parametrize("n", [1, 7, 30])
def test_dequant_agg_group_matches_reference(block, n):
    """Leaves of mixed lengths in one grouped call, zero-weight rows
    among them, each against the reference's jnp ref and its Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(n * block)
    sizes = [128, 2304, 640, 1024]
    qs = [rng.integers(-127, 128, (n, d)).astype(np.int8) for d in sizes]
    ss = [rng.uniform(1e-3, 0.05, (n, d // block)).astype(np.float32)
          for d in sizes]
    w = rng.uniform(0, 1, n).astype(np.float32)
    w[rng.uniform(0, 1, n) < 0.3] = 0.0
    w[0] = max(w[0], 0.1)
    den = np.float32(w.sum())
    outs = twops.dequant_agg_group([torch.from_numpy(q) for q in qs],
                                   [torch.from_numpy(s) for s in ss],
                                   torch.from_numpy(w), torch.tensor(den),
                                   block)
    assert len(outs) == len(sizes)
    for q, s, out in zip(qs, ss, outs):
        assert out.dtype == torch.float32 and out.shape == (q.shape[1],)
        ref = jwref.dequant_agg_ref(q, s, w, den, block=block)
        pallas = jwops.dequant_agg(jnp.asarray(q), jnp.asarray(s), w, den,
                                   block=block)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                                   atol=1e-5)


@pytest.mark.parametrize("literal", [False, True])
def test_weighted_average_pytree_matches_reference(literal):
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(0, 1, (5, 7, 9)).astype(np.float32),
            "b": rng.normal(0, 1, (5, 13)).astype(np.float32)}
    w = np.array([0.5, 0.0, 0.2, 0.3, 0.0], np.float32)
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    out = tagg.weighted_average(tt, torch.from_numpy(w), literal_eq1=literal)
    ref = jagg.weighted_average(tree, w, literal_eq1=literal)
    ker = jagg.weighted_average(tree, w, literal_eq1=literal,
                                use_kernel=True)
    for k in tree:
        assert out[k].shape == tt[k].shape[1:]
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ker[k]),
                                   atol=1e-5)


def test_literal_eq1_is_unnormalized_sum_like_reference():
    """``tests/test_aggregate.py::test_literal_eq1_is_unnormalized_sum``
    through both packages, single- and multi-model."""
    rng = np.random.default_rng(6)
    tree = {"a": rng.normal(0, 1, (2, 7, 9)).astype(np.float32)}
    tt = {"a": torch.from_numpy(tree["a"])}
    w = np.array([0.5, 0.5], np.float32)
    lit = tagg.weighted_average(tt, torch.from_numpy(w), literal_eq1=True)
    expect = 0.5 * tree["a"][0] + 0.5 * tree["a"][1]
    np.testing.assert_allclose(lit["a"].numpy(), expect, rtol=1e-5)
    wm = np.array([[0.5, 0.5], [0.2, 0.0]], np.float32)
    multi = tagg.multi_weighted_average(tt, torch.from_numpy(wm),
                                        literal_eq1=True)
    jmulti = jagg.multi_weighted_average(tree, wm, literal_eq1=True)
    np.testing.assert_allclose(multi["a"].numpy(), np.asarray(jmulti["a"]),
                               atol=1e-5)
    np.testing.assert_allclose(multi["a"][1].numpy(), 0.2 * tree["a"][0],
                               rtol=1e-5)


def test_participation_weights_matches_reference():
    c = np.array([[0.6, 0.4], [0.3, 0.7], [0.5, 0.5]])
    participating = np.array([True, False, True])
    active = np.array([[True, True], [True, True], [False, True]])
    for m in (0, 1):
        w = tagg.participation_weights(c, m, participating, active)
        np.testing.assert_array_equal(
            w, jagg.participation_weights(c, m, participating, active))
    np.testing.assert_allclose(
        tagg.participation_weights(c, 1, participating, active),
        [0.4, 0.0, 0.5])


def test_nonfinite_zero_weight_row_poisons_like_reference():
    """Rows of weight 0 are multiplied, not skipped, in both packages:
    a non-holder whose training diverged makes the aggregate NaN."""
    u = np.ones((3, 10), np.float32)
    u[1, 4] = np.nan
    w = np.array([0.5, 0.0, 0.5], np.float32)
    out = twops.weighted_agg(torch.from_numpy(u), torch.from_numpy(w),
                             torch.tensor(np.float32(1.0)))
    ref = np.asarray(jwref.weighted_agg_ref(u, w, np.float32(1.0)))
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
    assert np.isnan(ref[4]) and np.isfinite(np.delete(ref, 4)).all()


def test_single_model_wrappers_reject_bad_input():
    u, w, d = torch.zeros(4, 8), torch.ones(4), torch.tensor(4.0)
    with pytest.raises(ValueError):
        twops.weighted_agg(u, torch.ones(3), d)           # N mismatch
    with pytest.raises(ValueError):
        twops.weighted_agg(u, w, torch.ones(1))           # denom not 0-d
    with pytest.raises(ValueError):
        twops.weighted_agg(u[0], w, d)                    # not 2-D
    q = torch.zeros(4, 256, dtype=torch.int8)
    with pytest.raises(ValueError):
        twops.dequant_agg(q, torch.ones(4, 2), w, d, block=96)   # D % block
    with pytest.raises(ValueError):
        twops.dequant_agg(q, torch.ones(4, 3), w, d)      # scales shape
    with pytest.raises(ValueError):
        twops.dequant_agg(q, torch.ones(3, 2), w, d)      # scales rows
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        twops.weighted_agg(torch.zeros(2, 4, **meta), torch.ones(2, **meta),
                           torch.tensor(1.0, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        twops.dequant_agg(torch.zeros(2, 128, dtype=torch.int8, **meta),
                          torch.ones(2, 1, **meta), torch.ones(2, **meta),
                          torch.tensor(1.0, **meta))


# -- eq 1 over every leaf of a param dict in one grouped call -----------------
# (on CPU tensors the group wrappers are the plain versions leaf by leaf, so
# they equal the per-leaf wrappers bit for bit)

GROUP_SIZES = [0, 1, 10, 2_303, 128, 5]


def _group_leaves(b, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, (b, d)).astype(np.float32))
            for d in GROUP_SIZES]


@pytest.mark.parametrize("m,b", [(1, 4), (2, 32), (3, 7), (17, 5)])
def test_multi_weighted_agg_group_equals_per_leaf_plain(m, b):
    us = _group_leaves(b, seed=m)
    _, w, d = _agg_inputs(m, b, (1,), seed=b)
    w, d = torch.from_numpy(w), torch.from_numpy(d)
    outs = twops.multi_weighted_agg_group(us, w, d)
    assert len(outs) == len(us)
    for u, out in zip(us, outs):
        assert out.dtype == torch.float32 and out.shape == (m, u.shape[1])
        assert torch.equal(out, twops.multi_weighted_agg(u, w, d))
        assert torch.equal(out, twref.multi_weighted_agg_ref(u, w, d))


@pytest.mark.parametrize("n", [1, 3, 30])
def test_weighted_agg_group_equals_per_leaf_plain(n):
    us = _group_leaves(n, seed=n)
    _, w, d = _single_inputs(n, (1,), seed=n)
    w, d = torch.from_numpy(w), torch.tensor(d)
    outs = twops.weighted_agg_group(us, w, d)
    assert len(outs) == len(us)
    for u, out in zip(us, outs):
        assert out.dtype == torch.float32 and out.shape == (u.shape[1],)
        assert torch.equal(out, twops.weighted_agg(u, w, d))
        assert torch.equal(out, twref.weighted_agg_ref(u, w, d))


def test_group_wrappers_take_an_empty_group():
    assert twops.multi_weighted_agg_group([], torch.ones(2, 3),
                                          torch.ones(2)) == []
    assert twops.weighted_agg_group([], torch.ones(3), torch.tensor(1.0)) == []
    assert twops.dequant_agg_group([], [], torch.ones(3),
                                   torch.tensor(1.0)) == []


def _bad_groups():
    """Each case: the group calls that must raise ValueError."""
    u, meta = torch.zeros(4, 8), torch.zeros(4, 8, device="meta")

    def eq1(leaves):
        return [lambda: twops.multi_weighted_agg_group(
                    leaves, torch.ones(2, 4), torch.ones(2)),
                lambda: twops.weighted_agg_group(leaves, torch.ones(4),
                                                 torch.tensor(4.0))]

    q, s = torch.zeros(4, 256, dtype=torch.int8), torch.ones(4, 2)

    def deq(qs, ss, block=128):
        return [lambda: twops.dequant_agg_group(qs, ss, torch.ones(4),
                                                torch.tensor(4.0), block)]

    return {
        "mismatched B": eq1([u, torch.zeros(3, 8)]),
        "mixed devices": eq1([u, meta]),
        "non-contiguous leaf": eq1([u, torch.zeros(8, 4).t()]),
        "not float32": eq1([u, torch.zeros(4, 8, dtype=torch.float64)]),
        "not 2-D": eq1([u, torch.zeros(4, 2, 4)]),
        "dequant_agg scales shape": deq([q, q], [s, torch.ones(4, 3)]),
        "dequant_agg D % block": deq([q], [torch.ones(4, 2)], block=96),
        "dequant_agg mismatched N": deq(
            [q, torch.zeros(3, 256, dtype=torch.int8)],
            [s, torch.ones(3, 2)]),
        "dequant_agg lists of different lengths": deq([q, q], [s]),
        "dequant_agg codes not int8": deq([q, q.float()], [s, s]),
        "dequant_agg scales not float32": deq([q], [s.double()]),
        "dequant_agg non-contiguous codes": deq(
            [torch.zeros(256, 4, dtype=torch.int8).t()], [s]),
        "dequant_agg mixed devices": deq([q, q.to("meta")],
                                         [s, s.to("meta")]),
    }


@pytest.mark.parametrize("case", list(_bad_groups()))
def test_group_wrappers_reject_bad_leaves(case):
    for call in _bad_groups()[case]:
        with pytest.raises(ValueError):
            call()


def test_group_wrappers_reject_bad_weights():
    us = [torch.zeros(4, 8)]
    with pytest.raises(ValueError):
        twops.multi_weighted_agg_group(us, torch.ones(2, 4), torch.ones(3))
    with pytest.raises(ValueError):
        twops.multi_weighted_agg_group(us, torch.ones(4), torch.ones(1))
    with pytest.raises(ValueError):
        twops.multi_weighted_agg_group(us, torch.ones(2, 4, dtype=torch.float64),
                                       torch.ones(2))
    with pytest.raises(ValueError):
        twops.weighted_agg_group(us, torch.ones(4), torch.ones(1))


def _many_leaf_tree(lead, seed):
    """A pytree with more leaves than one launch's table holds, of mixed
    ranks and lengths (empty, 1, 10, 2303 values among them)."""
    rng = np.random.default_rng(seed)
    shapes = [(0,), (1,), (10,), (2_303,), (3, 5, 7), (4, 32)] + [
        (int(k),) for k in rng.integers(1, 200, 34)]
    return {f"leaf{i:02d}": rng.normal(0, 1, (lead,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("literal", [False, True])
def test_multi_weighted_average_many_leaves_matches_reference(literal):
    tree = _many_leaf_tree(6, seed=7)
    w = np.zeros((3, 6), np.float32)
    w[0, :3] = [0.5, 0.2, 0.3]
    w[1, 3:5] = [0.7, 0.3]
    w[2, 5] = 1.0
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    out = tagg.multi_weighted_average(tt, torch.from_numpy(w),
                                      literal_eq1=literal)
    ref = jagg.multi_weighted_average(tree, w, literal_eq1=literal)
    assert list(out) == list(tree)
    for k in tree:
        assert out[k].shape == (3,) + tree[k].shape[1:]
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5)


@pytest.mark.parametrize("literal", [False, True])
def test_weighted_average_many_leaves_matches_reference(literal):
    tree = _many_leaf_tree(5, seed=8)
    w = np.array([0.5, 0.0, 0.2, 0.3, 0.0], np.float32)
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    out = tagg.weighted_average(tt, torch.from_numpy(w), literal_eq1=literal)
    ref = jagg.weighted_average(tree, w, literal_eq1=literal)
    assert list(out) == list(tree)
    for k in tree:
        assert out[k].shape == tree[k].shape[1:]
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5)


# -- transport quantization over every leaf of a param dict in one call -------
# (on CPU tensors the group wrappers are the plain versions leaf by leaf)

QUANT_GROUP_SIZES = [10, 32, 864, 2_303, 9_216]


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_group_matches_reference(rows, bits):
    """One group over mixed leaves against the reference's jnp version
    and its Pallas kernels (interpret mode), leaf by leaf."""
    rng = np.random.default_rng(rows * 10 + bits)
    xs = [(rng.normal(0, 1, (rows, d)) * 3).astype(np.float32)
          for d in QUANT_GROUP_SIZES]
    qs, ss = tqops.quantize_group([torch.from_numpy(x) for x in xs], bits)
    assert len(qs) == len(ss) == len(xs)
    for x, q, s in zip(xs, qs, ss):
        qr, sr = jqref.quantize_ref(jnp.asarray(x), bits=bits)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert tuple(q.shape) == qr.shape and tuple(s.shape) == sr.shape
        _assert_quant_bar(q.numpy(), s.numpy(), qr, sr)
        qk, sk = jqops.quantize(jnp.asarray(x), bits=bits)
        _assert_quant_bar(q.numpy(), s.numpy(), qk, sk)
    # dequantize the reference's codes on both sides
    refs = [jqref.quantize_ref(jnp.asarray(x), bits=bits) for x in xs]
    outs = tqops.dequantize_group(
        [torch.from_numpy(np.array(q)) for q, _ in refs],
        [torch.from_numpy(np.array(s)) for _, s in refs],
        [x.shape[1] for x in xs])
    for x, out, (qr, sr) in zip(xs, outs, refs):
        assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jqref.dequantize_ref(
                qr, sr, x.shape, jnp.float32)))
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jqops.dequantize(qr, sr, x.shape,
                                                     jnp.float32)))


def _narrow_cnn_tree(lead, seed):
    """The CNN's 20 leaves (names and layouts of ``models/cnn.py``) at an
    eighth of its widths, stacked over ``lead`` models."""
    rng = np.random.default_rng(seed)
    channels, dense = (4, 4, 8, 8, 16, 16, 32, 32), 32
    shapes, c_in = {}, 3
    for i, c_out in enumerate(channels):
        shapes[f"conv.{i}"] = (3, 3, c_in, c_out)
        c_in = c_out
    for i, c_out in enumerate(channels):
        shapes[f"conv_b.{i}"] = (c_out,)
    shapes.update({"fc1": (2 * 2 * c_in, dense), "fc1_b": (dense,),
                   "fc2": (dense, 10), "fc2_b": (10,)})
    return {k: (rng.normal(0, 1, (lead,) + s) * 0.1).astype(np.float32)
            for k, s in shapes.items()}


def test_roundtrip_rows_on_a_cnn_param_dict_matches_reference_vmap():
    stacked = _narrow_cnn_tree(3, seed=5)
    jrows = jax.vmap(lambda t: jqz.roundtrip(t, 8))(stacked)
    rows = tqz.roundtrip_rows({k: torch.from_numpy(v)
                               for k, v in stacked.items()}, 8)
    assert list(rows) == list(stacked) and len(rows) == 20
    for k in stacked:
        assert rows[k].shape == stacked[k].shape
        np.testing.assert_array_equal(rows[k].numpy(), np.asarray(jrows[k]))


@pytest.mark.parametrize("stacked", [False, True])
def test_roundtrip_makes_one_group_call_per_kernel(monkeypatch, stacked):
    """Every leaf of a param dict goes through one quantize_group and one
    dequantize_group call, and no per-leaf wrapper."""
    calls = []
    for name in ("quantize_group", "dequantize_group", "quantize",
                 "dequantize"):
        fn = getattr(tqops, name)
        monkeypatch.setattr(
            tqops, name,
            lambda *a, _fn=fn, _name=name, **k: (calls.append(_name),
                                                 _fn(*a, **k))[1])
    tree = {k: torch.from_numpy(v) for k, v in _narrow_cnn_tree(
        2 if stacked else 1, seed=6).items()}
    if stacked:
        tqz.roundtrip_rows(tree, 8)
    else:
        tqz.roundtrip({k: v[0] for k, v in tree.items()}, 8)
    assert calls == ["quantize_group", "dequantize_group"]


@pytest.mark.parametrize("itemsize", [1, 4])
def test_group_segments_start_16_byte_aligned(itemsize):
    sizes = [0, 1, 10, 2_303, 128, 5]
    offsets, total = tgroup.segments(sizes, itemsize)
    align = 16 // itemsize
    assert all(o % align == 0 for o in offsets)
    ends = [o + n for o, n in zip(offsets, sizes)]
    assert all(e <= o for e, o in zip(ends, offsets[1:] + [total]))
    assert total - ends[-1] < align and offsets[0] == 0
    if itemsize == 4:
        assert offsets == [0, 0, 4, 16, 2_320, 2_448] and total == 2_456


@pytest.mark.parametrize("cap", [1, 3, 32])
def test_group_launches_split_at_the_cap(cap):
    sizes = [0, 5, 7, 0, 1, 300, 2, 0, 9] * 5
    groups = tgroup.launch_groups(sizes, cap)
    live = [i for i, n in enumerate(sizes) if n]
    assert [i for g in groups for i in g] == live
    assert len(groups) == -(-len(live) // cap)
    assert all(1 <= len(g) <= cap for g in groups)
    assert tgroup.launch_groups([0, 0], cap) == []


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_group_views_are_aligned_views_of_one_buffer(dtype):
    shapes = [(0, 128), (3, 0), (2, 5), (1, 10), (4, 128), (7,)]
    views, ptrs = tgroup.views(shapes, dtype, torch.device("cpu"))
    base = views[0].untyped_storage().data_ptr()
    for v, p, shape in zip(views, ptrs, shapes):
        assert tuple(v.shape) == shape and v.dtype == dtype
        assert v.is_contiguous() and v.untyped_storage().data_ptr() == base
        assert (p - base) % 16 == 0
        if v.numel():                       # an empty view reports 0
            assert v.data_ptr() == p


def test_quantize_group_takes_empty_groups_and_leaves():
    assert tqops.quantize_group([], 8) == ([], [])
    assert tqops.dequantize_group([], [], []) == []
    xs = [torch.zeros(0, 5), torch.zeros(3, 0), torch.ones(2, 130)]
    qs, ss = tqops.quantize_group(xs, 8)
    assert [tuple(q.shape) for q in qs] == [(0, 128), (3, 0), (2, 256)]
    assert [tuple(s.shape) for s in ss] == [(0, 1), (3, 0), (2, 2)]
    outs = tqops.dequantize_group(qs, ss, [5, 0, 130])
    assert [tuple(o.shape) for o in outs] == [(0, 5), (3, 0), (2, 130)]
    assert torch.equal(outs[2], xs[2])


def _bad_quantize_groups():
    x = torch.zeros(2, 8)
    return {
        "mixed devices": [x, torch.zeros(2, 8, device="meta")],
        "not float32": [x, torch.zeros(2, 8, dtype=torch.float64)],
        "non-contiguous leaf": [x, torch.zeros(8, 2).t()],
        "not 2-D": [x, torch.zeros(8)],
    }


@pytest.mark.parametrize("case", list(_bad_quantize_groups()))
def test_quantize_group_rejects_bad_leaves(case):
    with pytest.raises(ValueError):
        tqops.quantize_group(_bad_quantize_groups()[case], 8)


def _bad_dequantize_groups():
    q, s = torch.zeros(2, 256, dtype=torch.int8), torch.ones(2, 2)
    return {
        "mismatched ns": ([q, q], [s, s], [256]),
        "mismatched scales": ([q, q], [s], [256, 256]),
        "n past the padded row": ([q], [s], [257]),
        "n a block short of the padded row": ([q], [s], [100]),
        "n = 0 on padded rows": ([q], [s], [0]),
        "scales of another shape": ([q], [torch.ones(2, 3)], [200]),
        "codes not int8": ([q.float()], [s], [200]),
        "scales not float32": ([q], [s.double()], [200]),
        "non-contiguous codes": ([torch.zeros(256, 2, dtype=torch.int8).t()],
                                 [s], [200]),
        "mixed devices": ([q, q.to("meta")], [s, s.to("meta")], [200, 200]),
    }


@pytest.mark.parametrize("case", list(_bad_dequantize_groups()))
def test_dequantize_group_rejects_bad_input(case):
    with pytest.raises(ValueError):
        tqops.dequantize_group(*_bad_dequantize_groups()[case])
