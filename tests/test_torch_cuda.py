"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips on a host without a
GPU. This file imports no jax, so it runs where only PyTorch is
installed (the repository's conftest imports jax; skip it there):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

TF32 is switched off for the plain versions' products. Tolerances:
aggregation (all three kernels) atol=1e-5 (float32, different summation
order); quantize and dequantize exact (both sides use IEEE division and
round half to even). The mode-B LM trainer: the tiny LM on the card
against the CPU (discrete state exact, score history 1e-6, params 1e-4),
and the int8 gradient transport's step (one launch of each kernel, params
equal to the plain versions' step). The decode path: the tiny decoder
configs of the serving tests and reduced whisper-small on the card
against the CPU (logits 1e-5, cache floats 1e-6 of each leaf's scale,
``index`` / ``pos`` equal), rollback after a verify bitwise equal to the
prefill of the accepted prefix. The serving plane: every gateway mode's
greedy streams on the card equal the CPU's and vanilla's with no kernel
launch, the KV int8 codes and scales bit-equal to the CPU's, and the
trainer's draft rows within the params bar. The tensor-parallel LM
mesh: the trainer on mesh cells of the card against the same mesh on
the CPU, the mesh transport step's launches and its params equal to the
plain versions' step, and (with 2 / 4 cards) cells on distinct cards
against one card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.quantize import ops as tqops  # noqa: E402
from repro_torch.kernels.quantize import ref as tqref  # noqa: E402
from repro_torch.kernels.weighted_agg import ops as twops  # noqa: E402
from repro_torch.kernels.weighted_agg import ref as twref  # noqa: E402


def _agg_inputs(m, b, shape, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 1, (b,) + shape).astype(np.float32)
    w = rng.uniform(0, 1, (m, b)).astype(np.float32)
    w *= rng.uniform(0, 1, (1, b)) > 0.2      # padding-pair columns
    d = np.maximum(w.sum(axis=1), 1e-12).astype(np.float32)
    return u, w, d


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,d", [(1, 16, 10), (2, 32, 589_824),
                                   (16, 32, 2_303), (17, 5, 64)])
def test_agg_kernel_matches_plain_on_card(cuda, m, b, d):
    u, w, den = _agg_inputs(m, b, (d,), seed=d)
    args = [torch.from_numpy(a).to(cuda) for a in (u, w, den)]
    before = twops.multi_weighted_agg.launches
    out = twops.multi_weighted_agg(*args)
    torch.cuda.synchronize()
    assert twops.multi_weighted_agg.launches == before + 1
    ref = (args[1] @ args[0]) / args[2][:, None]
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(1, 10), (2, 589_824), (16, 2_303),
                                 (300, 777)])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_kernels_match_plain_on_card(cuda, r, n, bits):
    x = torch.from_numpy(np.random.default_rng(n).normal(
        0, 1, (r, n)).astype(np.float32)).to(cuda)
    q, s = tqops.quantize(x, bits)
    qr, sr = tqref.quantize_ref(x, bits)
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr)
    out = tqops.dequantize(q, s, n)
    ref = tqref.dequantize_ref(qr, sr, (r, n), torch.float32)
    assert torch.equal(out, ref)


def _unaligned(t):
    """A contiguous copy of ``t`` whose data pointer is one element past
    an allocation's start, so not 16-byte aligned (the kernels' scalar
    paths)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(30, 589_824), (30, 32), (3, 17),
                                 (8, 2_303), (1, 5)])
@pytest.mark.parametrize("aligned", [True, False])
def test_weighted_agg_kernel_matches_plain_on_card(cuda, n, d, aligned):
    rng = np.random.default_rng(n * d)
    u = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)
                         ).to(cuda)
    w = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(cuda)
    w[::3] = 0.0                                  # non-holders
    den = torch.clamp(w.sum(), min=1e-12)
    if not aligned:
        u = _unaligned(u)
    before = twops.weighted_agg.launches
    out = twops.weighted_agg(u, w, den)
    torch.cuda.synchronize()
    assert twops.weighted_agg.launches == before + 1
    ref = twref.weighted_agg_ref(u, w, den)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5)


@pytest.mark.cuda
def test_weighted_agg_kernel_propagates_nan_of_zero_weight_row(cuda):
    u = torch.ones(3, 10, device=cuda)
    u[1, 4] = float("nan")
    w = torch.tensor([0.5, 0.0, 0.5], device=cuda)
    out = twops.weighted_agg(u, w, torch.ones((), device=cuda)).cpu()
    assert torch.isnan(out[4]) and torch.isfinite(out[:4]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 64])
@pytest.mark.parametrize("n,d", [(30, 589_824), (30, 128), (5, 2_304)])
@pytest.mark.parametrize("aligned", [True, False])
def test_dequant_agg_kernel_matches_plain_on_card(cuda, block, n, d,
                                                  aligned):
    rng = np.random.default_rng(n + d + block)
    x = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)
                         ).to(cuda)
    # codes and scales from the quantize kernel (block 128), or made up
    if block == 128:
        q, s = tqops.quantize(x, 8)
    else:
        q = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(
            np.int8)).to(cuda)
        s = torch.from_numpy(rng.uniform(1e-3, 0.05, (n, d // block)
                                         ).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(cuda)
    den = torch.clamp(w.sum(), min=1e-12)
    if not aligned:
        q = _unaligned(q)
    before = twops.dequant_agg.launches
    out = twops.dequant_agg(q, s, w, den, block)
    torch.cuda.synchronize()
    assert twops.dequant_agg.launches == before + 1
    ref = twref.dequant_agg_ref(q, s, w, den, block)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(2, 2_303), (3, 130), (1, 10)])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_kernels_match_plain_unaligned_on_card(cuda, r, n, bits):
    x = torch.from_numpy(np.random.default_rng(n + r).normal(
        0, 1, (r, n)).astype(np.float32)).to(cuda)
    x = _unaligned(x)
    q, s = tqops.quantize(x, bits)
    qr, sr = tqref.quantize_ref(x, bits)
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr)
    out = tqops.dequantize(q, s, n)
    ref = tqref.dequantize_ref(qr, sr, (r, n), torch.float32)
    assert torch.equal(out, ref)


# -- eq 1 as one grouped launch over a param dict's leaves --------------------

M_TEMPLATES = [1, 2, 3, 8, 16, 17, 33]   # every register tile; 2-5 passes


def _cnn_leaf_sizes():
    from repro_torch.models.cnn import init_cnn
    return [v.numel() for v in init_cnn(torch.Generator()).values()]


def _leaves(b, sizes, seed, device, unaligned=()):
    gen = torch.Generator(device=device).manual_seed(seed)
    us = [torch.randn(b, d, generator=gen, device=device) for d in sizes]
    return [_unaligned(u) if i in unaligned else u for i, u in enumerate(us)]


def _group_weights(m, b, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.rand(m, b, generator=gen, device=device)
    w[:, -min(5, max(1, b // 6)):] = 0.0       # padding pairs
    return w, torch.clamp(w.sum(1), min=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("m", M_TEMPLATES)
def test_group_kernel_matches_plain_at_cnn_leaves_on_card(cuda, m):
    sizes = _cnn_leaf_sizes()
    us = _leaves(32, sizes, m, cuda)
    w, den = _group_weights(m, 32, m, cuda)
    before = twops.multi_weighted_agg.launches
    outs = twops.multi_weighted_agg_group(us, w, den)
    torch.cuda.synchronize()
    assert twops.multi_weighted_agg.launches == before + 1
    for u, out in zip(us, outs):
        assert out.shape == (m, u.shape[1]) and out.is_contiguous()
        ref = twref.multi_weighted_agg_ref(u, w, den)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   atol=1e-5)


@pytest.mark.cuda
def test_weighted_agg_group_matches_plain_at_cnn_leaves_on_card(cuda):
    sizes = _cnn_leaf_sizes()
    us = _leaves(30, sizes, 30, cuda)
    w, den = _group_weights(1, 30, 30, cuda)
    w, den = w[0].contiguous(), den[0]
    before = twops.weighted_agg.launches
    outs = twops.weighted_agg_group(us, w, den)
    torch.cuda.synchronize()
    assert twops.weighted_agg.launches == before + 1
    for u, out in zip(us, outs):
        ref = twref.weighted_agg_ref(u, w, den)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
def test_group_beyond_the_leaf_cap_on_card(cuda, single):
    """More leaves than one launch's table holds: one launch per cap's
    worth of non-empty leaves, each leaf right; empty leaves launch
    nothing."""
    sizes = [(7 * i) % 300 for i in range(75)]      # leaf 0 is empty
    m = 1 if single else 3
    us = _leaves(6, sizes, 1, cuda, unaligned={5, 40})
    w, den = _group_weights(m, 6, 1, cuda)
    if single:
        w, den = w[0].contiguous(), den[0]
    counter = twops.weighted_agg if single else twops.multi_weighted_agg
    fn = twops.weighted_agg_group if single else twops.multi_weighted_agg_group
    ref_fn = twref.weighted_agg_ref if single else twref.multi_weighted_agg_ref
    _, _, _, cap = twops._kernels()
    before = counter.launches
    outs = fn(us, w, den)
    torch.cuda.synchronize()
    live = sum(1 for d in sizes if d)
    assert counter.launches == before + -(-live // cap) and live > 2 * cap
    for u, out in zip(us, outs):
        np.testing.assert_allclose(out.cpu().numpy(),
                                   ref_fn(u, w, den).cpu().numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 16])
def test_group_with_unaligned_and_ragged_leaves_on_card(cuda, m):
    sizes = [1, 10, 2_303, 4_096, 129, 5, 1_027]
    us = _leaves(5, sizes, 2, cuda, unaligned={0, 2, 3, 6})
    w, den = _group_weights(m, 5, 2, cuda)
    outs = twops.multi_weighted_agg_group(us, w, den)
    for u, out in zip(us, outs):
        ref = twref.multi_weighted_agg_ref(u, w, den)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   atol=1e-5)


@pytest.mark.cuda
def test_group_with_weights_past_the_default_shared_memory_on_card(cuda):
    """M = 16 and B = 600: weights (38 KB) and partial sums (32 KB) need
    the launcher to lift the block's shared memory past 48 KB."""
    us = _leaves(600, [1_000, 37], 3, cuda)
    w, den = _group_weights(16, 600, 3, cuda)
    outs = twops.multi_weighted_agg_group(us, w, den)
    for u, out in zip(us, outs):
        ref = twref.multi_weighted_agg_ref(u, w, den)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
def test_group_propagates_nan_of_zero_weight_row_per_leaf_on_card(cuda,
                                                                   single):
    sizes = [10, 300, 4_096]
    us = [torch.ones(4, d, device=cuda) for d in sizes]
    for i, u in enumerate(us):
        u[2, 3 + i] = float("nan")                 # row 2 has weight 0
    w = torch.tensor([[0.5, 0.25, 0.0, 0.25], [0.0, 1.0, 0.0, 0.0]],
                     device=cuda)
    if single:
        outs = twops.weighted_agg_group(us, w[0].contiguous(),
                                        torch.ones((), device=cuda))
        outs = [o[None] for o in outs]
    else:
        outs = twops.multi_weighted_agg_group(us, w,
                                              torch.ones(2, device=cuda))
    for i, out in enumerate(outs):
        out = out.cpu()
        nan = torch.isnan(out)
        assert nan[:, 3 + i].all() and nan.sum() == out.shape[0]


# -- eq 1 over int8 payloads (dequant_agg) as one grouped launch ------------

def _deq_leaves(n, sizes, block, seed, device, unaligned=()):
    """Codes (n, D) and scales (n, D // block) per leaf of D values; a leaf
    in ``unaligned`` has codes one byte past an allocation's start."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qs, ss = [], []
    for i, d in enumerate(sizes):
        q = torch.randint(-127, 128, (n, d), generator=gen, device=device,
                          dtype=torch.int8)
        qs.append(_unaligned(q) if i in unaligned else q)
        ss.append(torch.rand(n, d // block, generator=gen, device=device)
                  * 0.05)
    return qs, ss


def _deq_weights(n, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.rand(n, generator=gen, device=device)
    w[::3] = 0.0                                  # non-holders
    return w, torch.clamp(w.sum(), min=1e-12)


def _check_deq_group(qs, ss, w, den, block, launches):
    before = twops.dequant_agg.launches
    outs = twops.dequant_agg_group(qs, ss, w, den, block)
    torch.cuda.synchronize()
    assert twops.dequant_agg.launches == before + launches
    for q, s, out in zip(qs, ss, outs):
        assert out.shape == (q.shape[1],) and out.is_contiguous()
        assert out.data_ptr() % 16 == 0
        ref = twref.dequant_agg_ref(q, s, w, den, block)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   atol=1e-5)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 64])
def test_dequant_agg_group_matches_plain_at_cnn_leaves_on_card(cuda, block):
    """The 20 CNN leaves at N = 30 in one launch: at block 128 codes and
    scales from the quantize kernel, as the transport makes them; at 64
    made up over rows padded to the block."""
    sizes = _cnn_leaf_sizes()
    w, den = _deq_weights(30, block, cuda)
    if block == 128:
        qs, ss = tqops.quantize_group(_quant_leaves(30, sizes, 5, cuda), 8)
    else:
        qs, ss = _deq_leaves(30, [-(-d // block) * block for d in sizes],
                             block, 5, cuda)
    _check_deq_group(qs, ss, w, den, block, launches=1)


@pytest.mark.cuda
def test_dequant_agg_group_beyond_the_leaf_cap_on_card(cuda):
    sizes = [128 * (1 + (7 * i) % 40) for i in range(40)]
    qs, ss = _deq_leaves(6, sizes, 128, 1, cuda, unaligned={5, 35})
    w, den = _deq_weights(6, 1, cuda)
    _, _, _, cap = twops._kernels()
    assert cap < len(sizes) <= 2 * cap
    _check_deq_group(qs, ss, w, den, 128, launches=2)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 64, 12, 8])
def test_dequant_agg_group_with_unaligned_and_ragged_leaves_on_card(cuda,
                                                                    block):
    """Aligned and unaligned leaves whose last tile is part full, in one
    call; at blocks 12 and 8 (not multiples of 16) every leaf takes the
    scalar path, each column with its own scale."""
    sizes = [block * nb for nb in (1, 3, 18, 5, 7, 32, 2)]
    qs, ss = _deq_leaves(5, sizes, block, block, cuda, unaligned={1, 3, 6})
    w, den = _deq_weights(5, block, cuda)
    _check_deq_group(qs, ss, w, den, block, launches=1)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 8])
def test_dequant_agg_group_propagates_nan_scale_of_zero_weight_row_on_card(
        cuda, block):
    """A NaN scale in a row of weight 0 poisons its block of the result
    and nothing else, on the vector and the scalar path."""
    sizes = [block, 3 * block, 32 * block]
    qs, ss = _deq_leaves(4, sizes, block, 0, cuda, unaligned={1})
    for i, s in enumerate(ss):
        s[2, i] = float("nan")
    w = torch.tensor([0.5, 0.25, 0.0, 0.25], device=cuda)
    outs = twops.dequant_agg_group(qs, ss, w, torch.ones((), device=cuda),
                                   block)
    for i, out in enumerate(outs):
        nan = torch.isnan(out.cpu())
        assert nan[i * block:(i + 1) * block].all()
        assert nan.sum() == block


@pytest.mark.cuda
def test_dequant_agg_group_is_bit_equal_across_calls_on_card(cuda):
    sizes = [128, 2_304, 589_824, 640]
    qs, ss = _deq_leaves(30, sizes, 128, 2, cuda, unaligned={3})
    w, den = _deq_weights(30, 2, cuda)
    first = twops.dequant_agg_group(qs, ss, w, den)
    second = twops.dequant_agg_group(qs, ss, w, den)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# -- transport quantization as one grouped launch over a param dict's leaves --

def _quant_leaves(rows, sizes, seed, device, unaligned=()):
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = [torch.randn(rows, d, generator=gen, device=device) * 0.1
          for d in sizes]
    return [_unaligned(x) if i in unaligned else x for i, x in enumerate(xs)]


def _check_quantize_group(xs, bits):
    """One quantize_group and one dequantize_group call over ``xs``: one
    launch of each per table's worth of non-empty leaves; codes, scales
    and values bit-equal to the plain versions and to the per-leaf
    wrappers; every returned view contiguous and 16-byte aligned."""
    _, _, cap = tqops._kernels()
    live = sum(1 for x in xs if x.numel())
    before = tqops.quantize.launches, tqops.dequantize.launches
    qs, ss = tqops.quantize_group(xs, bits)
    outs = tqops.dequantize_group(qs, ss, [x.shape[1] for x in xs])
    torch.cuda.synchronize()
    launches = -(-live // cap)
    assert (tqops.quantize.launches, tqops.dequantize.launches) == (
        before[0] + launches, before[1] + launches)
    for x, q, s, out in zip(xs, qs, ss, outs):
        for t in (q, s, out):
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
        nb = -(-x.shape[1] // 128)
        assert q.shape == (x.shape[0], nb * 128) and out.shape == x.shape
        if not x.numel():                  # the plain version takes none
            continue
        qr, sr = tqref.quantize_ref(x, bits)
        assert torch.equal(q, qr) and torch.equal(s, sr)
        assert torch.equal(out, tqref.dequantize_ref(qr, sr, tuple(x.shape),
                                                     torch.float32))
        q1, s1 = tqops.quantize(x, bits)
        assert torch.equal(q, q1) and torch.equal(s, s1)
        assert torch.equal(out, tqops.dequantize(q1, s1, x.shape[1]))
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_group_matches_plain_at_cnn_leaves_on_card(cuda, m, bits):
    xs = _quant_leaves(m, _cnn_leaf_sizes(), m + bits, cuda)
    assert _check_quantize_group(xs, bits) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_group_with_unaligned_and_ragged_leaves_on_card(cuda, bits):
    """Aligned, unaligned and ragged leaves in one call: each takes its
    own float4 or scalar path."""
    sizes = [10, 2_303, 4_096, 129, 5, 1_027, 589_824, 1, 128]
    xs = _quant_leaves(3, sizes, bits, cuda, unaligned={0, 2, 3, 6})
    assert _check_quantize_group(xs, bits) == 1


@pytest.mark.cuda
def test_quantize_group_beyond_the_leaf_cap_on_card(cuda):
    sizes = [(7 * i) % 300 for i in range(75)]      # leaf 0 is empty
    xs = _quant_leaves(2, sizes, 1, cuda, unaligned={5, 40})
    _, _, cap = tqops._kernels()
    assert _check_quantize_group(xs, 8) > 2 and len(xs) > 2 * cap


@pytest.mark.cuda
def test_quantize_group_with_empty_leaves_on_card(cuda):
    xs = [torch.zeros(0, 5, device=cuda), torch.zeros(3, 0, device=cuda),
          torch.randn(2, 300, device=cuda)]
    assert _check_quantize_group(xs, 8) == 1
    qs, ss = tqops.quantize_group(xs[:2], 8)
    assert [tuple(q.shape) for q in qs] == [(0, 128), (3, 0)]
    assert [tuple(s.shape) for s in ss] == [(0, 1), (3, 0)]
    assert _check_quantize_group(xs[:2], 8) == 0


@pytest.mark.cuda
def test_quantize_group_past_32_bit_offsets_on_card(cuda):
    """A leaf whose element offsets pass 2^31 (2 rows of 2^30 + 300
    values, 8.6 GB of float32) makes the launch take the kernels' 64-bit
    index instantiation; a small leaf rides in the same launch. The blocks
    at both ends of each row, the second row's end past offset 2^31, equal
    the plain version's bit for bit."""
    n = 2**30 + 300
    nb = -(-n // 128)
    gen = torch.Generator(device=cuda).manual_seed(0)
    xs = [torch.randn(2, n, generator=gen, device=cuda),
          torch.randn(3, 1_000, generator=gen, device=cuda)]
    before = tqops.quantize.launches, tqops.dequantize.launches
    qs, ss = tqops.quantize_group(xs, 8)
    outs = tqops.dequantize_group(qs, ss, [n, 1_000])
    torch.cuda.synchronize()
    assert (tqops.quantize.launches, tqops.dequantize.launches) == (
        before[0] + 1, before[1] + 1)
    assert 2 * nb * 128 > 2**31 - 1
    for b0, b1 in ((0, 8), (nb - 10, nb)):     # 128-blocks of each row
        x = xs[0][:, b0 * 128:min(b1 * 128, n)].contiguous()
        qr, sr = tqref.quantize_ref(x, 8)
        assert torch.equal(qs[0][:, b0 * 128:b1 * 128], qr)
        assert torch.equal(ss[0][:, b0:b1], sr)
        assert torch.equal(outs[0][:, b0 * 128:min(b1 * 128, n)],
                           tqref.dequantize_ref(qr, sr, tuple(x.shape),
                                                torch.float32))
    qr, sr = tqref.quantize_ref(xs[1], 8)
    assert torch.equal(qs[1], qr) and torch.equal(ss[1], sr)
    assert torch.equal(outs[1], tqref.dequantize_ref(qr, sr, (3, 1_000),
                                                     torch.float32))


# -- the pipelined and sparse fused paths on the card -------------------------

def _mlp_servers(device, specs, hidden=32, n_train=64, batch_size=16,
                 fedavg=False, rounds=8, **cfg_kw):
    """The reference's engine-equivalence setup (MLP, 8 devices,
    milestones 2/5), one server per spec, each run ``rounds`` rounds.
    ``specs``: preset strings, or a {name: spec} dict."""
    import dataclasses

    from repro_torch.configs.fedcd_cifar import HIERARCHICAL
    from repro_torch.core.fedavg import FedAvgServer
    from repro_torch.core.fedcd import FedCDServer
    from repro_torch.data.partition import hierarchical_devices, stack_devices
    from repro_torch.models.mlp import (init_mlp_classifier, mlp_accuracy,
                                        mlp_loss)

    data = stack_devices(hierarchical_devices(
        seed=0, devices_per_archetype=1, n_train=n_train, n_val=32,
        n_test=32, noise=2.0)[:8])
    cfg = dataclasses.replace(HIERARCHICAL, n_devices=8, devices_per_round=4,
                              milestones=(2, 5), max_models=8,
                              late_delete_round=6, seed=0, **cfg_kw)
    params = init_mlp_classifier(torch.Generator().manual_seed(0),
                                 hidden=hidden)
    cls = FedAvgServer if fedavg else FedCDServer
    if not isinstance(specs, dict):
        specs = {s: s for s in specs}
    out = {name: cls(cfg, params, mlp_loss, mlp_accuracy, data,
                     batch_size=batch_size, spec=s, device=device)
           for name, s in specs.items()}
    for srv in out.values():
        if rounds:
            srv.run(rounds)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["fused+pipeline", "fused+sparse:1.1",
                                  "fused+pipeline+sparse:0.9"])
def test_pipelined_and_sparse_fedcd_match_fused_on_card(cuda, spec):
    """Discrete state and accuracies exact, params within 1e-5, against
    the synchronous dense ``fused`` run on the card."""
    runs = _mlp_servers(cuda, ["fused", spec])
    ref, other = runs["fused"], runs[spec]
    assert ref.registry.live_ids() == other.registry.live_ids()
    assert ref.registry.genealogy() == other.registry.genealogy()
    np.testing.assert_array_equal(ref.state.active, other.state.active)
    np.testing.assert_array_equal(ref.state.history, other.state.history)
    for a, b in zip(ref.metrics, other.metrics):
        np.testing.assert_array_equal(a.preferred, b.preferred)
        np.testing.assert_array_equal(a.test_acc, b.test_acc)
        np.testing.assert_array_equal(a.val_acc, b.val_acc)
        assert a.comm_bytes == b.comm_bytes
    for m in ref.registry.live_ids():
        for k, v in ref.registry.params[m].items():
            np.testing.assert_allclose(other.registry.params[m][k].cpu(),
                                       v.cpu(), atol=1e-5, rtol=0)
    if "pipeline" in spec:
        st = other.pipeline_stats
        assert st.speculated > 0 and st.hit + st.repaired > 0
    if "sparse" in spec:
        assert other.planner.sparse_rounds > 0


@pytest.mark.cuda
def test_pipelined_fedavg_matches_fused_on_card(cuda):
    runs = _mlp_servers(cuda, ["fused", "fused+pipeline"], fedavg=True,
                        rounds=4)
    ref, pipe = runs["fused"], runs["fused+pipeline"]
    for a, b in zip(ref.metrics, pipe.metrics):
        np.testing.assert_array_equal(a.test_acc, b.test_acc)
        np.testing.assert_array_equal(a.val_acc, b.val_acc)
    for k, v in ref.params.items():
        np.testing.assert_allclose(pipe.params[k].cpu(), v.cpu(), atol=1e-5,
                                   rtol=0)
    assert pipe.pipeline_stats.hit == 3


@pytest.mark.cuda
@pytest.mark.parametrize("fedavg", [False, True])
def test_readback_overlaps_speculative_training_on_card(cuda, fedavg):
    """The readback waits on its own copies' event, not on the stream: it
    returns while the next round's speculative training, enqueued after
    the eval matrices, is still running. A device spin after each
    speculation keeps the stream busy for a fixed time, so the finding
    does not depend on whether the host or the card sets the pace."""
    srv = _mlp_servers(cuda, ["fused+pipeline"], fedavg=fedavg,
                       rounds=0)["fused+pipeline"]
    ex = srv.executor
    speculate, readback = ex.speculate, ex.readback
    seen = {"event": None, "speculated": 0, "overlapped": 0}

    def spec(plan):
        before = ex._spec
        speculate(plan)
        seen["event"] = None
        if ex._spec is not None and ex._spec is not before:
            torch.cuda._sleep(40_000_000)        # ~20-40 ms
            seen["event"] = torch.cuda.Event()
            seen["event"].record()

    def read():
        out = readback()
        if seen["event"] is not None:
            seen["speculated"] += 1
            seen["overlapped"] += int(not seen["event"].query())
            seen["event"] = None
        return out
    ex.speculate, ex.readback = spec, read
    srv.run(6)
    torch.cuda.synchronize()
    assert seen["speculated"] >= 4
    assert seen["overlapped"] >= 1
    assert all(np.isfinite(m.test_acc).all() for m in srv.metrics)


# -- semi-synchronous rounds and device churn on the card ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("fedavg", [False, True])
def test_zero_latency_semisync_is_bit_identical_to_fused_on_card(cuda, bits,
                                                                 fedavg):
    """The zero-latency gate on the card: ``fused+semisync`` with
    ``StragglerModel.zero()`` takes the synchronous path, bit for bit."""
    from repro_torch.core.spec import EngineSpec
    from repro_torch.data.scenarios import StragglerModel

    runs = _mlp_servers(
        cuda, {"fused": "fused",
               "zero": EngineSpec(straggler=StragglerModel.zero())},
        fedavg=fedavg, rounds=4 if fedavg else 6, quantize_bits=bits)
    ref, zero = runs["fused"], runs["zero"]
    for a, b in zip(ref.metrics, zero.metrics):
        np.testing.assert_array_equal(a.test_acc, b.test_acc)
        np.testing.assert_array_equal(a.val_acc, b.val_acc)
    if fedavg:
        trees = [(ref.params, zero.params)]
    else:
        assert ref.registry.live_ids() == zero.registry.live_ids()
        np.testing.assert_array_equal(ref.state.active, zero.state.active)
        np.testing.assert_array_equal(ref.state.history, zero.state.history)
        trees = [(ref.registry.params[m], zero.registry.params[m])
                 for m in ref.registry.live_ids()]
    for a, b in trees:
        for k, v in a.items():
            assert torch.equal(v, b[k]), k
    st = zero.semisync_stats
    assert st.ontime == st.dispatched > 0 and st.stragglers == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mass", [0.0, 0.61])
def test_fold_blend_on_card_equals_cpu(cuda, mass):
    """The stale fold's float32 operations (multiply, add, IEEE divide by
    a tensor) give the same bits on the card as on the CPU."""
    from repro_torch.federated.executors import _blend_stale

    rng = np.random.default_rng(3)
    shapes = {"conv": (3, 3, 64, 64), "dense": (2304, 10), "b": (10,)}
    cur = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for k, s in shapes.items()}
    ups = [(float(w), {k: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()})
        for w in rng.uniform(0.05, 0.5, 4)]
    host = _blend_stale(cur, mass, ups)
    card = _blend_stale({k: v.to(cuda) for k, v in cur.items()}, mass,
                        [(w, {k: v.to(cuda) for k, v in t.items()})
                         for w, t in ups])
    for k in shapes:
        assert torch.equal(card[k].cpu(), host[k]), k


@pytest.mark.cuda
def test_churn_row_write_is_read_by_the_next_train_dispatch_on_card(cuda):
    """A join reusing a freed slot writes its row through pinned memory
    without blocking; a train dispatch enqueued right after reads the
    new row (stream order), as the same dispatch on the CPU does."""
    from repro_torch.data.bank import DeviceDataBank
    from repro_torch.data.partition import hierarchical_devices, stack_devices
    from repro_torch.data.scenarios import ChurnSchedule
    from repro_torch.federated.simulation import make_pair_train
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss

    data = stack_devices(hierarchical_devices(
        seed=0, devices_per_archetype=1, n_train=64, n_val=32, n_test=32))
    sched = ChurnSchedule(n_train=64, n_val=32, n_test=32)
    joined = sched.make_device(sched.make_rng(), 3)
    params = init_mlp_classifier(torch.Generator().manual_seed(0), hidden=32)
    train = make_pair_train(mlp_loss, 0.05)
    perms = np.random.default_rng(0).permuted(
        np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)),
        axis=1).reshape(2, 4, 16)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        bank = DeviceDataBank(data, dev, id_cap=11)
        stacked = {k: v[None].to(dev) for k, v in params.items()}
        bank.remove(4)
        v0 = bank.version
        d = bank.add(joined)                 # slot 4 reused by id 10
        assert (d, bank.row_of[d], bank.version) == (10, 4, v0 + 1)
        trained = train(stacked, np.zeros(2, np.int32),
                        *bank.splits["train"],
                        np.array([bank.row_of[d], 0], np.int32), perms)
        out[dev.type] = {k: v.cpu() for k, v in trained.items()}
        xs = bank.splits["train"][0][4].cpu().numpy()
        np.testing.assert_array_equal(xs, joined.train[0])
    for k, v in out["cpu"].items():
        np.testing.assert_allclose(out["cuda"][k], v, atol=1e-5, rtol=0)


# -- checkpoint/resume on the card --------------------------------------------

@pytest.mark.cuda
def test_bank_restores_write_into_the_existing_tensors_on_card(cuda):
    """``StackedParamBank.restore`` and ``DeviceDataBank.restore`` write
    each row in place (same ``data_ptr``), through pinned memory, and move
    ``version`` on; the rows read back exactly."""
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.data.bank import DeviceDataBank
    from repro_torch.data.partition import hierarchical_devices, stack_devices

    reg = ModelRegistry.create({"w": torch.zeros(64, 32, device=cuda),
                                "b": torch.zeros(32, device=cuda)},
                               m_cap=4, stacked=True)
    pb = reg.params
    ptrs, v0 = {k: v.data_ptr() for k, v in pb.tree.items()}, pb.version
    rng = np.random.default_rng(0)
    rows = {m: {"w": rng.normal(size=(64, 32)).astype(np.float32),
                "b": rng.normal(size=32).astype(np.float32)} for m in (0, 2)}
    pb.restore(rows, row_of={0: 0, 1: 1, 2: 2}, used_rows={0, 1, 2})
    assert {k: v.data_ptr() for k, v in pb.tree.items()} == ptrs
    assert pb.version == v0 + 1 and pb._present == {0, 2}
    for m, row in rows.items():
        for k, a in row.items():
            np.testing.assert_array_equal(pb[m][k].cpu().numpy(), a)

    data = stack_devices(hierarchical_devices(
        seed=0, devices_per_archetype=1, n_train=16, n_val=8, n_test=8))
    bank = DeviceDataBank(data, cuda, n_cap=12, id_cap=14)
    ptrs = [t.data_ptr() for pair in bank.splits.values() for t in pair]
    v0 = bank.version
    devices = {d: {k: (rng.normal(size=data[k][0].shape[1:]).astype(
        np.float32), rng.integers(0, 10, data[k][1].shape[1]).astype(
        np.int32)) for k in ("train", "val", "test")} for d in (3, 12)}
    bank.restore(devices, next_id=13, row_of={3: 3, 12: 11})
    assert [t.data_ptr() for pair in bank.splits.values()
            for t in pair] == ptrs
    assert bank.version == v0 + 1 and bank.present_ids() == [3, 12]
    for d, r in ((3, 3), (12, 11)):
        for k, (x, y) in devices[d].items():
            np.testing.assert_array_equal(bank.splits[k][0][r].cpu().numpy(),
                                          x)
            np.testing.assert_array_equal(bank.splits[k][1][r].cpu().numpy(),
                                          y)


@pytest.mark.cuda
def test_stale_updates_restore_bit_for_bit_on_card(cuda, tmp_path):
    """A semi-sync run's buffered straggler rows (on the card) go to the
    checkpoint and come back to the card bit for bit; the resumed run
    equals the uninterrupted one."""
    from repro_torch.core.spec import EngineSpec
    from repro_torch.data.scenarios import StragglerModel

    straggler = StragglerModel(distribution="lognormal", sigma=2.0,
                               quorum=0.6, dropout_rate=0.05, seed=0)
    root = str(tmp_path / "ck")
    runs = _mlp_servers(cuda, {
        "full": EngineSpec(straggler=straggler),
        "saver": EngineSpec(straggler=straggler, save_every=4,
                            checkpoint_dir=root)}, rounds=0)
    runs["full"].run(8)
    saver = runs["saver"]
    saver.run(4)
    assert saver.executor._stale_updates
    res = _mlp_servers(cuda, {"res": EngineSpec(straggler=straggler,
                                                resume_from=root)},
                       rounds=0)["res"]
    ex, ex0 = res.executor, saver.executor
    assert sorted(ex._stale_updates) == sorted(ex0._stale_updates)
    for key, tree in ex0._stale_updates.items():
        for k, v in tree.items():
            got = ex._stale_updates[key][k]
            assert got.device.type == "cuda" and torch.equal(got, v), key
    res.run(8)
    full = runs["full"]
    assert res.semisync_stats.as_dict() == full.semisync_stats.as_dict()
    np.testing.assert_array_equal(res.state.history, full.state.history)
    for m in full.registry.live_ids():
        for k, v in full.registry.params[m].items():
            assert torch.equal(res.registry.params[m][k], v), (m, k)


@pytest.mark.cuda
def test_card_checkpoint_resumes_on_cpu(cuda, tmp_path):
    """A checkpoint written by a card run restores into a CPU server: the
    restored state equals the card's exactly, and the CPU run continues
    as the card run does (discrete state equal, params to 1e-5)."""
    from repro_torch.checkpoint import verify_checkpoint

    root = str(tmp_path / "ck")
    card = _mlp_servers(cuda, {"card": "fused"}, rounds=4)["card"]
    path = card.save(root)
    manifest, _ = verify_checkpoint(path)
    assert manifest["round"] == 4
    cpu = _mlp_servers(torch.device("cpu"), ["fused"], rounds=0)["fused"]
    assert cpu.restore(path) == 4
    assert cpu.registry.live_ids() == card.registry.live_ids()
    np.testing.assert_array_equal(cpu.state.history, card.state.history)
    for m in card.registry.live_ids():
        for k, v in card.registry.params[m].items():
            assert torch.equal(cpu.registry.params[m][k], v.cpu()), (m, k)
    card.run(6)
    cpu.run(6)
    assert cpu.registry.live_ids() == card.registry.live_ids()
    np.testing.assert_array_equal(cpu.state.active, card.state.active)
    for a, b in zip(card.metrics, cpu.metrics):
        np.testing.assert_array_equal(a.preferred, b.preferred)
    for m in card.registry.live_ids():
        for k, v in card.registry.params[m].items():
            np.testing.assert_allclose(cpu.registry.params[m][k],
                                       v.cpu(), atol=1e-5, rtol=0)


# -- the sharded planes on the card -------------------------------------------

def _mesh_spec(cuda, sm, sd, **kw):
    from repro_torch.core.spec import EngineSpec
    from repro_torch.launch.mesh import make_launch_mesh
    return EngineSpec(model_shards=sm, data_shards=sd,
                      mesh=make_launch_mesh(sm, sd, devices=[cuda] * (sm * sd)),
                      **kw)


@pytest.mark.cuda
def test_string_mesh_beyond_the_cards_raises(cuda):
    """``sharded@S`` takes S CUDA devices: beyond the cards present it
    raises, never shrinking and never moving to the CPU."""
    from repro_torch.core.spec import EngineSpec
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA devices"):
        EngineSpec.parse(f"sharded@{n + 1}").resolve_mesh()
    mesh = EngineSpec.parse(f"sharded@{n}").resolve_mesh() if n > 1 else None
    if mesh is not None:
        assert all(d.type == "cuda" for d in mesh.devices)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (2, 2)],
                         ids=["1x1", "4x1", "2x2"])
def test_sharded_fedcd_on_card_matches_cpu(cuda, shape):
    """The sharded plane with every cell on the card against the same
    plane on the CPU: discrete state equal, params to 1e-5. On a 1-D
    mesh eq 1 launches kernel 1 once per shard with work; with a data
    axis it launches none (the plain data-axis sum)."""
    cpu = torch.device("cpu")
    before = twops.multi_weighted_agg.launches
    card = _mlp_servers(cuda, {"s": _mesh_spec(cuda, *shape)})["s"]
    launched = twops.multi_weighted_agg.launches - before
    host = _mlp_servers(cpu, {"s": _mesh_spec(cpu, *shape)})["s"]
    assert (launched > 0) == (shape[1] == 1)
    assert card.registry.live_ids() == host.registry.live_ids()
    np.testing.assert_array_equal(card.state.active, host.state.active)
    for a, b in zip(card.metrics, host.metrics):
        np.testing.assert_array_equal(a.preferred, b.preferred)
    for m in host.registry.live_ids():
        for k, v in host.registry.params[m].items():
            np.testing.assert_allclose(card.registry.params[m][k].cpu(), v,
                                       atol=1e-5, rtol=0)
    assert card.registry.params.row_of == host.registry.params.row_of


@pytest.mark.cuda
def test_sharded_rounds_make_no_host_sync(cuda):
    """A sharded round's launch path (bucketing, per-cell train, eq 1,
    transport, scatter, eval) enqueues without waiting for the card: run
    under ``set_sync_debug_mode("error")`` up to readback."""
    srv = _mlp_servers(cuda, {"s": _mesh_spec(cuda, 2, 2,
                                              pipeline=True)},
                       rounds=1, quantize_bits=8)["s"]
    ex = srv.executor
    inner = ex.launch

    def launch(plan):
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner(plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    ex.launch = launch
    srv.run(4)
    assert len(srv.metrics) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_sharded_fedavg_on_card_matches_fused(cuda, shape):
    runs = _mlp_servers(cuda, {"fused": "fused",
                               "s": _mesh_spec(cuda, *shape)},
                        fedavg=True, rounds=4)
    for a, b in zip(runs["fused"].metrics, runs["s"].metrics):
        np.testing.assert_allclose(a.test_acc, b.test_acc, atol=1e-6)
    for k, v in runs["fused"].params.items():
        np.testing.assert_allclose(runs["s"].params[k].cpu(), v.cpu(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "pipeline+semisync", "churn"])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_cells_on_distinct_cards_match_one_card(cuda, shape, variant):
    """A mesh with every cell on its own card (the first four) against
    the same mesh with every cell on one card: each bank block on its
    owner's card, the other cells reading copies refreshed after every
    write (the scatter, clones, folds, churn's row writes), the
    data-axis sum and the readback crossing cards. Discrete state equal,
    params to 1e-5. Needs four cards; skips with fewer."""
    from repro_torch.core.spec import EngineSpec
    from repro_torch.data.scenarios import StragglerModel, random_churn
    from repro_torch.launch.mesh import make_launch_mesh

    sm, sd = shape
    if torch.cuda.device_count() < sm * sd:
        pytest.skip(f"needs {sm * sd} CUDA devices")
    extra = {"plain": {},
             "pipeline+semisync": dict(
                 pipeline=True,
                 straggler=StragglerModel(distribution="lognormal",
                                          sigma=2.0, quorum=0.6, seed=0)),
             "churn": dict(scenario=random_churn(
                 8, 8, seed=3, join_rate=0.5, leave_rate=0.4,
                 drift_rate=0.3, min_devices=3, n_train=64, n_val=32,
                 n_test=32))}[variant]
    apart = EngineSpec(model_shards=sm, data_shards=sd,
                       mesh=make_launch_mesh(sm, sd), **extra)
    runs = _mlp_servers(cuda, {"one": _mesh_spec(cuda, sm, sd, **extra),
                               "apart": apart})
    one, srv = runs["one"], runs["apart"]
    assert len(set(srv.mesh.devices)) == sm * sd
    assert (srv.registry.params._tree is None
            or srv.executor.databank._splits is None)
    assert srv.registry.live_ids() == one.registry.live_ids()
    np.testing.assert_array_equal(srv.state.active, one.state.active)
    np.testing.assert_array_equal(srv.state.history, one.state.history)
    for a, b in zip(one.metrics, srv.metrics):
        np.testing.assert_array_equal(a.preferred, b.preferred)
        assert a.comm_bytes == b.comm_bytes
    for m in one.registry.live_ids():
        for k, v in one.registry.params[m].items():
            got = srv.registry.params[m][k]
            assert got.device == srv.registry.params.devices[
                srv.registry.params.shard_of(m)]
            np.testing.assert_allclose(got.cpu(), v.cpu(), atol=1e-5,
                                       rtol=0)
    fed = _mlp_servers(cuda, {"one": _mesh_spec(cuda, sm, sd),
                              "apart": EngineSpec(
                                  model_shards=sm, data_shards=sd,
                                  mesh=make_launch_mesh(sm, sd))},
                       fedavg=True, rounds=4)
    for k, v in fed["one"].params.items():
        np.testing.assert_allclose(fed["apart"].params[k].cpu(), v.cpu(),
                                   atol=1e-5, rtol=1e-5)


# -- the mode-B LM trainer on the card ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("model", [2, 4], ids=["model2", "model4"])
def test_lm_mesh_on_distinct_cards_matches_one_card(cuda, model):
    """The tensor-parallel LM trainer (the tiny LM of
    tests/test_llm_equivalence.py, ``llm``, 8 rounds) on a ``model=2`` /
    ``model=4`` mesh with every cell on its own card against the same
    mesh with every cell on one card: each leaf's pieces on their cells'
    cards, the heads' partial sums and the vocabulary blocks crossing
    cards. Discrete state equal, params to 1e-5. Needs ``model`` cards;
    skips with fewer."""
    from repro_torch.config import ArchConfig
    from repro_torch.launch.mesh import make_launch_mesh
    from repro_torch.models import transformer as tf
    if torch.cuda.device_count() < model:
        pytest.skip(f"needs {model} CUDA devices")
    init = tf.init_lm(ArchConfig(**LM_KW), torch.Generator().manual_seed(0))
    one = _lm_run(None, "llm", init,
                  mesh=make_launch_mesh(model, 1, devices=["cuda:0"] * model))
    apart = _lm_run(None, "llm", init, mesh=make_launch_mesh(model, 1))
    wq = apart.registry.params.tree["segments.0.attn.wq"]
    assert {p.device for p in wq.pieces} == {
        torch.device("cuda", i) for i in range(model)}
    np.testing.assert_array_equal(apart.state.active, one.state.active)
    np.testing.assert_array_equal(apart.state.alive, one.state.alive)
    assert apart.registry.live_ids() == one.registry.live_ids()
    assert [m.trained_models for m in apart.metrics] == \
        [m.trained_models for m in one.metrics]
    np.testing.assert_allclose(apart.state.history, one.state.history,
                               atol=1e-6, equal_nan=True)
    for m in one.registry.live_ids():
        want = one.executor.params_of(m)
        for k, v in apart.executor.params_of(m).items():
            np.testing.assert_allclose(v.cpu(), want[k].cpu(), atol=1e-5,
                                       rtol=0)


@pytest.mark.cuda
def test_lm_mesh_decode_on_distinct_cards_matches_one_card(cuda):
    """The decode path on ``model=2`` with each cell on its own card
    against the same mesh with both cells on one card, from one sharded
    bank row of the tiny LM: a prefill of 6 tokens, 8 decode steps, then
    one gateway step (an admission and a decode token) over the bank.
    Logits and caches within 1e-7, the streams equal. Needs two cards;
    skips with fewer."""
    from repro_torch.config import ArchConfig
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.core.scores import init_scores, push_accuracies
    from repro_torch.launch.mesh import make_launch_mesh
    from repro_torch.launch.sharding import lm_bank_shardings
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeGateway
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    cfg = ArchConfig(**LM_KW)
    init = tf.init_lm(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 14),
                        generator=torch.Generator().manual_seed(1))
    state = push_accuracies(init_scores(2, 4, ell=2), np.full((2, 4), 0.5))
    runs = []
    for devices in (["cuda:0"] * 2, ["cuda:0", "cuda:1"]):
        mesh = make_launch_mesh(2, 1, devices=devices)
        reg = ModelRegistry.create(init, m_cap=4, stacked=True,
                                   shardings=lm_bank_shardings(cfg, init,
                                                               mesh))
        row = reg.params[0]
        with torch.no_grad():
            c = tf.init_lm_caches(cfg, 2, 16, device="cuda:0")
            lg, c = tf.lm_prefill(cfg, row, tok[:, :6].cuda(), c, mesh=mesh)
            logits = [lg]
            for t in range(6, 14):
                lg, c = tf.lm_decode(cfg, row, tok[:, t:t + 1].cuda(), c,
                                     mesh=mesh)
                logits.append(lg)
        gw = ServeGateway(cfg, reg, lambda: state, max_len=32, lanes=2,
                          chunk=8)
        req = gw.submit(0, tok[0, :10].numpy(), max_new=4)
        gw.step()
        pool = next(iter(gw.groups.values())).pool.read()
        runs.append((logits, c, list(req.tokens), pool))
    (la, ca, ta, pa), (lb, cb, tb, pb) = runs
    for a, b in zip(la, lb):
        np.testing.assert_allclose(b.cpu(), a.cpu(), atol=1e-7, rtol=0)
    for tree_a, tree_b in ((ca, cb), (pa, pb)):
        for k, v in tree_a.items():
            np.testing.assert_allclose(tree_b[k].float().cpu(),
                                       v.float().cpu(), atol=1e-7, rtol=0,
                                       err_msg=k)
    assert ta == tb and len(ta) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_lm_mesh_on_card_matches_cpu(cuda, shape):
    """The tensor-parallel LM trainer with every cell on the card against
    the same mesh on the CPU (the tiny LM, 8 rounds): discrete state
    equal, params to 1e-4 (the card-against-CPU bar), no kernel launch."""
    from repro_torch.config import ArchConfig
    from repro_torch.launch.mesh import make_host_mesh, make_launch_mesh
    from repro_torch.models import transformer as tf
    sm, sd = shape
    init = tf.init_lm(ArchConfig(**LM_KW), torch.Generator().manual_seed(0))
    before = tqops.quantize.launches
    card = _lm_run(None, "llm", init, mesh=make_launch_mesh(
        sm, sd, devices=[cuda] * (sm * sd)))
    host = _lm_run(None, "llm", init, mesh=make_host_mesh(sm, sd))
    assert tqops.quantize.launches == before
    np.testing.assert_array_equal(card.state.active, host.state.active)
    assert card.registry.live_ids() == host.registry.live_ids()
    for m in host.registry.live_ids():
        want = host.executor.params_of(m)
        for k, v in card.executor.params_of(m).items():
            np.testing.assert_allclose(v.cpu(), want[k], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,launches", [("tiny", 1), ("qwen3-4b", 2)])
def test_lm_mesh_transport_on_card(cuda, arch, launches):
    """``grad_transport_bits=8`` on a ``model=2, data=2`` mesh of the
    card: the tiny LM (its 64-wide leaves cut their 128-value blocks
    into pieces, so they are gathered: 12 rows, one launch of each
    kernel) and reduced Qwen3-4B (every piece whole blocks, so each goes
    alone: 35 rows, two launches, 32 rows a launch); the params equal to
    the step with the plain versions of both."""
    from repro_torch.config import ArchConfig
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.registry import StackedParamBank
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_launch_mesh
    from repro_torch.launch.sharding import lm_bank_shardings
    from repro_torch.models import transformer as tf
    cfg = (ArchConfig(**LM_KW) if arch == "tiny"
           else reduced(get_arch(arch)))
    init = tf.init_lm(cfg, torch.Generator().manual_seed(0))
    mesh = make_launch_mesh(2, 2, devices=[cuda] * 4)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 17))).to(cuda)
    scores = torch.tensor([0.4, 0.1, 0.3, 0.2], device=cuda)
    step = steps.make_train_step(cfg, mesh, lr=0.05, remat=False,
                                 grad_transport_bits=8)

    def run():
        bank = StackedParamBank(1, init, shardings=lm_bank_shardings(
            cfg, init, mesh))
        bank[0] = init
        step(bank[0], tok[:, :-1], tok[:, 1:], scores)
        return {k: v.full(cuda) for k, v in bank[0].items()}

    before = tqops.quantize.launches, tqops.dequantize.launches
    pk = run()
    torch.cuda.synchronize()
    assert (tqops.quantize.launches - before[0],
            tqops.dequantize.launches - before[1]) == (launches, launches)
    real = tqops.quantize_group, tqops.dequantize_group
    try:
        tqops.quantize_group = lambda xs, bits=8: tuple(
            map(list, zip(*[tqref.quantize_ref(x, bits) for x in xs])))
        tqops.dequantize_group = lambda qs, ss, ns: [
            tqref.dequantize_ref(q, s, (q.shape[0], n), torch.float32)
            for q, s, n in zip(qs, ss, ns)]
        pp = run()
    finally:
        tqops.quantize_group, tqops.dequantize_group = real
    for k in pk:
        assert torch.equal(pk[k], pp[k]), k


LM_KW = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab_size=64, param_dtype="float32",
             compute_dtype="float32")
LM_FED = dict(n_devices=4, devices_per_round=3, score_window=2,
              milestones=(2, 5), late_delete_round=6, max_models=6,
              lr=0.05, seed=0)


def _lm_run(device, spec, init, rounds=8, mesh=None):
    from repro_torch.config import ArchConfig, FedCDConfig
    from repro_torch.federated.llm import FedLLMTrainer
    tr = FedLLMTrainer(ArchConfig(**LM_KW), FedCDConfig(**LM_FED), 4, 2, 16,
                       seed=0, spec=spec, device=device, init_params=init,
                       mesh=mesh)
    tr.run(rounds)
    return tr


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["llm", "legacy"])
def test_lm_trainer_on_card_matches_cpu(cuda, spec):
    """The tiny LM of tests/test_llm_equivalence.py over its 8 rounds, on
    the card and on the CPU from the same params: discrete state equal,
    score history to 1e-6, params to 1e-4 (float32, TF32 off)."""
    from repro_torch.config import ArchConfig
    from repro_torch.models import transformer as tf
    init = tf.init_lm(ArchConfig(**LM_KW), torch.Generator().manual_seed(0))
    card, host = _lm_run(cuda, spec, init), _lm_run("cpu", spec, init)
    np.testing.assert_array_equal(card.state.active, host.state.active)
    np.testing.assert_array_equal(card.state.alive, host.state.alive)
    assert card.registry.live_ids() == host.registry.live_ids()
    assert [m.trained_models for m in card.metrics] == \
        [m.trained_models for m in host.metrics]
    np.testing.assert_allclose(card.state.history, host.state.history,
                               atol=1e-6, equal_nan=True)
    for m in host.registry.live_ids():
        for k, v in host.registry.params[m].items():
            np.testing.assert_allclose(card.registry.params[m][k].cpu(), v,
                                       atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_lm_grad_transport_launches_once_per_step_on_card(cuda):
    """``make_train_step(grad_transport_bits=8)``: one quantize and one
    dequantize launch per step, params equal to the step with the plain
    versions of both (both round half to even and divide in IEEE)."""
    from repro_torch.config import ArchConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    cfg = ArchConfig(**LM_KW)
    init = tf.init_lm(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, 64, (8, 17))).to(cuda)
    scores = torch.tensor([0.4, 0.1, 0.3, 0.2], device=cuda)
    step = steps.make_train_step(cfg, lr=0.05, remat=False,
                                 grad_transport_bits=8)
    before = tqops.quantize.launches, tqops.dequantize.launches
    pk, _ = step({k: v.to(cuda) for k, v in init.items()}, tok[:, :-1],
                 tok[:, 1:], scores)
    torch.cuda.synchronize()
    assert (tqops.quantize.launches - before[0],
            tqops.dequantize.launches - before[1]) == (1, 1)
    real = tqops.quantize_group, tqops.dequantize_group
    try:
        tqops.quantize_group = lambda xs, bits=8: tuple(
            map(list, zip(*[tqref.quantize_ref(x, bits) for x in xs])))
        tqops.dequantize_group = lambda qs, ss, ns: [
            tqref.dequantize_ref(q, s, (q.shape[0], n), torch.float32)
            for q, s, n in zip(qs, ss, ns)]
        pp, _ = step({k: v.to(cuda) for k, v in init.items()}, tok[:, :-1],
                     tok[:, 1:], scores)
    finally:
        tqops.quantize_group, tqops.dequantize_group = real
    for k in pk:
        assert torch.equal(pk[k], pp[k]), k


# -- the MoE / MLA / MTP families on the card ------------------------------------

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")


def _moe_run(device, name, spec, init, rounds=8):
    from repro_torch.config import FedCDConfig
    from repro_torch.configs import get_arch, reduced
    from repro_torch.federated.llm import FedLLMTrainer
    tr = FedLLMTrainer(reduced(get_arch(name)), FedCDConfig(**LM_FED), 4, 2,
                       16, seed=0, spec=spec, device=device, init_params=init)
    tr.run(rounds)
    return tr


def _moe_init(name):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import transformer as tf
    return tf.init_lm(reduced(get_arch(name)),
                      torch.Generator().manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_trainer_on_card_matches_cpu(cuda, name):
    """Reduced Phi-3.5-MoE and DeepSeek-V3 (MLA, shared expert, MTP) over
    8 rounds on ``llm``, on the card and on the CPU from the same params:
    discrete state equal, score history to 1e-6, params to 1e-4 (float32,
    TF32 off: routing on near-ties would flip under TF32)."""
    init = _moe_init(name)
    card = _moe_run(cuda, name, "llm", init)
    host = _moe_run("cpu", name, "llm", init)
    np.testing.assert_array_equal(card.state.active, host.state.active)
    np.testing.assert_array_equal(card.state.alive, host.state.alive)
    assert card.registry.live_ids() == host.registry.live_ids()
    assert [m.trained_models for m in card.metrics] == \
        [m.trained_models for m in host.metrics]
    np.testing.assert_allclose(card.state.history, host.state.history,
                               atol=1e-6, equal_nan=True)
    for m in host.registry.live_ids():
        for k, v in host.registry.params[m].items():
            np.testing.assert_allclose(card.registry.params[m][k].cpu(), v,
                                       atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_engines_bit_equal_on_card(cuda, name):
    """``legacy`` and ``llm+pipeline`` equal ``llm`` at 0.0 on the card:
    the MoE path has ordered reductions only (stable sorts, F.embedding
    gathers, the combine summed in choice order, no scatter-add)."""
    init = _moe_init(name)
    ref = _moe_run(cuda, name, "llm", init)
    for spec in ("legacy", "llm+pipeline"):
        tr = _moe_run(cuda, name, spec, init)
        assert tr.registry.live_ids() == ref.registry.live_ids()
        np.testing.assert_array_equal(tr.state.active, ref.state.active)
        for m in ref.registry.live_ids():
            for k, v in ref.registry.params[m].items():
                assert torch.equal(tr.registry.params[m][k], v), (spec, k)


@pytest.mark.cuda
def test_moe_grad_transport_launches_twice_per_step_on_card(cuda):
    """Reduced DeepSeek-V3's gradient tree has 46 leaves of 128 values or
    more, 32 a launch: 2 quantize and 2 dequantize launches per step, and
    params equal to the step through the plain versions."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import steps
    cfg = reduced(get_arch("deepseek-v3-671b"))
    init = _moe_init("deepseek-v3-671b")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 17))).to(cuda)
    scores = torch.tensor([0.4, 0.1, 0.3, 0.2], device=cuda)
    step = steps.make_train_step(cfg, lr=0.05, remat=False,
                                 grad_transport_bits=8)
    before = tqops.quantize.launches, tqops.dequantize.launches
    pk, _ = step({k: v.to(cuda) for k, v in init.items()}, tok[:, :-1],
                 tok[:, 1:], scores)
    torch.cuda.synchronize()
    assert (tqops.quantize.launches - before[0],
            tqops.dequantize.launches - before[1]) == (2, 2)
    real = tqops.quantize_group, tqops.dequantize_group
    try:
        tqops.quantize_group = lambda xs, bits=8: tuple(
            map(list, zip(*[tqref.quantize_ref(x, bits) for x in xs])))
        tqops.dequantize_group = lambda qs, ss, ns: [
            tqref.dequantize_ref(q, s, (q.shape[0], n), torch.float32)
            for q, s, n in zip(qs, ss, ns)]
        pp, _ = step({k: v.to(cuda) for k, v in init.items()}, tok[:, :-1],
                     tok[:, 1:], scores)
    finally:
        tqops.quantize_group, tqops.dequantize_group = real
    for k in pk:
        assert torch.equal(pk[k], pp[k]), k


@pytest.mark.cuda
def test_quantize_pytree_is_one_launch_each_on_card(cuda):
    """The packed transport API: one quantize and one dequantize launch
    for a model of up to 32 leaves, codes and scales equal to the plain
    versions', each leaf back in its shape and dtype."""
    from repro_torch.core import quantize as tq
    init = _moe_init("phi3.5-moe-42b-a6.6b")
    tree = {k: v.to(cuda) for k, v in init.items()}
    tree["segments.0.attn.wq"] = tree["segments.0.attn.wq"].to(
        torch.bfloat16)
    before = tqops.quantize.launches, tqops.dequantize.launches
    packed = tq.quantize_pytree(tree)
    out = tq.dequantize_pytree(packed)
    torch.cuda.synchronize()
    assert (tqops.quantize.launches - before[0],
            tqops.dequantize.launches - before[1]) == (1, 1)
    host = tq.quantize_pytree({k: v.cpu() for k, v in tree.items()})
    for a, b in zip(packed["q"], host["q"]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(packed["scales"], host["scales"]):
        assert torch.equal(a.cpu(), b)
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k


# -- the xLSTM and Zamba2 hybrid families on the card ----------------------------

SSM_ARCHS = ("xlstm-125m", "zamba2-7b")


def _ssm_run(device, name, spec, init, rounds=8):
    """Reduced ``name`` on ``LM_FED`` at seq 24: the mLSTM / SSD runs two
    chunks of 16, the second padded."""
    from repro_torch.config import FedCDConfig
    from repro_torch.configs import get_arch, reduced
    from repro_torch.federated.llm import FedLLMTrainer
    tr = FedLLMTrainer(reduced(get_arch(name)), FedCDConfig(**LM_FED), 4, 2,
                       24, seed=0, spec=spec, device=device, init_params=init)
    tr.run(rounds)
    return tr


@pytest.mark.cuda
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_ssm_trainer_on_card_matches_cpu(cuda, name):
    """Reduced xlstm-125m and Zamba2 over 8 rounds on ``llm``, on the card
    and on the CPU from the same params: discrete state equal, score
    history to 1e-6, params to 1e-4 (float32, TF32 off)."""
    init = _moe_init(name)
    card = _ssm_run(cuda, name, "llm", init)
    host = _ssm_run("cpu", name, "llm", init)
    np.testing.assert_array_equal(card.state.active, host.state.active)
    np.testing.assert_array_equal(card.state.alive, host.state.alive)
    assert card.registry.live_ids() == host.registry.live_ids()
    assert [m.trained_models for m in card.metrics] == \
        [m.trained_models for m in host.metrics]
    np.testing.assert_allclose(card.state.history, host.state.history,
                               atol=1e-6, equal_nan=True)
    for m in host.registry.live_ids():
        for k, v in host.registry.params[m].items():
            np.testing.assert_allclose(card.registry.params[m][k].cpu(), v,
                                       atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_ssm_legacy_bit_equal_to_llm_on_card(cuda, name):
    """``legacy`` equals ``llm`` at 0.0 on the card: the chunk loops,
    cumulative sums, ``repeat_interleave`` and maxima reduce in a fixed
    order, and no scatter-add is on the path."""
    init = _moe_init(name)
    ref = _ssm_run(cuda, name, "llm", init)
    tr = _ssm_run(cuda, name, "legacy", init)
    assert tr.registry.live_ids() == ref.registry.live_ids()
    np.testing.assert_array_equal(tr.state.active, ref.state.active)
    for m in ref.registry.live_ids():
        for k, v in ref.registry.params[m].items():
            assert torch.equal(tr.registry.params[m][k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("name,launches", [("zamba2-7b", 1),
                                           ("xlstm-125m", 1)])
def test_ssm_grad_transport_launches_on_card(cuda, name, launches):
    """Reduced Zamba2 (31 leaves of 128 values or more) and reduced xLSTM
    (22) make one quantize and one dequantize launch per step, params
    equal to the step through the plain versions."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import steps
    cfg = reduced(get_arch(name))
    init = _moe_init(name)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 25))).to(cuda)
    scores = torch.tensor([0.4, 0.1, 0.3, 0.2], device=cuda)
    step = steps.make_train_step(cfg, lr=0.05, remat=False,
                                 grad_transport_bits=8)
    before = tqops.quantize.launches, tqops.dequantize.launches
    pk, _ = step({k: v.to(cuda) for k, v in init.items()}, tok[:, :-1],
                 tok[:, 1:], scores)
    torch.cuda.synchronize()
    assert (tqops.quantize.launches - before[0],
            tqops.dequantize.launches - before[1]) == (launches, launches)
    real = tqops.quantize_group, tqops.dequantize_group
    try:
        tqops.quantize_group = lambda xs, bits=8: tuple(
            map(list, zip(*[tqref.quantize_ref(x, bits) for x in xs])))
        tqops.dequantize_group = lambda qs, ss, ns: [
            tqref.dequantize_ref(q, s, (q.shape[0], n), torch.float32)
            for q, s, n in zip(qs, ss, ns)]
        pp, _ = step({k: v.to(cuda) for k, v in init.items()}, tok[:, :-1],
                     tok[:, 1:], scores)
    finally:
        tqops.quantize_group, tqops.dequantize_group = real
    for k in pk:
        assert torch.equal(pk[k], pp[k]), k


# -- the decode path on the card ----------------------------------------------

def _decode_config(name):
    """The tiny decoder configs of ``tests/test_gateway.py:37-55`` and
    reduced whisper-small."""
    from repro_torch.config import ArchConfig, MLAConfig, XLSTMConfig
    from repro_torch.configs import get_arch, reduced
    common = dict(n_heads=4, d_ff=128, vocab_size=64, d_model=64,
                  param_dtype="float32", compute_dtype="float32")
    if name == "whisper-small":
        return reduced(get_arch(name))
    return {
        "dense_win": lambda: ArchConfig(name="tw", n_layers=2, n_kv_heads=2,
                                        sliding_window=6, **common),
        "mla": lambda: ArchConfig(
            name="tm", family="moe", attn_type="mla", n_layers=2,
            n_kv_heads=4, mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                        qk_nope_dim=16, qk_rope_dim=8,
                                        v_head_dim=16), **common),
        "ssm": lambda: ArchConfig(name="ts", family="ssm", n_layers=3,
                                  n_kv_heads=4,
                                  xlstm=XLSTMConfig(slstm_layers=(1,)),
                                  **common),
        "hybrid": lambda: ArchConfig(name="th", family="hybrid", n_layers=5,
                                     n_kv_heads=4, shared_attn_every=2,
                                     shared_attn_lora_rank=4, **common),
    }[name]()


DECODE_FAMILIES = ("dense_win", "mla", "ssm", "hybrid")


def _decode(cfg, params, prompt, dec, device, frames=None):
    """Prefill ``prompt`` in chunks of 4 (the last padded) and decode
    ``dec`` (an audio config: caches from ``frames``, decode only).
    Returns every call's logits and the caches, on the host."""
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf
    win = cfg.sliding_window
    params = {k: v.to(device) for k, v in params.items()}
    serve = steps.make_serve_step(cfg, window=win)
    out = []
    with torch.no_grad():
        if frames is not None:
            caches = ed.init_encdec_caches(cfg, params, frames.to(device), 24)
        else:
            prefill = steps.make_prefill_step(cfg, window=win)
            caches = tf.init_lm_caches(cfg, 2, 24, window=win, device=device)
            for s in range(0, prompt.shape[1], 4):
                chunk = prompt[:, s:s + 4]
                nv = chunk.shape[1]
                chunk = torch.nn.functional.pad(chunk, (0, 4 - nv))
                last, caches = prefill(params, caches, chunk.to(device), nv)
                out.append(last.cpu())
        for t in range(dec.shape[1]):
            last, caches = serve(params, caches, dec[:, t:t + 1].to(device))
            out.append(last.cpu())
    return out, {k: v.cpu() for k, v in caches.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", DECODE_FAMILIES + ("whisper-small",))
def test_decode_on_card_matches_cpu(cuda, name):
    """An 11-token prompt in chunks of 4 and 8 decode steps (whisper:
    its caches and 8 decode steps), card against CPU from the same
    params: logits 1e-5, cache floats 1e-6 of each leaf's scale,
    ``index`` / ``pos`` equal; no kernel launched."""
    from repro_torch.models import encdec as ed
    from repro_torch.models import frontends
    from repro_torch.models import transformer as tf
    cfg = _decode_config(name)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 11)))
    dec = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    frames = None
    if cfg.family == "audio":
        params = ed.init_encdec(cfg, gen)
        frames = frontends.synthetic_audio_frames(gen, cfg, 2)
    else:
        params = tf.init_lm(cfg, gen)
    before = tqops.quantize.launches, twops.multi_weighted_agg.launches
    card = _decode(cfg, params, prompt, dec, cuda, frames)
    assert (tqops.quantize.launches,
            twops.multi_weighted_agg.launches) == before
    host = _decode(cfg, params, prompt, dec, "cpu", frames)
    for a, b in zip(card[0], host[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)
    assert list(card[1]) == list(host[1])
    for k, h in host[1].items():
        c = card[1][k]
        assert c.dtype == h.dtype and c.shape == h.shape, k
        if h.dtype.is_floating_point:
            scale = max(1.0, float(h.abs().max()))
            np.testing.assert_allclose(c.numpy(), h.numpy(),
                                       atol=1e-6 * scale, rtol=0, err_msg=k)
        else:
            assert torch.equal(c, h), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", DECODE_FAMILIES)
def test_rollback_bitwise_equals_prefill_on_card(cuda, name):
    """``tests/test_specdecode.py:104-140`` on the card: a verify whose
    draft is rejected at its second token leaves bitwise the caches of a
    prefill of the chunk with ``n_valid=n_keep``."""
    from repro_torch.models import transformer as tf
    cfg = _decode_config(name)
    win = cfg.sliding_window
    params = {k: v.to(cuda) for k, v in
              tf.init_lm(cfg, torch.Generator().manual_seed(1)).items()}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 11))).to(cuda)
    with torch.no_grad():
        caches = tf.init_lm_caches(cfg, 1, 24, window=win, device=cuda)
        _, caches = tf.lm_prefill(cfg, params, toks[:, :7], caches,
                                  window=win)
        chunk = toks[:, 7:]
        probe, _ = tf.lm_prefill(cfg, params, chunk, caches, window=win)
        draft = torch.argmax(probe, -1).to(torch.int32)[:, :-1]
        draft[:, 1] = (draft[:, 1] + 1) % cfg.vocab_size
        _, n_keep, rolled = tf.lm_spec_verify(cfg, params, chunk, draft,
                                              caches, window=win)
        _, oracle = tf.lm_prefill(cfg, params, chunk, caches, window=win,
                                  n_valid=n_keep)
    assert int(n_keep) == 2
    for k in oracle:
        assert torch.equal(rolled[k], oracle[k]), k


@pytest.mark.cuda
def test_whisper_grad_transport_launches_once_per_step_on_card(cuda):
    """Reduced whisper-small's audio step with ``grad_transport_bits=8``
    (27 leaves): one quantize and one dequantize launch, params equal to
    the step through the plain versions."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ed
    from repro_torch.models import frontends
    cfg = reduced(get_arch("whisper-small"))
    gen = torch.Generator().manual_seed(0)
    init = ed.init_encdec(cfg, gen)
    frames = frontends.synthetic_audio_frames(gen, cfg, 4, cuda)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 9))).to(cuda)
    scores = torch.tensor([0.4, 0.6], device=cuda)
    step = steps.make_train_step(cfg, lr=0.05, grad_transport_bits=8)
    before = tqops.quantize.launches, tqops.dequantize.launches
    pk, _ = step({k: v.to(cuda) for k, v in init.items()}, tok[:, :-1],
                 tok[:, 1:], scores, frames)
    torch.cuda.synchronize()
    assert (tqops.quantize.launches - before[0],
            tqops.dequantize.launches - before[1]) == (1, 1)
    real = tqops.quantize_group, tqops.dequantize_group
    try:
        tqops.quantize_group = lambda xs, bits=8: tuple(
            map(list, zip(*[tqref.quantize_ref(x, bits) for x in xs])))
        tqops.dequantize_group = lambda qs, ss, ns: [
            tqref.dequantize_ref(q, s, (q.shape[0], n), torch.float32)
            for q, s, n in zip(qs, ss, ns)]
        pp, _ = step({k: v.to(cuda) for k, v in init.items()}, tok[:, :-1],
                     tok[:, 1:], scores, frames)
    finally:
        tqops.quantize_group, tqops.dequantize_group = real
    for k in pk:
        assert torch.equal(pk[k], pp[k]), k


# -- the serving plane on the card ---------------------------------------------

def _serve_world(cfg, device):
    """Two models of ``cfg`` (``init_lm`` of seed 0 and a perturbed
    clone) in a stacked registry on ``device``; devices 0-3 prefer model
    0, 4-7 model 1."""
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.core.scores import init_scores, push_accuracies
    from repro_torch.models import transformer as tf
    init = tf.init_lm(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    clone = {k: v + 0.02 * torch.randn(v.shape, generator=gen)
             for k, v in init.items()}
    reg = ModelRegistry.create({k: v.to(device) for k, v in init.items()},
                               m_cap=4, stacked=True)
    reg.clone(0, 1, {k: v.to(device) for k, v in clone.items()})
    state = init_scores(8, 4, ell=2)
    state.active[:, 1] = True
    state.alive[1] = True
    accs = np.zeros((8, 4))
    accs[:4, 0], accs[:4, 1] = 0.9, 0.1
    accs[4:, 0], accs[4:, 1] = 0.1, 0.9
    return reg, push_accuracies(state, accs)


SERVE_MODES = {"vanilla": {}, "spec": dict(spec_k=3, draft_layers=1),
               "paged": dict(paged=True, page_slots=8),
               "spec_paged": dict(spec_k=3, draft_layers=1, paged=True,
                                  page_slots=8)}


def _serve_streams(cfg, device, kw):
    from repro_torch.serve import ServeGateway
    reg, state = _serve_world(cfg, device)
    gw = ServeGateway(cfg, reg, lambda: state, max_len=64, lanes=4,
                      chunk=8, **kw)
    rng = np.random.default_rng(0)
    reqs = [gw.submit(d, rng.integers(0, 64, size=10), max_new=6)
            for d in range(8)]
    gw.drain()
    assert all(r.done and len(r.tokens) == 6 for r in reqs)
    if kw.get("paged"):
        assert gw.stats()["pools"]["pages"]["pages_in_use"] == 0
    return [r.tokens for r in reqs], gw.dispatches


@pytest.mark.cuda
@pytest.mark.parametrize("name", DECODE_FAMILIES)
def test_serve_gateway_on_card_matches_cpu(cuda, name):
    """Greedy streams of every gateway mode on the card equal the CPU's
    and vanilla's; the serving plane launches no kernel."""
    cfg = _decode_config(name)
    counters = (twops.multi_weighted_agg, twops.weighted_agg,
                twops.dequant_agg, tqops.quantize, tqops.dequantize)
    before = [f.launches for f in counters]
    want, _ = _serve_streams(cfg, torch.device("cpu"), {})
    for mode, kw in SERVE_MODES.items():
        card, _ = _serve_streams(cfg, cuda, kw)
        assert card == want, mode
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == before


@pytest.mark.cuda
def test_serve_kv_quantize_on_card_matches_cpu(cuda):
    """The KV contract's int8 codes and f16 scales on the card equal the
    CPU's bit for bit (IEEE division by a tensor, round half to even)."""
    from repro_torch.serve import kv_pool as kv
    rng = np.random.default_rng(0)
    spec = kv._LeafSpec((2, 1, 20, 2, 16), -3, 8, torch.float32)
    x = rng.standard_normal((3, 2, 1, 20, 2, 16)).astype(np.float32)
    x *= rng.uniform(1e-3, 50.0, (3, 2, 1, 20, 1, 1)).astype(np.float32)
    n = 3 * spec.R * spec.P
    pt = rng.permutation(n).reshape(3, spec.R, spec.P).astype(np.int32)
    pt[1] = kv.FREE
    out = []
    for dev in ("cpu", cuda):
        pages = torch.zeros((n + 1, spec.ps, spec.T), dtype=torch.int8,
                            device=dev)
        scales = torch.zeros((n + 1, spec.ps), dtype=torch.float16,
                             device=dev)
        kv._quantize_leaf(pages, scales, pt, torch.from_numpy(x).to(dev),
                          spec, 3)
        dense = kv._dequantize_leaf(pages, scales, pt, spec, 3)
        out.append((pages[:-1].cpu(), scales[:-1].cpu(), dense.cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_serve_draft_rows_on_card_match_cpu(cuda):
    """``FedLLMTrainer(draft_layers=1)`` on the card against the CPU, 3
    rounds: the same drafts present, rows within the trainer's card-vs-
    CPU params bar (1e-4)."""
    from repro_torch.config import ArchConfig, FedCDConfig
    from repro_torch.federated.llm import FedLLMTrainer
    from repro_torch.models import transformer as tf
    cfg = ArchConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab_size=64,
                     param_dtype="float32", compute_dtype="float32")
    fed = FedCDConfig(n_devices=4, devices_per_round=3, score_window=2,
                      milestones=(2, 5), late_delete_round=6, max_models=6,
                      lr=0.05, seed=0)
    init = tf.init_lm(cfg, torch.Generator().manual_seed(0))
    rows = []
    for dev in ("cpu", cuda):
        tr = FedLLMTrainer(cfg, fed, 4, 2, 16, seed=0, device=dev,
                           init_params=init, draft_layers=1)
        tr.run(3)
        rows.append({m: {k: v.cpu() for k, v in tr.draft.row_params(
            tr.draft.row(tr.registry, m)).items()}
            for m in sorted(tr.draft.present)})
    assert list(rows[0]) == list(rows[1]) and len(rows[0]) >= 2
    for m in rows[0]:
        for k in rows[0][m]:
            assert float((rows[0][m][k] - rows[1][m][k]).abs().max()) <= 1e-4
