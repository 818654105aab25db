"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips on a host without a
GPU. This file imports no jax, so it runs where only PyTorch is
installed (the repository's conftest imports jax; skip it there):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

TF32 is switched off for the plain versions' products. Tolerances:
aggregation (all three kernels) atol=1e-5 (float32, different summation
order); quantize and dequantize exact (both sides use IEEE division and
round half to even).
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
