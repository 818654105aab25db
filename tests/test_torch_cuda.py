"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips on a host without a
GPU. This file imports no jax, so it runs where only PyTorch is
installed (the repository's conftest imports jax; skip it there):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

TF32 is switched off for the plain versions' products. Tolerances:
aggregation atol=1e-5 (float32, different summation order); quantize and
dequantize exact (both sides use IEEE division and round half to even).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.quantize import ops as tqops  # noqa: E402
from repro_torch.kernels.quantize import ref as tqref  # noqa: E402
from repro_torch.kernels.weighted_agg import ops as twops  # noqa: E402


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
