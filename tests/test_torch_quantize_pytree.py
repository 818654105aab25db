"""The port's packed transport API (``repro_torch.core.quantize``
``quantize_pytree`` / ``dequantize_pytree``) against the reference's
(``repro/core/quantize.py``), on the CPU: the payload's codes and scales
exactly equal to the reference's, leaf for leaf in the reference's leaf
order, with its shapes, dtypes and bits; the round trip of
``tests/test_kernels.py``'s ``test_pytree_quantize_roundtrip`` (atol
0.05, ``roundtrip(tree, 0) is tree``); each direction one group call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quantize as jq  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.kernels.quantize import ops as tqops  # noqa: E402


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 2, (40, 300)).astype(np.float32),
            "a": np.arange(12.0, dtype=np.float32).reshape(3, 4),
            "b": [np.ones((5,), np.float32), np.zeros((2, 2), np.float32),
                  rng.normal(0, 1, (3, 129)).astype(np.float32)],
            "s": np.float32(rng.normal())}


@pytest.mark.parametrize("bits", [8, 4])
def test_payload_matches_reference(bits):
    tree = _tree(0)
    ref = jq.quantize_pytree(jax.tree.map(jnp.asarray, tree), bits=bits)
    port = tq.quantize_pytree(params_from_jax(tree), bits=bits)
    assert port["names"] == ["a", "b.0", "b.1", "b.2", "s", "w"]
    assert port["bits"] == ref["bits"] == bits
    assert port["shapes"] == [tuple(s) for s in ref["shapes"]]
    assert [str(d).replace("torch.", "") for d in port["dtypes"]] == \
        [str(d) for d in ref["dtypes"]]
    assert len(port["q"]) == len(ref["q"]) == 6
    for a, b, sa, sb in zip(port["q"], ref["q"], port["scales"],
                            ref["scales"]):
        assert a.dtype == torch.int8 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(sa.numpy(), np.asarray(sb))
    out = tq.dequantize_pytree(port)
    want = params_from_jax(jq.dequantize_pytree(ref))
    assert list(out) == list(want)
    for k in want:
        assert out[k].shape == want[k].shape and out[k].dtype == \
            want[k].dtype
        np.testing.assert_array_equal(out[k].numpy(), want[k].numpy())


def test_pytree_quantize_roundtrip():
    """``tests/test_kernels.py:100-107`` through the port."""
    tree = params_from_jax({"a": np.arange(12.0, dtype=np.float32)
                            .reshape(3, 4),
                            "b": [np.ones((5,), np.float32),
                                  np.zeros((2, 2), np.float32)]})
    out = tq.dequantize_pytree(tq.quantize_pytree(tree, bits=8))
    for k in tree:
        np.testing.assert_allclose(out[k].numpy(), tree[k].numpy(),
                                   atol=0.05)
    assert tq.roundtrip(tree, bits=0) is tree


def test_leaves_keep_their_dtype_and_take_one_group_call(monkeypatch):
    calls = {"q": [], "dq": 0}
    real_q, real_dq = tqops.quantize_group, tqops.dequantize_group

    def q(xs, bits=8):
        calls["q"].append([tuple(x.shape) for x in xs])
        return real_q(xs, bits)

    def dq(qs, ss, ns):
        calls["dq"] += 1
        return real_dq(qs, ss, ns)

    monkeypatch.setattr(tqops, "quantize_group", q)
    monkeypatch.setattr(tqops, "dequantize_group", dq)
    g = torch.Generator().manual_seed(1)
    tree = {"z": torch.randn((4, 64), generator=g).to(torch.bfloat16),
            "router": torch.randn((64, 4), generator=g),
            "a.1": torch.randn((3,), generator=g),
            "a.0": torch.randn((), generator=g)}
    packed = tq.quantize_pytree(tree)
    assert packed["names"] == ["a.0", "a.1", "router", "z"]
    out = tq.dequantize_pytree(packed)
    assert calls == {"q": [[(1, 1), (1, 3), (1, 256), (1, 256)]], "dq": 1}
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
    # the same values as the per-leaf round trip
    for k, v in tree.items():
        qk, sk = tq.quantize_leaf(v.float())
        want = tq.dequantize_leaf(qk, sk, v.shape, v.dtype)
        assert torch.equal(out[k], want), k
