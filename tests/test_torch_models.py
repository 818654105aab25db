"""Port parity: the MLP and the paper's CNN (full width) give the
reference's logits, loss and gradients on the reference's params.

Tolerance: rtol=atol=1e-5 — float32 with a different summation order in
the convolutions and matrix products on each side."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import cnn as jcnn  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    "mlp": (lambda: jmlp.init_mlp_classifier(jax.random.PRNGKey(0),
                                             hidden=32),
            jmlp.apply_mlp_classifier, jmlp.mlp_loss,
            tmlp.apply_mlp_classifier, tmlp.mlp_loss),
    "cnn": (lambda: jcnn.init_cnn(jax.random.PRNGKey(0)),
            jcnn.apply_cnn, jcnn.cnn_loss, tcnn.apply_cnn, tcnn.cnn_loss),
}


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_loss_grads_match(name):
    init, japply, jloss, tapply, tloss = CASES[name]
    jparams = init()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    x, y = _batch()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    np.testing.assert_allclose(tapply(tparams, tx).numpy(),
                               np.asarray(japply(jparams, jnp.asarray(x))),
                               **TOL)
    jl, jg = jax.value_and_grad(jloss)(jparams, (x, y))
    tg, tl = torch.func.grad_and_value(tloss)(tparams, (tx, ty))
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for (k, g), jgl in zip(tg.items(), jleaves):
        assert g.shape == jgl.shape, k
        np.testing.assert_allclose(g.numpy(), np.asarray(jgl), **TOL,
                                   err_msg=k)


def test_cnn_shape_and_layout():
    """Full width: 20 leaves, ~1.44 M params, the reference's HWIO
    kernels and (in, out) dense weights; the flatten keeps HWC order."""
    p = tcnn.init_cnn(torch.Generator().manual_seed(0))
    jp = jcnn.init_cnn(jax.random.PRNGKey(0))
    assert len(p) == len(jax.tree.leaves(jp)) == 20
    for t, j in zip(p.values(), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    assert sum(t.numel() for t in p.values()) == 1_437_226
    assert tuple(p["conv.1"].shape) == (3, 3, 32, 32)
    assert tuple(p["fc1"].shape) == (1024, 256)


def test_params_roundtrip_through_reference_structure():
    jp = jax.tree.map(np.asarray, jcnn.init_cnn(jax.random.PRNGKey(1)))
    back = params_to_numpy(params_from_jax(jp))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_vmapped_pair_grads_match_per_pair_loop():
    """torch.func.vmap(grad) over per-pair conv weights (how the round
    trains its pairs) equals a loop over the pairs."""
    gen = torch.Generator().manual_seed(0)
    ps = [tcnn.init_cnn(gen) for _ in range(2)]
    stacked = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    x, y = _batch(n=4)
    xb = torch.from_numpy(x).reshape(2, 2, 32, 32, 3)
    yb = torch.from_numpy(y).reshape(2, 2)
    g = torch.func.vmap(torch.func.grad(tcnn.cnn_loss))(stacked, (xb, yb))
    for i, p in enumerate(ps):
        gi = torch.func.grad(tcnn.cnn_loss)(p, (xb[i], yb[i]))
        for k in p:
            np.testing.assert_allclose(g[k][i].numpy(), gi[k].numpy(),
                                       **TOL, err_msg=k)
