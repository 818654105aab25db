"""The port's MoE and MLA layers (``repro_torch.models.moe``,
``repro_torch.models.mla``) against the reference's, function by
function, on the CPU.

Configs are the reduced Phi-3.5-MoE (no shared expert) and DeepSeek-V3
(one shared expert, MLA); params are the reference's ``init_moe`` /
``init_mla`` output carried through ``repro_torch.convert``; inputs come
from a numpy seed. Bars (float32): ``capacity`` equal; routing ids equal,
weights and aux to 1e-6; ``_expert_shard`` / ``apply_moe`` outputs to
1e-6 (with and without a shared expert, and at a capacity factor of 0.5,
where pairs are dropped); ``apply_moe``'s gradients to 1e-5 of
``jax.grad``'s; ``mla_forward`` on the naive and the chunked path (S =
2304) and every cache function (``init_mla_cache``, ``mla_prefill`` with
a window and ``n_valid``, a run of ``mla_decode`` steps,
``mla_rollback``) to 1e-6, the caches' integer leaves exactly. The
bfloat16 tier (bf16 params and compute, float32 router) holds
``apply_moe`` and ``mla_forward`` to 2e-2 absolute: both round the
expert and attention products to bf16, with different accumulation
orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

PHI, DSV3 = "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(name, **kw):
    j = jconfig.override(jconfigs.reduced(jconfigs.get_arch(name)), **kw)
    t = tconfig.override(tconfigs.reduced(tconfigs.get_arch(name)), **kw)
    return j, t


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _jit(fn, *static):
    """The reference's ``fn`` under ``jax.jit`` (one compile per shape,
    where eager dispatch compiles every op)."""
    return jax.jit(fn, static_argnames=static)


J_FORWARD = _jit(jmla.mla_forward, "cfg")
J_PREFILL = _jit(jmla.mla_prefill, "cfg", "window")
J_DECODE = _jit(jmla.mla_decode, "cfg", "window")
J_APPLY_MOE = _jit(jmoe.apply_moe, "cfg")
J_ROUTE = _jit(jmoe._route, "cfg")
J_SHARD = _jit(jmoe._expert_shard, "cap", "compute_dtype")


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module")
def moe_params():
    """The reference's ``init_moe`` of both reduced archs (dict by arch)."""
    out = {}
    for name in (PHI, DSV3):
        jc, _ = _pair(name)
        out[name] = _jit(jmoe.init_moe, "cfg", "dtype")(
            jax.random.PRNGKey(3), jc, jnp.float32)
    return out


# -- MoE -----------------------------------------------------------------------

def test_capacity_matches_over_token_counts():
    for name in (PHI, DSV3):
        for cf in (0.5, 1.0, 1.25, 2.0):
            jc, tc = _pair(name, **{"moe.capacity_factor": cf})
            full_j = jconfig.override(jconfigs.get_arch(name),
                                      **{"moe.capacity_factor": cf})
            full_t = tconfig.override(tconfigs.get_arch(name),
                                      **{"moe.capacity_factor": cf})
            for n in (1, 3, 8, 31, 64, 100, 128, 2047, 2048, 4096, 65536):
                assert tmoe.capacity(n, tc) == jmoe.capacity(n, jc)
                assert tmoe.capacity(n, full_t) == jmoe.capacity(n, full_j)
    # the full-width tiers of the card run (2048 tokens a step)
    assert tmoe.capacity(2048, tconfigs.get_arch(PHI)) == 328
    assert tmoe.capacity(2048, tconfig.override(
        tconfigs.get_arch(DSV3), **{"moe.n_experts": 16})) == 1288


@pytest.mark.parametrize("name", [PHI, DSV3])
def test_route_matches(moe_params, name):
    jc, tc = _pair(name)
    p = moe_params[name]
    xf = _x((96, jc.d_model), 1)
    ji, jw, ja = J_ROUTE(p, jc, jnp.asarray(xf))
    ti, tw, ta = tmoe._route(_port(p), tc, _t(xf))
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(tw.numpy(), _np(jw), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ta.numpy(), _np(ja), atol=TOL, rtol=TOL)


def test_route_breaks_ties_to_the_lower_expert(moe_params):
    """Equal router logits: ``lax.top_k`` takes the lower index first,
    and so does the port's stable sort."""
    jc, tc = _pair(PHI)
    p = dict(moe_params[PHI])
    router = np.zeros_like(_np(p["router"]))
    router[:, 2] = router[:, 3] = 1.0              # experts 2, 3 tie
    p["router"] = jnp.asarray(router)
    xf = np.abs(_x((16, jc.d_model), 2))
    ji, _, _ = J_ROUTE(p, jc, jnp.asarray(xf))
    ti, _, _ = tmoe._route(_port(p), tc, _t(xf))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    assert (ti[:, 0] == 2).all() and (ti[:, 1] == 3).all()


def _dropped(ids, n_experts, cap):
    counts = np.bincount(np.asarray(ids).reshape(-1), minlength=n_experts)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap", "drops"])
@pytest.mark.parametrize("name", [PHI, DSV3])
def test_expert_shard_matches(moe_params, name, cf):
    jc, tc = _pair(name, **{"moe.capacity_factor": cf})
    p = moe_params[name]
    T = 80
    xf = _x((T, jc.d_model), 4)
    ids, wts, _ = J_ROUTE(p, jc, jnp.asarray(xf))
    cap = jmoe.capacity(T, jc)
    if cf < 1:
        assert _dropped(ids, jc.moe.n_experts, cap) > 0
    a = J_SHARD(jnp.asarray(xf), ids, wts, p["w_gate"], p["w_up"],
              p["w_down"], e0=jnp.int32(0), cap=cap,
              compute_dtype=jnp.float32)
    tp = _port(p)
    b = tmoe._expert_shard(_t(xf), _t(ids).long(), _t(wts), tp["w_gate"],
                           tp["w_up"], tp["w_down"], e0=0, cap=cap,
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(b.numpy(), _np(a), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap", "drops"])
@pytest.mark.parametrize("name", [PHI, DSV3])
def test_apply_moe_matches(moe_params, name, cf):
    jc, tc = _pair(name, **{"moe.capacity_factor": cf})
    p = moe_params[name]
    assert ("shared" in p) == (name == DSV3)
    x = _x((2, 40, jc.d_model), 5)
    ya, aa = J_APPLY_MOE(p, jc, jnp.asarray(x))
    yb, ab = tmoe.apply_moe(_port(p), tc, _t(x))
    np.testing.assert_allclose(yb.numpy(), _np(ya), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ab.numpy(), _np(aa), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap", "drops"])
@pytest.mark.parametrize("name", [PHI, DSV3])
def test_apply_moe_gradients_match(moe_params, name, cf):
    jc, tc = _pair(name, **{"moe.capacity_factor": cf})
    p = moe_params[name]
    x = _x((2, 24, jc.d_model), 6)
    r = _x((2, 24, jc.d_model), 7)

    def jloss(params, xx):
        y, aux = jmoe.apply_moe(params, jc, xx)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _port(p).items()}
    tx = _t(x).requires_grad_()
    y, aux = tmoe.apply_moe(tp, tc, tx)
    (torch.sum(y * _t(r)) + aux).backward()
    ref = _port(jg)
    assert list(ref) == list(tp)
    for k in ref:
        np.testing.assert_allclose(tp[k].grad.numpy(), ref[k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jgx), atol=1e-5,
                               rtol=1e-5)


def test_apply_moe_mesh_raises(moe_params):
    """``apply_moe(mesh=...)`` runs expert-parallel (ROADMAP item 13b.4;
    the mesh bars are in ``tests/test_torch_lm_mesh.py``): at ``data=1``
    it keeps the one-device values. An expert axis other than the launch
    mesh's ``model`` raises."""
    from repro_torch.launch.mesh import make_host_mesh
    _, tc = _pair(PHI)
    params = _port(moe_params[PHI])
    x = torch.randn((2, 4, tc.d_model), generator=torch.Generator()
                    .manual_seed(0))
    y0, a0 = tmoe.apply_moe(params, tc, x)
    y, a = tmoe.apply_moe(params, tc, x, mesh=make_host_mesh(model=2))
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=1e-6)
    assert float(a) == float(a0)
    with pytest.raises(ValueError, match="model"):
        tmoe.apply_moe(params, tc, x, mesh=make_host_mesh(model=2),
                       ep_axis="data")


# -- MLA -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    jc, tc = _pair(DSV3)
    p = _jit(jmla.init_mla, "cfg", "dtype")(jax.random.PRNGKey(4), jc,
                                            jnp.float32)
    return jc, tc, p, _port(p)


def test_init_mla_names_shapes_dtypes(mla):
    jc, tc, p, tp = mla
    mine = tmla.init_mla(torch.Generator().manual_seed(0), tc,
                         torch.float32)
    assert list(mine) == list(tp)
    for k in tp:
        assert mine[k].shape == tp[k].shape and mine[k].dtype == tp[k].dtype


@pytest.mark.parametrize("S", [48, 2304], ids=["naive", "chunked"])
def test_mla_forward_matches(mla, S):
    jc, tc, p, tp = mla
    x = _x((1, S, jc.d_model), 8)
    a = J_FORWARD(p, jc, jnp.asarray(x))
    b = tmla.mla_forward(tp, tc, _t(x))
    np.testing.assert_allclose(b.numpy(), _np(a), atol=TOL, rtol=1e-5)


def _cache_close(tc_cache, jc_cache):
    assert sorted(tc_cache) == sorted(jc_cache)
    for k in ("index", "pos"):
        np.testing.assert_array_equal(tc_cache[k].numpy(),
                                      _np(jc_cache[k]), err_msg=k)
        assert tc_cache[k].dtype == torch.int32
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc_cache[k].numpy(), _np(jc_cache[k]),
                                   atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("window", [0, 8])
def test_init_mla_cache_matches(mla, window):
    jc, tc, _, _ = mla
    a = jmla.init_mla_cache(jc, 2, 12, jnp.float32, window)
    b = tmla.init_mla_cache(tc, 2, 12, torch.float32, window)
    _cache_close(b, a)
    for k in a:
        assert tuple(b[k].shape) == a[k].shape


@pytest.mark.parametrize("window,n_valid", [(0, None), (0, 3), (8, None),
                                            (8, 4)])
def test_mla_prefill_and_decode_match(mla, window, n_valid):
    """Two prefill chunks (the second padded when ``n_valid`` is given;
    with a window of 8 the ring buffer wraps), then decode steps."""
    jc, tc, p, tp = mla
    jcache = jmla.init_mla_cache(jc, 2, 12, jnp.float32, window)
    tcache = tmla.init_mla_cache(tc, 2, 12, torch.float32, window)
    for i, (S, nv) in enumerate(((5, None), (5, n_valid))):
        x = _x((2, S, jc.d_model), 10 + i)
        ya, jcache = J_PREFILL(p, jc, jnp.asarray(x), jcache, window,
                                nv)
        yb, tcache = tmla.mla_prefill(tp, tc, _t(x), tcache, window, nv)
        np.testing.assert_allclose(yb.numpy(), _np(ya), atol=TOL,
                                   rtol=1e-5)
        _cache_close(tcache, jcache)
    for i in range(4):
        x = _x((2, 1, jc.d_model), 20 + i)
        ya, jcache = J_DECODE(p, jc, jnp.asarray(x), jcache, window)
        yb, tcache = tmla.mla_decode(tp, tc, _t(x), tcache, window)
        np.testing.assert_allclose(yb.numpy(), _np(ya), atol=TOL,
                                   rtol=1e-5)
        _cache_close(tcache, jcache)


@pytest.mark.parametrize("window", [0, 8])
def test_mla_rollback_matches(mla, window):
    """A verify chunk of 4 rolled back to 2 kept tokens equals the
    reference's rollback, and the prefill of those 2 tokens alone."""
    jc, tc, p, tp = mla
    jold = jmla.init_mla_cache(jc, 2, 12, jnp.float32, window)
    told = tmla.init_mla_cache(tc, 2, 12, torch.float32, window)
    x0 = _x((2, 6, jc.d_model), 30)
    _, jold = J_PREFILL(p, jc, jnp.asarray(x0), jold, window)
    _, told = tmla.mla_prefill(tp, tc, _t(x0), told, window)
    x = _x((2, 4, jc.d_model), 31)
    _, jfull = J_PREFILL(p, jc, jnp.asarray(x), jold, window)
    _, tfull = tmla.mla_prefill(tp, tc, _t(x), told, window)
    a = jmla.mla_rollback(jold, jfull, 2, 4, window)
    b = tmla.mla_rollback(told, tfull, 2, 4, window)
    _cache_close(b, a)
    _, tkeep = tmla.mla_prefill(tp, tc, _t(x), told, window, n_valid=2)
    for k in b:
        assert torch.equal(b[k], tkeep[k]), k
    with pytest.raises(ValueError, match="exceeds cache slots"):
        tmla.mla_rollback(told, tfull, 2, 13, window)


# -- bfloat16 ------------------------------------------------------------------

def test_bf16_tier():
    """bf16 params and compute, the reference on the CPU too: the router
    stays float32 in both, and the outputs agree to a few bf16 ulps."""
    kw = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    jc, tc = _pair(DSV3, **kw)
    p = _jit(jmoe.init_moe, "cfg", "dtype")(jax.random.PRNGKey(5), jc,
                                            jnp.bfloat16)
    tp = _port(p)
    assert tp["router"].dtype == torch.float32
    assert all(v.dtype == torch.bfloat16 for k, v in tp.items()
               if k != "router")
    x = _x((2, 16, jc.d_model), 40)
    ya, aa = J_APPLY_MOE(p, jc, jnp.asarray(x, jnp.bfloat16))
    yb, ab = tmoe.apply_moe(tp, tc, _t(x).to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(yb.float().numpy(),
                               _np(ya).astype(np.float32), atol=2e-2)
    np.testing.assert_allclose(ab.numpy(), _np(aa), atol=1e-6)
    pm = _jit(jmla.init_mla, "cfg", "dtype")(jax.random.PRNGKey(6), jc,
                                             jnp.bfloat16)
    a = J_FORWARD(pm, jc, jnp.asarray(x, jnp.bfloat16))
    b = tmla.mla_forward(_port(pm), tc, _t(x).to(torch.bfloat16))
    assert b.dtype == torch.bfloat16
    np.testing.assert_allclose(b.float().numpy(),
                               _np(a).astype(np.float32), atol=2e-2)
