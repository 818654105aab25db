"""The port's Mamba2 and xLSTM blocks (``repro_torch.models.mamba2``,
``repro_torch.models.xlstm``) against the reference's own functions, on
the CPU, function by function, on inputs drawn from a numpy seed.

Params are the reference's inits carried through ``repro_torch.convert``
(the ports' inits are held to the reference's names, shapes and dtypes,
and to the values of their deterministic leaves). Shapes include those
of ``tests/test_models.py``: the SSD at S=13 (and 11) with chunk 4,
with and without a carried state ``h0``, one and two B/C groups; the
mLSTM inner loop through its padding path (S=10, chunk 4) with and
without a state, and at ``dh = 384`` (xlstm-125m's head width, where
the float32 ``1/sqrt(dh)`` differs from the float64 one by an ulp); the
decode loops over S=11 / 10 / 7 tokens; both rollbacks.

Bars (float32): outputs, states and decode caches to 1e-5 (products in
other orders: the reference's XLA dots against PyTorch's), gradients
(of the output against a random cotangent, every param and the input)
to 1e-5 absolute plus 1e-5 relative; slices, inits' constant leaves and
the rollbacks' selections exact. The reference's functions run under
``jax.jit``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import ArchConfig as JArch  # noqa: E402
from repro.config import override as joverride  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.config import ArchConfig as TArch  # noqa: E402
from repro_torch.config import override as toverride  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

BASE = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=64, param_dtype="float32", compute_dtype="float32")
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    return joverride(JArch(**BASE), **kw), toverride(TArch(**BASE), **kw)


SSM = {"ssm.state_dim": 8, "ssm.head_dim": 16, "ssm.chunk": 4}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), _np(want),
                               **(kw or TOL))


def _close_tree(got, want, **kw):
    want = params_from_jax(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k].detach().float().numpy(),
                                   want[k].float().numpy(), err_msg=k,
                                   **(kw or TOL))


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _params(init, jc, seed, jitter=0.0):
    """The reference's init (numpy) and its port; ``jitter`` perturbs
    every leaf so that constant inits (zeros, ones) do not hide a
    wrong product."""
    jp = jax.jit(lambda k: init(k, jc, jnp.float32))(
        jax.random.PRNGKey(seed))
    jp = jax.tree.map(np.asarray, jp)
    if jitter:
        rng = np.random.default_rng(seed)
        jp = jax.tree.map(lambda a: (a + jitter * rng.normal(size=a.shape)
                                     ).astype(a.dtype), jp)
    return jp, params_from_jax(jp)


def _grads_match(jfn, tfn, jp, x, cot):
    """d/d(params, x) of sum(fn(params, x) * cot) in both packages."""
    gj = jax.jit(jax.grad(lambda p, u: jnp.sum(jfn(p, u) * cot),
                          argnums=(0, 1)))(jp, x)
    tp = {k: v.clone().requires_grad_() for k, v in
          params_from_jax(jp).items()}
    u = _t(x).requires_grad_()
    torch.sum(tfn(tp, u) * _t(cot)).backward()
    _close_tree({k: v.grad for k, v in tp.items()}, gj[0])
    _close(u.grad, gj[1])


# -- Mamba2 -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba2_names_shapes_dtypes(dtype):
    jc, tc = _pair(**SSM)
    assert TM._dims(tc)[1:] == JM._dims(jc)[1:]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = params_from_jax(jax.tree.map(np.asarray, jax.jit(
        lambda k: JM.init_mamba2(k, jc, jd))(jax.random.PRNGKey(0))))
    mine = TM.init_mamba2(torch.Generator().manual_seed(0), tc, td)
    assert list(mine) == list(ref)
    for k, v in ref.items():
        assert (mine[k].shape, mine[k].dtype) == (v.shape, v.dtype), k
    for k in ("A_log", "D", "dt_bias"):
        assert mine[k].dtype == torch.float32
    # the constant leaves (A_log: a float32 linspace and log, ulps apart)
    for k in ("D", "dt_bias", "conv_b", "norm.scale"):
        assert torch.equal(mine[k], ref[k]), k
    np.testing.assert_allclose(mine["A_log"].numpy(), ref["A_log"].numpy(),
                               rtol=1e-6)


def test_split_proj_and_causal_conv_match():
    jc, tc = _pair(**SSM)
    _, d_in, H = JM._dims(jc)
    rng = np.random.default_rng(0)
    width = 2 * d_in + 2 * 8 + H
    proj = _rand(rng, 2, 5, width)
    for a, b in zip(TM._split_proj(tc, _t(proj)), JM._split_proj(jc, proj)):
        assert torch.equal(a, _t(b))
    xbc, w, b = _rand(rng, 2, 9, 40), _rand(rng, 4, 40), _rand(rng, 40)
    for state in (None, _rand(rng, 2, 3, 40)):
        ya, sa = TM._causal_conv(_t(xbc), _t(w), _t(b),
                                 None if state is None else _t(state))
        yb, sb = JM._causal_conv(xbc, w, b, state)
        _close(ya, yb)
        assert torch.equal(sa, _t(sb))


def _ssd_inputs(rng, B, S, H, P, G, N):
    return (_rand(rng, B, S, H, P),
            rng.uniform(0.1, 0.9, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            _rand(rng, B, S, G, N), _rand(rng, B, S, G, N))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N", [(1, 13, 2, 4, 1, 3),
                                         (2, 11, 4, 8, 2, 5)])
def test_ssd_chunked_matches(B, S, H, P, G, N, with_h0):
    """Two, three or four chunks of 4, the last one padded."""
    rng = np.random.default_rng(S + G)
    args = _ssd_inputs(rng, B, S, H, P, G, N)
    h0 = _rand(rng, B, H, P, N) if with_h0 else None
    ya, ha = TM._ssd_chunked(*map(_t, args), chunk=4,
                             h0=None if h0 is None else _t(h0))
    yb, hb = jax.jit(JM._ssd_chunked, static_argnums=5)(*args, 4, h0)
    _close(ya, yb)
    _close(ha, hb)
    assert ha.dtype == torch.float32


def test_ssd_chunked_grads_match():
    rng = np.random.default_rng(7)
    args = _ssd_inputs(rng, 2, 11, 4, 8, 2, 5)
    h0 = _rand(rng, 2, 4, 8, 5)
    cot = _rand(rng, 2, 11, 4, 8)

    def jloss(*a):
        y, h = JM._ssd_chunked(*a[:5], 4, a[5])
        return jnp.sum(y * cot) + jnp.sum(h)

    gj = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*args, h0)
    ts = [_t(a).requires_grad_() for a in (*args, h0)]
    y, h = TM._ssd_chunked(*ts[:5], chunk=4, h0=ts[5])
    (torch.sum(y * _t(cot)) + torch.sum(h)).backward()
    for a, b in zip(ts, gj):
        _close(a.grad, b)


def test_mamba2_forward_and_grads_match():
    jc, tc = _pair(**SSM)
    jp, tp = _params(JM.init_mamba2, jc, 2, jitter=0.05)
    rng = np.random.default_rng(2)
    u = _rand(rng, 2, 11, 64)
    _close(TM.mamba2_forward(tp, tc, _t(u)),
           jax.jit(lambda p, x: JM.mamba2_forward(p, jc, x))(jp, u))
    _grads_match(lambda p, x: JM.mamba2_forward(p, jc, x),
                 lambda p, x: TM.mamba2_forward(p, tc, x), jp, u,
                 _rand(rng, 2, 11, 64))


def test_mamba2_decode_loop_matches():
    """tests/test_models.py's decode case: 11 one-token steps, each
    output and the final cache against the reference's loop, and the
    port's loop against the port's full forward."""
    jc, tc = _pair(**SSM)
    jp, tp = _params(JM.init_mamba2, jc, 3, jitter=0.05)
    B, S = 2, 11
    u = _rand(np.random.default_rng(3), B, S, 64)
    jcache = JM.init_mamba2_cache(jc, B, jnp.float32)
    tcache = TM.init_mamba2_cache(tc, B, torch.float32)
    _close_tree(tcache, jcache, atol=0, rtol=0)
    jstep = jax.jit(lambda p, x, c: JM.mamba2_decode(p, jc, x, c))
    outs = []
    for t in range(S):
        ya, tcache = TM.mamba2_decode(tp, tc, _t(u[:, t:t + 1]), tcache)
        yb, jcache = jstep(jp, u[:, t:t + 1], jcache)
        _close(ya, yb)
        outs.append(ya)
    _close_tree(tcache, jcache)
    np.testing.assert_allclose(
        torch.cat(outs, 1).numpy(),
        TM.mamba2_forward(tp, tc, _t(u)).numpy(), atol=2e-4)


def _states(rng):
    return {"C": _rand(rng, 2, 5, 3, 4, 4), "m": _rand(rng, 2, 5, 3),
            "n": _rand(rng, 2, 5, 3, 4)}


@pytest.mark.parametrize("n_keep", [1, 3, 5])
@pytest.mark.parametrize("which", ["mamba2", "xlstm"])
def test_rollbacks_select_the_reference_step(which, n_keep):
    states = _states(np.random.default_rng(n_keep))
    jfn, tfn = ((JM.mamba2_rollback, TM.mamba2_rollback)
                if which == "mamba2" else
                (JX.xlstm_rollback, TX.xlstm_rollback))
    want = jfn(states, n_keep, 1)
    for nk in (n_keep, torch.tensor(n_keep)):
        got = tfn({k: _t(v) for k, v in states.items()}, nk, 1)
        _close_tree(got, want, atol=0, rtol=0)


# -- mLSTM --------------------------------------------------------------------

MLSTM = {"xlstm.chunk": 4}
WIDE_HEAD = {"xlstm.chunk": 4, "d_model": 192, "n_heads": 1,
             "n_kv_heads": 1}                     # dh = 384


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_xlstm_names_shapes_dtypes(dtype):
    jc, tc = _pair(**MLSTM)
    assert TX._mlstm_dims(tc) == JX._mlstm_dims(jc)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for jinit, tinit in ((JX.init_mlstm, TX.init_mlstm),
                         (JX.init_slstm, TX.init_slstm)):
        ref = params_from_jax(jax.tree.map(np.asarray, jax.jit(
            lambda k: jinit(k, jc, jd))(jax.random.PRNGKey(0))))
        mine = tinit(torch.Generator().manual_seed(0), tc, td)
        assert list(mine) == list(ref)
        for k, v in ref.items():
            assert (mine[k].shape, mine[k].dtype) == (v.shape, v.dtype), k
        assert mine["f_bias"].dtype == torch.float32
        for k in mine:
            if k in ("f_bias", "conv_b") or k.startswith("norm."):
                assert torch.equal(mine[k], ref[k]), k
    for jcache, tcache in ((JX.init_mlstm_cache, TX.init_mlstm_cache),
                           (JX.init_slstm_cache, TX.init_slstm_cache)):
        _close_tree(tcache(tc, 2, td), jcache(jc, 2, jd), atol=0, rtol=0)


def test_mlstm_scale_is_the_float32_reciprocal():
    for dh in (128, 384, 192):
        want = np.float32(1.0) / np.sqrt(np.float32(dh))
        assert TX._scale(dh, "cpu").item() == float(want)
    # at xlstm-125m's dh the float64 reciprocal rounds to another float32
    assert np.float32(1 / np.sqrt(384.0)) != TX._scale(384, "cpu").item()


def _mlstm_inputs(rng, B, S, H, dh):
    q, k, v = (_rand(rng, B, S, H, dh) for _ in range(3))
    logi = _rand(rng, B, S, H)
    logf = np.log(rng.uniform(0.5, 0.99, (B, S, H))).astype(np.float32)
    return q, k, v, logi, logf


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,chunk", [(10, 4), (1, 1), (8, 8)])
def test_mlstm_inner_chunked_matches(S, chunk, with_state):
    """S=10 at chunk 4 pads the last chunk (input gate -1e30); chunk 1 is
    the decode path's call."""
    rng = np.random.default_rng(S * 10 + chunk)
    B, H, dh = 2, 3, 8
    args = _mlstm_inputs(rng, B, S, H, dh)
    state = ({"C": _rand(rng, B, H, dh, dh) * 0.1,
              "n": np.abs(_rand(rng, B, H, dh)),
              "m": _rand(rng, B, H)} if with_state else None)
    ya, sa = TX._mlstm_inner_chunked(
        *map(_t, args), chunk,
        state=None if state is None else {k: _t(v)
                                          for k, v in state.items()})
    yb, sb = jax.jit(JX._mlstm_inner_chunked, static_argnums=5)(
        *args, chunk, state)
    _close(ya, yb)
    _close_tree(sa, sb)


def test_mlstm_inner_chunked_grads_match():
    rng = np.random.default_rng(11)
    args = _mlstm_inputs(rng, 2, 10, 3, 8)
    cot = _rand(rng, 2, 10, 3, 8)

    def jloss(*a):
        y, st = JX._mlstm_inner_chunked(*a, 4)
        return jnp.sum(y * cot) + jnp.sum(st["C"]) + jnp.sum(st["n"])

    gj = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*args)
    ts = [_t(a).requires_grad_() for a in args]
    y, st = TX._mlstm_inner_chunked(*ts, 4)
    (torch.sum(y * _t(cot)) + torch.sum(st["C"])
     + torch.sum(st["n"])).backward()
    for a, b in zip(ts, gj):
        _close(a.grad, b)


@pytest.mark.parametrize("kw", [MLSTM, WIDE_HEAD], ids=["dh16", "dh384"])
def test_mlstm_forward_and_grads_match(kw):
    jc, tc = _pair(**kw)
    jp, tp = _params(JX.init_mlstm, jc, 4, jitter=0.02)
    rng = np.random.default_rng(4)
    d = jc.d_model
    x = _rand(rng, 2, 10, d)
    _close(TX.mlstm_forward(tp, tc, _t(x)),
           jax.jit(lambda p, u: JX.mlstm_forward(p, jc, u))(jp, x))
    _grads_match(lambda p, u: JX.mlstm_forward(p, jc, u),
                 lambda p, u: TX.mlstm_forward(p, tc, u), jp, x,
                 _rand(rng, 2, 10, d))


def test_mlstm_decode_loop_matches():
    jc, tc = _pair(**MLSTM)
    jp, tp = _params(JX.init_mlstm, jc, 5, jitter=0.02)
    B, S = 1, 10
    x = _rand(np.random.default_rng(5), B, S, 64)
    jcache = JX.init_mlstm_cache(jc, B, jnp.float32)
    tcache = TX.init_mlstm_cache(tc, B, torch.float32)
    jstep = jax.jit(lambda p, u, c: JX.mlstm_decode(p, jc, u, c))
    outs = []
    for t in range(S):
        ya, tcache = TX.mlstm_decode(tp, tc, _t(x[:, t:t + 1]), tcache)
        yb, jcache = jstep(jp, x[:, t:t + 1], jcache)
        _close(ya, yb)
        outs.append(ya)
    _close_tree(tcache, jcache)
    np.testing.assert_allclose(
        torch.cat(outs, 1).numpy(),
        TX.mlstm_forward(tp, tc, _t(x)).numpy(), atol=2e-4)


# -- sLSTM --------------------------------------------------------------------

def test_slstm_cell_matches():
    jc, tc = _pair()
    jp, tp = _params(JX.init_slstm, jc, 6, jitter=0.05)
    rng = np.random.default_rng(6)
    B, H, dh = 2, 4, 16
    pre = _rand(rng, B, 4, H, dh)
    st = (_rand(rng, B, H, dh), np.abs(_rand(rng, B, H, dh)) + 0.5,
          _rand(rng, B, H, dh), _rand(rng, B, H, dh))
    got = TX._slstm_cell(tp, tc, _t(pre), tuple(map(_t, st)))
    want = jax.jit(lambda p, a, s: JX._slstm_cell(p, jc, a, s))(jp, pre, st)
    for a, b in zip(got, want):
        _close(a, b)


def test_slstm_forward_and_grads_match():
    jc, tc = _pair()
    jp, tp = _params(JX.init_slstm, jc, 7, jitter=0.05)
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 7, 64)
    _close(TX.slstm_forward(tp, tc, _t(x)),
           jax.jit(lambda p, u: JX.slstm_forward(p, jc, u))(jp, x))
    _grads_match(lambda p, u: JX.slstm_forward(p, jc, u),
                 lambda p, u: TX.slstm_forward(p, tc, u), jp, x,
                 _rand(rng, 2, 7, 64))


def test_slstm_gelu_is_the_tanh_approximation():
    """jax.nn.gelu's default; PyTorch's default (erf) is 1e-4 off at 1."""
    x = np.linspace(-4, 4, 81).astype(np.float32)
    want = _np(jax.nn.gelu(x))
    got = torch.nn.functional.gelu(_t(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(torch.nn.functional.gelu(_t(x)).numpy() - want).max() \
        > 1e-4


def test_slstm_decode_loop_matches():
    jc, tc = _pair()
    jp, tp = _params(JX.init_slstm, jc, 8, jitter=0.05)
    B, S = 2, 7
    x = _rand(np.random.default_rng(8), B, S, 64)
    jcache = JX.init_slstm_cache(jc, B, jnp.float32)
    tcache = TX.init_slstm_cache(tc, B, torch.float32)
    jstep = jax.jit(lambda p, u, c: JX.slstm_decode(p, jc, u, c))
    outs = []
    for t in range(S):
        ya, tcache = TX.slstm_decode(tp, tc, _t(x[:, t:t + 1]), tcache)
        yb, jcache = jstep(jp, x[:, t:t + 1], jcache)
        _close(ya, yb)
        outs.append(ya)
    _close_tree(tcache, jcache)
    np.testing.assert_allclose(
        torch.cat(outs, 1).numpy(),
        TX.slstm_forward(tp, tc, _t(x)).numpy(), atol=2e-4)
