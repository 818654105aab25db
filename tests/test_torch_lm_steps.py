"""The port's mode-B round steps (``repro_torch.launch.steps``) against the
reference's, on the CPU: every case of ``tests/test_federated_llm.py``
through both packages, ``remat=True`` against ``remat=False``, and
``quantize_grads`` against the reference's.

The tiny LM of ``tests/test_federated_llm.py`` (float32); params are the
reference's ``init_lm`` output through ``repro_torch.convert``; tokens
from a numpy seed. Bars: one train step's params to 1e-6 of the
reference's (1e-5 after 8 steps; the per-step losses to 1e-5); eval and
gradients to 1e-6 (the eq-1 identity to the reference's 1e-4 relative);
``remat`` bit-equal; the int8 transport at the kernel bar of
``tests/test_kernels.py``: codes within one step of the reference's on
fewer than 1e-3 of the elements, scales to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import ArchConfig as JArch  # noqa: E402
from repro.kernels.quantize import ref as jqref  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.config import ArchConfig as TArch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.quantize import ops as tqops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

KW = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab_size=64, param_dtype="float32",
          compute_dtype="float32")
JCFG, TCFG = JArch(**KW), TArch(**KW)
N_CLIENTS, PER, SEQ = 4, 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_params(seed):
    return jtf.init_lm(JCFG, jax.random.PRNGKey(seed))


def _port(params):
    return params_from_jax(jax.tree.map(np.asarray, params))


def _data(seed):
    toks = np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (N_CLIENTS * PER, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, atol):
    ref = _port(ref)
    assert list(port) == list(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].detach().numpy(),
                                   ref[k].numpy(), atol=atol, rtol=1e-6,
                                   err_msg=k)


def _copy(p):
    return {k: v.clone() for k, v in p.items()}


def _nll_rows(params, tokens, labels):
    logits, _, _ = ttf.lm_forward(TCFG, params, tokens)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean(dim=-1)


def test_weighted_loss_equals_weighted_gradient_average():
    """The mode-B identity (grad of Σ c_i L_i / Σ c_i == eq 1 over
    per-client grads), on the port; and the port's weighted-loss gradient
    equals the reference's."""
    p = _port(_ref_params(0))
    tokens, labels = _data(1)
    tok, lab = _t(tokens), _t(labels)
    scores = torch.tensor([0.1, 0.5, 0.2, 0.2])
    names = list(p)

    def grads_of(loss_fn):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        return torch.autograd.grad(loss_fn(leaves), list(leaves.values()))

    per_client = [grads_of(lambda q, c=c: _nll_rows(
        q, tok[c * PER:(c + 1) * PER], lab[c * PER:(c + 1) * PER]).mean())
        for c in range(N_CLIENTS)]
    denom = float(scores.sum())
    eq1 = [sum(float(scores[i]) * g[j] for i, g in enumerate(per_client))
           / denom for j in range(len(names))]
    row_w = TS.client_weights_per_row(scores, N_CLIENTS * PER)
    gw = grads_of(lambda q: torch.sum(_nll_rows(q, tok, lab) * row_w))
    for a, b in zip(eq1, gw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)

    jp = _ref_params(0)
    jrow = JS.client_weights_per_row(jnp.asarray(scores.numpy()),
                                     N_CLIENTS * PER)
    np.testing.assert_allclose(row_w.numpy(), np.asarray(jrow), rtol=1e-7)

    @jax.jit
    def jgrad(params):
        def weighted(q):
            logits, _, _ = jtf.lm_forward(JCFG, q, jnp.asarray(tokens))
            logz = jax.nn.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, jnp.asarray(labels)[..., None],
                                       -1)[..., 0]
            return jnp.sum((logz - gold).mean(axis=-1) * jrow)
        return jax.grad(weighted)(params)

    ref = _port(jgrad(jp))
    for k, g in zip(names, gw):
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


def test_train_step_reduces_weighted_loss():
    jp = _ref_params(2)
    p = _port(jp)
    tokens, labels = _data(3)
    scores = np.ones(N_CLIENTS, np.float32) / N_CLIENTS
    step = TS.make_train_step(TCFG, lr=0.1, remat=False)
    jstep = jax.jit(JS.make_train_step(JCFG, lr=0.1, remat=False))
    losses, jlosses = [], []
    for _ in range(8):
        p, m = step(p, _t(tokens), _t(labels), _t(scores))
        jp, jm = jstep(jp, tokens, labels, scores, None)
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5)
    _close(p, jp, atol=1e-5)


def test_microbatched_step_matches_single_batch():
    jp = _ref_params(4)
    tokens, labels = _data(5)
    scores = np.array([0.4, 0.1, 0.3, 0.2], np.float32)
    p1, m1 = TS.make_train_step(TCFG, lr=0.05, remat=False)(
        _port(jp), _t(tokens), _t(labels), _t(scores))
    p2, m2 = TS.make_train_step(TCFG, lr=0.05, remat=False,
                                microbatches=2)(
        _port(jp), _t(tokens), _t(labels), _t(scores))
    for k in p1:
        np.testing.assert_allclose(p1[k].numpy(), p2[k].numpy(), atol=2e-5)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               atol=1e-6)
    jp1, _ = jax.jit(JS.make_train_step(JCFG, lr=0.05, remat=False))(
        jp, tokens, labels, scores, None)
    _close(p1, jp1, atol=1e-6)


def test_eval_step_returns_per_client_losses():
    jp = _ref_params(6)
    tokens, labels = _data(7)
    out = TS.make_eval_step(TCFG, N_CLIENTS)(_port(jp), _t(tokens),
                                             _t(labels))
    assert out.shape == (N_CLIENTS,)
    assert bool(torch.isfinite(out).all())
    ref = JS.make_eval_step(JCFG, N_CLIENTS)(jp, tokens, labels)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def test_mode_b_round_with_population_loop():
    """Host-level loop over 2 global models with per-model client scores
    (DESIGN.md §3 mode B), on the port; each model's step equals the
    reference's."""
    jm0 = _ref_params(8)
    jm1 = jax.tree.map(lambda a: a + 0.01, jm0)
    tokens, labels = _data(9)
    c = np.array([[0.7, 0.1, 0.6, 0.2], [0.3, 0.9, 0.4, 0.8]], np.float32)
    step = TS.make_train_step(TCFG, lr=0.05, remat=False)
    ev = TS.make_eval_step(TCFG, N_CLIENTS)
    jstep = jax.jit(JS.make_train_step(JCFG, lr=0.05, remat=False))
    new_pop, val = [], []
    for m, jparams in enumerate((jm0, jm1)):
        p2, _ = step(_port(jparams), _t(tokens), _t(labels), _t(c[m]))
        new_pop.append(p2)
        val.append(ev(p2, _t(tokens), _t(labels)))
        jp2, _ = jstep(jparams, tokens, labels, c[m], None)
        _close(p2, jp2, atol=1e-6)
    assert all(v.shape == (N_CLIENTS,) for v in val)
    diff = sum(float(torch.sum(torch.abs(new_pop[0][k] - new_pop[1][k])))
               for k in new_pop[0])
    assert diff > 0


def test_int8_grad_transport_still_trains():
    """Paper §3.4 on the aggregation payload, on the port; and the
    quantized step stays within the transport bar of the reference's."""
    jp = _ref_params(10)
    tokens, labels = _data(11)
    scores = np.ones(N_CLIENTS, np.float32) / N_CLIENTS
    step = TS.make_train_step(TCFG, lr=0.1, remat=False,
                              grad_transport_bits=8)
    p = _port(jp)
    losses = []
    for _ in range(8):
        p, m = step(p, _t(tokens), _t(labels), _t(scores))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    exact = TS.make_train_step(TCFG, lr=0.1, remat=False)
    pe, _ = exact(_port(jp), _t(tokens), _t(labels), _t(scores))
    pq, _ = step(_port(jp), _t(tokens), _t(labels), _t(scores))
    num = sum(float(torch.sum(torch.abs(pe[k] - pq[k]))) for k in pe)
    den = sum(float(torch.sum(torch.abs(pe[k]))) for k in pe)
    assert num / den < 0.01
    jq, _ = jax.jit(JS.make_train_step(JCFG, lr=0.1, remat=False,
                                       grad_transport_bits=8))(
        jp, tokens, labels, scores, None)
    # one int8 step of a block is at most scale = max|g| / 127 of it,
    # times lr in the params
    _close(pq, jq, atol=1e-5)


def test_remat_equals_no_remat():
    jp = _ref_params(12)
    tokens, labels = _data(13)
    scores = np.array([0.4, 0.1, 0.3, 0.2], np.float32)
    outs = [TS.make_train_step(TCFG, lr=0.05, remat=r)(
        _port(jp), _t(tokens), _t(labels), _t(scores)) for r in (False, True)]
    (pa, ma), (pb, mb) = outs
    assert float(ma["loss"]) == float(mb["loss"])
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def _grad_tree(seed):
    """A gradient-shaped tree: a stacked leaf as per-layer parts, a
    plain leaf, a leaf under 128 values and a scalar."""
    rng = np.random.default_rng(seed)
    stacked = rng.normal(0, 1e-3, (3, 40, 7)).astype(np.float32)
    plain = rng.normal(0, 1, (300, 5)).astype(np.float32)
    small = rng.normal(0, 1, (127,)).astype(np.float32)
    scalar = np.float32(rng.normal())
    ref = {"a": stacked, "b": plain, "c": small, "d": scalar}
    port = {"a": [_t(x) for x in stacked], "b": _t(plain), "c": _t(small),
            "d": torch.tensor(scalar)}
    return ref, port


def test_quantize_grads_matches_reference():
    ref, port = _grad_tree(14)
    out = TS.quantize_grads(port, bits=8)
    jout = JS.quantize_grads({k: jnp.asarray(v) for k, v in ref.items()},
                             bits=8)
    # under 128 values and scalars pass through unchanged
    assert out["c"] is port["c"] and out["d"] is port["d"]
    got = {"a": torch.stack(out["a"]).numpy(), "b": out["b"].numpy()}
    for k in ("a", "b"):
        np.testing.assert_allclose(got[k], np.asarray(jout[k]), atol=0,
                                   rtol=1e-6)
        # the codes and scales at the transport bar
        row = ref[k].reshape(1, -1)
        jq, js = jqref.quantize_ref(jnp.asarray(row), bits=8)
        tq, ts = tqops.quantize(torch.from_numpy(row), 8)
        off = np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int))
        assert off.max() <= 1 and (off > 0).mean() < 1e-3
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_quantize_grads_is_one_group_call(monkeypatch):
    """Every leaf of 128 values or more goes through ONE quantize_group
    and ONE dequantize_group call (on the card: one launch of each)."""
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
    _, port = _grad_tree(15)
    TS.quantize_grads(port, bits=8)
    assert calls == {"q": [[(1, 840), (1, 1500)]], "dq": 1}


def test_steps_refuse_what_is_not_ported():
    """Every step builder takes a mesh: the train and eval steps since
    ROADMAP item 13b.4, the prefill and serve steps since item 15b.1
    (their bars are in ``tests/test_torch_lm_mesh.py`` and
    ``test_torch_lm_mesh_decode.py``). Here: the prefill and serve steps
    on ``model=2`` equal the one-device steps, on the ``train`` and the
    ``decode_2d`` layouts; the audio serve step on a mesh runs on
    the params gathered whole. The audio train step on reduced
    whisper-small moves the reference's way (the parity bars are in
    ``tests/test_torch_encdec.py``)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.tensor_parallel import Sharded
    from repro_torch.models import encdec as ted
    mesh = make_host_mesh(model=2)
    TS.make_train_step(TCFG, mesh=object())
    TS.make_eval_step(TCFG, N_CLIENTS, mesh=object())
    p = ttf.init_lm(TCFG, torch.Generator().manual_seed(0))
    tok = torch.arange(10, dtype=torch.long).reshape(2, 5) * 3
    outs = []
    for m in (mesh, None):
        c = ttf.init_lm_caches(TCFG, 2, 8)
        last, c = TS.make_prefill_step(TCFG, mesh=m)(p, c, tok, 4)
        lg, c = TS.make_serve_step(TCFG, mesh=m)(p, c, tok[:, 4:])
        outs.append((last, lg))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    d2 = {k: Sharded.place(p[k], mesh, v.spec)
          for k, v in param_shardings(TCFG, p, mesh,
                                      policy="decode_2d").items()}
    c = ttf.init_lm_caches(TCFG, 2, 8)
    last, c = TS.make_prefill_step(TCFG, mesh=mesh)(d2, c, tok, 4)
    lg, c = TS.make_serve_step(TCFG, mesh=mesh)(d2, c, tok[:, 4:])
    for a, b in zip((last, lg), outs[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    from repro.models import encdec as jed
    jc = jconfigs.reduced(jconfigs.get_arch("whisper-small"))
    tc = tconfigs.reduced(tconfigs.get_arch("whisper-small"))
    jp = jax.jit(lambda k: jed.init_encdec(jc, k))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(20)
    frames = rng.normal(size=(4, 24, 256)).astype(np.float32)
    toks = rng.integers(0, 512, (4, 3)).astype(np.int32)
    scores = np.array([0.25, 0.75], np.float32)
    jq, jm = jax.jit(JS.make_train_step(jc, lr=0.05, remat=False))(
        jp, toks[:, :-1], toks[:, 1:], scores, frames)
    tq, tm = TS.make_train_step(tc, lr=0.05)(
        _port(jp), _t(toks[:, :-1]).long(), _t(toks[:, 1:]).long(),
        _t(scores), frames=_t(frames))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=1e-5)
    _close(tq, jq, atol=1e-6)
    sp = {k: Sharded.place(v, mesh, s.spec)
          for (k, v), s in zip(tq.items(),
                               param_shardings(tc, tq, mesh).values())}
    caches = ted.init_encdec_caches(tc, tq, _t(frames), 8)
    got = TS.make_serve_step(tc, mesh=mesh)(sp, caches, _t(toks[:, :1]).long())
    want = TS.make_serve_step(tc)(tq, caches, _t(toks[:, :1]).long())
    assert torch.equal(got[0], want[0])
