"""The Zamba2 hybrid slice of the port's LM plane against the
reference's, on the CPU, on the reduced zamba2-7b (one site of 2 Mamba2
layers, the shared attention+MLP block with the site's rank-8 LoRA, one
tail Mamba2 layer; d_model 256, SSM heads of 32, state 16, chunk 16):
``init_lm`` at float32 and bfloat16 (the float32 ``A_log`` / ``D`` /
``dt_bias`` leaves of a bfloat16 model), ``_shared_block_params`` and
``_apply_shared_block``, ``lm_forward`` (with the LoRA B matrices at
their zero init and non-zero), the train step and ``quantize_grads``,
then ``FedLLMTrainer`` over the 8-round schedule of
``tests/test_llm_equivalence.py``, checkpoints crossing packages both
ways, and the train CLI. xLSTM is ``tests/test_torch_lm_ssm.py``.

Sequences are 24 tokens: the SSD runs two chunks of 16, the second
padded. LoRA's ``qb``, ``ob`` and ``cb`` start at zero, which hides a
wrong LoRA product at init, so the shared block, the forward and the
train step are held with non-zero B matrices too. Both packages start
from the reference trainer's initial model, carried through
``repro_torch.convert``; tokens come from a numpy seed. The reference
runs its ``legacy`` engine and its ``init_lm`` under ``jax.jit``. Bars
(float32): leaf names, shapes and dtypes equal; the per-site weights to
1e-6; the shared block (full sequence, a padded prefill chunk and a
decode step against its KV cache; the cache's floats to 1e-6 of their
largest magnitude, ``index`` and ``pos`` exact), logits and the final hidden state to 1e-5; one
train step's loss to 1e-5 and every updated leaf to 1e-6;
``quantize_grads`` of one gradient tree to rtol 1e-6 of the reference's,
in one group call of its 31 leaves (one launch of each kernel on the
card). The trainer: discrete state exact, score history 1e-6, params
1e-5; ``legacy`` and ``llm+pipeline`` bit-identical to ``llm``. The
bfloat16 forward (both packages on the CPU) holds the logit and argmax
bars of ``tests/test_torch_lm_models.py``'s bfloat16 tier; its hidden
state is held to the float32 forward, no further off than 1.5x the
reference's own bfloat16 error (|h| reaches ~3 here, where a bf16 ulp
is 1.6e-2).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.config import FedCDConfig as JFed  # noqa: E402
from repro.core.spec import EngineSpec as JSpec  # noqa: E402
from repro.federated import llm as jllm  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import FedCDConfig  # noqa: E402
from repro_torch.convert import (caches_from_jax, params_from_jax,  # noqa: E402
                                 params_to_numpy)
from repro_torch.core.spec import EngineSpec  # noqa: E402
from repro_torch.federated.llm import FedLLMTrainer  # noqa: E402
from repro_torch.kernels import group  # noqa: E402
from repro_torch.kernels.quantize import ops as tqops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

NAME = "zamba2-7b"
FK = dict(n_devices=4, devices_per_round=3, score_window=2,
          milestones=(2, 5), late_delete_round=6, max_models=6, lr=0.05,
          seed=0)
N_CLIENTS, PER, SEQ = 4, 2, 24
ROUNDS = 8
SCORES = np.array([0.4, 0.1, 0.3, 0.2], np.float32)
FLOAT32_LEAVES = {f"{g}.core.{k}" for g in ("mamba_groups", "mamba_tail")
                  for k in ("A_log", "D", "dt_bias")}
TRANSPORT_LEAVES = 31
LORA_B = ("lora.qb", "lora.ob", "lora.cb")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    j = jconfig.override(jconfigs.reduced(jconfigs.get_arch(NAME)), **kw)
    t = tconfig.override(tconfigs.reduced(tconfigs.get_arch(NAME)), **kw)
    return j, t


JCFG, TCFG = _pair()
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
# the reference's functions, compiled once a config and shape
_ref_init = jax.jit(jtf.init_lm, static_argnums=0)
_ref_forward = jax.jit(jtf.lm_forward, static_argnums=0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _data(seed):
    toks = np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (N_CLIENTS * PER, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _ref_trainer(cfg, spec):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm.tf, "init_lm", _ref_init)
        return jllm.FedLLMTrainer(cfg, JFed(**FK), N_CLIENTS, PER, SEQ,
                                  n_archetypes=2, seed=0, spec=spec)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's ``legacy`` run over 8 rounds, checkpointing every
    4 rounds; its initial model (numpy)."""
    root = str(tmp_path_factory.mktemp("ref") / "ck")
    tr = _ref_trainer(JCFG, JSpec(engine="legacy", save_every=4,
                                  checkpoint_dir=root))
    init = jax.tree.map(lambda a: np.array(a, copy=True),
                        tr.registry.params[0])
    tr.run(ROUNDS)
    return tr, init, root


# -- init_lm -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_names_shapes_dtypes(dtype):
    jc, tc = _pair(param_dtype=dtype, compute_dtype=dtype)
    shapes = jax.eval_shape(lambda: jtf.init_lm(jc, jax.random.PRNGKey(0)))
    ref = _port(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    mine = ttf.init_lm(tc, torch.Generator().manual_seed(0))
    assert list(mine) == list(ref)
    for k, v in ref.items():
        assert (tuple(mine[k].shape), mine[k].dtype) == \
            (tuple(v.shape), v.dtype), k
        assert ttf.param_dtype(tc, k) == v.dtype, k
    assert {k for k, v in ref.items() if v.dtype == torch.float32} == \
        (set(ref) if dtype == "float32" else FLOAT32_LEAVES)
    assert sum(v.numel() >= 128 for v in mine.values()) == TRANSPORT_LEAVES


def test_bf16_tree_keeps_float32_leaves_through_trainer_and_checkpoint(
        tmp_path):
    """The float32 leaves of a bfloat16 model cross both ways, are
    adopted by the trainer in their own dtype, stay so in the bank as it
    trains, and come back so from a checkpoint."""
    jc, tc = _pair(**BF16)
    jp = _ref_init(jc, jax.random.PRNGKey(1))
    tp = _port(jp)
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32), b)
    root = str(tmp_path / "ck")
    tr = FedLLMTrainer(tc, FedCDConfig(**FK), N_CLIENTS, PER, SEQ,
                       device="cpu", init_params=back,
                       spec=EngineSpec(engine="llm", save_every=3,
                                       checkpoint_dir=root))
    for k, v in tp.items():
        assert torch.equal(tr.registry.params[0][k], v), k
    tr.run(3)
    res = FedLLMTrainer(tc, FedCDConfig(**FK), N_CLIENTS, PER, SEQ,
                        device="cpu", init_params=back,
                        spec=EngineSpec(engine="llm", resume_from=root))
    assert len(res.metrics) == 3
    for m in tr.registry.live_ids():
        for k, v in tp.items():
            for t in (tr, res):
                assert t.registry.params[m][k].dtype == v.dtype, k
            assert torch.equal(res.registry.params[m][k],
                               tr.registry.params[m][k]), k


# -- the shared block and its LoRA ------------------------------------------

def _with_lora_b(jp, seed):
    """``jp`` with its LoRA B matrices drawn non-zero (numpy seed)."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: np.array(a, copy=True), jp)
    for k in ("qb", "ob", "cb"):
        a = jp["lora"][k]
        jp["lora"][k] = (0.02 * rng.normal(size=a.shape)).astype(a.dtype)
    return jp


def test_shared_block_with_lora_matches(ref):
    from repro_torch.models.common import subtree
    jp = _with_lora_b(ref[1], 4)
    tp = _port(jp)
    site = jax.tree.map(lambda a: a[0], jp["lora"])
    want = _port(jtf._shared_block_params(jp["shared"], site))
    got = ttf._shared_block_params(subtree(tp, "shared"),
                                   {k: v[0] for k, v in
                                    subtree(tp, "lora").items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, err_msg=k)
    assert not torch.equal(got["attn.wq"], tp["shared.attn.wq"])
    rng = np.random.default_rng(5)
    x, x0 = (rng.normal(size=(2, SEQ, JCFG.d_model)).astype(np.float32)
             for _ in range(2))
    pos = np.arange(SEQ, dtype=np.int32)
    ya, _ = jax.jit(lambda p, a, b: jtf._apply_shared_block(
        p, JCFG, a, b, pos))(jtf._shared_block_params(jp["shared"], site),
                             x, x0)
    yb, cache = ttf._apply_shared_block(got, TCFG, _t(x), _t(x0), _t(pos))
    assert cache is None
    np.testing.assert_allclose(yb.numpy(), np.asarray(ya), atol=1e-5)
    # the cache branches: a padded prefill chunk, then one decode step
    sp = jtf._shared_block_params(jp["shared"], site)
    cache0 = jattn.init_kv_cache(JCFG, 2, 2 * SEQ, np.float32)
    ya, ca = jax.jit(lambda p, a, b, c: jtf._apply_shared_block(
        p, JCFG, a, b, None, cache=c, prefill=True, n_valid=SEQ - 5))(
        sp, x, x0, cache0)
    yb, cb = ttf._apply_shared_block(
        got, TCFG, _t(x), _t(x0), None, prefill=True, n_valid=SEQ - 5,
        cache=caches_from_jax(jax.tree.map(np.asarray, cache0)))
    np.testing.assert_allclose(yb[:, :SEQ - 5].numpy(),
                               np.asarray(ya)[:, :SEQ - 5], atol=1e-5)
    ya, ca = jax.jit(lambda p, a, b, c: jtf._apply_shared_block(
        p, JCFG, a, b, None, cache=c))(sp, x[:, :1], x0[:, :1], ca)
    yb, cb = ttf._apply_shared_block(got, TCFG, _t(x[:, :1]),
                                     _t(x0[:, :1]), None, cache=cb)
    np.testing.assert_allclose(yb.numpy(), np.asarray(ya), atol=1e-5)
    want = caches_from_jax(jax.tree.map(np.asarray, ca))
    assert list(cb) == list(want)
    for k in ("index", "pos"):
        assert torch.equal(cb[k], want[k]), k
    for k in ("k", "v"):
        scale = max(1.0, float(want[k].abs().max()))
        np.testing.assert_allclose(cb[k].numpy(), want[k].numpy(),
                                   atol=1e-6 * scale, err_msg=k)


# -- forward and the train step ----------------------------------------------

@pytest.mark.parametrize("lora_b", ["zero", "nonzero"])
def test_lm_forward_matches(ref, lora_b):
    jp = ref[1] if lora_b == "zero" else _with_lora_b(ref[1], 6)
    tokens, _ = _data(1)
    la, ha, aa = _ref_forward(JCFG, jp, tokens)
    lb, hb, ab = ttf.lm_forward(TCFG, _port(jp), _t(tokens))
    np.testing.assert_allclose(lb.numpy(), np.asarray(la), atol=1e-5)
    np.testing.assert_allclose(hb.numpy(), np.asarray(ha), atol=1e-5)
    assert float(ab) == float(aa) == 0.0


def test_lm_forward_bf16_tier():
    """Logits to 3e-2 and the argmax on 95% of positions, as the dense
    bfloat16 tier; the final hidden state (|h| up to ~3 in the hybrid,
    where a bf16 ulp is 1.6e-2) no further from the float32 forward of
    the same params than 1.5x the reference's own bfloat16 error."""
    jc, tc = _pair(**BF16)
    jp = _ref_init(jc, jax.random.PRNGKey(2))
    toks, _ = _data(8)
    la, ha, _ = _ref_forward(jc, jp, toks)
    _, h32, _ = _ref_forward(
        JCFG, jax.tree.map(lambda a: a.astype(jnp.float32), jp), toks)
    lb, hb, _ = ttf.lm_forward(tc, _port(jp), _t(toks))
    assert lb.dtype == torch.float32 and hb.dtype == torch.bfloat16
    np.testing.assert_allclose(lb.numpy(), np.asarray(la), atol=3e-2)
    assert (lb.numpy().argmax(-1) == np.asarray(la).argmax(-1)).mean() \
        >= 0.95
    h32 = np.asarray(h32)
    ref_err = np.abs(np.asarray(ha).astype(np.float32) - h32).max()
    assert np.abs(hb.float().numpy() - h32).max() <= 1.5 * ref_err


def test_train_step_matches_reference(ref):
    """One step from non-zero LoRA B matrices: loss and every updated
    leaf; ``remat=True`` bit-equal to ``remat=False`` (the hybrid path
    takes no remat, as the reference's)."""
    jp = _with_lora_b(ref[1], 7)
    tokens, labels = _data(2)
    jp2, jm = jax.jit(JS.make_train_step(JCFG, lr=0.05, remat=False))(
        jp, tokens, labels, SCORES, None)
    (pa, ma), (pb, mb) = [TS.make_train_step(TCFG, lr=0.05, remat=r)(
        _port(jp), _t(tokens), _t(labels), _t(SCORES))
        for r in (False, True)]
    np.testing.assert_allclose(float(ma["loss"]), float(jm["loss"]),
                               atol=1e-5)
    want = _port(jp2)
    assert list(pa) == list(want)
    for k in want:
        assert pa[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(pa[k].numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    assert float(ma["loss"]) == float(mb["loss"])
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def _within_transport_bar(got, want, grad, name):
    """The bar of ``tests/test_kernels.py:24-30`` on dequantized values:
    equal (rtol 1e-6) but on fewer than 1e-3 of the elements, where the
    codes differ by one step (at most the largest block scale)."""
    off = ~np.isclose(got, want, rtol=1e-6, atol=0)
    assert off.mean() < 1e-3, name
    step = np.abs(grad).max() / 127
    assert np.all(np.abs(got - want)[off] <= step * (1 + 1e-6)), name


def test_quantize_grads_matches_reference(monkeypatch, ref):
    """The port's gradient tree (a stacked leaf as its per-layer parts)
    through both packages' ``quantize_grads``, in one group call."""
    tokens, labels = _data(3)
    leaves = TS._grad_leaves(_port(ref[1]))
    row_w = TS.client_weights_per_row(_t(SCORES), N_CLIENTS * PER)
    total, _ = TS._lm_loss(TCFG, leaves, _t(tokens), _t(labels), row_w,
                           remat=False)
    grads = TS._unflat(leaves, torch.autograd.grad(total, TS._flat(leaves)))
    calls = []
    real = tqops.quantize_group

    def q(xs, bits=8):
        calls.append([x.shape[1] for x in xs])
        return real(xs, bits)

    monkeypatch.setattr(tqops, "quantize_group", q)
    out = TS.quantize_grads(grads, bits=8)
    stacked = {k: torch.stack(v) if isinstance(v, list) else v
               for k, v in grads.items()}
    want = _port(jax.jit(JS.quantize_grads)(
        {k: jnp.asarray(v.numpy()) for k, v in stacked.items()}))
    for k, v in out.items():
        got = torch.stack(v) if isinstance(v, list) else v
        assert got.dtype == want[k].dtype, k
        _within_transport_bar(got.numpy(), want[k].numpy(),
                              stacked[k].numpy(), k)
    assert len(calls) == 1 and len(calls[0]) == TRANSPORT_LEAVES
    assert len(group.launch_groups(calls[0], 32)) == 1


# -- the trainer ---------------------------------------------------------------

def _run(init, spec="llm", rounds=ROUNDS):
    tr = FedLLMTrainer(TCFG, FedCDConfig(**FK), N_CLIENTS, PER, SEQ,
                       n_archetypes=2, seed=0, spec=spec, device="cpu",
                       init_params=init)
    tr.run(rounds)
    return tr


@pytest.fixture(scope="module")
def port_llm(ref):
    return _run(ref[1], "llm")


def _leaves(tr, m):
    p = tr.registry.params[m]
    if all(isinstance(v, torch.Tensor) for v in p.values()):
        p = params_to_numpy(p)
    return [np.asarray(x) for x in jax.tree.leaves(p)]


def _assert_discrete_state_equal(a, b):
    assert np.array_equal(a.state.active, b.state.active)
    assert np.array_equal(a.state.alive, b.state.alive)
    assert a.registry.live_ids() == b.registry.live_ids()
    assert {m: (e.parent, e.birth_round, e.alive)
            for m, e in a.registry.entries.items()} == \
           {m: (e.parent, e.birth_round, e.alive)
            for m, e in b.registry.entries.items()}
    assert [m.trained_models for m in a.metrics] == \
           [m.trained_models for m in b.metrics]
    assert [m.live_models for m in a.metrics] == \
           [m.live_models for m in b.metrics]
    np.testing.assert_allclose(a.state.history, b.state.history,
                               atol=1e-6, equal_nan=True)


def _assert_params(a, b, atol):
    for m in a.registry.live_ids():
        for x, y in zip(_leaves(a, m), _leaves(b, m)):
            if atol == 0:
                assert np.array_equal(x, y)
            else:
                np.testing.assert_allclose(x, y, atol=atol, rtol=1e-6)


@pytest.mark.parametrize("spec", ["llm", "legacy"])
def test_trainer_matches_reference(ref, port_llm, spec):
    jtr = ref[0]
    tr = port_llm if spec == "llm" else _run(ref[1], spec)
    assert len(tr.registry.entries) > 1
    assert not all(e.alive for e in tr.registry.entries.values())
    _assert_discrete_state_equal(jtr, tr)
    _assert_params(jtr, tr, atol=1e-5)
    for ma, mb in zip(jtr.metrics, tr.metrics):
        np.testing.assert_allclose(ma.client_acc, mb.client_acc, atol=1e-6)
        assert np.isclose(ma.mean_loss, mb.mean_loss, atol=1e-5,
                          equal_nan=True)
    if spec == "legacy":
        _assert_params(port_llm, tr, atol=0)


def test_pipelined_bit_identical(ref, port_llm):
    b = _run(ref[1], "llm+pipeline")
    _assert_discrete_state_equal(port_llm, b)
    _assert_params(port_llm, b, atol=0)


def test_reference_checkpoint_resumes_in_the_port(ref):
    jtr, init, root = ref
    tr = _run(init, EngineSpec(engine="llm", resume_from=os.path.join(
        root, "step_000004")), rounds=4)
    assert len(tr.metrics) == 4
    tr.run(ROUNDS)
    _assert_discrete_state_equal(jtr, tr)
    _assert_params(jtr, tr, atol=1e-5)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, ref, port_llm):
    """A port checkpoint at round 7, written by the port's ``legacy``
    engine (the reference restores a stacked bank only into its ``llm``
    engine), restored by the reference's ``legacy`` trainer and run to
    round 8, equals the port's own 8 rounds. The reference trainer is
    the fixture's (its steps are compiled), put back to its own round-8
    state afterwards."""
    jtr = ref[0]
    own = jtr.save(str(tmp_path / "own"))
    root = str(tmp_path / "ck")
    _run(ref[1], EngineSpec(engine="legacy", save_every=7,
                            checkpoint_dir=root), rounds=7)
    try:
        assert jtr.restore(root) == 7
        jtr.run(ROUNDS)
        _assert_discrete_state_equal(port_llm, jtr)
        _assert_params(port_llm, jtr, atol=1e-5)
    finally:
        assert jtr.restore(own) == ROUNDS


def test_train_cli_runs_zamba2_on_cpu(tmp_path, monkeypatch):
    from repro_torch.launch import train
    out = str(tmp_path / "run")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train.main(["--arch", NAME, "--rounds", "2", "--device", "cpu", "--out",
                out])
    with open(os.path.join(out, "history.json")) as f:
        hist = json.load(f)
    assert [h["round"] for h in hist] == [1, 2]
    assert np.isfinite(hist[0]["loss"])
    assert os.path.exists(os.path.join(out, "model_0.npz"))
