"""The MLA slice of the port's LM plane against the reference's, on the
CPU, on the reduced DeepSeek-V3 (one dense MLA layer, one MLA + MoE
layer with a shared expert, 4 experts top-2, and the MTP head):
``lm_forward``, ``mtp_logits``, the train step with its MTP loss and
``quantize_grads``, then ``FedLLMTrainer`` over 3 rounds of the schedule
of ``tests/test_llm_equivalence.py`` (a clone at milestone 2, trained in
round 3), checkpoints crossing packages both ways, and the train CLI.

Both packages start from the reference trainer's initial model, carried
through ``repro_torch.convert``; tokens come from a numpy seed. The
reference runs its ``legacy`` engine (per-model steps compiled once;
its ``llm`` engine compiles a round per count of training rows, and the
reference holds the two equal) and its ``init_lm`` under ``jax.jit``
(the test patches the name its trainer calls). Bars (float32): logits,
the final hidden state and the MTP logits to 1e-5, the aux loss to 1e-6;
one train step's loss to 1e-5 and every updated leaf (the 19 ``mtp.*``
leaves among them) to 1e-6; ``remat`` bit-equal; ``quantize_grads`` of
one gradient tree to rtol 1e-6 of the reference's, in one group call of
its 46 leaves, which makes 2 launches of each kernel on the card (32
leaves a launch). The trainer: discrete state exact, score history 1e-6,
params 1e-5; ``legacy`` and ``llm+pipeline`` bit-identical to ``llm``.
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
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import FedCDConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core.spec import EngineSpec  # noqa: E402
from repro_torch.federated.llm import FedLLMTrainer  # noqa: E402
from repro_torch.kernels import group  # noqa: E402
from repro_torch.kernels.quantize import ops as tqops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

DSV3 = "deepseek-v3-671b"
FK = dict(n_devices=4, devices_per_round=3, score_window=2,
          milestones=(2, 5), late_delete_round=6, max_models=6, lr=0.05,
          seed=0)
N_CLIENTS, PER, SEQ = 4, 2, 16
ROUNDS = 3
SCORES = np.array([0.4, 0.1, 0.3, 0.2], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, **kw):
    j = jconfig.override(jconfigs.reduced(jconfigs.get_arch(name)), **kw)
    t = tconfig.override(tconfigs.reduced(tconfigs.get_arch(name)), **kw)
    return j, t


JCFG, TCFG = _pair(DSV3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _data(seed):
    toks = np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (N_CLIENTS * PER, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's ``legacy`` run over 3 rounds, checkpointing every
    2 rounds; its initial model (numpy)."""
    root = str(tmp_path_factory.mktemp("ref") / "ck")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm.tf, "init_lm", jax.jit(jtf.init_lm,
                                               static_argnums=0))
        tr = jllm.FedLLMTrainer(JCFG, JFed(**FK), N_CLIENTS, PER, SEQ,
                                n_archetypes=2, seed=0,
                                spec=JSpec(engine="legacy", save_every=2,
                                           checkpoint_dir=root))
    init = jax.tree.map(lambda a: np.array(a, copy=True),
                        tr.registry.params[0])
    tr.run(ROUNDS)
    return tr, init, root


# -- forward and the train step ----------------------------------------------

def test_lm_forward_and_mtp_logits_match(ref):
    jp = ref[1]
    tokens, labels = _data(1)

    @jax.jit
    def fwd(p, tok, lab):
        logits, hidden, aux = jtf.lm_forward(JCFG, p, tok)
        return logits, hidden, aux, jtf.mtp_logits(JCFG, p, hidden, lab)

    la, ha, aa, ma = fwd(jp, tokens, labels)
    tp = _port(jp)
    lb, hb, ab = ttf.lm_forward(TCFG, tp, _t(tokens))
    np.testing.assert_allclose(lb.numpy(), np.asarray(la), atol=1e-5)
    np.testing.assert_allclose(hb.numpy(), np.asarray(ha), atol=1e-5)
    np.testing.assert_allclose(float(ab), float(aa), atol=1e-6)
    assert float(ab) > 0
    mb = ttf.mtp_logits(TCFG, tp, hb, _t(labels))
    np.testing.assert_allclose(mb.numpy(), np.asarray(ma), atol=1e-5)


def test_lm_and_mtp_refuse_a_mesh():
    """The forward and the MTP head (ROADMAP item 13b.4) and the decode
    path (item 15b.1) take a tensor-parallel mesh: at ``data=1`` they
    keep the one-device values, the MLA latent caches too (bars in
    ``tests/test_torch_lm_mesh.py`` and ``test_torch_lm_mesh_decode.py``).
    A ``decode_2d`` layout (specs over combined axes, gathered where
    used) keeps them too."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.tensor_parallel import Sharded
    mesh = make_host_mesh(model=2)
    p = ttf.init_lm(TCFG, torch.Generator().manual_seed(0))
    tok = torch.arange(4, dtype=torch.long)[None] * 5
    lg, h, _ = ttf.lm_forward(TCFG, p, tok, mesh=mesh)
    lg0, h0, _ = ttf.lm_forward(TCFG, p, tok)
    np.testing.assert_allclose(lg.numpy(), lg0.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        ttf.mtp_logits(TCFG, p, h, tok, mesh=mesh).numpy(),
        ttf.mtp_logits(TCFG, p, h0, tok).numpy(), atol=1e-5)
    outs = []
    for m in (mesh, None):
        c = ttf.init_lm_caches(TCFG, 1, 8)
        _, c = ttf.lm_prefill(TCFG, p, tok, c, mesh=m)
        ld, c = ttf.lm_decode(TCFG, p, tok[:, :1], c, mesh=m)
        outs.append((ld, c))
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(),
                               atol=1e-5)
    for k, v in outs[1][1].items():
        np.testing.assert_allclose(outs[0][1][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
    d2 = {k: Sharded.place(p[k], mesh, v.spec)
          for k, v in param_shardings(TCFG, p, mesh,
                                      policy="decode_2d").items()}
    c = ttf.init_lm_caches(TCFG, 1, 8)
    _, c = ttf.lm_prefill(TCFG, d2, tok, c, mesh=mesh)
    ld, c = ttf.lm_decode(TCFG, d2, tok[:, :1], c, mesh=mesh)
    np.testing.assert_allclose(ld.numpy(), outs[1][0].numpy(), atol=1e-5)
    for k, v in outs[1][1].items():
        np.testing.assert_allclose(c[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)


def test_train_step_matches_reference(ref):
    """One step: loss (the MTP loss inside it), aux and every updated leaf
    (the MTP head's too); and remat=True bit-equal to remat=False."""
    jp = ref[1]
    tokens, labels = _data(2)
    # the reference trainer's own compiled step (lr 0.05, remat off)
    jp2, jm = ref[0].executor._train(jp, tokens, labels,
                                     jnp.asarray(SCORES), None)
    (pa, ma), (pb, mb) = [TS.make_train_step(TCFG, lr=0.05, remat=r)(
        _port(jp), _t(tokens), _t(labels), _t(SCORES))
        for r in (False, True)]
    np.testing.assert_allclose(float(ma["loss"]), float(jm["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(ma["aux"]), float(jm["aux"]), atol=1e-6)
    want = _port(jp2)
    assert list(pa) == list(want)
    for k in want:
        assert pa[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(pa[k].numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    assert any(k.startswith("mtp.") for k in want)
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
    assert len(calls) == 1 and len(calls[0]) == 46
    assert len(group.launch_groups(calls[0], 32)) == 2


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
    assert len(tr.registry.entries) > 1          # the milestone clone
    assert tr.metrics[-1].trained_models == 2    # ... trained in round 3
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
        root, "step_000002")), rounds=2)
    assert len(tr.metrics) == 2
    tr.run(ROUNDS)
    _assert_discrete_state_equal(jtr, tr)
    _assert_params(jtr, tr, atol=1e-5)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, ref, port_llm):
    """A port checkpoint at round 2 (the clone's first), written by the
    port's ``legacy`` engine (the reference restores a stacked bank only
    into its ``llm`` engine), restored by the reference's ``legacy``
    trainer and run to round 3, equals the port's own 3 rounds. The
    reference trainer is the fixture's (its steps are compiled), put back
    to its own round-3 state afterwards."""
    jtr = ref[0]
    own = jtr.save(str(tmp_path / "own"))
    root = str(tmp_path / "ck")
    _run(ref[1], EngineSpec(engine="legacy", save_every=2,
                            checkpoint_dir=root), rounds=2)
    try:
        assert jtr.restore(root) == 2
        jtr.run(ROUNDS)
        _assert_discrete_state_equal(port_llm, jtr)
        _assert_params(port_llm, jtr, atol=1e-5)
    finally:
        assert jtr.restore(own) == ROUNDS


def test_train_cli_runs_deepseek_on_cpu(tmp_path, monkeypatch):
    from repro_torch.launch import train
    out = str(tmp_path / "run")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train.main(["--arch", DSV3, "--rounds", "2", "--device", "cpu", "--out",
                out])
    with open(os.path.join(out, "history.json")) as f:
        hist = json.load(f)
    assert [h["round"] for h in hist] == [1, 2]
    assert np.isfinite(hist[0]["loss"])
    assert os.path.exists(os.path.join(out, "model_0.npz"))
