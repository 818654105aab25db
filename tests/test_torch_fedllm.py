"""The port's mode-B FedCD trainer (``repro_torch.federated.llm``) against
the reference's, on the CPU: the 8-round schedule of
``tests/test_llm_equivalence.py`` (clones at milestones 2 and 5, late
deletions from round 6), every meshless case of that file through the
port (a no-train round among them), checkpoints crossing packages in
both directions, and the train CLI.

Both packages start from the same params (the reference trainer's
initial model, through ``init_params``). Bars: discrete state exact
(active, alive, live ids, genealogy, trained and live counts per round),
score history to 1e-6, params to 1e-5; ``llm+pipeline`` bit-identical to
``llm``; a crashed run resumed from its checkpoint bit-identical to the
uninterrupted one (the reference's bar).
"""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import ArchConfig as JArch  # noqa: E402
from repro.config import FedCDConfig as JFed  # noqa: E402
from repro.core.spec import EngineSpec as JSpec  # noqa: E402
from repro.federated.llm import FedLLMTrainer as JTrainer  # noqa: E402
from repro_torch.config import ArchConfig, FedCDConfig  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core.spec import EngineSpec  # noqa: E402
from repro_torch.data.scenarios import (FaultEvent,  # noqa: E402
                                        FaultSchedule, SimulatedCrash)
from repro_torch.federated.llm import FedLLMTrainer, make_acc_step  # noqa: E402

KW = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab_size=64, param_dtype="float32",
          compute_dtype="float32")
FK = dict(n_devices=4, devices_per_round=3, score_window=2,
          milestones=(2, 5), late_delete_round=6, max_models=6, lr=0.05,
          seed=0)
CFG, FED = ArchConfig(**KW), FedCDConfig(**FK)
N_CLIENTS, PER, SEQ = 4, 2, 16
ROUNDS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's ``llm`` run over 8 rounds, checkpointing every 4
    rounds; its initial model as numpy."""
    root = str(tmp_path_factory.mktemp("ref") / "ck")
    tr = JTrainer(JArch(**KW), JFed(**FK), N_CLIENTS, PER, SEQ,
                  n_archetypes=2, seed=0,
                  spec=JSpec(engine="llm", save_every=4,
                             checkpoint_dir=root))
    init = jax.tree.map(lambda a: np.array(a, copy=True),
                        tr.registry.params[0])
    tr.run(ROUNDS)
    return tr, init, root


def _trainer(init, spec="llm", **kw):
    return FedLLMTrainer(CFG, FED, N_CLIENTS, PER, SEQ, n_archetypes=2,
                         seed=0, spec=spec, device="cpu", init_params=init,
                         **kw)


def _run(init, spec="llm", rounds=ROUNDS):
    tr = _trainer(init, spec)
    tr.run(rounds)
    return tr


@pytest.fixture(scope="module")
def port_llm(ref):
    return _run(ref[1], "llm")


def _leaves(tr, m):
    p = tr.registry.params[m]
    if isinstance(p, dict) and all(isinstance(v, torch.Tensor)
                                   for v in p.values()):
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


def _assert_params_close(a, b, atol=1e-5):
    for m in a.registry.live_ids():
        for x, y in zip(_leaves(a, m), _leaves(b, m)):
            np.testing.assert_allclose(x, y, atol=atol, rtol=1e-6)


def _assert_params_equal(a, b):
    for m in a.registry.live_ids():
        for x, y in zip(_leaves(a, m), _leaves(b, m)):
            assert np.array_equal(x, y)


# -- the port against the reference ------------------------------------------

@pytest.mark.parametrize("spec", ["llm", "legacy"])
def test_port_matches_reference_through_clones_and_deletions(ref, port_llm,
                                                             spec):
    jtr = ref[0]
    tr = port_llm if spec == "llm" else _run(ref[1], spec)
    assert len(tr.registry.entries) > 1
    assert not all(e.alive for e in tr.registry.entries.values())
    _assert_discrete_state_equal(jtr, tr)
    _assert_params_close(jtr, tr)
    for ma, mb in zip(jtr.metrics, tr.metrics):
        np.testing.assert_allclose(ma.client_acc, mb.client_acc, atol=1e-6)
        assert np.isclose(ma.mean_loss, mb.mean_loss, atol=1e-5,
                          equal_nan=True)
        assert (ma.live_models, ma.active_models) == \
            (mb.live_models, mb.active_models)
        assert np.isclose(ma.score_std, mb.score_std, atol=1e-6)


def test_legacy_equals_llm_bit_for_bit(ref, port_llm):
    tr = _run(ref[1], "legacy")
    _assert_discrete_state_equal(port_llm, tr)
    _assert_params_equal(port_llm, tr)


def test_pipelined_matches_synchronous_bit_identical(ref, port_llm):
    b = _run(ref[1], "llm+pipeline")
    _assert_discrete_state_equal(port_llm, b)
    _assert_params_equal(port_llm, b)


def test_default_init_from_seed_runs():
    tr = FedLLMTrainer(CFG, FED, N_CLIENTS, PER, SEQ, seed=0, device="cpu")
    a = tr.registry.params[0]["embed.table"].clone()
    tr.run(2)
    tr2 = FedLLMTrainer(CFG, FED, N_CLIENTS, PER, SEQ, seed=0, device="cpu")
    assert torch.equal(tr2.registry.params[0]["embed.table"], a)
    assert all(np.isfinite(m.mean_loss) for m in tr.metrics)


# -- kill-and-resume ---------------------------------------------------------

def test_crash_and_resume_matches_uninterrupted(tmp_path, ref, port_llm):
    root = str(tmp_path / "ck")
    faulted = EngineSpec(engine="llm", save_every=3, checkpoint_dir=root,
                         faults=FaultSchedule(
                             (FaultEvent(5, "mid-dispatch"),)))
    with pytest.raises(SimulatedCrash):
        _run(ref[1], faulted)
    resumed = _run(ref[1], EngineSpec(engine="llm", resume_from=root))
    assert len(resumed.metrics) == ROUNDS
    _assert_discrete_state_equal(port_llm, resumed)
    _assert_params_equal(port_llm, resumed)


def test_pipelined_crash_resumes_bit_identical(tmp_path, ref, port_llm):
    root = str(tmp_path / "ck")
    faulted = EngineSpec(engine="llm", pipeline=True, save_every=3,
                         checkpoint_dir=root,
                         faults=FaultSchedule(
                             (FaultEvent(4, "post-readback"),)))
    with pytest.raises(SimulatedCrash):
        _run(ref[1], faulted)
    # round 3's snapshot carries the prefetched round-4 inputs (the RNG
    # stream is already past those draws)
    with open(os.path.join(root, "step_000003", "manifest.json")) as f:
        assert json.load(f)["state"]["prefetch_round"] == 4
    resumed = _run(ref[1], EngineSpec(engine="llm", pipeline=True,
                                      resume_from=root))
    _assert_discrete_state_equal(port_llm, resumed)
    _assert_params_equal(port_llm, resumed)


def test_legacy_checkpoint_restores_into_stacked_registry(tmp_path, ref,
                                                          port_llm):
    src = _run(ref[1], "legacy", rounds=4)
    path = src.save(str(tmp_path / "step"))
    dst = _trainer(ref[1], "llm")
    assert dst.restore(path) == 4
    _assert_discrete_state_equal(src, dst)
    _assert_params_equal(src, dst)
    dst.run(ROUNDS)
    _assert_discrete_state_equal(port_llm, dst)
    _assert_params_equal(port_llm, dst)


# -- checkpoints crossing packages -------------------------------------------

def test_reference_checkpoint_resumes_in_the_port(ref):
    jtr, init, root = ref
    tr = _trainer(init, EngineSpec(engine="llm", resume_from=os.path.join(
        root, "step_000004")))
    assert len(tr.metrics) == 4
    tr.run(ROUNDS)
    _assert_discrete_state_equal(jtr, tr)
    _assert_params_close(jtr, tr)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, ref):
    """A port checkpoint at round 4, restored by the reference's trainer
    and run one more round, equals the port's own round 5."""
    init = ref[1]
    root = str(tmp_path / "ck")
    _run(init, EngineSpec(engine="llm", save_every=4, checkpoint_dir=root),
         rounds=4)
    port5 = _run(init, "llm", rounds=5)
    jtr = JTrainer(JArch(**KW), JFed(**FK), N_CLIENTS, PER, SEQ,
                   n_archetypes=2, seed=0, spec="llm")
    assert jtr.restore(root) == 4
    jtr.run(5)
    _assert_discrete_state_equal(port5, jtr)
    _assert_params_close(port5, jtr)


def test_draft_rows_in_a_checkpoint_raise(tmp_path, ref):
    """A checkpoint without draft rows says so; one with them restores
    them verbatim, and only into a trainer of the same draft depth."""
    tr = _run(ref[1], "llm", rounds=1)
    path = tr.save(str(tmp_path / "step"))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["kind"] == "fedllm" and manifest["state"]["draft"] is None
    src = _trainer(ref[1], draft_layers=1)
    src.run(1)
    path = src.save(str(tmp_path / "draft"))
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["state"]["draft"] == {"layers": 1,
                                                  "present": [0]}
    dst = _trainer(ref[1], draft_layers=1)
    with torch.no_grad():
        for v in dst.draft.tree.values():
            v.zero_()
    assert dst.restore(path) == 1
    assert dst.draft.present == {0}
    for k, v in src.draft.tree.items():
        assert torch.equal(dst.draft.tree[k][0], v[0]), k
    from repro_torch.checkpoint.io import CheckpointError
    with pytest.raises(CheckpointError, match="draft depth mismatch"):
        _trainer(ref[1], draft_layers=2).restore(path)


# -- the reference's regressions, in its order ---------------------------------

def test_acc_step_rejects_indivisible_batch(ref):
    with pytest.raises(ValueError, match="not divisible"):
        make_acc_step(CFG, n_clients=3, batch_size=8)
    step = make_acc_step(CFG, n_clients=3)
    params = _trainer(ref[1], "legacy").registry.params[0]
    tokens = torch.zeros((8, SEQ), dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible"):
        step(params, tokens, tokens)


def test_no_train_round_reports_nan_not_zero(ref):
    tr = _trainer(ref[1], "llm")
    tr.state.active[:] = False            # nobody holds any model
    m = tr.run_round(1)
    assert np.isnan(m.mean_loss)
    assert m.trained_models == 0


def test_mean_loss_survives_checkpoint_nan(tmp_path, ref):
    tr = _trainer(ref[1], "llm")
    tr.state.active[:] = False
    tr.run_round(1)
    path = tr.save(str(tmp_path / "step"))
    dst = _trainer(ref[1], "llm")
    dst.restore(path)
    assert np.isnan(dst.metrics[0].mean_loss)
    assert dst.metrics[0].trained_models == 0
    # and across packages, from the legacy engine's dict storage
    src = _trainer(ref[1], "legacy")
    src.state.active[:] = False
    src.run_round(1)
    path = src.save(str(tmp_path / "legacy"))
    jdst = JTrainer(JArch(**KW), JFed(**FK), N_CLIENTS, PER, SEQ, seed=0,
                    spec="legacy")
    assert jdst.restore(path) == 1
    assert np.isnan(jdst.metrics[0].mean_loss)
    assert jdst.metrics[0].trained_models == 0


def test_llm_spec_validation(ref):
    with pytest.raises(ValueError, match="FedLLMTrainer supports"):
        _trainer(ref[1], "fused")
    with pytest.raises(ValueError, match="requires engine='fused'"):
        EngineSpec.parse("llm+sparse:0.5")
    with pytest.raises(ValueError, match="only apply to 'sharded'"):
        EngineSpec.parse("llm@2")
    assert EngineSpec.parse("llm+pipeline").canonical == "llm+pipeline"
    from repro_torch.core.fedcd import FedCDServer
    with pytest.raises(ValueError, match="mode-B LM plane"):
        FedCDServer(FED, {"w": torch.zeros(2)}, None, None,
                    {"train": (np.zeros((4, 4, 2)), np.zeros((4, 4)))},
                    spec="llm", device="cpu")


def test_run_resumes_after_restore_round_count(ref):
    tr = _run(ref[1], "llm", rounds=3)
    assert [m.round for m in tr.metrics] == [1, 2, 3]
    tr.run(5)
    assert [m.round for m in tr.metrics] == [1, 2, 3, 4, 5]


def test_trainer_refuses_what_is_not_ported(ref):
    """A trainer takes a tensor-parallel mesh (ROADMAP item 13b.4; its
    bars are in ``tests/test_torch_lm_mesh.py``) and the decode-side
    steps serve its rows on that mesh (item 15b.1): a prefill and a
    decode step of the mesh bank's row equal the one-device steps on the
    row gathered, and so does the row laid out by the ``decode_2d``
    policy (specs over combined axes, gathered where used).
    Draft rows are built: one 1-layer draft of the initial model, a copy
    of its leading layer."""
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.tensor_parallel import Sharded
    from repro_torch.models import transformer as ttf
    tr = _trainer(ref[1], mesh=make_host_mesh(model=2))
    tok = torch.arange(8, dtype=torch.long).reshape(2, 4) * 5
    outs = []
    for m, p in ((tr.mesh, tr.registry.params[0]),
                 (None, tr.executor.params_of(0))):
        c = ttf.init_lm_caches(CFG, 2, 8)
        last, c = TS.make_prefill_step(CFG, mesh=m)(p, c, tok, 3)
        lg, _ = TS.make_serve_step(CFG, mesh=m)(p, c, tok[:, 3:])
        outs.append((last, lg))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    whole = tr.executor.params_of(0)
    d2 = {k: Sharded.place(whole[k], tr.mesh, v.spec)
          for k, v in param_shardings(CFG, whole, tr.mesh,
                                      policy="decode_2d").items()}
    c = ttf.init_lm_caches(CFG, 2, 8)
    last, c = TS.make_prefill_step(CFG, mesh=tr.mesh)(d2, c, tok, 3)
    lg, _ = TS.make_serve_step(CFG, mesh=tr.mesh)(d2, c, tok[:, 3:])
    for a, b in zip((last, lg), outs[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    for spec in ("llm", "legacy"):
        tr = _trainer(ref[1], spec, draft_layers=1)
        assert tr.draft.present == {0} and tr.draft.dcfg.n_layers == 1
        row = tr.draft.row_params(tr.draft.row(tr.registry, 0))
        params = tr.executor.params_of(0)
        assert torch.equal(row["segments.0.attn.wq"],
                           params["segments.0.attn.wq"][:1])
        assert torch.equal(row["embed.table"], params["embed.table"])


def test_trainer_needs_cuda_unless_cpu_is_asked(monkeypatch, ref):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FedLLMTrainer(CFG, FED, N_CLIENTS, PER, SEQ, device=device,
                          init_params=ref[1])


# -- the train CLI -----------------------------------------------------------

def test_train_cli_runs_on_cpu(tmp_path, monkeypatch):
    from repro_torch.launch import train
    out = str(tmp_path / "run")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train.main(["--rounds", "2", "--device", "cpu", "--out", out,
                "--save-every", "1"])
    with open(os.path.join(out, "history.json")) as f:
        hist = json.load(f)
    assert [h["round"] for h in hist] == [1, 2]
    assert np.isfinite(hist[0]["loss"])
    assert os.path.exists(os.path.join(out, "model_0.npz"))
    assert os.path.exists(os.path.join(out, "ckpts", "step_000002",
                                       "manifest.json"))
    train.main(["--rounds", "3", "--device", "cpu", "--out", out,
                "--save-every", "1", "--resume",
                os.path.join(out, "ckpts")])
    with open(os.path.join(out, "history.json")) as f:
        assert [h["round"] for h in json.load(f)] == [1, 2, 3]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--rounds", "1", "--out", out])
