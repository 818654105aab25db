"""The port's legacy and batched round engines against the reference's,
and the port's three engines against each other, on the CPU (the setup
of ``tests/test_engine_equivalence.py::_small_setup``: MLP, 8 devices,
milestones 2/5), from the reference's initial params and the same
seeded host streams.

Bars (ROADMAP, DESIGN.md §7):
* unquantized, 8 rounds: per-round metrics (all but ``wall_s``), live
  ids, genealogy, active matrix, score history and preferred models
  exact; params to atol=1e-5 (float32, different reduction order);
* int8 transport, 5 rounds: discrete state exact, params within one
  int8 step (``test_torch_slice.STEP`` bar, as the reference holds its
  own engines);
* FedAvg, 4 rounds: accuracies exact, params to atol=1e-5.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fedavg import FedAvgServer as JFedAvg  # noqa: E402
from repro.core.fedcd import FedCDServer as JFedCD  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quantize as tqz  # noqa: E402
from repro_torch.core.fedavg import FedAvgServer as TFedAvg  # noqa: E402
from repro_torch.core.fedcd import ENGINES  # noqa: E402
from repro_torch.core.fedcd import FedCDServer as TFedCD  # noqa: E402
from repro_torch.core.lifecycle import clone_at_milestone  # noqa: E402
from repro_torch.core.registry import ModelRegistry  # noqa: E402
from repro_torch.core.scores import init_scores  # noqa: E402
from repro_torch.kernels.weighted_agg import ops as twops  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from test_torch_slice import (STEP, _discrete_state_equal,  # noqa: E402
                              _leaves, _params_close, _small_setup, _tcfg)

ROUNDS = 8
HOST_ENGINES = ("legacy", "batched")


def _init():
    jp = jmlp.init_mlp_classifier(jax.random.PRNGKey(0), hidden=32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _ref(cfg, data, engine, rounds, jp):
    srv = JFedCD(cfg, jp, jmlp.mlp_loss, jmlp.mlp_accuracy, data,
                 batch_size=16, spec=engine)
    srv.run(rounds)
    return srv


def _port(cfg, data, engine, rounds, tp):
    srv = TFedCD(_tcfg(cfg), tp, tmlp.mlp_loss, tmlp.mlp_accuracy, data,
                 batch_size=16, spec=engine, device="cpu")
    srv.run(rounds)
    return srv


@pytest.fixture(scope="module")
def runs():
    """{(package, engine): server} after 8 unquantized rounds."""
    cfg, data = _small_setup()
    jp, tp = _init()
    out = {("port", e): _port(cfg, data, e, ROUNDS, tp) for e in ENGINES}
    for e in HOST_ENGINES:
        out[("ref", e)] = _ref(cfg, data, e, ROUNDS, jp)
    return out


def _metrics_equal(a, b):
    assert len(a.metrics) == len(b.metrics)
    for ma, mb in zip(a.metrics, b.metrics):
        np.testing.assert_array_equal(ma.test_acc, mb.test_acc)
        np.testing.assert_array_equal(ma.val_acc, mb.val_acc)
        assert ma.score_std == mb.score_std


@pytest.mark.parametrize("engine", HOST_ENGINES)
def test_engine_metrics_match_reference(runs, engine):
    ref, port = runs[("ref", engine)], runs[("port", engine)]
    assert len(port.metrics) == ROUNDS
    _discrete_state_equal(ref, port)
    _metrics_equal(ref, port)


@pytest.mark.parametrize("engine", HOST_ENGINES)
def test_engine_score_history_matches_reference(runs, engine):
    ref, port = runs[("ref", engine)], runs[("port", engine)]
    np.testing.assert_array_equal(ref.state.history, port.state.history)


@pytest.mark.parametrize("engine", HOST_ENGINES)
def test_engine_params_match_reference(runs, engine):
    ref, port = runs[("ref", engine)], runs[("port", engine)]
    _params_close(ref, port, atol=1e-5)
    # the dict registry keeps every live model on the server's device
    for m in port.registry.live_ids():
        assert all(t.device.type == "cpu"
                   for t in port.registry.params[m].values())


@pytest.mark.parametrize("other", ["batched", "fused"])
def test_port_engines_agree(runs, other):
    """legacy ≡ batched ≡ fused within the port, as
    ``tests/test_engine_equivalence.py`` pins the reference's."""
    legacy, eng = runs[("port", "legacy")], runs[("port", other)]
    _discrete_state_equal(legacy, eng)
    _metrics_equal(legacy, eng)
    np.testing.assert_array_equal(legacy.state.history, eng.state.history)
    for m in legacy.registry.live_ids():
        for k, a in legacy.registry.params[m].items():
            np.testing.assert_allclose(eng.registry.params[m][k].numpy(),
                                       a.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("engine", HOST_ENGINES)
def test_quantized_engine_matches_reference(engine):
    cfg, data = _small_setup(quantize_bits=8)
    jp, tp = _init()
    ref = _ref(cfg, data, engine, 5, jp)
    port = _port(cfg, data, engine, 5, tp)
    _discrete_state_equal(ref, port)
    for mr, mp in zip(ref.metrics, port.metrics):
        # a one-step param flip can flip one of 32 eval examples
        np.testing.assert_allclose(mp.test_acc, mr.test_acc, atol=1 / 16)
    _params_close(ref, port, atol=2 * STEP)


@pytest.mark.parametrize("engine", HOST_ENGINES)
def test_fedavg_engine_matches_reference(engine):
    cfg, data = _small_setup()
    jp, tp = _init()
    ref = JFedAvg(cfg, jp, jmlp.mlp_loss, jmlp.mlp_accuracy, data,
                  batch_size=16, spec=engine)
    ref.run(4)
    ports = {e: TFedAvg(_tcfg(cfg), tp, tmlp.mlp_loss, tmlp.mlp_accuracy,
                        data, batch_size=16, spec=e, device="cpu")
             for e in (engine, "fused")}
    for srv in ports.values():
        srv.run(4)
    port = ports[engine]
    for mr, mp in zip(ref.metrics, port.metrics):
        assert mr.comm_bytes == mp.comm_bytes
        np.testing.assert_array_equal(mr.test_acc, mp.test_acc)
        np.testing.assert_array_equal(mr.val_acc, mp.val_acc)
    for a, (k, b) in zip(_leaves(ref.params), port.params.items()):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=0)
        # and the port's fused FedAvg agrees with this engine
        np.testing.assert_allclose(ports["fused"].params[k].numpy(),
                                   b.numpy(), atol=1e-5, rtol=0)


def test_aggregation_routes_through_the_engines_kernels(monkeypatch):
    """Legacy FedCD and FedAvg make one grouped call of the single-model
    kernel wrapper per aggregated model, over every leaf; batched and
    fused make one grouped call of the multi-model one. No engine calls
    the per-leaf wrappers. (On CUDA tensors each grouped call is one
    launch.)"""
    names = ("weighted_agg_group", "multi_weighted_agg_group",
             "weighted_agg", "multi_weighted_agg")
    calls = dict.fromkeys(names, 0)
    leaves = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(twops, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            leaves[_name] += len(a[0]) if _name.endswith("_group") else 1
            return _real(*a)
        monkeypatch.setattr(twops, name, counted)

    def reset():
        for k in names:
            calls[k] = leaves[k] = 0

    def expect(group):
        return ({k: int(k == group) for k in names},
                {k: n_leaves * (k == group) for k in names})

    cfg, data = _small_setup()
    _, tp = _init()
    n_leaves = len(tp)
    seen = {}
    for engine in ENGINES:
        reset()
        srv = TFedCD(_tcfg(cfg), tp, tmlp.mlp_loss, tmlp.mlp_accuracy,
                     data, batch_size=16, spec=engine, device="cpu")
        m = srv.run_round(1)
        assert m.live_models == 1
        seen[engine] = (dict(calls), dict(leaves))
    assert seen["legacy"] == expect("weighted_agg_group")
    for engine in ("batched", "fused"):
        assert seen[engine] == expect("multi_weighted_agg_group")
    reset()
    TFedAvg(_tcfg(cfg), tp, tmlp.mlp_loss, tmlp.mlp_accuracy, data,
            batch_size=16, spec="legacy", device="cpu").run_round(1)
    assert (calls, leaves) == expect("weighted_agg_group")


def test_dict_registry_clones_on_device_through_roundtrip():
    """Dict mode with the transport roundtrip as the clone function: a
    clone is a new set of tensors on the parent's device, equal to the
    parent's roundtrip, and the parent is left as it was."""
    cfg, _ = _small_setup(quantize_bits=8)
    _, tp = _init()
    reg = ModelRegistry.create(tp, cfg.max_models)
    state = init_scores(cfg.n_devices, cfg.max_models, cfg.score_window)
    before = {k: v.clone() for k, v in tp.items()}
    state, pairs = clone_at_milestone(
        state, reg, 2, _tcfg(cfg), np.random.default_rng(0),
        clone_params_fn=lambda p: tqz.roundtrip(p, 8))
    assert pairs == [(0, 1)] and reg.live_ids() == [0, 1]
    want = tqz.roundtrip(before, 8)
    for k, v in reg.params[1].items():
        assert v.device == tp[k].device
        assert v.data_ptr() != reg.params[0][k].data_ptr()
        assert torch.equal(v, want[k])
        assert torch.equal(reg.params[0][k], before[k])
    reg.kill(1, 3)
    assert 1 not in reg.params and reg.live_ids() == [0]
