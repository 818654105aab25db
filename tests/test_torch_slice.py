"""The slice end to end: the port's FedCDServer and FedAvgServer against
the reference's on the CPU, from the reference's initial params and the
same seeded host streams (the setup of
``tests/test_engine_equivalence.py::_small_setup``).

Bars:
* unquantized, 8 rounds: per-round metrics (all but ``wall_s``), live
  ids, active matrix, score history and preferred models exact; params
  to atol=1e-5 (float32, different reduction order);
* int8 transport, 5 rounds: discrete state exact, params within one
  int8 step — the bar the reference holds its own engines to
  (``tests/test_engine_equivalence.py::test_quantized_transport_engines_
  match``, DESIGN.md §7): a ~1e-7 difference at a ``round()`` boundary
  moves a value by a whole quantization step.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.fedcd_cifar import HIERARCHICAL  # noqa: E402
from repro.core.fedavg import FedAvgServer as JFedAvg  # noqa: E402
from repro.core.fedcd import FedCDServer as JFedCD  # noqa: E402
from repro.data.partition import hierarchical_devices, stack_devices  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.config import FedCDConfig as TCfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.fedavg import FedAvgServer as TFedAvg  # noqa: E402
from repro_torch.core.fedcd import FedCDServer as TFedCD  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402

ROUNDS = 8
STEP = 1.0 / 127        # one int8 step: scale = blockmax/127, |w| < 1 here


def _small_setup(n_devices=8, seed=0, n_train=64, n_eval=32, **cfg_kw):
    devs = hierarchical_devices(seed=seed, devices_per_archetype=1,
                                n_train=n_train, n_val=n_eval,
                                n_test=n_eval, noise=2.0)[:n_devices]
    data = stack_devices(devs)
    cfg = dataclasses.replace(
        HIERARCHICAL, n_devices=n_devices, devices_per_round=n_devices // 2,
        milestones=(2, 5), max_models=8, late_delete_round=6, seed=seed,
        **cfg_kw)
    return cfg, data


def _tcfg(cfg):
    return TCfg(**dataclasses.asdict(cfg))


def _leaves(params):
    return [np.asarray(a) for a in jax.tree.leaves(params)]


def _run_pair(cfg, data, rounds, model="mlp", batch_size=16):
    if model == "mlp":
        jp = jmlp.init_mlp_classifier(jax.random.PRNGKey(0), hidden=32)
        jfns, tfns = ((jmlp.mlp_loss, jmlp.mlp_accuracy),
                      (tmlp.mlp_loss, tmlp.mlp_accuracy))
    else:
        jp = jcnn.init_cnn(jax.random.PRNGKey(0))
        jfns, tfns = ((jcnn.cnn_loss, jcnn.cnn_accuracy),
                      (tcnn.cnn_loss, tcnn.cnn_accuracy))
    ref = JFedCD(cfg, jp, *jfns, data, batch_size=batch_size, spec="fused")
    ref.run(rounds)
    port = TFedCD(_tcfg(cfg), params_from_jax(jax.tree.map(np.asarray, jp)),
                  *tfns, data, batch_size=batch_size, device="cpu")
    port.run(rounds)
    return ref, port


def _discrete_state_equal(ref, port):
    np.testing.assert_array_equal(ref.state.active, port.state.active)
    np.testing.assert_array_equal(ref.state.alive, port.state.alive)
    assert ref.registry.live_ids() == port.registry.live_ids()
    assert ref.registry.genealogy() == port.registry.genealogy()
    for mr, mp in zip(ref.metrics, port.metrics):
        assert mr.round == mp.round
        assert mr.live_models == mp.live_models
        assert mr.active_models == mp.active_models
        assert mr.comm_bytes == mp.comm_bytes
        np.testing.assert_array_equal(mr.preferred, mp.preferred)


def _params_close(ref, port, atol):
    for m in ref.registry.live_ids():
        rleaves = _leaves(ref.registry.params[m])
        pleaves = [t.numpy() for t in port.registry.params[m].values()]
        assert len(rleaves) == len(pleaves)
        for a, b in zip(rleaves, pleaves):
            np.testing.assert_allclose(b, a, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def unquantized():
    cfg, data = _small_setup()
    return _run_pair(cfg, data, ROUNDS)


def test_metrics_match_exactly(unquantized):
    ref, port = unquantized
    assert len(ref.metrics) == len(port.metrics) == ROUNDS
    _discrete_state_equal(ref, port)
    for mr, mp in zip(ref.metrics, port.metrics):
        np.testing.assert_array_equal(mr.test_acc, mp.test_acc)
        np.testing.assert_array_equal(mr.val_acc, mp.val_acc)
        assert mr.score_std == mp.score_std


def test_score_history_matches_exactly(unquantized):
    ref, port = unquantized
    np.testing.assert_array_equal(ref.state.history, port.state.history)


def test_params_match(unquantized):
    ref, port = unquantized
    _params_close(ref, port, atol=1e-5)


def test_quantized_transport_matches():
    cfg, data = _small_setup(quantize_bits=8)
    ref, port = _run_pair(cfg, data, 5)
    _discrete_state_equal(ref, port)
    for mr, mp in zip(ref.metrics, port.metrics):
        # a one-step param flip can flip one of 32 eval examples
        np.testing.assert_allclose(mp.test_acc, mr.test_acc, atol=1 / 16)
    _params_close(ref, port, atol=2 * STEP)
    assert port._compressed_bytes == ref._compressed_bytes


def test_fedavg_matches():
    cfg, data = _small_setup()
    jp = jmlp.init_mlp_classifier(jax.random.PRNGKey(0), hidden=32)
    ref = JFedAvg(cfg, jp, jmlp.mlp_loss, jmlp.mlp_accuracy, data,
                  batch_size=16, spec="fused")
    ref.run(4)
    port = TFedAvg(_tcfg(cfg), params_from_jax(jax.tree.map(np.asarray, jp)),
                   tmlp.mlp_loss, tmlp.mlp_accuracy, data, batch_size=16,
                   device="cpu")
    port.run(4)
    for mr, mp in zip(ref.metrics, port.metrics):
        assert mr.comm_bytes == mp.comm_bytes
        np.testing.assert_array_equal(mr.test_acc, mp.test_acc)
        np.testing.assert_array_equal(mr.val_acc, mp.val_acc)
    for a, b in zip(_leaves(ref.params), port.params.values()):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=0)


def test_fedcd_above_fedavg_shares_sampling_stream():
    """Both port servers draw the same cohorts from equal seeds."""
    cfg, data = _small_setup()
    p = tmlp.init_mlp_classifier(torch.Generator().manual_seed(0),
                                 hidden=32)
    fedcd = TFedCD(_tcfg(cfg), p, tmlp.mlp_loss, tmlp.mlp_accuracy, data,
                   batch_size=16, device="cpu")
    fedavg = TFedAvg(_tcfg(cfg), p, tmlp.mlp_loss, tmlp.mlp_accuracy, data,
                     batch_size=16, device="cpu")
    for t in (1, 2):
        a = fedcd._round_sample(t)
        fedcd._prefetch = None
        b = fedavg.rng.choice(cfg.n_devices, cfg.devices_per_round,
                              replace=False)
        assert sorted(np.nonzero(a[0])[0]) == sorted(b)
        fedavg.rng.permuted(np.zeros((cfg.n_devices * cfg.local_epochs,
                                      64)), axis=1)
    # the init params are copied, not aliased, into the banks
    assert all(torch.equal(p[k], fedavg.params[k]) for k in p)


def test_unported_options_and_missing_gpu_raise(monkeypatch):
    """The sharded planes are ported (ROADMAP item 12): with
    ``device="cpu"`` a sharded spec runs with its cells on the CPU; left
    to the card, a mesh needs that many CUDA devices and raises without
    them, as ``jax.make_mesh`` does beyond the device count."""
    cfg, data = _small_setup()
    p = tmlp.init_mlp_classifier(torch.Generator().manual_seed(0),
                                 hidden=32)
    for cls, name in ((TFedCD, "ShardedExecutor"),
                      (TFedAvg, "FedAvgShardedExecutor")):
        srv = cls(_tcfg(cfg), p, tmlp.mlp_loss, tmlp.mlp_accuracy, data,
                  device="cpu", spec="sharded@2+pipeline")
        assert type(srv.executor).__name__ == name
        srv.run(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TFedCD, TFedAvg):
        with pytest.raises(ValueError, match="CUDA devices"):
            cls(_tcfg(cfg), p, tmlp.mlp_loss, tmlp.mlp_accuracy, data,
                spec="sharded@2+pipeline")
