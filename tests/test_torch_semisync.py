"""The port's semi-synchronous rounds (``+semisync``: quorum deadline,
weight-zeroed late pairs, straggler rows harvested and folded back in)
against the reference's, on the CPU, in the setup of
``tests/test_engine_equivalence.py::_small_setup`` (MLP, 8 devices,
milestones 2/5), from the reference's initial params and the same seeded
host streams. The cases are the meshless tiers of
``tests/test_semisync_equivalence.py``, each run through both packages.

Bars (ROADMAP):
* discrete state (live ids, genealogy, active matrix, score history,
  preferred models), per-round metrics and ``semisync_stats().as_dict()``
  exactly equal to the reference's; params to atol=1e-5 (float32,
  different reduction order), within one int8 step under int8 transport;
* the zero-latency model is bit-identical to the synchronous run inside
  the port (``torch.equal``), plain, quantized and under churn;
* the stale fold (``_blend_stale``) equals the reference's numpy fold bit
  for bit on the same inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fedavg import FedAvgServer as JFedAvg  # noqa: E402
from repro.core.fedcd import FedCDServer as JFedCD  # noqa: E402
from repro.core.plan import RoundPlanner as JPlanner  # noqa: E402
from repro.core.spec import EngineSpec as JSpec  # noqa: E402
from repro.data import scenarios as js  # noqa: E402
from repro.federated.executors import _blend_stale as j_blend  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.core import quantize as tqz  # noqa: E402
from repro_torch.core.fedavg import FedAvgServer as TFedAvg  # noqa: E402
from repro_torch.core.fedcd import FedCDServer as TFedCD  # noqa: E402
from repro_torch.core.plan import RoundPlan  # noqa: E402
from repro_torch.core.plan import RoundPlanner as TPlanner  # noqa: E402
from repro_torch.core.spec import EngineSpec as TSpec  # noqa: E402
from repro_torch.data import scenarios as ts  # noqa: E402
from repro_torch.federated.executors import (TrainMeta,  # noqa: E402
                                             _blend_stale, _harvest_rows)
from repro_torch.kernels.weighted_agg import ops as twops  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from test_torch_engines import _init  # noqa: E402
from test_torch_pipeline import PLAN_FIELDS, _planner_inputs  # noqa: E402
from test_torch_slice import (STEP, _discrete_state_equal,  # noqa: E402
                              _leaves, _params_close, _small_setup, _tcfg)

ROUNDS = 8
# the reference's heavy-tail regime: quorum 60% + lognormal sigma 2 makes
# ~40% of each cohort straggle; 5% random dropouts
STRAGGLER = dict(distribution="lognormal", sigma=2.0, quorum=0.6,
                 dropout_rate=0.05, seed=0)
MOD = {"ref": js, "port": ts}


def straggler(pkg, zero=False, **kw):
    """The package's StragglerModel (``zero``: the zero-latency gate)."""
    mod = MOD[pkg]
    if "dropouts" in kw:
        kw["dropouts"] = tuple(mod.DeviceDropout(*e) for e in kw["dropouts"])
    if zero:
        return mod.StragglerModel.zero(**kw)
    return mod.StragglerModel(**kw)


def churn(pkg, rounds=ROUNDS):
    """The reference's churn fixture: joins, leaves and drifts within
    ``rounds`` rounds of the 8-device setup."""
    return MOD[pkg].random_churn(rounds, 8, seed=3, join_rate=0.5,
                                 leave_rate=0.4, drift_rate=0.3,
                                 min_devices=3, n_train=64, n_val=32,
                                 n_test=32)


def make(pkg, spec_kw, server="fedcd", quantize_bits=0, cfg=None):
    """One server of ``pkg`` ("ref" or "port") on the small setup.
    ``spec_kw`` maps EngineSpec fields to values or, for ``straggler``
    and ``scenario``, to functions of the package name."""
    base, data = _small_setup(quantize_bits=quantize_bits)
    cfg = cfg or base
    kw = {k: (v(pkg) if callable(v) else v) for k, v in spec_kw.items()}
    jp, tp = _init()
    if pkg == "ref":
        cls = JFedCD if server == "fedcd" else JFedAvg
        return cls(cfg, jp, jmlp.mlp_loss, jmlp.mlp_accuracy, data,
                   batch_size=16, spec=JSpec(**kw))
    cls = TFedCD if server == "fedcd" else TFedAvg
    return cls(_tcfg(cfg), tp, tmlp.mlp_loss, tmlp.mlp_accuracy, data,
               batch_size=16, spec=TSpec(**kw), device="cpu")


def run_pair(spec_kw, rounds=ROUNDS, **kw):
    """(reference server, port server) after ``rounds`` rounds."""
    out = []
    for pkg in ("ref", "port"):
        srv = make(pkg, spec_kw, **kw)
        srv.run(rounds)
        out.append(srv)
    return out


def same_state(ref, port, acc_atol=0.0):
    """Discrete state, score history and per-round metrics exact (the
    accuracies to ``acc_atol``), and the semi-sync stats equal."""
    _discrete_state_equal(ref, port)
    np.testing.assert_array_equal(ref.state.history, port.state.history)
    assert len(ref.metrics) == len(port.metrics)
    for mr, mp in zip(ref.metrics, port.metrics):
        np.testing.assert_allclose(mp.test_acc, mr.test_acc, atol=acc_atol,
                                   rtol=0)
        np.testing.assert_allclose(mp.val_acc, mr.val_acc, atol=acc_atol,
                                   rtol=0)
        if not acc_atol:
            assert mr.score_std == mp.score_std
    if ref.semisync_stats is not None:
        assert port.semisync_stats.as_dict() == ref.semisync_stats.as_dict()


def bit_identical(a, b):
    """Two port FedCD runs: same discrete state and metrics, params equal
    bit for bit."""
    same_state(a, b)
    for m in a.registry.live_ids():
        for k, v in a.registry.params[m].items():
            assert torch.equal(v, b.registry.params[m][k]), (m, k)


def fedavg_same(ref, port, atol=0.0):
    for mr, mp in zip(ref.metrics, port.metrics):
        assert mr.comm_bytes == mp.comm_bytes
        np.testing.assert_allclose(mp.test_acc, mr.test_acc, atol=atol,
                                   rtol=0)
        np.testing.assert_allclose(mp.val_acc, mr.val_acc, atol=atol,
                                   rtol=0)
    for a, b in zip(_leaves(ref.params), port.params.values()):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=0)
    if ref.semisync_stats is not None:
        assert port.semisync_stats.as_dict() == ref.semisync_stats.as_dict()


# -- the zero-latency gate: semi-sync off == synchronous, bit for bit --------

@pytest.mark.parametrize("case", ["plain", "quantized", "churn"])
def test_zero_latency_is_bit_identical_to_sync(case):
    rounds, bits, extra = ROUNDS, 0, {}
    if case == "quantized":
        rounds, bits = 5, 8
    if case == "churn":
        extra = dict(scenario=churn)
    zero = dict(extra, straggler=lambda p: straggler(p, zero=True))
    sync = make("port", extra, quantize_bits=bits)
    sync.run(rounds)
    ref, port = run_pair(zero, rounds, quantize_bits=bits)
    bit_identical(sync, port)
    st = port.semisync_stats.as_dict()
    assert st["stragglers"] == st["folded"] == 0
    assert st["dropouts"] == st["expired"] == 0
    assert st["ontime"] == st["dispatched"] > 0
    assert st["t_semisync"] == st["t_sync"] == 0.0
    if bits:
        same_state(ref, port, acc_atol=1 / 16)
        _params_close(ref, port, atol=STEP)
    else:
        same_state(ref, port)
        _params_close(ref, port, atol=1e-5)


def test_fedavg_zero_latency_matches_sync():
    zero = dict(straggler=lambda p: straggler(p, zero=True))
    sync = make("port", {}, server="fedavg")
    sync.run(4)
    ref, port = run_pair(zero, 4, server="fedavg")
    fedavg_same(ref, port)
    for mr, mp in zip(sync.metrics, port.metrics):
        np.testing.assert_array_equal(mr.test_acc, mp.test_acc)
        np.testing.assert_array_equal(mr.val_acc, mp.val_acc)
    for k, v in sync.params.items():
        assert torch.equal(v, port.params[k])


# -- the straggler regime: buffering, folding, accounting --------------------

@pytest.fixture(scope="module")
def straggled():
    """{(package, pipeline): server} after 8 rounds of the heavy tail."""
    out = {}
    for pipeline in (False, True):
        spec = dict(pipeline=pipeline,
                    straggler=lambda p: straggler(p, **STRAGGLER))
        ref, port = run_pair(spec)
        out[("ref", pipeline)], out[("port", pipeline)] = ref, port
    return out


@pytest.mark.parametrize("pipeline", [False, True])
def test_straggler_regime_matches_reference(straggled, pipeline):
    ref, port = straggled[("ref", pipeline)], straggled[("port", pipeline)]
    same_state(ref, port)
    _params_close(ref, port, atol=1e-5)
    st = port.semisync_stats.as_dict()
    assert st["rounds"] == ROUNDS
    assert st["stragglers"] > 0 and st["folded"] > 0
    assert all(2 <= tau <= 2 for tau in st["staleness_hist"])
    assert sum(st["staleness_hist"].values()) == st["folded"]
    assert st["ontime"] + st["stragglers"] + st["dropouts"] \
        == st["dispatched"]
    assert st["t_semisync"] < st["t_sync"]
    assert sorted(port.executor._stale_updates) == sorted(
        (p.dispatch_round, p.model, p.device)
        for p in port.planner.semisync.pending)
    if pipeline:
        assert port.pipeline_stats.as_dict() == ref.pipeline_stats.as_dict()
        # fold rounds suppress speculation (it would read pre-fold params)
        assert port.pipeline_stats.skipped > 0


def test_straggler_pipelined_matches_port_sync(straggled):
    """Pipelined ≡ synchronous within the port, bit for bit: one launch
    path, and the fold guard keeps speculation off pre-fold params."""
    bit_identical(straggled[("port", False)], straggled[("port", True)])


def test_max_staleness_zero_expires_every_straggler():
    spec = dict(straggler=lambda p: straggler(
        p, distribution="lognormal", sigma=2.0, quorum=0.6,
        max_staleness=0, seed=0))
    ref, port = run_pair(spec)
    same_state(ref, port)
    _params_close(ref, port, atol=1e-5)
    st = port.semisync_stats.as_dict()
    assert st["stragglers"] > 0 and st["folded"] == 0
    assert st["expired"] > 0
    assert st["expired"] + len(port.planner.semisync.pending) \
        == st["stragglers"]
    # the buffer holds exactly the stragglers still in flight
    assert sorted(port.executor._stale_updates) == sorted(
        (p.dispatch_round, p.model, p.device)
        for p in port.planner.semisync.pending)


def test_scripted_dropout_never_arrives():
    victim = 3
    drops = tuple((t, victim) for t in range(1, ROUNDS + 1))
    spec = dict(straggler=lambda p: straggler(p, zero=True, dropouts=drops))
    ref, port = run_pair(spec)
    same_state(ref, port)
    _params_close(ref, port, atol=1e-5)
    st = port.semisync_stats.as_dict()
    assert st["dropouts"] > 0
    assert st["folded"] == 0 and st["stragglers"] == 0
    assert st["dropouts"] + st["ontime"] == st["dispatched"]


@pytest.mark.parametrize("server", ["fedcd", "fedavg"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_total_dropout_round_dispatches_cleanly(server, pipeline):
    """dropout_rate=1: no pair ever arrives and nothing aggregates, yet
    every round evaluates (FedCD: train nothing, eval; FedAvg:
    ``_dispatch_eval_only``) and the run completes like the
    reference's."""
    spec = dict(pipeline=pipeline, straggler=lambda p: straggler(
        p, distribution="zero", dropout_rate=1.0))
    ref, port = run_pair(spec, 3, server=server)
    st = port.semisync_stats.as_dict()
    assert st["dropouts"] == st["dispatched"] > 0
    assert st["ontime"] == 0 and st["folded"] == 0
    assert len(port.metrics) == 3
    assert all(np.isfinite(m.test_acc).all() for m in port.metrics)
    if server == "fedcd":
        same_state(ref, port)
        _params_close(ref, port, atol=0.0)   # nothing ever trained in
    else:
        fedavg_same(ref, port)
        _, tp = _init()
        for k, v in tp.items():               # the global model never moved
            assert torch.equal(port.params[k], v)


def test_fedavg_straggler_matches_reference():
    spec = dict(straggler=lambda p: straggler(p, **STRAGGLER))
    ref, port = run_pair(spec, 6, server="fedavg")
    st = port.semisync_stats.as_dict()
    assert st["stragglers"] > 0 and st["folded"] > 0
    assert st["t_semisync"] < st["t_sync"]
    fedavg_same(ref, port, atol=1e-5)
    piped = make("port", dict(spec, pipeline=True), server="fedavg")
    piped.run(6)
    fedavg_same(ref, piped, atol=1e-5)
    for k, v in port.params.items():
        assert torch.equal(v, piped.params[k])
    assert piped.pipeline_stats.skipped > 0


def test_quantized_straggler_matches_reference():
    """Under int8 transport each fold is a transport roundtrip, as the
    reference's ``_maybe_compress``: one int8 step."""
    spec = dict(straggler=lambda p: straggler(p, **STRAGGLER))
    ref, port = run_pair(spec, 6, quantize_bits=8)
    _discrete_state_equal(ref, port)
    assert port.semisync_stats.as_dict() == ref.semisync_stats.as_dict()
    assert port.semisync_stats.folded > 0
    _params_close(ref, port, atol=STEP)


# -- the pieces: fold, harvest, coordinator ----------------------------------

@pytest.mark.parametrize("mass", [0.0, 0.37, 2.5])
def test_blend_stale_matches_reference_bitwise(mass):
    rng = np.random.default_rng(5)
    shapes = {"w": (7, 3), "b": (3,), "c": (2, 2, 5)}
    cur = {k: rng.normal(size=s).astype(np.float32)
           for k, s in shapes.items()}
    ups = [(float(w), {k: rng.normal(size=s).astype(np.float32)
                       for k, s in shapes.items()})
           for w in rng.uniform(0.01, 0.4, 3)]
    ref = j_blend(cur, mass, ups)
    got = _blend_stale({k: torch.from_numpy(v) for k, v in cur.items()},
                       mass, [(w, {k: torch.from_numpy(v)
                                   for k, v in t.items()})
                              for w, t in ups])
    for k in shapes:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_harvest_addresses_rows_by_model_and_device():
    """A repaired speculation is a superset batch in its own column
    order: harvest finds each straggler's row by (model, device), and the
    buffered rows are copies, untouched by later writes to the batch."""
    meta = TrainMeta(pair_model=[1, 0, 0, 1, 2], pair_device=[4, 2, 5, 0, 3],
                     b_pad=8)
    trained = {"w": torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3),
               "b": torch.arange(8, dtype=torch.float32)}
    plan = RoundPlan(round=4, participating=np.ones(6, bool),
                     perms=np.zeros((6, 1, 1), np.int32),
                     scores=np.ones((6, 3), np.float32), live=[0, 1],
                     agg_models=[0, 1], pair_model=[0, 0, 1, 1],
                     pair_device=[2, 5, 0, 4], transfers=8, val_stale=[],
                     test_stale=[], straggler_pairs=[1, 2])
    buf = {}
    _harvest_rows(buf, plan, trained, meta)
    assert sorted(buf) == [(4, 0, 5), (4, 1, 0)]
    want = {(4, 0, 5): 2, (4, 1, 0): 3}           # their batch columns
    snapshot = {k: {n: v.clone() for n, v in t.items()}
                for k, t in buf.items()}
    for name in trained:
        trained[name].add_(100.0)
    for key, col in want.items():
        for name, v in buf[key].items():
            assert torch.equal(v, snapshot[key][name])
            assert torch.equal(v, trained[name][col] - 100.0)


def test_coordinator_plans_match_reference():
    """Six planned rounds of the heavy-tail model over one score state:
    every plan field, the buffer and the accounting equal the
    reference's, and ``state_dict`` round-trips."""
    plans, coords = {}, {}
    for pkg, planner_cls in (("ref", JPlanner), ("port", TPlanner)):
        state, reg, (part, perms), scores = _planner_inputs(pkg)
        n = state.active.shape[0]
        planner = planner_cls(_tcfg(_small_setup()[0]),
                              straggler=straggler(pkg, **STRAGGLER),
                              n_devices=n)
        rng = np.random.default_rng(11)
        plans[pkg] = []
        for t in range(1, 7):
            part = rng.uniform(0, 1, n) < 0.6
            plans[pkg].append(planner.build(t, (part, perms), scores,
                                            state, reg))
        coords[pkg] = planner.semisync
    fields = PLAN_FIELDS + ("straggler_pairs", "dropped_pairs",
                            "fold_drops", "round_time", "sync_time")
    for ref, port in zip(plans["ref"], plans["port"]):
        for name in fields:
            assert getattr(port, name) == getattr(ref, name), name
        assert ({m: (mass, [dataclasses.astuple(e) for e in es])
                 for m, (mass, es) in port.folds.items()}
                == {m: (mass, [dataclasses.astuple(e) for e in es])
                    for m, (mass, es) in ref.folds.items()})
        assert port.changed_models() == ref.changed_models()
        assert port.semisync_work() == ref.semisync_work()
        np.testing.assert_array_equal(port.scores, ref.scores)
    ref, port = coords["ref"], coords["port"]
    assert port.state_dict() == ref.state_dict()
    assert port.stats.stragglers > 0 and port.stats.folded > 0
    again = TPlanner(_tcfg(_small_setup()[0]),
                     straggler=straggler("port", **STRAGGLER)).semisync
    again.load_state(port.state_dict())
    assert again.state_dict() == port.state_dict()
    port.on_clones([(0, 5)])
    assert port.mass[5] == port.mass[0]


def test_folds_route_through_the_transport(monkeypatch):
    """Under int8 transport every fold that blends is one
    ``roundtrip_rows`` call (on the card one launch of each transport
    kernel), beside one per finish and one per clone; eq 1 stays one
    grouped call per aggregating round."""
    counts = {"agg": 0, "roundtrip": 0}
    real_agg, real_rt = twops.multi_weighted_agg_group, tqz.roundtrip_rows

    def agg(*a):
        counts["agg"] += 1
        return real_agg(*a)

    def rt(stacked, bits=8):
        counts["roundtrip"] += 1
        return real_rt(stacked, bits)
    monkeypatch.setattr(twops, "multi_weighted_agg_group", agg)
    monkeypatch.setattr(tqz, "roundtrip_rows", rt)
    srv = make("port", dict(straggler=lambda p: straggler(p, **STRAGGLER)),
               quantize_bits=8)
    folds = aggs = 0
    real_launch = srv.executor.launch

    def launch(plan):
        nonlocal folds, aggs
        folds += len(plan.folds)
        aggs += bool(plan.agg_models)
        real_launch(plan)
    srv.executor.launch = launch
    srv.run(6)
    clones = len(srv.registry.entries) - 1       # one roundtrip each
    assert folds > 0
    assert counts["agg"] == aggs
    assert counts["roundtrip"] == aggs + folds + clones


# -- the mesh tiers (``tests/test_semisync_equivalence.py:135-151, 203``) ---

def _mesh(sm, sd):
    from repro_torch.launch.mesh import make_launch_mesh
    return dict(model_shards=sm, data_shards=sd,
                mesh=lambda pkg: make_launch_mesh(
                    sm, sd, devices=["cpu"] * (sm * sd)))


@pytest.mark.parametrize("shape,pipeline", [((2, 1), False),
                                            ((2, 2), True)],
                         ids=["2x1", "2x2-pipeline"])
def test_straggler_trajectory_engine_independent_sharded(straggled, shape,
                                                         pipeline):
    """The semi-sync trajectory on a mesh — harvests read out of per-cell
    blocks, folds written into their model's shard — is the reference's
    fused one, stats included."""
    port = make("port", dict(_mesh(*shape), pipeline=pipeline,
                             straggler=lambda p: straggler(p, **STRAGGLER)))
    port.run(ROUNDS)
    ref = straggled[("ref", False)]
    same_state(ref, port, acc_atol=1e-6)
    _params_close(ref, port, atol=1e-5)
    assert port.semisync_stats.folded > 0


@pytest.mark.parametrize("shape", [(2, 2)], ids=["2x2"])
def test_fedavg_straggler_engine_independent_sharded(shape):
    kw = dict(straggler=lambda p: straggler(p, **STRAGGLER))
    ref = make("ref", kw, server="fedavg")
    ref.run(6)
    port = make("port", dict(_mesh(*shape), **kw), server="fedavg")
    port.run(6)
    assert port.semisync_stats.folded > 0
    fedavg_same(ref, port, atol=1e-5)
