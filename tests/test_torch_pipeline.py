"""The port's pipelined dispatch (``+pipeline``: split train / finish with
cross-round speculation) and holder-only validation scoring
(``+sparse:<x>``) against the reference's, on the CPU, in the setup of
``tests/test_engine_equivalence.py::_small_setup`` (MLP, 8 devices,
milestones 2/5), from the reference's initial params and the same seeded
host streams. The cases are those of
``tests/test_pipelined_equivalence.py``, each run through both packages.

Bars (ROADMAP):
* unquantized, 8 rounds: per-round metrics (all but ``wall_s``), live
  ids, genealogy, active matrix, score history and preferred models
  exact; params to atol=1e-5 (float32, different reduction order);
* int8 transport, 5 rounds: discrete state exact, params within one int8
  step (``test_torch_slice.STEP``);
* FedAvg, 4 rounds: accuracies exact, params to atol=1e-5;
* the speculation accounting (``pipeline_stats.as_dict()``) and the
  planner's ``sparse_rounds`` equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fedavg import FedAvgServer as JFedAvg  # noqa: E402
from repro.core.fedcd import FedCDServer as JFedCD  # noqa: E402
from repro.core.plan import EvalHints as JHints  # noqa: E402
from repro.core.plan import RoundPlanner as JPlanner  # noqa: E402
from repro.core.registry import ModelRegistry as JRegistry  # noqa: E402
from repro.core.scores import init_scores as j_init_scores  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.core import quantize as tqz  # noqa: E402
from repro_torch.core.fedavg import FedAvgServer as TFedAvg  # noqa: E402
from repro_torch.core.fedcd import FedCDServer as TFedCD  # noqa: E402
from repro_torch.core.plan import EvalHints as THints  # noqa: E402
from repro_torch.core.plan import RoundPlanner as TPlanner  # noqa: E402
from repro_torch.core.registry import ModelRegistry as TRegistry  # noqa: E402
from repro_torch.core.scores import init_scores as t_init_scores  # noqa: E402
from repro_torch.federated.simulation import make_pair_eval  # noqa: E402
from repro_torch.kernels.weighted_agg import ops as twops  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from test_torch_engines import _init  # noqa: E402
from test_torch_slice import (STEP, _discrete_state_equal,  # noqa: E402
                              _leaves, _params_close, _small_setup, _tcfg)

ROUNDS = 8
# the reference's accounting on this setup (tests/test_pipelined_equivalence)
STATS_8 = dict(speculated=6, hit=3, repaired=2, invalidated=0, discarded=0,
               skipped=2)
STATS_INT8 = dict(speculated=3, hit=3, repaired=0, invalidated=0,
                  discarded=0, skipped=2)
STATS_FEDAVG = dict(speculated=4, hit=3, repaired=0, invalidated=0,
                    discarded=0, skipped=0)
# crossover -> rounds the reference plans holder-only over 8 rounds
SPARSE_ROUNDS = {1.1: 8, 0.9: 2, 0.0: 0}
SPECS = ["fused", "fused+pipeline", "fused+pipeline+sparse:0.9"] + [
    f"fused+sparse:{x}" for x in SPARSE_ROUNDS]


def _ref(cfg, data, spec, jp):
    return JFedCD(cfg, jp, jmlp.mlp_loss, jmlp.mlp_accuracy, data,
                  batch_size=16, spec=spec)


def _port(cfg, data, spec, tp):
    return TFedCD(_tcfg(cfg), tp, tmlp.mlp_loss, tmlp.mlp_accuracy, data,
                  batch_size=16, spec=spec, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """{(package, spec): server} after 8 unquantized rounds."""
    cfg, data = _small_setup()
    jp, tp = _init()
    out = {}
    for spec in SPECS:
        out[("ref", spec)] = _ref(cfg, data, spec, jp)
        out[("port", spec)] = _port(cfg, data, spec, tp)
    for srv in out.values():
        srv.run(ROUNDS)
    return out


def _same_run(a, b, atol=1e-5):
    """Discrete state, per-round metrics and score history exact; params
    to ``atol``. ``a`` may be either package's server, ``b`` is the
    port's."""
    _discrete_state_equal(a, b)
    assert len(a.metrics) == len(b.metrics)
    for ma, mb in zip(a.metrics, b.metrics):
        np.testing.assert_array_equal(ma.test_acc, mb.test_acc)
        np.testing.assert_array_equal(ma.val_acc, mb.val_acc)
        assert ma.score_std == mb.score_std
    np.testing.assert_array_equal(a.state.history, b.state.history)
    _params_close(a, b, atol=atol)


def _port_runs_equal(a, b):
    """Two port runs: the same as ``_same_run``, params bit-equal."""
    _same_run(a, b, atol=0.0)


@pytest.mark.parametrize("spec", ["fused+pipeline",
                                  "fused+pipeline+sparse:0.9"])
def test_pipelined_fedcd_matches_reference(runs, spec):
    _same_run(runs[("ref", spec)], runs[("port", spec)])


@pytest.mark.parametrize("spec", ["fused+pipeline",
                                  "fused+pipeline+sparse:0.9"])
def test_pipeline_stats_match_reference(runs, spec):
    ref, port = runs[("ref", spec)], runs[("port", spec)]
    assert port.pipeline_stats.as_dict() == ref.pipeline_stats.as_dict()
    assert port.pipeline_stats.as_dict() == STATS_8
    assert port.planner.sparse_rounds == ref.planner.sparse_rounds


@pytest.mark.parametrize("spec", ["fused+pipeline",
                                  "fused+pipeline+sparse:0.9"])
def test_pipelined_fedcd_matches_port_sync(runs, spec):
    """Pipelined ≡ synchronous within the port: the split programs run
    the one-call round's code, and a repaired batch's dead pairs weigh 0."""
    _same_run(runs[("port", "fused")], runs[("port", spec)])


@pytest.mark.parametrize("x", list(SPARSE_ROUNDS))
def test_sparse_eval_matches_reference(runs, x):
    spec = f"fused+sparse:{x}"
    ref, port = runs[("ref", spec)], runs[("port", spec)]
    assert ref.planner.sparse_rounds == SPARSE_ROUNDS[x]
    assert port.planner.sparse_rounds == ref.planner.sparse_rounds
    _same_run(ref, port)


@pytest.mark.parametrize("x", list(SPARSE_ROUNDS))
def test_sparse_eval_matches_dense(runs, x):
    """Holder-only scoring reproduces the dense run: every consumed
    (device, model) accuracy is an active pair's."""
    _same_run(runs[("port", "fused")], runs[("port", f"fused+sparse:{x}")])


def test_sparse_crossover_zero_is_the_dense_run(runs):
    """crossover 0 never triggers (density > 0): bit-equal to ``fused``."""
    dense, zero = runs[("port", "fused")], runs[("port", "fused+sparse:0.0")]
    _port_runs_equal(dense, zero)
    for m in dense.registry.live_ids():
        for k, v in dense.registry.params[m].items():
            assert torch.equal(v, zero.registry.params[m][k])


def test_quantized_pipelined_matches_reference():
    cfg, data = _small_setup(quantize_bits=8)
    jp, tp = _init()
    out = {}
    for spec in ("fused", "fused+pipeline"):
        out[("ref", spec)] = _ref(cfg, data, spec, jp)
        out[("port", spec)] = _port(cfg, data, spec, tp)
    for srv in out.values():
        srv.run(5)
    ref, port = out[("ref", "fused+pipeline")], out[("port", "fused+pipeline")]
    _discrete_state_equal(ref, port)
    for mr, mp in zip(ref.metrics, port.metrics):
        # a one-step param flip can flip one of 32 eval examples
        np.testing.assert_allclose(mp.test_acc, mr.test_acc, atol=1 / 16)
    _params_close(ref, port, atol=STEP)
    assert port.pipeline_stats.as_dict() == ref.pipeline_stats.as_dict()
    assert port.pipeline_stats.as_dict() == STATS_INT8
    # and the port's own sync run, which runs the same code
    _port_runs_equal(out[("port", "fused")], port)


def _invalidation_script(make):
    """A clone landing OUTSIDE the milestone path (a direct registry write
    between rounds) rewrites bank rows under a pending speculation."""
    srv = make()
    srv.run_round(1)                 # leaves a speculation for round 2
    row = srv.registry.params[0]
    clone = srv.registry.clone(
        0, 1, ({k: v.clone() for k, v in row.items()}
               if isinstance(srv, TFedCD) else
               {k: np.asarray(v) for k, v in row.items()}))
    srv.state.active[:, clone] = True
    srv.state.alive[clone] = True
    for t in (2, 3):
        srv.run_round(t)
    return srv


def test_forced_invalidation_matches_reference():
    cfg, data = _small_setup()
    cfg = dataclasses.replace(cfg, milestones=())
    jp, tp = _init()
    out = {}
    for spec in ("fused", "fused+pipeline"):
        out[("ref", spec)] = _invalidation_script(
            lambda: _ref(cfg, data, spec, jp))
        out[("port", spec)] = _invalidation_script(
            lambda: _port(cfg, data, spec, tp))
    ref, port = out[("ref", "fused+pipeline")], out[("port", "fused+pipeline")]
    _same_run(ref, port)
    _same_run(out[("port", "fused")], port)
    stats = port.pipeline_stats.as_dict()
    assert stats == ref.pipeline_stats.as_dict()
    assert stats["invalidated"] >= 1      # round 2's speculation was stale


def _extinction_script(make):
    """Mass extinction between rounds: the speculative batch has no
    surviving pair."""
    srv = make()
    srv.run_round(1)                 # leaves a speculation for round 2
    for m in list(srv.registry.live_ids()):
        srv.registry.kill(m, 1)
    srv.state.active[:] = False
    srv.state.alive[:] = False
    assert srv.registry.live_ids() == []
    m = srv.run_round(2)
    assert (m.live_models, m.active_models, m.comm_bytes) == (0, 0, 0)
    srv.run_round(3)                 # still clean with nothing pending
    return srv


def test_extinction_discards_speculation_like_reference():
    cfg, data = _small_setup(quantize_bits=8)
    jp, tp = _init()
    ref = _extinction_script(lambda: _ref(cfg, data, "fused+pipeline", jp))
    port = _extinction_script(lambda: _port(cfg, data, "fused+pipeline", tp))
    _discrete_state_equal(ref, port)
    stats = port.pipeline_stats.as_dict()
    assert stats == ref.pipeline_stats.as_dict()
    # never consumed (no surviving pair) = discarded, not invalidated
    assert stats["discarded"] >= 1 and stats["invalidated"] == 0


def test_pipelined_fedavg_matches_reference():
    cfg, data = _small_setup()
    jp, tp = _init()
    ref = JFedAvg(cfg, jp, jmlp.mlp_loss, jmlp.mlp_accuracy, data,
                  batch_size=16, spec="fused+pipeline")
    ports = {s: TFedAvg(_tcfg(cfg), tp, tmlp.mlp_loss, tmlp.mlp_accuracy,
                        data, batch_size=16, spec=s, device="cpu")
             for s in ("fused", "fused+pipeline")}
    for srv in (ref, *ports.values()):
        srv.run(4)
    port = ports["fused+pipeline"]
    for mr, mp, ms in zip(ref.metrics, port.metrics,
                          ports["fused"].metrics):
        assert mr.comm_bytes == mp.comm_bytes
        np.testing.assert_array_equal(mr.test_acc, mp.test_acc)
        np.testing.assert_array_equal(mr.val_acc, mp.val_acc)
        np.testing.assert_array_equal(ms.test_acc, mp.test_acc)
    for a, (k, b) in zip(_leaves(ref.params), port.params.items()):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=0)
        assert torch.equal(ports["fused"].params[k], b)
    assert port.pipeline_stats.as_dict() == ref.pipeline_stats.as_dict()
    assert port.pipeline_stats.as_dict() == STATS_FEDAVG
    assert ports["fused"].pipeline_stats is None


def _planner_inputs(pkg):
    """One score state, registry (models 0-4 born, 1 and 3 dead) and
    sample, the same in both packages; model 2 has no participating
    holder, so it trains nothing and its cached rows stay fresh."""
    rng = np.random.default_rng(3)
    n, m_cap = 12, 8
    init = j_init_scores if pkg == "ref" else t_init_scores
    state = init(n, m_cap, 3)
    state.history[:] = rng.uniform(0, 1, state.history.shape)
    state.history[rng.uniform(0, 1, state.history.shape) < 0.2] = np.nan
    state.active[:, :5] = rng.uniform(0, 1, (n, 5)) < 0.35
    state.active[:, [1, 3]] = False
    state.alive[:5] = True
    state.alive[[1, 3]] = False
    if pkg == "ref":
        reg = JRegistry.create({"w": np.zeros(2, np.float32)}, m_cap)
    else:
        reg = TRegistry.create({"w": torch.zeros(2)}, m_cap)
    for m in range(1, 5):
        reg.clone(0, m, reg.params[0])
    for m in (1, 3):
        reg.kill(m, 4)
    participating = rng.uniform(0, 1, n) < 0.5
    participating[state.active[:, 2]] = False     # model 2 does not train
    perms = rng.integers(0, 64, (n, 4, 16)).astype(np.int32)
    scores = rng.uniform(0, 1, (n, m_cap)).astype(np.float32)
    return state, reg, (participating, perms), scores


PLAN_FIELDS = ("round", "live", "agg_models", "pair_model", "pair_device",
               "transfers", "val_stale", "test_stale", "sparse_val",
               "val_pair_model", "val_pair_device", "clone_milestone",
               "speculative", "churn_next", "fold_next")


@pytest.mark.parametrize("sparse", [None, 0.0, 0.3, 0.5, 1.1])
@pytest.mark.parametrize("hinted", [False, True])
def test_planner_matches_reference(sparse, hinted):
    plans, counts = {}, {}
    for pkg, (planner_cls, hints_cls) in {
            "ref": (JPlanner, JHints), "port": (TPlanner, THints)}.items():
        state, reg, sample, scores = _planner_inputs(pkg)
        planner = planner_cls(_tcfg(_small_setup()[0]), sparse_eval=sparse)
        hints = hints_cls({0, 2}, {0}, [0, 4]) if hinted else None
        plans[pkg] = [planner.build(5, sample, scores, state, reg, hints),
                      planner.build_speculative(6, sample, state, reg)]
        counts[pkg] = planner.sparse_rounds
    assert counts["port"] == counts["ref"]
    for ref, port in zip(plans["ref"], plans["port"]):
        for name in PLAN_FIELDS:
            assert getattr(port, name) == getattr(ref, name), name
        np.testing.assert_array_equal(port.scores, ref.scores)
        np.testing.assert_array_equal(port.perms, ref.perms)


def test_pair_eval_groups_by_model_and_keeps_pair_order():
    """``make_pair_eval`` equals the dense eval matrix read at each pair,
    in pair order, whatever order the pairs come in."""
    _, data = _small_setup()
    _, tp = _init()
    stacked = {k: torch.stack([v, v * 0.5, -v]) for k, v in tp.items()}
    xs, ys = (torch.as_tensor(a) for a in data["val"])
    xs = xs.float()
    m_idx = np.array([2, 0, 2, 1, 0, 2], np.int32)
    d_idx = np.array([5, 1, 0, 7, 3, 5], np.int32)
    got = make_pair_eval(tmlp.mlp_accuracy)(stacked, m_idx, d_idx, xs, ys)
    dense = torch.stack([torch.func.vmap(
        tmlp.mlp_accuracy, in_dims=(None, 0, 0))(
            {k: v[m] for k, v in stacked.items()}, xs, ys)
        for m in range(3)])
    assert torch.equal(got, dense[m_idx, d_idx])
    assert make_pair_eval(tmlp.mlp_accuracy)(
        stacked, [], [], xs, ys).shape == (0,)


def test_pipelined_rounds_route_through_the_kernel_wrappers(monkeypatch):
    """Each pipelined round makes one grouped eq-1 call and one transport
    roundtrip (its finish; clones add their own roundtrips): the same
    kernel calls as the one-call round. (On CUDA tensors each grouped call
    is one launch.)"""
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
    cfg, data = _small_setup(quantize_bits=8)
    _, tp = _init()
    seen = {}
    for spec in ("fused", "fused+pipeline", "fused+pipeline+sparse:1.1"):
        counts.update(agg=0, roundtrip=0)
        _port(cfg, data, spec, tp).run(3)
        seen[spec] = dict(counts)
    assert seen["fused"]["agg"] == 3
    assert seen["fused+pipeline"] == seen["fused"]
    assert seen["fused+pipeline+sparse:1.1"] == seen["fused"]


# -- the mesh tiers (``tests/test_pipelined_equivalence.py:104, 222``) ------

MESH_SHAPES = [(1, 1), (2, 1), (4, 1)]


def _mesh_spec(shape, **kw):
    from repro_torch.launch.mesh import make_launch_mesh
    sm, sd = shape
    return dict(model_shards=sm, data_shards=sd,
                mesh=make_launch_mesh(sm, sd, devices=["cpu"] * (sm * sd)),
                **kw)


def _port_spec_run(spec_kw, rounds=ROUNDS, cfg=None, bits=0):
    from repro_torch.core.spec import EngineSpec
    base, data = _small_setup(quantize_bits=bits)
    srv = _port(cfg or base, data, EngineSpec(**spec_kw), _init()[1])
    srv.run(rounds)
    return srv


@pytest.mark.parametrize("shape", MESH_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pipelined_sharded_matches_sync(runs, shape):
    """``sharded@SxD+pipeline`` walks the reference's synchronous fused
    trajectory, with the reference's speculation accounting: the
    sharded executors inherit launch, speculation and repair."""
    from test_torch_semisync import same_state
    pip = _port_spec_run(_mesh_spec(shape, pipeline=True))
    ref = runs[("ref", "fused")]
    same_state(ref, pip, acc_atol=1e-6)
    _params_close(ref, pip, atol=1e-5)
    assert pip.pipeline_stats.as_dict() == STATS_8 == \
        runs[("ref", "fused+pipeline")].pipeline_stats.as_dict()


@pytest.mark.parametrize("shape,x", [((2, 1), 1.1), ((2, 2), 0.9)],
                         ids=["2x1-1.1", "2x2-0.9"])
def test_sparse_eval_matches_dense_sharded(runs, shape, x):
    """Holder-only scoring on the mesh (pairs bucket per owning cell)
    reproduces the reference's dense run, on the same rounds as the
    reference's sparse one."""
    from test_torch_semisync import same_state
    sp = _port_spec_run(_mesh_spec(shape, sparse_eval=x))
    same_state(runs[("ref", "fused")], sp, acc_atol=1e-6)
    _params_close(runs[("ref", "fused")], sp, atol=1e-5)
    assert sp.planner.sparse_rounds == SPARSE_ROUNDS[x]


def test_forced_invalidation_on_a_mesh_matches_reference():
    """A clone written between rounds lands on another shard under a
    pending speculation: the bank version moves and the speculation is
    retrained, as in the reference's fused run."""
    cfg, data = _small_setup()
    cfg = dataclasses.replace(cfg, milestones=())
    jp, tp = _init()
    ref = _invalidation_script(lambda: _ref(cfg, data, "fused+pipeline", jp))

    def port():
        from repro_torch.core.spec import EngineSpec
        return _port(cfg, data, EngineSpec(**_mesh_spec((2, 1),
                                                        pipeline=True)), tp)
    srv = _invalidation_script(port)
    from test_torch_semisync import same_state
    same_state(ref, srv, acc_atol=1e-6)
    _params_close(ref, srv, atol=1e-5)
    assert srv.pipeline_stats.as_dict() == ref.pipeline_stats.as_dict()
    assert srv.pipeline_stats.invalidated >= 1
    assert srv.registry.params.shard_of(1) == 1    # the clone's shard


@pytest.mark.parametrize("shape", [(2, 2)], ids=["2x2"])
def test_pipelined_sharded_fedavg_matches_reference(shape):
    from test_torch_semisync import fedavg_same, make
    ref = make("ref", dict(pipeline=True), server="fedavg")
    ref.run(4)
    port = make("port", _mesh_spec(shape, pipeline=True), server="fedavg")
    port.run(4)
    fedavg_same(ref, port, atol=1e-6)
    assert port.pipeline_stats.as_dict() == STATS_FEDAVG
