"""The port's mesh-sharded fused plane (``sharded@S``: the bank's rows and
the work pairs bucket per owning model shard of a launch mesh) against
the reference's, on the CPU, in the setup of
``tests/test_engine_equivalence.py::_small_setup`` (MLP, 8 devices,
milestones 2/5). The cases are those of
``tests/test_sharded_equivalence.py``, each run through both packages.

The port's mesh places several cells on one device
(``make_launch_mesh(S, 1, devices=["cpu"] * S)``), so its 2- and 4-shard
tiers run here; the reference's need
``--xla_force_host_platform_device_count``, so they are held against the
reference's single-device ``fused`` run, at the reference's own bars
(discrete state exact, params ``atol=rtol=1e-5``, int8 within
``2/127``). The one-shard tier meets the reference's ``sharded@1`` on its
one-device mesh (params ``1e-5``, int8 one step). One subprocess tier
runs the reference on four forced host devices and holds the port's
placement (``row_of``, migrations, load EWMAs) to it exactly; the
reference's round-4 checkpoints of those runs resume on the port's mesh
of the same shape with their placement restored verbatim. Cells apart on
two CPU device objects run the per-cell paths and the copies between
devices.

Also pinned: the host bucketing (``shard_rows``, ``shard_work_batch``,
``shard_eval_pairs``, ``shard_pairs_2d``, ``shard_eval_pairs_2d``) equal
to the reference's over a seeded sweep; both packages' banks driven
through one placement / migration / rebalance sequence to the same
``row_of`` and EWMA; the launch mesh's placement rules.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.registry import StackedParamBank as JBank  # noqa: E402
from repro.federated import simulation as jsim  # noqa: E402
from repro.launch.mesh import make_model_mesh as j_model_mesh  # noqa: E402
from repro_torch.core.registry import StackedParamBank as TBank  # noqa: E402
from repro_torch.core.spec import EngineSpec as TSpec  # noqa: E402
from repro_torch.federated import simulation as tsim  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import (LaunchMesh, make_host_mesh,  # noqa: E402
                                     make_launch_mesh, make_model_mesh)
from test_torch_semisync import fedavg_same, make, same_state  # noqa: E402
from test_torch_slice import (STEP, _discrete_state_equal,  # noqa: E402
                              _params_close)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The MLP tiers are tiny: one intra-op thread runs them about as
    fast and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUNDS = 8
SHARDS = (1, 2, 4)


def cpu_mesh(model, data=1):
    return make_launch_mesh(model, data, devices=["cpu"] * (model * data))


def mesh_kw(model, data=1):
    """EngineSpec fields of a ``model x data`` mesh, both packages: the
    port's cells all on the CPU; the reference's one-cell mesh (its only
    runnable one here)."""
    def mesh(pkg):
        if pkg == "ref":
            assert (model, data) == (1, 1)
            return j_model_mesh(1)
        return cpu_mesh(model, data)
    return dict(model_shards=model, data_shards=data, mesh=mesh)


def port_run(spec_kw, rounds=ROUNDS, **kw):
    srv = make("port", spec_kw, **kw)
    srv.run(rounds)
    return srv


@pytest.fixture(scope="module")
def fused_ref():
    srv = make("ref", {})
    srv.run(ROUNDS)
    return srv


@pytest.fixture(scope="module")
def quantized_ref():
    srv = make("ref", {}, quantize_bits=8)
    srv.run(5)
    return srv


def _quantized_close(ref, port):
    _discrete_state_equal(ref, port)
    for mr, mp in zip(ref.metrics, port.metrics):
        np.testing.assert_allclose(mp.test_acc, mr.test_acc, atol=1 / 16)
    _params_close(ref, port, atol=2 * STEP)


# -- the host bucketing, copied as is --------------------------------------

def _sweep(seed):
    """Seeded bucketing inputs with empty shards/cells among them."""
    rng = np.random.default_rng(seed)
    s_m, s_d = int(rng.integers(1, 5)), int(rng.integers(1, 4))
    rps_m, rps_d = int(rng.integers(1, 5)), int(rng.integers(1, 6))
    n = int(rng.integers(1, 3 * s_m * rps_m + 1))
    # a model shard or two left out: empty buckets
    allowed = [r for r in range(s_m * rps_m)
               if (r // rps_m) % 3 != seed % 3] or [0]
    mrows = rng.choice(allowed, n).tolist()
    drows = rng.integers(0, s_d * rps_d, n).tolist()
    perms = [rng.integers(0, 9, (3, 2)).astype(np.int32) for _ in range(n)]
    return s_m, s_d, rps_m, rps_d, mrows, drows, perms


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x == y


@pytest.mark.parametrize("seed", range(12))
def test_bucketing_equals_the_reference(seed):
    s_m, s_d, rps_m, rps_d, mrows, drows, perms = _sweep(seed)
    uniq = sorted(set(mrows))
    for minimum in (1, 2, 8):
        _same(tsim.shard_rows(uniq, rps_m, s_m, minimum),
              jsim.shard_rows(uniq, rps_m, s_m, minimum))
        _same(tsim.shard_rows([], rps_m, s_m, minimum),
              jsim.shard_rows([], rps_m, s_m, minimum))
        _same(tsim.shard_work_batch(mrows, drows, perms, rps_m, s_m,
                                    minimum),
              jsim.shard_work_batch(mrows, drows, perms, rps_m, s_m,
                                    minimum))
        _same(tsim.shard_eval_pairs(mrows, drows, rps_m, s_m, minimum),
              jsim.shard_eval_pairs(mrows, drows, rps_m, s_m, minimum))
        _same(tsim.shard_pairs_2d(mrows, drows, perms, rps_m, s_m, rps_d,
                                  s_d, minimum),
              jsim.shard_pairs_2d(mrows, drows, perms, rps_m, s_m, rps_d,
                                  s_d, minimum))
        _same(tsim.shard_eval_pairs_2d(mrows, drows, rps_m, s_m, rps_d, s_d,
                                       minimum),
              jsim.shard_eval_pairs_2d(mrows, drows, rps_m, s_m, rps_d, s_d,
                                       minimum))


# -- the bank's placement, migration and rebalance -------------------------

def _bank_pair(n_shards, m_cap=16):
    return (JBank(m_cap, {"w": np.zeros(2, np.float32)}, n_shards=n_shards),
            TBank(m_cap, {"w": torch.zeros(2)}, n_shards=n_shards))


def _same_bank(j, t):
    assert t.row_of == j.row_of
    assert t._used_rows == j._used_rows
    np.testing.assert_array_equal(t.load_ewma, j.load_ewma)
    assert t.version == j.version
    for m in j.row_of:
        if m in j:
            np.testing.assert_array_equal(t[m]["w"].numpy(),
                                          np.asarray(j[m]["w"]))


def test_bank_placement_migration_rebalance_equal_the_reference():
    """One sequence of writes, pair loads, deletions, migrations and
    rebalances through both packages' 4-shard banks: the same rows, the
    same EWMA, the same moves."""
    j, t = _bank_pair(4)
    loads = [[12.0, 0.0, 4.0, 4.0], [0.0, 0.0, 0.0, 0.0],
             [3.0, 3.0, 3.0, 3.0], [12.0, 1.0, 1.0, 1.0]]
    for m in range(8):
        j[m] = {"w": np.full(2, m, np.float32)}
        t[m] = {"w": torch.full((2,), float(m))}
    _same_bank(j, t)
    for step, load in enumerate(loads * 3):
        j.note_pair_load(load)
        t.note_pair_load(load)
        m = 8 + step // 2
        if step % 2 == 0 and m < 16:
            j[m] = {"w": np.full(2, m, np.float32)}
            t[m] = {"w": torch.full((2,), float(m))}
        if step == 3:
            j.pop(1), t.pop(1)
        if step == 5:
            dest = (j.shard_of(0) + 1) % 4
            if any(r not in j._used_rows
                   for r in range(dest * 4, dest * 4 + 4)):
                assert t.migrate(0, dest) == j.migrate(0, dest)
        assert t.rebalance(1.3) == j.rebalance(1.3)
        _same_bank(j, t)
    # the sequence moved rows and placed them away from hot shards
    assert any(r != m for m, r in t.row_of.items())


def test_row_placement_balances_shards():
    """``test_sharded_equivalence.py::test_row_placement_balances_shards``
    through both packages."""
    for n_shards in (4, 1):
        j, t = _bank_pair(n_shards)
        for m in range(12):
            j[m] = {"w": np.full(2, m, np.float32)}
            t[m] = {"w": torch.full((2,), float(m))}
        _same_bank(j, t)
        if n_shards == 4:
            per = [sum(1 for m in range(12) if t.row_of[m] // 4 == s)
                   for s in range(4)]
            assert per == [3, 3, 3, 3]
            for b in (j, t):
                b.pop(1), b.pop(5)
            j[12] = {"w": np.zeros(2, np.float32)}
            t[12] = {"w": torch.zeros(2)}
            assert t.row_of[12] // 4 == 1
        else:
            assert [t.row_of[m] for m in range(12)] == list(range(12))
        _same_bank(j, t)


def test_work_aware_placement_follows_pair_load():
    """``test_pipelined_equivalence.py::test_work_aware_placement_
    follows_pair_load`` through both packages."""
    j, t = _bank_pair(4)
    for m in range(8):
        j[m] = {"w": np.zeros(2, np.float32)}
        t[m] = {"w": torch.zeros(2)}
    for b in (j, t):
        b.note_pair_load([12.0, 0.0, 4.0, 4.0])
    j[8] = {"w": np.zeros(2, np.float32)}
    t[8] = {"w": torch.zeros(2)}
    assert t.shard_of(8) == j.shard_of(8) == 1
    for _ in range(40):
        for b in (j, t):
            b.note_pair_load([0.0] * 4)
    assert (t.load_ewma == 0).all()
    j[9] = {"w": np.zeros(2, np.float32)}
    t[9] = {"w": torch.zeros(2)}
    assert t.shard_of(9) == j.shard_of(9) != 1
    _same_bank(j, t)


def test_rebalance_triggers_on_skewed_ewma():
    """``test_datamesh_equivalence.py::test_rebalance_triggers_on_skewed_
    ewma`` through both packages: one move off the hot shard, the row's
    params intact, the version bumped, the EWMA reset."""
    j, t = _bank_pair(4, m_cap=8)
    for m in range(6):
        j[m] = {"w": np.full(2, m, np.float32)}
        t[m] = {"w": torch.full((2,), float(m))}
    for _ in range(4):
        for b in (j, t):
            b.note_pair_load([12.0, 1.0, 1.0, 1.0])
    v0 = t.version
    moves = t.rebalance(threshold=2.0)
    assert moves == j.rebalance(threshold=2.0)
    assert len(moves) == 1 and moves[0][1] == 0
    m, _, dst = moves[0]
    assert t.shard_of(m) == dst and t.version == v0 + 1
    assert torch.equal(t[m]["w"], torch.full((2,), float(m)))
    assert (t.load_ewma == 0).all() and t.rebalance(2.0) == []
    _same_bank(j, t)


def test_bank_blocks_are_views_of_one_tensor_on_one_device():
    """Cells sharing a device share one tensor: each shard's block is a
    view of the (m_cap, ...) bank, and a cell reads the block itself."""
    bank = TBank(8, {"w": torch.zeros(3)}, n_shards=4,
                 devices=[torch.device("cpu")] * 4)
    bank[5] = {"w": torch.ones(3)}
    tree = bank.tree["w"]
    for s in range(4):
        blk = bank.block(s)["w"]
        assert blk.data_ptr() == tree[2 * s].data_ptr()
        assert bank.resident(s, torch.device("cpu")) is bank.block(s)
    assert torch.equal(tree[bank.row_of[5]], torch.ones(3))


# -- the launch mesh --------------------------------------------------------

def test_launch_mesh_places_cells_and_never_shrinks(monkeypatch):
    mesh = make_launch_mesh(2, 3, devices=["cpu"] * 6)
    assert mesh.shape == {"model": 2, "data": 3}
    assert mesh.device(1, 2) == torch.device("cpu")
    assert sharding.bank_devices(mesh) == [torch.device("cpu")] * 2
    assert sharding.data_bank_devices(mesh) == [torch.device("cpu")] * 3
    assert make_model_mesh(4, devices=["cpu"] * 4).shape == \
        {"model": 4, "data": 1}
    assert make_host_mesh(data=2, model=2).shape == {"model": 2, "data": 2}
    with pytest.raises(ValueError, match="needs 4 devices"):
        LaunchMesh(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError):
        LaunchMesh(0, 1, [])
    # without devices: CUDA devices only, and too few raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA devices, found 0"):
        make_launch_mesh(4, 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        TSpec.parse("sharded@2x2").resolve_mesh()
    assert TSpec.parse("fused").resolve_mesh() is None
    # a CPU request puts every cell on the CPU
    got = TSpec.parse("sharded@2x2").resolve_mesh("cpu")
    assert got.devices == [torch.device("cpu")] * 4


def test_rows_per_shard_raise_the_reference_errors():
    from repro.launch.sharding import bank_rows_per_shard as j_rows
    mesh = cpu_mesh(3)
    assert sharding.bank_rows_per_shard(9, mesh) == 3
    assert sharding.data_rows_per_shard(6, cpu_mesh(1, 3)) == 2
    with pytest.raises(ValueError, match="max_models=8"):
        sharding.bank_rows_per_shard(8, mesh)
    with pytest.raises(ValueError, match="capacity=7"):
        sharding.data_rows_per_shard(7, cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="max_models=8"):
        j_rows(8, type("M", (), {"shape": {"model": 3}})())


def test_server_rejects_indivisible_bank_and_foreign_device():
    with pytest.raises(ValueError, match="max_models=8"):
        make("port", mesh_kw(3))
    with pytest.raises(ValueError, match="does not match"):
        make("port", dict(model_shards=2, mesh=lambda p: cpu_mesh(4)))
    spec = TSpec(model_shards=2, mesh=cpu_mesh(2))
    from test_torch_engines import _init
    from test_torch_slice import _small_setup, _tcfg
    from repro_torch.core.fedcd import FedCDServer
    from repro_torch.models import mlp as tmlp
    cfg, data = _small_setup()
    srv = FedCDServer(_tcfg(cfg), _init()[1], tmlp.mlp_loss,
                      tmlp.mlp_accuracy, data, batch_size=16, spec=spec,
                      device="cpu")
    assert srv.device == torch.device("cpu")
    with pytest.raises(ValueError, match="cells"):
        FedCDServer(_tcfg(cfg), _init()[1], tmlp.mlp_loss,
                    tmlp.mlp_accuracy, data, batch_size=16, spec=spec,
                    device="meta")


# -- the engine tiers -------------------------------------------------------

@pytest.fixture(scope="module", params=SHARDS)
def sharded(request):
    return request.param, port_run(mesh_kw(request.param))


def test_discrete_state_matches_exactly(fused_ref, sharded):
    n, srv = sharded
    assert type(srv.executor).__name__ == "ShardedExecutor"
    assert srv.registry.params.n_shards == n
    same_state(fused_ref, srv, acc_atol=1e-6)


def test_params_match_to_reduction_order(fused_ref, sharded):
    _, srv = sharded
    for m in fused_ref.registry.live_ids():
        for a, b in zip(jax_leaves(fused_ref.registry.params[m]),
                        srv.registry.params[m].values()):
            np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-5)


def jax_leaves(tree):
    import jax
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def test_one_shard_equals_the_reference_one_shard_plane():
    """Port ``sharded@1`` on an injected one-cell mesh against the
    reference's ``sharded@1`` on its one-device mesh, both executors the
    sharded plane."""
    ref = make("ref", mesh_kw(1))
    ref.run(ROUNDS)
    port = port_run(mesh_kw(1))
    assert type(ref.executor).__name__ == type(port.executor).__name__
    same_state(ref, port, acc_atol=1e-6)
    _params_close(ref, port, atol=1e-5)
    assert port.registry.params.row_of == ref.registry.params.row_of


def test_one_shard_quantized_equals_the_reference_one_shard_plane():
    ref = make("ref", mesh_kw(1), quantize_bits=8)
    ref.run(5)
    port = port_run(mesh_kw(1), rounds=5, quantize_bits=8)
    _discrete_state_equal(ref, port)
    _params_close(ref, port, atol=STEP)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_quantized_sharded_matches_single(quantized_ref, n_shards):
    srv = port_run(mesh_kw(n_shards), rounds=5, quantize_bits=8)
    _quantized_close(quantized_ref, srv)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_fedavg_sharded_pair_axis_matches(n_shards):
    ref = make("ref", {}, server="fedavg")
    ref.run(4)
    srv = port_run(mesh_kw(n_shards), rounds=4, server="fedavg")
    assert type(srv.executor).__name__ == "FedAvgShardedExecutor"
    fedavg_same(ref, srv, atol=1e-6)


# -- edge cases: extinction, single survivor, cross-shard clones ----------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_extinction_dispatches_cleanly_sharded(n_shards):
    srv = make("port", mesh_kw(n_shards), quantize_bits=8)
    srv.run_round(1)
    for m in list(srv.registry.live_ids()):
        srv.registry.kill(m, 1)
    srv.state.active[:] = False
    srv.state.alive[:] = False
    assert srv.registry.live_ids() == []
    per_model = srv._transport_bytes(1)
    assert per_model > 0 and srv._transport_bytes(0) == 0
    assert srv._transport_bytes(3) == 3 * per_model
    m = srv.run_round(2)                 # every shard empty: no work
    assert (m.live_models, m.active_models, m.comm_bytes) == (0, 0, 0)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_single_survivor_leaves_other_shards_empty(n_shards):
    import dataclasses
    srv = make("port", mesh_kw(n_shards))
    srv.cfg = dataclasses.replace(srv.cfg, milestones=())
    before = {k: v.clone() for k, v in srv.registry.params[0].items()}
    metrics = srv.run(3)
    assert [m.live_models for m in metrics] == [1, 1, 1]
    assert srv.registry.live_ids() == [0]
    assert any(not torch.equal(before[k], v)
               for k, v in srv.registry.params[0].items())
    for leaf in srv.registry.stacked.values():
        assert bool((leaf[1:] == 0).all())


@pytest.mark.parametrize("n_shards", SHARDS)
def test_clone_lands_on_non_owner_shard(n_shards):
    import dataclasses
    srv = make("port", mesh_kw(n_shards))
    rps = srv._rows_per_shard
    row_of = srv.registry.params.row_of
    clone = None
    for _ in range(srv.cfg.max_models - 1):
        parent = {k: v.clone() for k, v in srv.registry.params[0].items()}
        c = srv.registry.clone(0, 0, parent)
        assert c is not None
        srv.state.active[:, c] = True
        srv.state.alive[c] = True
        if row_of[c] // rps != 0:
            clone = c
            break
    if n_shards == 1:
        assert clone is None
        return
    assert clone == 1 and row_of[clone] // rps == 1
    for k, v in srv.registry.params[0].items():
        assert torch.equal(v, srv.registry.params[clone][k])
    srv.cfg = dataclasses.replace(srv.cfg, milestones=())
    m = srv.run_round(1)
    assert clone in srv.registry.live_ids()
    assert m.live_models == len(srv.registry.live_ids())


# -- the reference on four forced host devices: placement exact ------------

REF_RUNS = {
    "sharded@4": dict(model_shards=4),
    "sharded@2+migrate": dict(model_shards=2, migrate_threshold=1.05),
    "sharded@2x2+churn+migrate": dict(model_shards=2, data_shards=2,
                                      migrate_threshold=1.05,
                                      scenario="churn"),
}

_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    sys.path.insert(0, {tests!r})
    from test_torch_semisync import make, churn
    assert jax.device_count() == 4, jax.device_count()
    runs = json.loads({runs!r})
    out = {{}}

    def record(name, srv):
        pb, ex = srv.registry.params, srv.executor
        out[name + "/row_of"] = np.array(sorted(pb.row_of.items()))
        out[name + "/load_ewma"] = pb.load_ewma
        out[name + "/migrations"] = np.array(ex.migrations)
        out[name + "/data_row_of"] = np.array(
            sorted(ex.databank.row_of.items()))
        out[name + "/data_load_ewma"] = ex.databank.load_ewma
        out[name + "/history"] = srv.state.history
        out[name + "/active"] = srv.state.active
        out[name + "/preferred"] = np.stack(
            [m.preferred for m in srv.metrics])
        out[name + "/live"] = np.array(srv.registry.live_ids())
        for m in srv.registry.live_ids():
            for i, a in enumerate(jax.tree.leaves(pb[m])):
                out[f"{{name}}/params/{{m}}/{{i}}"] = np.asarray(a)

    for name, kw in runs.items():
        if kw.get("scenario"):
            kw["scenario"] = churn
        root = {ckpt!r} + "/" + name
        srv = make("ref", dict(kw, save_every=4, checkpoint_dir=root))
        srv.run({rounds})
        record(name, srv)
        # its own resume from round 4, on the same mesh shape
        srv = make("ref", dict(kw, resume_from=root + "/step_000004"))
        srv.run({rounds})
        record(name + "+resumed", srv)
    np.savez({path!r}, **out)
""")


@pytest.fixture(scope="module")
def ref_on_four_devices(tmp_path_factory):
    """The reference's real multi-shard runs, in a process of its own
    (the forced device count must precede jax's start)."""
    root = tmp_path_factory.mktemp("ref4")
    path = str(root / "ref.npz")
    code = _REF_SCRIPT.format(tests=str(ROOT / "tests"),
                              runs=json.dumps(REF_RUNS), rounds=ROUNDS,
                              path=path, ckpt=str(root / "ckpt"))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path)), root / "ckpt"


def _ref_run(ref_on_four_devices, name, resumed=False):
    """The reference's round-8 arrays of run ``name`` (``resumed``: of
    its run resumed from its round-4 checkpoint), and the port's spec
    fields for the same run."""
    from test_torch_semisync import churn
    arrays, _ = ref_on_four_devices
    tag = name + ("+resumed" if resumed else "") + "/"
    ref = {k[len(tag):]: v for k, v in arrays.items() if k.startswith(tag)}
    kw = dict(REF_RUNS[name])
    s, d = kw.pop("model_shards"), kw.pop("data_shards", 1)
    if kw.pop("scenario", None):
        kw["scenario"] = churn
    return ref, dict(mesh_kw(s, d), **kw)


def _same_as_ref_run(ref, port):
    pb, ex = port.registry.params, port.executor
    assert sorted(pb.row_of.items()) == [tuple(r) for r in ref["row_of"]]
    np.testing.assert_array_equal(pb.load_ewma, ref["load_ewma"])
    assert ex.migrations == int(ref["migrations"])
    assert sorted(ex.databank.row_of.items()) == \
        [tuple(r) for r in ref["data_row_of"]]
    np.testing.assert_array_equal(ex.databank.load_ewma,
                                  ref["data_load_ewma"])
    np.testing.assert_array_equal(port.state.history, ref["history"])
    np.testing.assert_array_equal(port.state.active, ref["active"])
    np.testing.assert_array_equal(
        np.stack([m.preferred for m in port.metrics]), ref["preferred"])
    assert port.registry.live_ids() == ref["live"].tolist()
    for m in port.registry.live_ids():
        for i, b in enumerate(port.registry.params[m].values()):
            np.testing.assert_allclose(b.numpy(), ref[f"params/{m}/{i}"],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(REF_RUNS))
def test_placement_equals_the_reference_on_four_devices(
        ref_on_four_devices, name):
    ref, spec_kw = _ref_run(ref_on_four_devices, name)
    port = port_run(spec_kw)
    _same_as_ref_run(ref, port)
    if "migrate" in name:
        assert port.executor.migrations >= 1


@pytest.mark.parametrize("name", sorted(REF_RUNS))
def test_reference_checkpoint_restores_its_placement_verbatim(
        ref_on_four_devices, name):
    """The reference's round-4 checkpoint of its four-device run resumes
    on the port's mesh of the same shape: ``row_of``, used rows and the
    load EWMA from its manifest, verbatim; run to round 8, the port
    then equals the reference's own resumed run (whose data bank, too,
    restarts its pair-load EWMA at the restore)."""
    ref, spec_kw = _ref_run(ref_on_four_devices, name, resumed=True)
    step = ref_on_four_devices[1] / name / "step_000004"
    with open(step / "manifest.json") as f:
        bank = json.load(f)["state"]["bank"]
    port = make("port", dict(spec_kw, resume_from=str(step)))
    pb = port.registry.params
    assert pb.row_of == {int(m): r for m, r in bank["row_of"].items()}
    assert sorted(pb._used_rows) == bank["used_rows"]
    np.testing.assert_array_equal(pb.load_ewma, bank["load_ewma"])
    port.run(ROUNDS)
    _same_as_ref_run(ref, port)


# -- cells on distinct devices -------------------------------------------------

def apart_kw(model, data=1):
    """A mesh whose cells alternate between two CPU device objects
    (``cpu`` and ``cpu:0``): the banks keep a block per owner device and
    a cell reads the blocks it does not own through copies (``.to`` makes
    a real copy between the two), so the per-cell train and eval, the
    data-axis sum and the copies' refresh after every write run here, as
    they would across cards."""
    devices = ["cpu", "cpu:0"] * (model * data // 2)
    return dict(model_shards=model, data_shards=data,
                mesh=lambda pkg: make_launch_mesh(model, data,
                                                  devices=devices))


@pytest.mark.parametrize("shape,variant", [((4, 1), "sparse"),
                                           ((2, 2), "pipeline")],
                         ids=["4x1-sparse", "2x2-pipeline"])
def test_cells_on_distinct_devices_match_the_reference(fused_ref, shape,
                                                       variant):
    extra = {"pipeline": dict(pipeline=True),
             "sparse": dict(sparse_eval=1.1)}[variant]
    srv = port_run(dict(apart_kw(*shape), **extra))
    pb, db = srv.registry.params, srv.executor.databank
    # some block lives apart: the per-cell paths ran
    assert pb._tree is None or db._splits is None
    same_state(fused_ref, srv, acc_atol=1e-6)
    _params_close(fused_ref, srv, atol=1e-5)


def test_cells_on_distinct_devices_quantized(quantized_ref):
    _quantized_close(quantized_ref,
                     port_run(apart_kw(4, 1), rounds=5, quantize_bits=8))


def test_fedavg_cells_on_distinct_devices():
    ref = make("ref", {}, server="fedavg")
    ref.run(4)
    fedavg_same(ref, port_run(apart_kw(2, 2), rounds=4, server="fedavg"),
                atol=1e-6)
