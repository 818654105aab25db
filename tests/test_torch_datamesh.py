"""The port's 2-D (model × data) mesh plane (``sharded@SxD``: the data
bank's rows shard over the mesh's ``data`` axis, work pairs bucket per
mesh cell, eq 1 completes with a sum over the data axis) against the
reference, on the CPU, in the setup of
``tests/test_engine_equivalence.py::_small_setup`` (MLP, 8 devices,
milestones 2/5). The cases are the mesh tiers of
``tests/test_datamesh_equivalence.py``.

The port's cells share the CPU (``make_launch_mesh(S, D, devices=["cpu"]
* (S*D))``), so its ``(1,2)``, ``(2,2)`` and ``(1,4)`` tiers run here and
are held against the reference's single-device ``fused`` run at the
reference's bars: discrete state exact, params ``atol=rtol=1e-5``. The
reference's mesh-only data-bank cases are held to the values its own
tests assert; its meshless ones run through both packages. Row
migration (a forced one, and the ``migrate_threshold`` trigger) and
churn on the mesh are pinned the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.bank import DeviceDataBank as JBank  # noqa: E402
from repro_torch.data.bank import DeviceDataBank as TBank  # noqa: E402
from repro_torch.data.partition import DeviceData  # noqa: E402
from test_torch_churn import script  # noqa: E402
from test_torch_semisync import churn, make, same_state  # noqa: E402
from test_torch_sharded import cpu_mesh, mesh_kw, port_run  # noqa: E402
from test_torch_slice import _params_close  # noqa: E402

ROUNDS = 8
MESHES = ((1, 2), (2, 2), (1, 4))        # (model shards, data shards)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The MLP tiers are tiny: one intra-op thread runs them about as
    fast and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single():
    srv = make("ref", {})
    srv.run(ROUNDS)
    return srv


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def meshed(request):
    sm, sd = request.param
    return request.param, port_run(mesh_kw(sm, sd))


def test_discrete_state_matches_single(single, meshed):
    _, srv = meshed
    assert type(srv.executor).__name__ == "Sharded2DExecutor"
    same_state(single, srv, acc_atol=1e-6)


def test_params_match_to_reduction_order(single, meshed):
    _, srv = meshed
    _params_close(single, srv, atol=1e-5)
    for m in single.registry.live_ids():
        for a, b in zip(single.registry.params[m].values(),
                        srv.registry.params[m].values()):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                       rtol=1e-5)


def test_device_splits_not_replicated(meshed):
    """Each data shard holds ``n_cap / S_data`` rows: the splits are not
    replicated per model shard. Cells sharing the CPU read views of one
    tensor per split."""
    (sm, sd), srv = meshed
    bank = srv.executor.databank
    assert bank.n_shards == sd and bank.rows_per_shard * sd == bank.n_cap
    assert bank.bytes_per_shard() * sd == bank.nbytes()
    for split in ("train", "val", "test"):
        full = bank.splits[split][0]
        for s in range(sd):
            xs, ys = bank.block(s, split)
            assert xs.shape[0] == ys.shape[0] == full.shape[0] // sd
            assert xs.data_ptr() == full[s * bank.rows_per_shard].data_ptr()
            assert bank.resident(s, split, torch.device("cpu"))[0] is xs


def test_sharded2d_executor_feeds_data_pair_load():
    srv = port_run(mesh_kw(1, 2), rounds=2)
    bank = srv.executor.databank
    assert bank.load_ewma.shape == (2,)
    assert bank.load_ewma.sum() > 0


# -- churn on the mesh --------------------------------------------------------

@pytest.fixture(scope="module")
def churn_single():
    srv = make("ref", dict(scenario=churn))
    srv.run(ROUNDS)
    return srv


@pytest.mark.parametrize("shape,variant", [
    ((1, 2), "sync"), ((2, 2), "sync"), ((1, 4), "sync"),
    ((2, 2), "pipeline"), ((1, 4), "sparse")],
    ids=["1x2-sync", "2x2-sync", "1x4-sync", "2x2-pipeline", "1x4-sparse"])
def test_churn_equivalent_across_engines(churn_single, shape, variant):
    """The same churn schedule walks the reference's fused trajectory on
    the 2-D mesh, synchronous, pipelined and with holder-only
    validation scoring."""
    extra = {"sync": {}, "pipeline": dict(pipeline=True),
             "sparse": dict(sparse_eval=1.1)}[variant]
    srv = port_run(dict(mesh_kw(*shape), scenario=churn, **extra))
    same_state(churn_single, srv, acc_atol=1e-6)
    np.testing.assert_array_equal(srv.present, churn_single.present)
    assert srv.executor.databank.present_ids() == \
        churn_single.executor.databank.present_ids()
    _params_close(churn_single, srv, atol=1e-5)


def test_emptied_data_shard_dispatches_cleanly():
    """Every device of data shard 1 of a (1, 2) mesh leaves: its cells get
    all-padding buckets (and are not launched) every round, yet the run
    equals the reference's fused one."""
    def sched(pkg):
        return script(pkg, [("leave", 2, d) for d in range(4, 8)])
    ref = make("ref", dict(scenario=sched))
    ref.run(5)
    srv = port_run(dict(mesh_kw(1, 2), scenario=sched), rounds=5)
    bank = srv.executor.databank
    assert all(bank.shard_of(d) == 0 for d in bank.present_ids())
    same_state(ref, srv, acc_atol=1e-6)
    _params_close(ref, srv, atol=1e-5)


# -- DeviceDataBank placement over data shards -------------------------------

def _toy_data(n0):
    rng = np.random.default_rng(0)
    return {k: (rng.normal(size=(n0, 6, 2)).astype(np.float32),
                rng.integers(0, 3, (n0, 6)).astype(np.int32))
            for k in ("train", "val", "test")}


def _toy_device(rng):
    def split():
        return (rng.normal(size=(6, 2)).astype(np.float32),
                rng.integers(0, 3, 6).astype(np.int32))
    return DeviceData(0, split(), split(), split())


def test_bank_sharded_placement_and_write_routing():
    """``test_datamesh_equivalence.py::test_bank_sharded_placement_and_
    write_routing``'s values: joins balance onto the emptier data shard,
    and each shard's block holds ``n_cap / 2`` rows; a join's row is
    written into its shard's block."""
    rng = np.random.default_rng(3)
    bank = TBank(_toy_data(2), "cpu", n_cap=8, id_cap=20,
                 mesh=cpu_mesh(1, 2))
    d = bank.add(_toy_device(rng))
    assert bank.shard_of(d) == 1
    d2 = bank.add(_toy_device(rng))
    assert bank.shard_of(d2) == 1
    for split in ("train", "val", "test"):
        xs, _ = bank.block(1, split)
        assert xs.shape[0] == bank.splits[split][0].shape[0] // 2
    r = bank.row_of[d2] - bank.rows_per_shard
    assert torch.equal(bank.block(1, "train")[0][r],
                       bank.splits["train"][0][bank.row_of[d2]])


def test_bank_capacity_rounds_up_to_the_data_axis():
    bank = TBank(_toy_data(3), "cpu", n_cap=5, mesh=cpu_mesh(1, 2))
    ref = JBank(_toy_data(3), n_cap=5)
    assert (bank.n_cap, bank.rows_per_shard) == (6, 3)
    assert ref.n_cap == 5                 # meshless: no rounding
    assert bank.splits["val"][0].shape[0] == 6


def test_data_bank_pair_load_ewma_fold_and_reset():
    """``test_datamesh_equivalence.py::test_data_bank_pair_load_ewma_
    fold_and_reset`` through both packages."""
    banks = (JBank(_toy_data(4), n_cap=8, id_cap=12),
             TBank(_toy_data(4), "cpu", n_cap=8, id_cap=12))
    for bank in banks:
        bank.note_pair_load([8.0])
        assert bank.load_ewma[0] == pytest.approx(4.0)
        bank.note_pair_load([0.0])
        assert bank.load_ewma[0] == pytest.approx(2.0)
        for _ in range(40):
            bank.note_pair_load([0.0])
        assert (bank.load_ewma == 0).all()
        bank.note_pair_load([6.0])
        devices = {0: {k: (np.asarray(bank.splits[k][0][0]),
                           np.asarray(bank.splits[k][1][0]))
                       for k in ("train", "val", "test")}}
        bank.restore(devices, next_id=5)
        assert (bank.load_ewma == 0).all()


def test_data_bank_churn_aware_placement_follows_pair_load():
    """``test_datamesh_equivalence.py::test_data_bank_churn_aware_
    placement_follows_pair_load``'s values: joins land on the data shard
    with the lowest observed pair load, fall back to the present count
    once the signal decays, and again under balanced traffic."""
    rng = np.random.default_rng(5)
    bank = TBank(_toy_data(2), "cpu", n_cap=12, id_cap=30,
                 mesh=cpu_mesh(1, 2))
    bank.note_pair_load([0.0, 12.0])
    assert bank.shard_of(bank.add(_toy_device(rng))) == 0
    assert bank.shard_of(bank.add(_toy_device(rng))) == 0
    for _ in range(40):
        bank.note_pair_load([0.0, 0.0])
    assert bank.shard_of(bank.add(_toy_device(rng))) == 1
    bank.note_pair_load([5.0, 5.0])
    assert bank.shard_of(bank.add(_toy_device(rng))) == 1


def test_restore_of_another_layout_re_places_least_loaded():
    """A checkpoint's devices restore onto a 2-shard bank through the
    least-loaded allocator (sorted ids, like joins); a matching layout
    restores ``row_of`` verbatim."""
    bank = TBank(_toy_data(4), "cpu", n_cap=8, id_cap=12,
                 mesh=cpu_mesh(1, 2))
    devices = {d: {k: (np.full((6, 2), d, np.float32),
                       np.full(6, d % 3, np.int32))
                   for k in ("train", "val", "test")} for d in (1, 5, 7)}
    bank.restore(devices, next_id=8)
    assert bank.row_of == {1: 0, 5: 4, 7: 1}
    bank.restore(devices, next_id=8, row_of={1: 3, 5: 7, 7: 4})
    assert bank.row_of == {1: 3, 5: 7, 7: 4}
    np.testing.assert_array_equal(
        bank.block(1, "train")[0][3].numpy(), np.full((6, 2), 5.0))


# -- row migration (work rebalancing) ------------------------------------------

def test_forced_migration_is_discrete_state_identical(single):
    """Migrating a row between rounds is pure layout: the run matches a
    no-migration run, and the reference, in discrete state exactly and
    in params to reduction order."""
    def run(migrate_at=None):
        srv = make("port", mesh_kw(2))
        for t in range(1, ROUNDS + 1):
            srv.run_round(t)
            if migrate_at == t:
                bank = srv.registry.params
                m = max(srv.registry.live_ids())
                dest = 1 - bank.shard_of(m)
                bank.migrate(m, dest)
                assert bank.shard_of(m) == dest
        return srv

    ref, mig = run(), run(migrate_at=3)
    assert ref.registry.params.row_of != mig.registry.params.row_of
    same_state(ref, mig, acc_atol=1e-6)
    _params_close(single, mig, atol=1e-5)
    for m in ref.registry.live_ids():
        for k, v in ref.registry.params[m].items():
            np.testing.assert_allclose(mig.registry.params[m][k].numpy(),
                                       v.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_migrate_threshold_rebalances_with_identical_state(single, shape):
    """``+migrate:1.05`` moves a row off the hotter shard during the run;
    the trajectory is the reference's fused one."""
    srv = port_run(dict(mesh_kw(*shape), migrate_threshold=1.05))
    assert srv.executor.migrations >= 1
    same_state(single, srv, acc_atol=1e-6)
    _params_close(single, srv, atol=1e-5)


def test_churn_with_cells_on_distinct_devices(churn_single):
    """Churn's row writes land in the owner block of their data shard and
    reach the other cells' copies before the next dispatch."""
    from test_torch_sharded import apart_kw
    srv = port_run(dict(apart_kw(2, 2), scenario=churn, pipeline=True))
    assert srv.executor.databank._splits is None
    same_state(churn_single, srv, acc_atol=1e-6)
    _params_close(churn_single, srv, atol=1e-5)
