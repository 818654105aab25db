"""The port's device churn (``EngineSpec(scenario=ChurnSchedule(...))``:
joins, leaves and label drift at round starts, the data bank's slot
reuse, device ids resolved to data rows at dispatch) against the
reference's, on the CPU, in the setup of
``tests/test_engine_equivalence.py::_small_setup`` (MLP, 8 devices,
milestones 2/5). The cases are the one-data-shard churn tiers of
``tests/test_datamesh_equivalence.py`` and its ``DeviceDataBank`` unit
cases, each run through both packages.

Bars (ROADMAP): discrete state (live ids, genealogy, active and alive
matrices, score history, preferred models, presence) and per-round
metrics exactly equal to the reference's; params to atol=1e-5; the
speculation accounting equal; the bank's id → row map equal to the
reference's one-shard bank after the same operations.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.bank import DeviceDataBank as JBank  # noqa: E402
from repro.data.partition import DeviceData as JDeviceData  # noqa: E402
from repro.federated.simulation import \
    draw_round_sample as j_draw  # noqa: E402
from repro_torch.data.bank import DeviceDataBank as TBank  # noqa: E402
from repro_torch.data.partition import DeviceData  # noqa: E402
from repro_torch.federated.simulation import draw_round_sample  # noqa: E402
from test_torch_semisync import (MOD, bit_identical, churn,  # noqa: E402
                                 make, run_pair, same_state)
from test_torch_slice import _params_close, _small_setup  # noqa: E402


def script(pkg, events):
    """A scripted schedule of ``(kind, round, arg...)`` events."""
    mod = MOD[pkg]
    kinds = {"join": mod.DeviceJoin, "leave": mod.DeviceLeave,
             "drift": mod.LabelDrift}
    return mod.ChurnSchedule(
        events=tuple(kinds[k](*a) for k, *a in events),
        n_train=64, n_val=32, n_test=32)


def same_population(ref, port):
    np.testing.assert_array_equal(ref.present, port.present)
    assert ref.n_devices == port.n_devices
    rb, pb = ref.executor.databank, port.executor.databank
    assert pb.row_of == rb.row_of
    assert pb.present_ids() == rb.present_ids()
    assert pb.next_id == rb.next_id


@pytest.fixture(scope="module")
def churned():
    """{(package, variant): server} after 8 rounds of the churn fixture,
    variant one of "fused", "pipeline", "sparse" (``+sparse:1.1``)."""
    variants = {"fused": {}, "pipeline": dict(pipeline=True),
                "sparse": dict(sparse_eval=1.1)}
    out = {}
    for name, kw in variants.items():
        ref, port = run_pair(dict(kw, scenario=churn))
        out[("ref", name)], out[("port", name)] = ref, port
    return out


def test_churn_runs_and_population_moves(churned):
    ref, port = churned[("ref", "fused")], churned[("port", "fused")]
    sched = churn("port")
    joins = sched.total_joins
    leaves = sum(1 for e in sched.events if type(e).__name__ == "DeviceLeave")
    assert joins > 0 and leaves > 0
    assert int(port.present.sum()) == port.cfg.n_devices + joins - leaves
    assert port.n_devices == port.cfg.n_devices + joins
    for d in np.nonzero(~port.present)[0]:
        assert not port.state.active[d].any()
    assert not port.executor.databank.identity_map()   # a slot was reused
    same_population(ref, port)
    same_state(ref, port)
    _params_close(ref, port, atol=1e-5)


@pytest.mark.parametrize("variant", ["pipeline", "sparse"])
def test_churn_variant_matches_reference(churned, variant):
    ref, port = churned[("ref", variant)], churned[("port", variant)]
    same_population(ref, port)
    same_state(ref, port)
    _params_close(ref, port, atol=1e-5)
    if variant == "pipeline":
        assert port.pipeline_stats.as_dict() == ref.pipeline_stats.as_dict()
        assert port.pipeline_stats.skipped > 0      # churn_next guard
    else:
        assert port.planner.sparse_rounds == ref.planner.sparse_rounds > 0


@pytest.mark.parametrize("variant", ["pipeline", "sparse"])
def test_churn_variant_matches_port_fused(churned, variant):
    """The acceptance gate inside the port: the same schedule walks the
    same trajectory on ``fused``, ``fused+pipeline`` and
    ``fused+sparse:1.1``, with bit-equal params."""
    bit_identical(churned[("port", "fused")], churned[("port", variant)])


def test_churn_sparse_val_matches_dense():
    """Holder-only validation under churn resolves device ids to data
    ROWS at dispatch: after a slot reuse id != row."""
    def sched(pkg):
        return script(pkg, [("leave", 2, 0), ("join", 3, 1)])
    dense_ref = make("ref", dict(scenario=sched))
    dense_ref.run(6)
    ref, port = run_pair(dict(scenario=sched, sparse_eval=1.1), 6)
    assert port.planner.sparse_rounds == ref.planner.sparse_rounds > 0
    assert not port.executor.databank.identity_map()
    assert port.executor.databank.row_of[8] == 0
    same_state(ref, port)
    same_state(dense_ref, port)
    _params_close(ref, port, atol=1e-5)


def _extinction_join(pkg):
    cfg, data = _small_setup(quantize_bits=8)
    srv = make(pkg, dict(scenario=lambda p: script(p, [("join", 2, 0)])),
               quantize_bits=8)
    srv.run_round(1)
    for m in list(srv.registry.live_ids()):
        srv.registry.kill(m, 1)
    srv.state.active[:] = False
    srv.state.alive[:] = False
    m = srv.run_round(2)                        # extinction + join
    assert m.live_models == 0
    joined = cfg.n_devices                      # the first join claims id N
    assert srv.present[joined]
    assert not srv.state.active[joined].any()
    assert joined in srv.executor.databank
    return srv


def test_join_during_extinction_round():
    ref, port = _extinction_join("ref"), _extinction_join("port")
    same_population(ref, port)
    same_state(ref, port)


def _leave_mid_round(pkg, pipeline):
    """An UNSCHEDULED departure between rounds 4 and 5 of a device that
    participates in round 5 (no ``churn_next`` hint, so a pipelined run
    has already speculated round 5's training with its pairs)."""
    cfg, data = _small_setup()
    cfg = dataclasses.replace(cfg, milestones=(2,))
    srv = make(pkg, dict(pipeline=pipeline), cfg=cfg)
    for t in range(1, 7):
        srv.run_round(t)
        if t == 4:
            d = int(np.nonzero(srv._prefetch[1][0])[0][0])
            srv.present[d] = False
            srv.state.active[d, :] = False
            srv.state.history[d] = np.nan
            srv.executor.databank.remove(d)
    return srv


def test_leave_mid_round_with_speculative_batch():
    runs = {(pkg, p): _leave_mid_round(pkg, p)
            for pkg in ("ref", "port") for p in (False, True)}
    for pipeline in (False, True):
        same_state(runs[("ref", pipeline)], runs[("port", pipeline)])
        _params_close(runs[("ref", pipeline)], runs[("port", pipeline)],
                      atol=1e-5)
    bit_identical(runs[("port", False)], runs[("port", True)])
    st = runs[("port", True)].pipeline_stats.as_dict()
    assert st == runs[("ref", True)].pipeline_stats.as_dict()
    assert st["speculated"] > 0 and st["repaired"] >= 1


@pytest.mark.parametrize("present", [None, "all", "some", "few"])
def test_present_sampling_matches_reference(present):
    """``draw_round_sample(present=)`` walks the reference's stream,
    the full-fleet fast path included."""
    mask = {None: None, "all": np.ones(12, bool),
            "some": np.arange(12) % 3 != 0,
            "few": np.arange(12) < 3}[present]
    rj, rt = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        pj, mj = j_draw(rj, 12, 5, 40, 16, 2, present=mask)
        pt, mt = draw_round_sample(rt, 12, 5, 40, 16, 2, present=mask)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(mt, mj)
        if mask is not None:
            assert not pt[~mask].any()


# -- DeviceDataBank unit behaviour -------------------------------------------

def _toy_data(n0=4):
    rng = np.random.default_rng(0)
    return {k: (rng.normal(size=(n0, 6, 2)).astype(np.float32),
                rng.integers(0, 3, (n0, 6)).astype(np.int32))
            for k in ("train", "val", "test")}


def _toy_banks(n0=4, n_cap=8, id_cap=12):
    data = _toy_data(n0)
    return (JBank(data, n_cap=n_cap, id_cap=id_cap),
            TBank(data, "cpu", n_cap=n_cap, id_cap=id_cap))


def _toy_device(rng, val=None, n=6, cls=DeviceData):
    def split(rows=n):
        x = rng.normal(size=(rows, 2)).astype(np.float32)
        if val is not None:
            x[:] = val
        return x, rng.integers(0, 3, rows).astype(np.int32)
    return cls(0, split(), split(), split())


def test_bank_identity_until_churn_then_slot_reuse():
    rng = np.random.default_rng(1)
    ref, port = _toy_banks()
    assert port.identity_map()
    assert port.present_ids() == [0, 1, 2, 3]
    assert port.splits["train"][0].shape == (8, 6, 2)      # n_cap rows
    np.testing.assert_array_equal(port.splits["train"][0][4:].numpy(), 0.0)
    v0 = port.version
    port.remove(1)
    ref.remove(1)
    assert 1 not in port
    assert port.version == v0               # leaves rewrite nothing
    d = port.add(_toy_device(rng, val=7.0))
    assert ref.add(_toy_device(np.random.default_rng(1), val=7.0,
                               cls=JDeviceData)) == d == 4
    assert port.row_of[d] == 1              # the freed ROW is reused
    assert 1 not in port.row_of             # stale mapping dropped
    assert port.row_of == ref.row_of
    assert port.version == v0 + 1           # joins rewrite rows
    np.testing.assert_allclose(port.splits["train"][0][1].numpy(), 7.0)
    assert port.splits["train"][1].dtype == torch.int64
    assert not port.identity_map()
    port.update(d, _toy_device(rng, val=-2.0))
    assert port.version == v0 + 2           # drifts rewrite rows
    np.testing.assert_allclose(port.splits["val"][0][1].numpy(), -2.0)


def test_bank_fills_low_rows_then_runs_out():
    rng = np.random.default_rng(2)
    ref, port = _toy_banks(n0=4, n_cap=8, id_cap=20)
    for _ in range(4):
        port.add(_toy_device(rng))
        ref.add(_toy_device(rng, cls=JDeviceData))
    assert sorted(port.row_of[d] for d in port.present_ids()) == \
        list(range(8))
    assert port.row_of == ref.row_of
    for bank, cls in ((ref, JDeviceData), (port, DeviceData)):
        with pytest.raises(IndexError):
            bank.add(_toy_device(rng, cls=cls))   # n_cap rows exhausted


def test_bank_full_id_space_and_absent_ids():
    rng = np.random.default_rng(3)
    ref, port = _toy_banks(n0=4, n_cap=8, id_cap=5)
    port.add(_toy_device(rng))
    ref.add(_toy_device(rng, cls=JDeviceData))
    for bank, cls in ((ref, JDeviceData), (port, DeviceData)):
        with pytest.raises(IndexError):
            bank.add(_toy_device(rng, cls=cls))   # ids 0-4 all claimed
        with pytest.raises(KeyError):
            bank.update(9, _toy_device(rng, cls=cls))
        with pytest.raises(KeyError):
            bank.remove(9)
    for kw in (dict(n_cap=3), dict(id_cap=3)):
        for make_bank in (lambda: JBank(_toy_data(), **kw),
                          lambda: TBank(_toy_data(), "cpu", **kw)):
            with pytest.raises(ValueError):
                make_bank()


def test_bank_rejects_mismatched_split_shapes():
    rng = np.random.default_rng(4)
    ref, port = _toy_banks()
    for bank, cls in ((ref, JDeviceData), (port, DeviceData)):
        bad = _toy_device(rng, cls=cls)
        bad.train = (np.zeros((5, 2), np.float32), np.zeros(5, np.int32))
        with pytest.raises(ValueError):
            bank.add(bad)
    # the port checks before it claims an id or a row
    assert port.next_id == 4 and port.present_ids() == [0, 1, 2, 3]
    assert port.version == 0


def test_churn_row_write_reaches_the_next_train_dispatch():
    """A join's row write lands in the bank before the next dispatch
    reads it: the port's first round after a slot reuse trains the
    joined device on its new data (pinned to the reference's round)."""
    def sched(pkg):
        return script(pkg, [("leave", 2, 0), ("join", 2, 3)])
    ref, port = run_pair(dict(scenario=sched), 3)
    bank = port.executor.databank
    assert bank.row_of[8] == 0
    # the joined device's data: the schedule's stream, first draw
    plain = script("port", [])
    dev = plain.make_device(plain.make_rng(), 3)
    np.testing.assert_array_equal(bank.splits["train"][0][0].numpy(),
                                  dev.train[0])
    np.testing.assert_array_equal(bank.splits["test"][1][0].numpy(),
                                  dev.test[1].astype(np.int64))
    same_state(ref, port)
    _params_close(ref, port, atol=1e-5)
