"""The port's scenario module (``repro_torch/data/scenarios.py``) against
the reference's: the straggler model's latency and dropout vectors, the
random churn schedules and the data of joining and drifting devices are
exactly equal for equal arguments, and the constructors refuse the same
arguments with ``ValueError``. Pure numpy on both sides: every bar here
is exact equality.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import scenarios as js  # noqa: E402
from repro_torch.data import scenarios as ts  # noqa: E402

SEEDS = (0, 1, 7)
MODELS = [
    dict(),                                           # the +semisync default
    dict(distribution="zero"),
    dict(distribution="exponential", scale=2.5),
    dict(distribution="lognormal", sigma=2.0, quorum=0.6,
         dropout_rate=0.05),
    dict(distribution="lognormal", hetero=0.7, dropout_rate=0.3),
]
CHURN_KW = [
    dict(),
    dict(join_rate=0.5, leave_rate=0.4, drift_rate=0.3, min_devices=3),
    dict(join_rate=0.9, leave_rate=0.9, drift_rate=0.9, min_devices=1,
         n_archetypes=6, first_round=1),
]
BAD_STRAGGLERS = [
    dict(distribution="pareto"),
    dict(quorum=0.0),
    dict(quorum=1.5),
    dict(gamma=-0.1),
    dict(gamma=1.01),
    dict(max_staleness=-1),
]


def _events(sched):
    return [(type(e).__name__, dataclasses.astuple(e)) for e in sched.events]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", MODELS)
def test_straggler_resolve_and_speeds_match_reference(kw, seed):
    drops = (ts.DeviceDropout(2, 3), ts.DeviceDropout(2, 99),
             ts.DeviceDropout(4, 0))
    jdrops = tuple(js.DeviceDropout(e.round, e.device) for e in drops)
    port = ts.StragglerModel(seed=seed, dropouts=drops, **kw)
    ref = js.StragglerModel(seed=seed, dropouts=jdrops, **kw)
    for n in (8, 30):
        np.testing.assert_array_equal(port.speeds(n), ref.speeds(n))
        for t in range(1, 7):
            lp, dp = port.resolve(t, n)
            lr, dr = ref.resolve(t, n)
            np.testing.assert_array_equal(lp, lr)
            np.testing.assert_array_equal(dp, dr)
    assert port.resolve(2, 8)[1][3] and port.resolve(4, 8)[1][0]


def test_zero_model_matches_reference():
    port, ref = ts.StragglerModel.zero(seed=4), js.StragglerModel.zero(seed=4)
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    lat, dropped = port.resolve(3, 10)
    assert not lat.any() and not dropped.any()


@pytest.mark.parametrize("kw", BAD_STRAGGLERS)
def test_straggler_value_errors_match_reference(kw):
    with pytest.raises(ValueError):
        js.StragglerModel(**kw)
    with pytest.raises(ValueError):
        ts.StragglerModel(**kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", CHURN_KW)
def test_random_churn_matches_reference(kw, seed):
    port = ts.random_churn(10, 8, seed=seed, **kw)
    ref = js.random_churn(10, 8, seed=seed, **kw)
    assert _events(port) == _events(ref)
    assert port.total_joins == ref.total_joins
    assert port.row_capacity(8) == ref.row_capacity(8)
    assert port.last_round() == ref.last_round()
    for t in range(12):
        assert port.has_events(t) == ref.has_events(t)
        for name in ("joins_at", "leaves_at", "drifts_at"):
            assert ([dataclasses.astuple(e) for e in getattr(port, name)(t)]
                    == [dataclasses.astuple(e)
                        for e in getattr(ref, name)(t)]), (name, t)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("partition,archetypes", [
    ("hierarchical", (0, 4, 9)),
    ("hypergeometric", (0, 3, 5)),
    ("dirichlet", (0, 2, 8)),
])
def test_make_device_data_matches_reference(partition, archetypes, seed):
    kw = dict(partition=partition, seed=seed, n_train=48, n_val=16,
              n_test=16, alpha=0.3)
    port, ref = ts.ChurnSchedule(**kw), js.ChurnSchedule(**kw)
    prng, rrng = port.make_rng(), ref.make_rng()
    for a in archetypes:
        np.testing.assert_array_equal(port.archetype_probs(a),
                                      ref.archetype_probs(a))
        dp, dr = port.make_device(prng, a), ref.make_device(rrng, a)
        assert dp.archetype == dr.archetype == a
        for split in ("train", "val", "test"):
            for x, y in zip(getattr(dp, split), getattr(dr, split)):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype


def test_unknown_partition_raises_like_reference():
    for mod in (js, ts):
        with pytest.raises(ValueError):
            mod.ChurnSchedule(partition="zipf").archetype_probs(0)


def test_streams_match_reference():
    assert ts.CHURN_STREAM == js.CHURN_STREAM
    assert ts.STRAGGLER_STREAM == js.STRAGGLER_STREAM
