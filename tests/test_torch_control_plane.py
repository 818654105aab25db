"""Port parity for the host control plane: from the same score state and
the same host RNG streams (the sampling stream and the ``[seed,
0xFEDCD]`` lifecycle stream), the port builds the reference's plans and
makes its deletions and clones — exactly."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import FedCDConfig as JCfg  # noqa: E402
from repro.core import lifecycle as jl  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import scores as jsc  # noqa: E402
from repro.core.registry import ModelRegistry as JReg  # noqa: E402
from repro.federated import simulation as jsim  # noqa: E402
from repro_torch.config import FedCDConfig as TCfg  # noqa: E402
from repro_torch.core import lifecycle as tl  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import scores as tsc  # noqa: E402
from repro_torch.core.fedcd import LIFECYCLE_STREAM  # noqa: E402
from repro_torch.core.registry import ModelRegistry as TReg  # noqa: E402
from repro_torch.federated import simulation as tsim  # noqa: E402

N, M_CAP, ELL = 12, 10, 3


def _population(seed):
    """Both packages' registries and score states with 6 models, one of
    them dead, and a random score history with unfilled entries."""
    rng = np.random.default_rng(seed)
    jreg = JReg.create({"w": jnp.zeros(3)}, m_cap=M_CAP, stacked=True)
    treg = TReg.create({"w": torch.zeros(3)}, m_cap=M_CAP, stacked=True)
    for parent in (0, 0, 1, 2, 3):
        for reg in (jreg, treg):
            reg.clone(parent, 0, reg.params[parent])
    for reg in (jreg, treg):
        reg.kill(4, 0)
    active = rng.uniform(0, 1, (N, M_CAP)) < 0.6
    active[:, 6:] = False
    active[:, 4] = False
    active[np.arange(N), rng.integers(0, 4, N)] = True
    history = rng.uniform(0, 1, (N, M_CAP, ELL))
    history[rng.uniform(0, 1, history.shape) < 0.2] = np.nan
    history[~active] = np.nan
    alive = np.zeros(M_CAP, bool)
    alive[[0, 1, 2, 3, 5]] = True
    js = jsc.ScoreState(history.copy(), active.copy(), alive.copy(), ELL)
    ts = tsc.ScoreState(history.copy(), active.copy(), alive.copy(), ELL)
    return jreg, treg, js, ts


def _same_state(a, b):
    np.testing.assert_array_equal(a.active, b.active)
    np.testing.assert_array_equal(a.alive, b.alive)
    np.testing.assert_array_equal(a.history, b.history)   # NaN-aware


def _cfgs(**kw):
    base = dict(n_devices=N, devices_per_round=5, milestones=(3,),
                late_delete_round=2, max_models=M_CAP, score_noise=0.05,
                seed=11)
    base.update(kw)
    return JCfg(**base), TCfg(**base)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scores_and_deletion_masks_identical(seed):
    _, _, js, ts = _population(seed)
    np.testing.assert_array_equal(jsc.normalized_scores(js),
                                  tsc.normalized_scores(ts))
    c = tsc.normalized_scores(ts)
    np.testing.assert_array_equal(jl.eq4_deletion_mask(c, js.active),
                                  tl.eq4_deletion_mask(c, ts.active))
    np.testing.assert_array_equal(
        jl.late_deletion_mask(c, js.active, 0.3),
        tl.late_deletion_mask(c, ts.active, 0.3))
    accs = np.random.default_rng(seed).uniform(0, 1, (N, M_CAP))
    _same_state(jsc.push_accuracies(js, accs), tsc.push_accuracies(ts, accs))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deletions_and_clones_identical(seed):
    jreg, treg, js, ts = _population(seed)
    jcfg, tcfg = _cfgs(seed=seed)
    js, jk = jl.apply_deletions(js, jreg, 3, jcfg)
    ts, tk = tl.apply_deletions(ts, treg, 3, tcfg)
    assert jk == tk
    _same_state(js, ts)
    jrng = np.random.default_rng([seed, 0xFEDCD])
    trng = np.random.default_rng([seed, LIFECYCLE_STREAM])
    js, jpairs = jl.clone_at_milestone(js, jreg, 3, jcfg, jrng)
    ts, tpairs = tl.clone_at_milestone(ts, treg, 3, tcfg, trng)
    assert jpairs == tpairs and jpairs          # some clones were made
    _same_state(js, ts)
    assert jreg.live_ids() == treg.live_ids()
    assert jreg.genealogy() == treg.genealogy()
    assert all((m in jreg.params) == (m in treg.params)
               for m in range(M_CAP))


@pytest.mark.parametrize("seed", [0, 1])
def test_round_samples_and_plans_identical(seed):
    jreg, treg, js, ts = _population(seed)
    jcfg, tcfg = _cfgs(seed=seed)
    jrng, trng = (np.random.default_rng(seed) for _ in range(2))
    hints = dict(val_cached={0, 1, 5}, test_cached={1}, pred_rows=[1, 3])
    jplanner, tplanner = jplan.RoundPlanner(jcfg), tplan.RoundPlanner(tcfg)
    for t in (2, 3):
        js_sample = jsim.draw_round_sample(jrng, N, 5, 40, 8, 2)
        ts_sample = tsim.draw_round_sample(trng, N, 5, 40, 8, 2)
        for a, b in zip(js_sample, ts_sample):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        c = tsc.normalized_scores(ts)
        jp = jplanner.build(t, js_sample, c, js, jreg,
                            jplan.EvalHints(**hints))
        tp = tplanner.build(t, ts_sample, c, ts, treg,
                            tplan.EvalHints(**hints))
        for f in ("round", "live", "agg_models", "pair_model",
                  "pair_device", "transfers", "val_stale", "test_stale",
                  "clone_milestone"):
            assert getattr(jp, f) == getattr(tp, f), f
        assert jp.pairs() == tp.pairs()
        assert jp.changed_models() == tp.changed_models()
        assert jplan.gather_pairs(js, jreg, js_sample[0]) == \
            tplan.gather_pairs(ts, treg, ts_sample[0])
    # no hints: every live row is planned stale
    tp = tplanner.build(4, ts_sample, c, ts, treg)
    assert tp.val_stale == treg.live_ids() and tp.test_stale == []


def test_buckets_and_padding_identical():
    for n in range(0, 300):
        assert jsim.bucket_size(n) == tsim.bucket_size(n)
        assert jsim.bucket_size(n, 1) == tsim.bucket_size(n, 1)
    live = [1, 4, 7, 9, 11]
    np.testing.assert_array_equal(jsim.pad_live_rows(live),
                                  tsim.pad_live_rows(live))
    perms = [np.full((3, 4), k, np.int32) for k in range(11)]
    for a, b in zip(jsim.pad_work_batch(list(range(11)), [2] * 11, perms),
                    tsim.pad_work_batch(list(range(11)), [2] * 11, perms)):
        np.testing.assert_array_equal(a, b)
