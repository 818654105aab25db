"""The plain reference at a tiny size, against the port's plain pieces
(these tests may import the port; the reference itself never does)."""
import math

import numpy as np
import pytest
import torch

from fbench import check_fl, ref_fl
from fbench.runners import fl_cnn

CHANNELS = [32, 32, 64, 64, 128, 128, 256, 256]
MODEL = {"channels": CHANNELS, "dense": 256, "n_classes": 10, "image": 32,
         "in_channels": 3}


def _params(seed=3):
    return fl_cnn.init_weights(seed, MODEL, torch.device("cpu"))


def test_init_weights_shapes_and_seed():
    p, q = _params(3), _params(3)
    assert sum(v.numel() for v in p.values()) == 1437226
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert not torch.equal(p["conv.3"], _params(4)["conv.3"])
    assert p["conv.2"].shape == (3, 3, 32, 64)
    assert abs(float(p["conv.2"].std()) - math.sqrt(2 / (9 * 32))) < 0.01


def test_cnn_forward_is_the_papers_cnn():
    from repro_torch.models.cnn import apply_cnn
    p = _params()
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ref_fl.cnn_forward(p, x, CHANNELS),
                               apply_cnn(p, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [5, 128, 300])
def test_roundtrip_is_blockwise_int8(n):
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)) * 0.3
    q, s = quantize_ref(x, 8)
    want = dequantize_ref(q, s, (n,), torch.float32)
    assert torch.equal(ref_fl.roundtrip(x, 8), want)


def test_weighted_mean_is_eq1():
    from repro_torch.kernels.weighted_agg.ref import multi_weighted_agg_ref
    g = torch.Generator().manual_seed(1)
    u = torch.randn(3, 40, generator=g)
    w = np.array([0.2, 0.5, 0.3])
    ref = ref_fl.weighted_mean([{"a": u[i]} for i in range(3)], w)["a"]
    wt = torch.tensor(w, dtype=torch.float32)[None]
    want = multi_weighted_agg_ref(u, wt, wt.sum(1))[0]
    torch.testing.assert_close(ref, want, rtol=1e-6, atol=1e-7)


def _scores(seed):
    rng = np.random.default_rng(seed)
    n, m = 12, 6
    active = rng.random((n, m)) < 0.7
    active[:, 0] = True
    hist = np.where(active[:, :, None], rng.random((n, m, 3)), np.nan)
    return ref_fl.Scores(hist, active, active.any(0))


@pytest.mark.parametrize("seed", range(6))
def test_lifecycle_is_eq2_to_eq4(seed):
    from repro_torch.config import FedCDConfig
    from repro_torch.core import lifecycle, scores

    class Reg:
        def __init__(self, alive):
            self.ids = [int(i) for i in np.nonzero(alive)[0]]

        def live_ids(self):
            return list(self.ids)

        def kill(self, m, t):
            self.ids.remove(m)

    s = _scores(seed)
    st = scores.ScoreState(s.history.copy(), s.active.copy(),
                           s.alive.copy(), 3)
    np.testing.assert_allclose(ref_fl.normalized(s),
                               scores.normalized_scores(st))
    accs = np.random.default_rng(seed + 100).random(s.active.shape)
    st = scores.push_accuracies(st, accs)
    mine = ref_fl.push(s, accs)
    for t in (3, 25):
        cfg = FedCDConfig(late_delete_round=20, late_delete_threshold=0.3)
        theirs, killed = lifecycle.apply_deletions(st, Reg(st.alive), t, cfg)
        ours, ours_killed = ref_fl.deletions(mine, t, 20, 0.3)
        np.testing.assert_array_equal(ours.active, theirs.active)
        assert sorted(ours_killed) == sorted(killed)


def test_accuracy_bounds_hold_ties_either_way():
    p = _params()
    x = torch.randn(2, 3, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    y = torch.randint(0, 10, (2, 3), generator=torch.Generator().manual_seed(3))
    lo, hi = ref_fl.accuracy_bounds(p, x, y, CHANNELS, 0.0)
    np.testing.assert_array_equal(lo, hi)
    logits = ref_fl.cnn_forward(p, x.reshape(6, 32, 32, 3), CHANNELS)
    hits = (logits.argmax(-1) == y.reshape(-1)).double().reshape(2, 3)
    np.testing.assert_array_equal(lo, hits.mean(1).numpy())
    lo2, hi2 = ref_fl.accuracy_bounds(p, x, y, CHANNELS, 10.0)
    assert np.all(lo2 <= lo) and np.all(hi2 >= hi)


def test_leaf_gap():
    a = {"w": torch.ones(4) * 2, "b": torch.ones(1) * 1e-9}
    b = {"w": torch.ones(4) * 2, "b": torch.ones(1) * 1e-9}
    assert check_fl.leaf_gap(a, b) == 0.0
    # a state left unchanged reads 1
    zero = {k: torch.zeros_like(v) for k, v in b.items()}
    assert check_fl.leaf_gap(zero, b) == pytest.approx(1.0)
    # the worst leaf against the larger of its and the median leaf's norm
    c = {"w": torch.ones(4) * 2.2, "b": torch.ones(1) * 1e-9}
    assert check_fl.leaf_gap(c, b) == pytest.approx(0.1)


def test_merge_takes_the_worst_median_of_a_group():
    parts = [{"grad_gap": 0.5, "step_gap": 0.9, "life_diff": 1.0,
              "agg_gap": 0.1,
              "gap_groups": [(("grad_gap", 0), [0.1, 0.2, 0.5]),
                             (("grad_gap", 1), [0.01, 0.02, 0.03]),
                             (("step_gap", 4), [0.3, 0.4, 0.9])]},
             {"grad_gap": 0.3, "step_gap": 0.2, "life_diff": 2.0,
              "agg_gap": 0.4,
              "gap_groups": [(("grad_gap", 0), [0.3]),
                             (("step_gap", 2), [0.1, 0.2])]}]
    assert check_fl.merge(parts) == {"grad_gap": 0.3, "step_gap": 0.4,
                                     "life_diff": 3.0, "agg_gap": 0.4}


def test_merge_keeps_a_non_finite_reading():
    parts = [{"grad_gap": float("inf"), "step_gap": 0.0,
              "gap_groups": [(("grad_gap", 0), [0.1, float("inf"), 0.1])]}]
    assert check_fl.merge(parts)["grad_gap"] == float("inf")
