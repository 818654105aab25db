"""What decides ``correct`` in the CNN cells: the program's checked
rounds, taken from its timed call (``run_round``) in the set-up and held
against the plain reference (``ref_fl``) stage by stage.

The local training of a round is chaotic at these settings (float32
SGD against float64 SGD from one start part by 0.7% of the update after
4 steps and 22% after 32; PERF.md), so no reference can follow a whole
round from its start. The check therefore follows the program step by
step from the program's own state, and compares each stage from the
same inputs:

* ``grad_gap``: the first SGD step's gradients of every pair, at the
  round's starting params, as the gap of the norms by the worst leaf
  (``|‖g_prog‖ − ‖g_ref‖| / max(‖g_ref‖, median leaf's ‖g_ref‖)``);
  the median of each model's pairs, the worst model;
* ``step_gap``: every step's gradients of one pair of each model, drawn
  from the seed, at the params the program's own steps reached; the
  median of each followed pair's steps, the worst pair. Medians, not
  the widest gaps, are compared: the widest of some hundred readings
  swings from seed to seed (PERF.md); a median per model and per pair
  still fails a fault in one model's pairs or in the later steps;
* ``sgd_gap``: each followed pair's trained params against its start
  minus lr times the program's own gradients (the update rule), as a
  gap of the update's norms;
* ``agg_gap``: every aggregated model's update (the bank row after the
  round minus before) against eq 1 of the program's trained pairs with
  the reference's weights, through the int8 round trip; clones against
  the round trip of their parent;
* ``acc_gap``: the widest distance of an entry of the round's validation
  matrix, or of a preferred model's test accuracy, outside the interval
  the reference's float64 accuracies of the program's rows allow, where
  a prediction at a tie (``TIE``) may go either way;
* ``life_diff``: entries where the program's pairs, active and alive
  masks and clones depart from eq 2-4 and cloning applied to the
  program's accuracies.

Leaves whose reference value is under a thousandth of the median
leaf's norm are left out of the gap numbers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fbench import ref_fl

Params = Dict[str, torch.Tensor]
QUIET = 1e-3
# a prediction whose two largest logits (float64) lie within this share
# of the largest one's magnitude is a tie at float32's resolution: the
# program may count it either way
TIE = 1e-4


@dataclass
class Record:
    """The program's state and outputs around one checked round."""
    before: Dict[int, Params]            # live models before, on the host
    scores: ref_fl.Scores                # score state before
    next_id: int
    clones_before: int = 0               # clones made by earlier rounds
    after: Dict[int, Params] = field(default_factory=dict)   # same ids
    clones: Dict[int, Params] = field(default_factory=dict)  # born now
    scores_after: Optional[ref_fl.Scores] = None
    val: Optional[np.ndarray] = None     # (N, M_cap) the round's matrix
    test: Optional[np.ndarray] = None    # (N,)
    pairs: List[Tuple[int, int]] = field(default_factory=list)
    trained: Optional[Params] = None     # (B_pad, ...) pair outputs
    grad0: Optional[Params] = None       # (B_pad, ...) first-step grads
    follow: List[int] = field(default_factory=list)  # followed pairs
    follow_grads: List[Params] = field(default_factory=list)  # (F, ...)


def leaf_gap(a: Params, b: Params, detail=None, tag=None) -> float:
    """Gap of the norms of ``a`` (program) and ``b`` (reference), by the
    worst leaf, against the larger of the leaf's and the median leaf's
    reference norm."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in b.items()}
    med = float(np.median(list(norms.values())))
    worst = 0.0
    if not np.isfinite(med):
        return float("inf")
    if med == 0.0:
        return worst
    for k, nb in norms.items():
        if nb < QUIET * med:
            continue
        na = float(torch.linalg.vector_norm(a[k].double()))
        gap = abs(na - nb) / max(nb, med) if np.isfinite(na) else np.inf
        worst = max(worst, gap)
        if detail is not None:
            detail.append((tag, k, gap, nb, na))
    return worst


def _sub(a: Params, b: Params) -> Params:
    return {k: a[k].double().cpu() - b[k].double().cpu() for k in a}


def _row(tree: Params, i: int) -> Params:
    return {k: v[i] for k, v in tree.items()}


def _to(p: Params, device) -> Params:
    return {k: v.to(device) for k, v in p.items()}


def gradient(p: Params, x: torch.Tensor, y: torch.Tensor,
             channels: List[int], dtype=torch.float64) -> Params:
    """The plain reference's gradient of the mean cross-entropy, computed
    in ``dtype``."""
    names = list(p)
    leaves = [p[k].detach().to(dtype).requires_grad_(True) for k in names]
    loss = F.cross_entropy(
        ref_fl.cnn_forward(dict(zip(names, leaves)), x.to(dtype), channels),
        y.long())
    return dict(zip(names, torch.autograd.grad(loss, leaves)))


def ref_pairs(rec: Record, participating: np.ndarray, fedcd: bool
              ) -> List[Tuple[int, int]]:
    """(model, device) work pairs: participating holders, models in id
    order (FedAvg: model 0 on every participating device)."""
    if not fedcd:
        return [(0, int(d)) for d in np.nonzero(participating)[0]]
    return [(m, int(d)) for m in sorted(rec.before)
            for d in np.nonzero(rec.scores.active[:, m]
                                & participating)[0]]


def side(rec: Record, t: int, sample, data, cfg: dict,
         channels: List[int], seed: int, fedcd: bool, tf32: bool = False,
         fault: str = "") -> Dict:
    """The reference's quantities of round ``t`` from the program's
    state; with ``tf32`` (the control) or a ``fault`` to put in the
    program's place: ``"half"`` (eq 1 over the first half of each
    model's pairs), ``"answer"`` (the validation row of the first model
    given to the next device along) or ``"stale"`` (every step's
    gradient taken at the pair's starting params)."""
    participating, perms = sample
    xs, ys = data["train"]
    dev = xs.device
    pairs = ref_pairs(rec, participating, fedcd)
    before = {m: _to(p, dev) for m, p in rec.before.items()}

    def batch(d: int, s: int):
        idx = torch.as_tensor(perms[d][s], device=dev).long()
        return xs[d][idx], ys[d][idx]

    # the reference computes in float64; the control in float32 with TF32
    dtype = torch.float32 if tf32 else torch.float64
    out: Dict = {"pairs": pairs}
    with ref_fl.precision(tf32):
        out["grad0"] = [gradient(before[m], *batch(d, 0), channels, dtype)
                        for m, d in pairs]
        follow: List[List[Params]] = []
        sgd_end: List[Params] = []
        # (another work order compares nothing: ``compare``)
        same = [tuple(map(int, q)) for q in rec.pairs] == pairs
        for j, k in enumerate(rec.follow if same else []):
            m, d = pairs[k]
            p = before[m]
            steps = []
            for s in range(perms.shape[1]):
                at = before[m] if fault == "stale" else p
                steps.append(gradient(at, *batch(d, s), channels, dtype))
                g = _to(_row(rec.follow_grads[s], j), dev)
                p = {n: p[n] - cfg["lr"] * g[n] for n in p}
            follow.append(steps)
            sgd_end.append(p)
        out["sgd_end"] = sgd_end
        out["follow_grads"] = follow
    # eq 1 of the program's trained pairs (in float64, stored as the
    # float32 it is shipped in), then the transport round trip
    c = (ref_fl.normalized(rec.scores) if fedcd
         else np.ones((participating.shape[0], 1)))
    trained = _to(rec.trained, dev)
    agg = {}
    for m in sorted({m for m, _ in pairs}):
        ks = [k for k, (mm, _) in enumerate(pairs) if mm == m]
        if fault == "half":
            ks = ks[:max(len(ks) // 2, 1)]
        w = np.array([c[pairs[k][1], m] for k in ks])
        a = ref_fl.weighted_mean([{n: v.double() for n, v in
                                   _row(trained, k).items()} for k in ks], w)
        a = {n: v.float() for n, v in a.items()}
        if cfg.get("quantize_bits") and fedcd:
            a = {k: ref_fl.roundtrip(v, cfg["quantize_bits"])
                 for k, v in a.items()}
        agg[m] = a
    out["agg"] = agg
    sc = rec.scores_after
    if fedcd:
        # the lifecycle on the program's accuracies
        s = ref_fl.push(rec.scores, rec.val)
        s, _ = ref_fl.deletions(s, t, cfg["late_delete_round"],
                                cfg["late_delete_threshold"])
        clones: List[Tuple[int, int]] = []
        if t in cfg["milestones"]:
            live = [m for m in sorted(rec.before) if s.alive[m]]
            s, clones = ref_fl.clone_all(
                s, live, rec.next_id, s.active.shape[1], cfg["score_noise"],
                ref_fl.life_rng(seed, rec.clones_before,
                                s.active.shape[0], cfg["score_noise"]))
        out["scores"], out["clone_pairs"] = s, clones
        out["clones"] = {
            child: ({k: ref_fl.roundtrip(v, cfg["quantize_bits"])
                     for k, v in _to(rec.after[parent], dev).items()}
                    if cfg["quantize_bits"] else _to(rec.after[parent], dev))
            for parent, child in clones}
        sc = s
    # accuracies of the program's rows after the round
    with ref_fl.precision(tf32):
        val = np.zeros_like(rec.val)
        ev = {k: (x.to(dtype), y) for k, (x, y) in data.items()}
        # the reference's bounds; the control's and a fault's answers
        tie = 0.0 if (tf32 or fault) else TIE
        val_hi = np.zeros_like(rec.val)
        for m, p in rec.after.items():
            val[:, m], val_hi[:, m] = ref_fl.accuracy_bounds(
                {k: v.to(dev, dtype) for k, v in p.items()}, *ev["val"],
                channels, tie)
        if fault == "answer":
            first = min(rec.after)
            val[:, first] = np.roll(val[:, first], 1)
            val_hi[:, first] = val[:, first]
        out["val"], out["val_hi"] = val, val_hi
        rows = dict(rec.after)
        rows.update(rec.clones)
        out["test"], out["test_hi"] = ref_fl.preferred_test(
            {m: {k: v.to(dev, dtype) for k, v in p.items()}
             for m, p in rows.items()}, sc, ev, channels, tie)
    return out


def program_side(rec: Record) -> Dict:
    n = len(rec.pairs)
    return {"pairs": rec.pairs,
            "grad0": [_row(rec.grad0, k) for k in range(n)],
            "follow_grads": [[_row(g, j) for g in rec.follow_grads]
                             for j in range(len(rec.follow))],
            "sgd_end": [_row(rec.trained, k) for k in rec.follow],
            "agg": rec.after, "clones": rec.clones, "val": rec.val,
            "test": rec.test, "scores": rec.scores_after}


def compare(rec: Record, prog: Dict, ref: Dict, t: int,
            detail=None) -> Dict[str, float]:
    """The numbers of one round: ``prog`` (the program, or the control
    or a fault in its place) against ``ref``."""
    nums = {"grad_gap": 0.0, "step_gap": 0.0, "sgd_gap": 0.0,
            "agg_gap": 0.0, "acc_gap": 0.0, "life_diff": 0.0}
    if list(prog["pairs"]) != list(ref["pairs"]):
        # another work order: nothing else compares
        nums["life_diff"] = 1.0 + abs(len(prog["pairs"]) - len(ref["pairs"]))
        return {k: (v if k == "life_diff" else float("inf"))
                for k, v in nums.items()}

    def gap(name, a, b, tag):
        g = leaf_gap(a, b, detail, (name, t) + tag)
        nums[name] = max(nums[name], g)
        return g

    # the readings of each group: a model's first steps, a pair's steps
    groups: Dict[Tuple, List[float]] = {}
    for k, (a, b) in enumerate(zip(prog["grad0"], ref["grad0"])):
        m = ref["pairs"][k][0]
        groups.setdefault(("grad_gap", m), []).append(
            gap("grad_gap", a, b, ("first", k)))
    for j, (pa, pb) in enumerate(zip(prog["follow_grads"],
                                     ref["follow_grads"])):
        k = rec.follow[j]
        groups[("step_gap", k)] = [gap("step_gap", a, b, ("step", k, s))
                                   for s, (a, b) in enumerate(zip(pa, pb))]
    nums["gap_groups"] = list(groups.items())
    before = rec.before
    for j, k in enumerate(rec.follow):
        m0 = ref["pairs"][k][0]
        gap("sgd_gap", _sub(prog["sgd_end"][j], before[m0]),
            _sub(ref["sgd_end"][j], before[m0]), ("follow", k))
    for m, a in ref["agg"].items():
        gap("agg_gap", _sub(prog["agg"].get(m, before[m]), before[m]),
            _sub(a, before[m]), ("model", m))
    for par, child in ref.get("clone_pairs", []):
        if child in prog["clones"]:
            gap("agg_gap", _sub(prog["clones"][child], before[par]),
                _sub(ref["clones"][child], before[par]), ("clone", child))
    live = sorted(rec.after)

    def outside(x, lo, hi):
        return float(np.max(np.maximum(lo - x, x - hi), initial=0.0))
    nums["acc_gap"] = max(
        outside(prog["val"][:, live], ref["val"][:, live],
                ref["val_hi"][:, live]),
        outside(prog["test"], ref["test"], ref["test_hi"]))
    if detail is not None:
        detail.append((("acc_gap", t), "val/test", nums["acc_gap"], 0, 0))
    if ref.get("scores") is not None and "clone_pairs" in ref:
        a, b = prog["scores"], ref["scores"]
        nums["life_diff"] += float(np.sum(a.active != b.active)
                                   + np.sum(a.alive != b.alive))
        nums["life_diff"] += float(len(set(prog["clones"]) ^ {
            c for _, c in ref["clone_pairs"]}))
    return nums


def merge(parts: List[Dict]) -> Dict[str, float]:
    """Rounds combine by the worst reading (``life_diff`` adds);
    ``grad_gap`` and ``step_gap`` are the worst median of a group of
    readings (a model's first steps, a followed pair's steps)."""
    out: Dict[str, float] = {}
    medians: Dict[str, float] = {}
    for part in parts:
        for (name, _), readings in part.pop("gap_groups", []):
            if readings:
                medians[name] = max(medians.get(name, 0.0),
                                    float(np.median(readings)))
        for k, v in part.items():
            out[k] = out.get(k, 0.0) + v if k == "life_diff" else max(
                out.get(k, 0.0), v)
    for name, v in medians.items():
        if np.isfinite(out.get(name, 0.0)):
            out[name] = v
    return out
