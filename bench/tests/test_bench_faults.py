"""The rest of a run, with the timed path broken underneath: each fault
a CNN cell can have comes out not correct, and the sound run correct.
(The control, TF32, exists only on the card: test_bench_chip.py.)"""
import numpy as np
import pytest
import torch

import repro_torch.federated.simulation as sim
from bench_helpers import tiny_job
from fbench import result
from fbench.runners import fl_cnn

CELLS = ["cnn-fedcd-r16", "cnn-fedavg"]


def _unchanged(monkeypatch):
    # a round that leaves the bank as it found it
    monkeypatch.setattr(sim, "_scatter_rows", lambda *a, **k: None)


def _half(monkeypatch):
    agg = sim._aggregate_rows

    def half(trained, w, bits):
        # half of each model's pairs left out, the mean over the rest
        w = w.clone()
        for row in w:
            on = torch.nonzero(row).flatten()
            row[on[:max(len(on) // 2, 1)]] = 0
        return agg(trained, w, bits)
    monkeypatch.setattr(sim, "_aggregate_rows", half)


def _answer(monkeypatch):
    ev = sim._eval_gathered

    def shifted(*args, **kwargs):
        # every device reads the next device's accuracy
        return torch.roll(ev(*args, **kwargs), 1, dims=1)
    monkeypatch.setattr(sim, "_eval_gathered", shifted)


def _stale(monkeypatch):
    def pair_train(loss_fn, lr):
        pair_grad = sim.vmap(sim.grad(loss_fn))

        def train(stacked, m_idx, xs, ys, d_idx, perms):
            # every step's gradient taken at the pairs' starting params
            start = {k: v[m_idx] for k, v in stacked.items()}
            params, rows = start, d_idx[:, None]
            for t in range(perms.shape[1]):
                idx = perms[:, t]
                g = pair_grad(start, (xs[rows, idx], ys[rows, idx]))
                params = {k: p - lr * g[k] for k, p in params.items()}
            return params
        return train
    monkeypatch.setattr(sim, "_pair_train", pair_train)


FAULTS = {"unchanged": _unchanged, "half": _half, "answer": _answer,
          "stale": _stale}


def _run(name, scratch):
    job = tiny_job(name, scratch)
    torch.manual_seed(0)
    out = fl_cnn.run(job)
    return result.verdict(out["numbers"], job.cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path):
    ok, table = _run(name, tmp_path)
    assert ok, table


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch, tmp_path):
    torch.set_num_threads(2)
    FAULTS[fault](monkeypatch)
    ok, table = _run(name, tmp_path)
    assert not ok, table
    failed = [k for k, v in table.items()
              if not np.isfinite(v["value"]) or v["value"] > v["limit"]]
    assert failed
