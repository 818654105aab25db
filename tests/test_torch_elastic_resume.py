"""Elastic checkpoint/resume and fault injection in the port, on the CPU,
in the setup of ``tests/test_engine_equivalence.py::_small_setup`` (MLP,
8 devices, milestones 2/5): the meshless tiers of
``tests/test_elastic_resume.py`` run through the port, port against
port. Checkpoints carried across packages and across mesh layouts are in
``tests/test_torch_elastic_cross.py`` (split off so the two halves run
on two test workers).

Bars:
* port against port (a crash at any scripted phase, then a fresh server
  resumed from the newest valid checkpoint, against the uninterrupted
  run): discrete state, score history, per-round metrics and
  ``semisync_stats`` exactly equal, params bit-identical
  (``torch.equal``) — the reference's bars for its own engines;
* torn and corrupt checkpoints raise ``CheckpointError`` naming the keys.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import scenarios as js  # noqa: E402
from repro_torch.checkpoint import CheckpointError  # noqa: E402
from repro_torch.checkpoint.state import (ARRAYS, MANIFEST,  # noqa: E402
                                          latest_checkpoint,
                                          verify_checkpoint)
from repro_torch.data import scenarios as ts  # noqa: E402
from test_torch_semisync import (STRAGGLER, bit_identical,  # noqa: E402
                                 churn, make, straggler)

ROUNDS = 8
FAULTS = {"ref": js, "port": ts}


def semi(pkg):
    return straggler(pkg, **STRAGGLER)


def _run(spec_kw, rounds=ROUNDS, server="fedcd", pkg="port", bits=0):
    srv = make(pkg, spec_kw, server=server, quantize_bits=bits)
    srv.run(rounds)
    return srv


def _faults(*events):
    """A FaultSchedule of ``(round, phase)`` events, for either package
    (``make`` calls it with the package name)."""
    def build(pkg):
        mod = FAULTS[pkg]
        return mod.FaultSchedule(tuple(mod.FaultEvent(*e) for e in events))
    return build


def _crash_then_resume(spec_kw, fault, root, rounds=ROUNDS,
                       server="fedcd", save_every=2):
    """Run with periodic saves until the scripted crash fires, then resume
    a FRESH server (same spec, no faults) from the checkpoint root and
    drive it to the same horizon."""
    faulted = dict(spec_kw, save_every=save_every, checkpoint_dir=root,
                   faults=_faults(fault))
    with pytest.raises(ts.SimulatedCrash):
        _run(faulted, rounds, server)
    return _run(dict(spec_kw, resume_from=root), rounds, server)


def _fedavg_bit_identical(ref, res):
    for mr, mp in zip(ref.metrics, res.metrics, strict=True):
        assert mr.round == mp.round and mr.comm_bytes == mp.comm_bytes
        np.testing.assert_array_equal(mr.test_acc, mp.test_acc)
        np.testing.assert_array_equal(mr.val_acc, mp.val_acc)
    for k, v in ref.params.items():
        assert torch.equal(v, res.params[k]), k


@pytest.fixture(scope="module")
def fused_ref():
    return _run({})


# -- kill at every scripted phase: resumed == uninterrupted ---------------

@pytest.mark.parametrize("phase", ts.FAULT_PHASES)
def test_crash_any_phase_resumes_bit_identical(phase, tmp_path, fused_ref):
    # mid-save only fires on a save round (cadence 2); the others crash
    # mid-round at an odd round so resume replays an unsaved round too
    t = 4 if phase == "mid-save" else 5
    res = _crash_then_resume({}, (t, phase), str(tmp_path / "ck"))
    bit_identical(fused_ref, res)


def test_pipelined_crash_resumes_bit_identical(tmp_path):
    ref = _run(dict(pipeline=True))
    res = _crash_then_resume(dict(pipeline=True), (5, "mid-dispatch"),
                             str(tmp_path / "ck"))
    # the resume boundary drops one in-flight speculation; that is
    # invisible to results (repair semantics)
    bit_identical(ref, res)


def test_semisync_crash_resumes_bit_identical(tmp_path):
    ref = _run(dict(straggler=semi))
    res = _crash_then_resume(dict(straggler=semi), (5, "post-readback"),
                             str(tmp_path / "ck"))
    bit_identical(ref, res)
    # the clock, the straggler buffer, the stale updates (back on the
    # device) and the fold accounting all restored
    assert res.semisync_stats.as_dict() == ref.semisync_stats.as_dict()
    assert res.semisync_stats.folded > 0


def test_churn_pipelined_crash_resumes_bit_identical(tmp_path):
    spec = dict(scenario=churn, pipeline=True)
    ref = _run(spec)
    res = _crash_then_resume(spec, (5, "post-plan"), str(tmp_path / "ck"))
    bit_identical(ref, res)
    assert res.databank.present_ids() == ref.databank.present_ids()
    assert res.databank.next_id == ref.databank.next_id
    np.testing.assert_array_equal(res.present, ref.present)


def test_fedavg_pipelined_crash_resumes_bit_identical(tmp_path):
    ref = _run(dict(pipeline=True), rounds=6, server="fedavg")
    res = _crash_then_resume(dict(pipeline=True), (5, "post-plan"),
                             str(tmp_path / "ck"), rounds=6,
                             server="fedavg")
    _fedavg_bit_identical(ref, res)


@pytest.mark.parametrize("engine", ["legacy", "batched"])
def test_dict_mode_crash_resumes_bit_identical(engine, tmp_path):
    ref = _run(dict(engine=engine))
    res = _crash_then_resume(dict(engine=engine), (5, "mid-dispatch"),
                             str(tmp_path / "ck"))
    bit_identical(ref, res)
    assert isinstance(res.registry.params, dict)


def test_fedavg_semisync_legacy_crash_resumes(tmp_path):
    """FedAvg's stale updates and coordinator restore too; its legacy
    engine (host dict) as well as the fused one."""
    for kw in (dict(straggler=semi), dict(engine="legacy")):
        ref = _run(kw, rounds=6, server="fedavg")
        res = _crash_then_resume(kw, (5, "mid-dispatch"),
                                 str(tmp_path / kw.get("engine", "semi")),
                                 rounds=6, server="fedavg")
        _fedavg_bit_identical(ref, res)
        if ref.semisync_stats is not None:
            assert res.semisync_stats.as_dict() == \
                ref.semisync_stats.as_dict()


def test_stacked_checkpoint_is_refused_by_a_dict_mode_registry(tmp_path):
    root = str(tmp_path / "ck")
    _run(dict(save_every=4, checkpoint_dir=root), rounds=4)
    with pytest.raises(CheckpointError, match="dict-mode"):
        make("port", dict(engine="legacy", resume_from=root))


# -- torn and corrupt checkpoints -----------------------------------------

def test_mid_save_crash_falls_back_to_previous_step(tmp_path, fused_ref):
    root = str(tmp_path / "ck")
    res = _crash_then_resume({}, (4, "mid-save"), root)
    # step 4's arrays committed but its manifest never did
    torn = os.path.join(root, "step_000004")
    assert os.path.exists(os.path.join(torn, ARRAYS))
    assert not os.path.exists(os.path.join(torn, MANIFEST))
    assert latest_checkpoint(root).endswith("step_000002")
    bit_identical(fused_ref, res)


@pytest.fixture()
def saved(tmp_path):
    """A valid step-4 checkpoint directory."""
    root = str(tmp_path / "ck")
    _run(dict(save_every=4, checkpoint_dir=root), rounds=4)
    return os.path.join(root, "step_000004")


def test_flipped_byte_is_rejected_naming_the_key(saved):
    data = dict(np.load(os.path.join(saved, ARRAYS)))
    key = "score/history"
    data[key] = data[key] + 1e-3       # silent corruption
    np.savez(os.path.join(saved, ARRAYS), **data)
    with pytest.raises(CheckpointError, match="score/history"):
        verify_checkpoint(saved)
    assert latest_checkpoint(os.path.dirname(saved)) is None


def test_dropped_key_is_rejected_naming_the_key(saved):
    data = dict(np.load(os.path.join(saved, ARRAYS)))
    data.pop("present")
    np.savez(os.path.join(saved, ARRAYS), **data)
    with pytest.raises(CheckpointError, match="present"):
        verify_checkpoint(saved)


def test_truncated_manifest_is_rejected(saved):
    with open(os.path.join(saved, MANIFEST), "w") as f:
        f.write('{"schema": 1, "kind"')
    with pytest.raises(CheckpointError, match="manifest"):
        verify_checkpoint(saved)


@pytest.mark.parametrize("server", ["fedcd", "fedavg"])
def test_resume_from_empty_root_is_an_error(tmp_path, server):
    with pytest.raises(CheckpointError, match="no valid"):
        make("port", dict(resume_from=str(tmp_path)), server=server)


def test_config_mismatch_names_the_field(saved):
    from test_torch_slice import _small_setup
    cfg, _ = _small_setup(lr=0.123)
    with pytest.raises(CheckpointError, match="lr"):
        make("port", dict(resume_from=saved), cfg=cfg)


def test_kind_mismatch_is_refused(saved):
    with pytest.raises(CheckpointError, match="kind 'fedcd'"):
        make("port", dict(resume_from=saved), server="fedavg")


# -- direct save/restore roundtrip ----------------------------------------

def test_manual_save_restore_roundtrip(tmp_path):
    srv = _run({}, rounds=4)
    path = srv.save(str(tmp_path / "snap"))
    manifest, _ = verify_checkpoint(path)
    assert manifest["round"] == 4
    res = make("port", {})
    assert res.restore(path) == 4
    assert res.rng.bit_generator.state == srv.rng.bit_generator.state
    assert res.life_rng.bit_generator.state == \
        srv.life_rng.bit_generator.state
    assert res.registry.genealogy() == srv.registry.genealogy()
    np.testing.assert_array_equal(res.present, srv.present)
    bit_identical(srv, res)
    # the prefetched round-5 sample survived (the saved RNG stream is
    # already past it — replaying the draw would double-consume)
    assert res._prefetch[0] == srv._prefetch[0] == 5
    np.testing.assert_array_equal(res._prefetch[1][0], srv._prefetch[1][0])
    np.testing.assert_array_equal(res._prefetch[1][1], srv._prefetch[1][1])
    # the eval caches came back, so the next plan reuses the same rows
    assert res.executor.plan_hints() == srv.executor.plan_hints()
    # restore wrote into the bank the executor reads, and moved its
    # version on (no speculation keyed on the old one survives)
    assert res.executor.registry.params.tree is res.registry.params.tree
    assert res.registry.params.version > 1


def test_save_is_atomic_no_tmp_residue(tmp_path):
    srv = _run({}, rounds=2)
    path = srv.save(str(tmp_path / "snap"))
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]
    # manifest commits last and agrees with the npz
    manifest, arrays = verify_checkpoint(path)
    assert set(manifest["arrays"]) == set(arrays)
    assert manifest["engine"] == "fused" and manifest["kind"] == "fedcd"
