"""Elastic checkpoint/resume across packages and across mesh layouts, on
the CPU, in the setup of ``tests/test_torch_elastic_resume.py`` (its
helpers): checkpoints the reference saves resumed by the port, and
resharding on resume (``tests/test_elastic_resume.py:150-190``). The
other direction and the manifests key for key are in
``tests/test_torch_elastic_cross_pkg.py`` (split off so that the two
halves take two xdist workers).

Bars:
* across packages (one package saves at round 4, the other resumes and
  runs to round 8, against the saver's uninterrupted run): discrete
  state and ``semisync_stats`` exactly equal; params to atol=1e-5, or
  within one int8 step when quantized (accuracies then to 1/16, as the
  port's other int8 parity tests);
* across layouts: a resumed run against the uninterrupted run on the
  resumer's layout, bit-identical on the same layout, params to 1e-5
  on another.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.state import MANIFEST  # noqa: E402
from repro_torch.data import scenarios as ts  # noqa: E402
from test_torch_elastic_resume import (_crash_then_resume,  # noqa: E402
                                       _faults, _run, semi)
from test_torch_semisync import bit_identical, churn, same_state  # noqa: E402
from test_torch_slice import STEP, _params_close  # noqa: E402


@pytest.fixture(scope="module")
def fused_ref():
    return _run({})


# -- across packages: the format is shared ---------------------------------

CROSS = {"fused": {}, "semisync": dict(straggler=semi),
         "churn": dict(scenario=churn)}


def cross_packages(tmp_path, saver, resumer, case, bits):
    """One package saves at round 4; the other resumes and runs to round
    8. Held against the saver's uninterrupted run."""
    kw, root = CROSS[case], str(tmp_path / "ck")
    _run(dict(kw, save_every=4, checkpoint_dir=root), rounds=4, pkg=saver,
         bits=bits)
    res = _run(dict(kw, resume_from=root), pkg=resumer, bits=bits)
    full = _run(kw, pkg=saver, bits=bits)
    ref, port = (full, res) if saver == "ref" else (res, full)
    same_state(ref, port, acc_atol=1 / 16 if bits else 0.0)
    _params_close(ref, port, atol=STEP if bits else 1e-5)
    if case == "semisync":
        assert res.semisync_stats.folded > 0
    if case == "churn":
        assert port.databank.present_ids() == ref.databank.present_ids()
        assert port.databank.row_of == {
            d: ref.databank.row_of[d] for d in ref.databank.present_ids()}


@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("case", sorted(CROSS))
@pytest.mark.parametrize("saver,resumer", [("ref", "port")])
def test_checkpoint_resumes_across_packages(tmp_path, saver, resumer, case,
                                            bits):
    """The reference saves at round 4; the port resumes and runs to
    round 8 (the other direction: ``test_torch_elastic_cross_pkg.py``)."""
    cross_packages(tmp_path, saver, resumer, case, bits)


# -- resharding-on-resume (``tests/test_elastic_resume.py:150-190``) -------

def mesh(sm, sd=1):
    """A launch mesh for either package: the port's cells on the CPU,
    the reference's one-cell mesh (its only one on a one-device host)."""
    def build(pkg):
        if pkg == "ref":
            from repro.launch.mesh import make_model_mesh
            assert (sm, sd) == (1, 1)
            return make_model_mesh(1)
        from repro_torch.launch.mesh import make_launch_mesh
        return make_launch_mesh(sm, sd, devices=["cpu"] * (sm * sd))
    return dict(model_shards=sm, data_shards=sd, mesh=build)


@pytest.fixture(scope="module")
def sharded2_ref():
    return _run(mesh(2))


def test_sharded_same_shape_resumes_bit_identical(tmp_path, sharded2_ref):
    res = _crash_then_resume(mesh(2), (5, "mid-dispatch"),
                             str(tmp_path / "ck"))
    bit_identical(sharded2_ref, res)
    # same layout -> placement restored verbatim
    assert res.registry.params.row_of == sharded2_ref.registry.params.row_of


def test_fused_checkpoint_resumes_onto_sharded_mesh(tmp_path, sharded2_ref):
    root = str(tmp_path / "ck")
    _run(dict(save_every=4, checkpoint_dir=root), rounds=4)
    res = _run(dict(mesh(2), resume_from=root))
    same_state(sharded2_ref, res, acc_atol=1e-6)
    _params_close(sharded2_ref, res, atol=1e-5)


def test_sharded_checkpoint_resumes_onto_2d_mesh(tmp_path):
    """``sharded@4`` resumes as ``sharded@2x2``: another model-shard count
    and a data axis the checkpoint never had."""
    root = str(tmp_path / "ck")
    with pytest.raises(ts.SimulatedCrash):
        _run(dict(mesh(4), save_every=2, checkpoint_dir=root,
                  faults=_faults((5, "mid-dispatch"))))
    res = _run(dict(mesh(2, 2), resume_from=root))
    ref = _run(mesh(2, 2))
    same_state(ref, res, acc_atol=1e-6)
    _params_close(ref, res, atol=1e-5)


def test_sharded_checkpoint_resumes_onto_fused(tmp_path, fused_ref):
    """The other direction: a 4-shard checkpoint whose rows are not the
    ids resumes on the one-shard fused plane, which places the ids
    anew and reads its bank through ``row_of``."""
    root = str(tmp_path / "ck")
    saver = _run(dict(mesh(4), save_every=4, checkpoint_dir=root),
                 rounds=4)
    assert any(m != r for m, r in saver.registry.params.row_of.items())
    res = _run(dict(resume_from=root))
    same_state(fused_ref, res, acc_atol=1e-6)
    _params_close(fused_ref, res, atol=1e-5)


# across packages AND layouts: (saver, its spec) -> (resumer, its spec)
RESHARD = {
    "ref sharded@1 -> port 2x2": ("ref", mesh(1), "port", mesh(2, 2)),
    "port 2x2 churn -> ref sharded@1 churn": (
        "port", dict(mesh(2, 2), scenario=churn),
        "ref", dict(mesh(1), scenario=churn)),
}


@pytest.mark.parametrize("case", sorted(RESHARD))
def test_checkpoint_resumes_across_packages_and_layouts(tmp_path, case):
    """One package saves at round 4 on one layout; the other resumes on
    another layout and runs to round 8. Held against the resumer's own
    uninterrupted run on its layout (the reference's fused run where the
    resumer is the port)."""
    saver, skw, resumer, rkw = RESHARD[case]
    root = str(tmp_path / "ck")
    _run(dict(skw, save_every=4, checkpoint_dir=root), rounds=4, pkg=saver)
    res = _run(dict(rkw, resume_from=root), pkg=resumer)
    full = _run({k: v for k, v in rkw.items()
                 if resumer == "ref" or k == "scenario"}, pkg="ref")
    same_state(full, res, acc_atol=1e-6)
    if resumer == "port":
        _params_close(full, res, atol=1e-5)
    else:
        for m in full.registry.live_ids():
            for a, b in zip(_jax_leaves(full.registry.params[m]),
                            _jax_leaves(res.registry.params[m])):
                np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    if "churn" in case:
        assert res.databank.present_ids() == full.databank.present_ids()


def _jax_leaves(tree):
    import jax
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def test_sharded_manifest_matches_the_reference_key_for_key(tmp_path):
    """The one-shard sharded plane saved by each package: the same
    arrays and the same state scalars, the bank's placement and load
    EWMA included."""
    manifests = {}
    for pkg in ("ref", "port"):
        root = str(tmp_path / pkg)
        _run(dict(mesh(1), save_every=4, checkpoint_dir=root), rounds=4,
             pkg=pkg)
        with open(os.path.join(root, "step_000004", MANIFEST)) as f:
            manifests[pkg] = json.load(f)
    ref, port = manifests["ref"], manifests["port"]
    assert {k: (v["dtype"], v["shape"]) for k, v in port["arrays"].items()} \
        == {k: (v["dtype"], v["shape"]) for k, v in ref["arrays"].items()}
    rs, ps = ref["state"], port["state"]
    assert set(ps) == set(rs)
    for key in rs:
        if key == "metrics":
            assert [dict(m, wall_s=0) for m in ps[key]] == \
                [dict(m, wall_s=0) for m in rs[key]]
        else:
            assert ps[key] == rs[key], key
