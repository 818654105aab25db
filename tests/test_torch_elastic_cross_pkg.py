"""Elastic checkpoint/resume across packages, on the CPU: checkpoints the
port saves resumed by the reference, and the manifests of both packages
key for key (the half of ``tests/test_torch_elastic_cross.py`` split off
so that the two take two xdist workers; the same helpers and bars).
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.state import MANIFEST  # noqa: E402
from test_torch_elastic_cross import CROSS, cross_packages  # noqa: E402
from test_torch_elastic_resume import _run  # noqa: E402


@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("case", sorted(CROSS))
@pytest.mark.parametrize("saver,resumer", [("port", "ref")])
def test_checkpoint_resumes_across_packages(tmp_path, saver, resumer, case,
                                            bits):
    """The port saves at round 4; the reference resumes and runs to
    round 8. Held against the port's uninterrupted run."""
    cross_packages(tmp_path, saver, resumer, case, bits)


@pytest.mark.parametrize("case", sorted(CROSS) + ["legacy", "pipeline"])
def test_manifest_matches_the_reference_key_for_key(tmp_path, case):
    """The same run saved by each package: the same arrays (keys, dtypes,
    shapes) and the same state scalars, RNG positions included."""
    kw = {"legacy": dict(engine="legacy"),
          "pipeline": dict(pipeline=True)}.get(case) or CROSS[case]
    manifests = {}
    for pkg in ("ref", "port"):
        root = str(tmp_path / pkg)
        _run(dict(kw, save_every=4, checkpoint_dir=root), rounds=4, pkg=pkg)
        with open(os.path.join(root, "step_000004", MANIFEST)) as f:
            manifests[pkg] = json.load(f)
    ref, port = manifests["ref"], manifests["port"]
    assert {k: (v["dtype"], v["shape"]) for k, v in port["arrays"].items()} \
        == {k: (v["dtype"], v["shape"]) for k, v in ref["arrays"].items()}
    for key in ("schema", "kind", "round", "engine", "config"):
        assert port[key] == ref[key], key
    rs, ps = ref["state"], port["state"]
    assert set(ps) == set(rs)
    for key in rs:
        if key == "metrics":             # wall_s is the host's clock
            assert [dict(m, wall_s=0) for m in ps[key]] == \
                [dict(m, wall_s=0) for m in rs[key]]
        else:
            assert ps[key] == rs[key], key
