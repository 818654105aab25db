"""The port's EngineSpec against the reference's: the same preset
grammar, the same canonical strings, the same ``ValueError``s (the
servers refuse ``engine="llm"`` with the reference's), the reference's
default straggler model behind ``+semisync``. Semi-synchronous and
churn specs construct and run, and so do the sharded planes (ROADMAP
item 12: ``sharded@S[xD]``, an injected launch mesh, ``+migrate``; a
sharded preset with ``device="cpu"`` puts its cells on the CPU); the
checkpoint fields and ``faults`` construct and act as in the reference
(paths under ``tmp_path``).

Cases are those of ``tests/test_spec.py`` (presets, bad presets, invalid
combinations), each run through both packages.
"""
import dataclasses
import os
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fedcd import FedCDServer as JFedCD  # noqa: E402
from repro.core.spec import EngineSpec as JSpec  # noqa: E402
from repro.data.scenarios import StragglerModel as JStraggler  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.checkpoint import CheckpointError  # noqa: E402
from repro_torch.core.fedavg import FedAvgServer as TFedAvg  # noqa: E402
from repro_torch.core.fedcd import FedCDServer as TFedCD  # noqa: E402
from repro_torch.core.spec import EngineSpec, resolve_spec  # noqa: E402
from repro_torch.data.scenarios import (  # noqa: E402
    ChurnSchedule, DeviceJoin, DeviceLeave, FaultEvent, FaultSchedule,
    StragglerModel)
from repro_torch.models import mlp as tmlp  # noqa: E402
from test_torch_slice import _small_setup, _tcfg  # noqa: E402

PRESETS = [
    "fused", "batched", "legacy",
    "sharded@4", "sharded@2x2",
    "fused+pipeline", "fused+semisync",
    "sharded@2x2+pipeline", "fused+sparse:0.25",
    "sharded@2+migrate:1.5", "fused+kernel",
    "sharded@4+pipeline+semisync+sparse:0.5+migrate:2+kernel",
]
BAD_PRESETS = [
    "sharded", "fused@2", "sharded@two", "sharded@2x2x2", "fused+bogus",
    "fused+sparse", "fused+pipeline:1", "batched+pipeline", "warp",
    # a preset the reference rejects stays a ValueError with +semisync
    "legacy+semisync", "batched+semisync+pipeline",
]
STAND_IN = object()          # for the reference's StragglerModel / scenario
BAD_COMBOS = [
    dict(engine="nope"),
    dict(model_shards=0),
    dict(data_shards=-1),
    dict(engine="batched", model_shards=2),
    dict(engine="legacy", pipeline=True),
    dict(engine="batched", sparse_eval=0.5),
    dict(engine="legacy", scenario=STAND_IN),
    dict(engine="batched", straggler=STAND_IN),
    dict(migrate_threshold=1.5),
    dict(model_shards=1, data_shards=2, use_agg_kernel=True),
    dict(save_every=-1),
    dict(save_every=2),
    dict(engine="llm", use_agg_kernel=True),
]


def _mlp():
    return tmlp.init_mlp_classifier(torch.Generator().manual_seed(0),
                                    hidden=8)


@pytest.mark.parametrize("text", PRESETS)
def test_preset_canonical_matches_reference(text):
    ref = JSpec.parse(text)
    spec = EngineSpec.parse(text)
    assert spec.canonical == ref.canonical
    assert EngineSpec.parse(spec.canonical) == spec
    for name in ("engine", "model_shards", "data_shards", "pipeline",
                 "sparse_eval", "migrate_threshold", "use_agg_kernel"):
        assert getattr(spec, name) == getattr(ref, name), name
    # "+semisync" attaches the reference's default straggler model
    assert (spec.straggler is None) == (ref.straggler is None)
    if "semisync" in text:
        assert isinstance(spec.straggler, StragglerModel)
        assert isinstance(ref.straggler, JStraggler)
        for f in dataclasses.fields(ref.straggler):
            assert (getattr(spec.straggler, f.name)
                    == getattr(ref.straggler, f.name)), f.name


@pytest.mark.parametrize("text", BAD_PRESETS)
def test_bad_preset_rejected_like_reference(text):
    with pytest.raises(ValueError):
        JSpec.parse(text)
    with pytest.raises(ValueError):
        EngineSpec.parse(text)


@pytest.mark.parametrize("bad", BAD_COMBOS)
def test_invalid_combination_rejected_like_reference(bad):
    if bad.get("straggler") is None and bad.get("scenario") is None:
        with pytest.raises(ValueError):
            JSpec(**bad).validate()
    with pytest.raises(ValueError):
        EngineSpec(**bad).validate()


def test_mesh_raises_not_implemented(monkeypatch):
    """The launch mesh is ported (ROADMAP item 12): what raised
    ``NotImplementedError`` here now acts as in the reference. A sharded
    preset's mesh takes that many CUDA devices and raises where there
    are fewer (as ``jax.make_mesh`` does beyond the device count); a
    stand-in without a ``shape`` fails both packages' shape check with
    ``AttributeError``; an injected mesh of another shape than the spec
    is the reference's ``ValueError``; ``engine="sharded"`` takes its
    shard counts from the mesh and needs one."""
    from repro.launch.mesh import make_model_mesh as j_model_mesh
    from repro_torch.launch.mesh import make_launch_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA devices"):
        EngineSpec.parse("sharded@4").resolve_mesh()
    assert EngineSpec.parse("legacy").resolve_mesh() is None
    for cls in (EngineSpec, JSpec):
        with pytest.raises(AttributeError):
            cls(mesh=object()).validate()
        with pytest.raises(AttributeError):
            cls.from_legacy(engine="sharded", mesh=object())
        with pytest.raises(ValueError):
            cls.from_legacy(engine="sharded")         # mesh required
    with pytest.raises(ValueError, match="does not match"):
        JSpec(model_shards=2, mesh=j_model_mesh(1)).validate()
    one = make_launch_mesh(1, 1, devices=["cpu"])
    with pytest.raises(ValueError, match="does not match"):
        EngineSpec(model_shards=2, mesh=one).validate()
    mesh = make_launch_mesh(2, 2, devices=["cpu"] * 4)
    spec = EngineSpec.from_legacy(engine="sharded", mesh=mesh)
    assert (spec.engine, spec.model_shards, spec.data_shards) == \
        ("fused", 2, 2)
    assert spec.resolve_mesh() is mesh
    assert spec.canonical == "sharded@2x2"
    assert EngineSpec.parse("sharded@2").with_mesh(mesh).mesh is mesh


def test_coerce_and_resolve_spec_follow_reference():
    assert EngineSpec.coerce("fused") == EngineSpec()
    spec = EngineSpec(engine="legacy")
    assert EngineSpec.coerce(spec) is spec
    with pytest.raises(TypeError):
        EngineSpec.coerce({"engine": "fused"})
    with pytest.raises(TypeError):
        resolve_spec("fused", dict(engine="fused"), "Srv")
    with pytest.warns(DeprecationWarning):
        assert (resolve_spec(None, dict(engine="batched"), "Srv")
                == EngineSpec(engine="batched"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_spec(None, dict(engine=None), "Srv") == EngineSpec()


@pytest.mark.parametrize("spec", ["fused", "batched", "legacy",
                                  "legacy+kernel", "batched+kernel"])
def test_servers_accept_ported_engines(spec):
    cfg, data = _small_setup()
    p = _mlp()
    srv = TFedCD(_tcfg(cfg), p, tmlp.mlp_loss, tmlp.mlp_accuracy, data,
                 batch_size=16, spec=spec, device="cpu")
    assert srv.spec == EngineSpec.parse(spec)
    assert srv.engine == spec.split("+")[0]
    if "kernel" not in spec:
        avg = TFedAvg(_tcfg(cfg), p, tmlp.mlp_loss, tmlp.mlp_accuracy,
                      data, batch_size=16, spec=spec, device="cpu")
        assert avg.engine == spec


@pytest.mark.parametrize("server,kw", [
    ("fedcd", dict(spec="fused+pipeline")),
    ("fedcd", dict(spec="fused+sparse:0.25")),
    ("fedcd", dict(pipeline=True)),
    ("fedcd", dict(sparse_eval=0.5)),
    ("fedavg", dict(spec="fused+pipeline")),
])
def test_servers_accept_pipelined_and_sparse_specs(server, kw):
    """``+pipeline`` and ``+sparse:<x>`` (and their deprecated kwargs)
    construct and run on the fused engine."""
    cfg, data = _small_setup()
    cls = TFedCD if server == "fedcd" else TFedAvg
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        srv = cls(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy,
                  data, batch_size=16, device="cpu", **kw)
    assert srv.engine == "fused"
    assert srv.spec.pipeline == bool(kw.get("pipeline")
                                     or "pipeline" in kw.get("spec", ""))
    srv.run(2)
    assert len(srv.metrics) == 2
    if srv.spec.pipeline:
        assert srv.pipeline_stats.speculated >= 1
    else:
        assert srv.pipeline_stats is None
        assert srv.planner.sparse_rounds >= 0


def test_kernel_flag_changes_nothing():
    """``+kernel`` is accepted for grammar parity: the port's kernels
    are always the path on CUDA tensors, so the run is the same."""
    cfg, data = _small_setup()
    out = []
    for spec in ("legacy", "legacy+kernel"):
        srv = TFedCD(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy,
                     data, batch_size=16, spec=spec, device="cpu")
        srv.run(2)
        out.append(srv)
    for k, v in out[0].registry.params[0].items():
        assert torch.equal(v, out[1].registry.params[0][k])
    np.testing.assert_array_equal(out[0].metrics[-1].test_acc,
                                  out[1].metrics[-1].test_acc)


def test_deprecated_kwargs_build_the_equivalent_spec():
    cfg, data = _small_setup()
    with pytest.warns(DeprecationWarning):
        srv = TFedCD(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy,
                     data, batch_size=16, engine="batched", device="cpu")
    assert srv.spec == EngineSpec(engine="batched")
    with pytest.warns(DeprecationWarning):
        srv = TFedCD(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy,
                     data, batch_size=16, engine="legacy",
                     use_agg_kernel=True, device="cpu")
    assert srv.spec == EngineSpec(engine="legacy", use_agg_kernel=True)
    with pytest.warns(DeprecationWarning):
        fa = TFedAvg(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy,
                     data, batch_size=16, engine="legacy", device="cpu")
    assert fa.spec == EngineSpec(engine="legacy")
    for cls in (TFedCD, TFedAvg):
        with pytest.raises(TypeError):
            cls(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy, data,
                spec="fused", engine="fused", device="cpu")


# item 12 is ported: the sharded specs construct and run, on the
# executor the reference picks for them (``exc`` None, ``match`` the
# executor's class); the rest raise the reference's errors
@pytest.mark.parametrize("kw,exc,match", [
    (dict(spec="sharded@2"), None, "ShardedExecutor"),
    (dict(spec="sharded@2x2+pipeline"), None, "Sharded2DExecutor"),
    (dict(spec="sharded@2+migrate:1.5"), None, "ShardedExecutor"),
    (dict(spec=EngineSpec(scenario=ChurnSchedule(), model_shards=2)),
     None, "ShardedExecutor"),
    # the LM plane is another trainer's spec: the reference's ValueError
    (dict(spec="llm"), ValueError, "mode-B LM plane"),
    # a mesh stand-in without a shape: the reference's AttributeError
    (dict(mesh=object()), AttributeError, "shape"),
])
def test_fedcd_rejects_unported_fields_at_construction(kw, exc, match):
    cfg, data = _small_setup()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if exc is not None:
            with pytest.raises(exc, match=match):
                TFedCD(_tcfg(cfg), _mlp(), tmlp.mlp_loss,
                       tmlp.mlp_accuracy, data, batch_size=16,
                       device="cpu", **kw)
            return
        srv = TFedCD(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy,
                     data, batch_size=16, device="cpu", **kw)
    assert type(srv.executor).__name__ == match
    assert srv.registry.params.n_shards == srv.spec.model_shards
    srv.run(1)
    assert len(srv.metrics) == 1


@pytest.mark.parametrize("spec,exc", [
    ("sharded@2", None),                 # item 12: constructs and runs
    ("llm", ValueError),                 # as in the reference
    # FedCD-only capabilities: ValueError, as in the reference
    ("fused+sparse:0.5", ValueError),
    ("fused+kernel", ValueError),
    ("legacy+kernel", ValueError),
    (EngineSpec(scenario=STAND_IN), ValueError),
    ("sharded@2+migrate:2", ValueError),
])
def test_fedavg_rejects_at_construction(spec, exc):
    cfg, data = _small_setup()
    if exc is None:
        srv = TFedAvg(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy,
                      data, batch_size=16, spec=spec, device="cpu")
        assert type(srv.executor).__name__ == "FedAvgShardedExecutor"
        srv.run(1)
        return
    with pytest.raises(exc):
        TFedAvg(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy, data,
                batch_size=16, spec=spec, device="cpu")


def _churn():
    return ChurnSchedule(events=(DeviceLeave(1, 0), DeviceJoin(1, 3)),
                         n_train=64, n_val=32, n_test=32)


@pytest.mark.parametrize("server,spec", [
    ("fedcd", "fused+semisync"),
    ("fedcd", "fused+pipeline+semisync"),
    ("fedavg", "fused+semisync"),
    ("fedavg", "fused+pipeline+semisync"),
    ("fedcd", EngineSpec(scenario=_churn())),
    ("fedcd", EngineSpec(scenario=_churn(), pipeline=True,
                         sparse_eval=1.1)),
])
def test_servers_run_semisync_and_churn_specs(server, spec):
    """The specs items 8 and 9 port: they construct and run a round."""
    cfg, data = _small_setup()
    cls = TFedCD if server == "fedcd" else TFedAvg
    srv = cls(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy, data,
              batch_size=16, spec=spec, device="cpu")
    srv.run(1)
    assert len(srv.metrics) == 1
    if srv.spec.straggler is not None:
        assert srv.semisync_stats.rounds == 1
    if srv.spec.scenario is not None:
        assert srv.semisync_stats is None
        assert not srv.present[0] and srv.present[cfg.n_devices]
        assert srv.executor.databank.row_of[cfg.n_devices] == 0


# -- the checkpoint fields (item 10): live, as in the reference ------------

def _server(server, spec):
    cfg, data = _small_setup()
    cls = TFedCD if server == "fedcd" else TFedAvg
    return cls(_tcfg(cfg), _mlp(), tmlp.mlp_loss, tmlp.mlp_accuracy, data,
               batch_size=16, spec=spec, device="cpu")


@pytest.mark.parametrize("server", ["fedcd", "fedavg"])
@pytest.mark.parametrize("extra", [{}, dict(straggler=StragglerModel())])
def test_checkpoint_dir_and_save_every_construct_and_save(tmp_path, server,
                                                          extra):
    root = tmp_path / "ckpt"
    srv = _server(server, EngineSpec(checkpoint_dir=str(root), save_every=2,
                                     **extra))
    srv.run(3)
    assert sorted(os.listdir(root)) == ["LATEST", "step_000002"]
    # checkpoint_dir alone saves nothing on its own; save() still works
    srv = _server(server, EngineSpec(checkpoint_dir=str(tmp_path / "b")))
    srv.run(1)
    assert not (tmp_path / "b").exists()
    assert os.path.exists(srv.save(str(tmp_path / "snap")))


@pytest.mark.parametrize("server", ["fedcd", "fedavg"])
def test_resume_from_an_empty_root_raises_checkpoint_error(tmp_path,
                                                           server):
    with pytest.raises(CheckpointError, match="no valid"):
        _server(server, EngineSpec(resume_from=str(tmp_path)))


@pytest.mark.parametrize("server", ["fedcd", "fedavg"])
def test_a_fault_schedule_constructs(server):
    faults = FaultSchedule((FaultEvent(3, "post-plan"),))
    srv = _server(server, EngineSpec(faults=faults))
    srv.run(2)
    assert srv.spec.faults is faults and len(srv.metrics) == 2


def test_a_faults_stand_in_acts_as_in_the_reference():
    """Neither package checks the type of ``faults``: a stand-in that is
    not a schedule constructs, and the first phase hook of a round raises
    ``AttributeError`` (semi-sync too: FedAvg's case of the old list)."""
    cfg, data = _small_setup()
    ref = JFedCD(cfg, jmlp.init_mlp_classifier(jax.random.PRNGKey(0),
                                               hidden=32),
                 jmlp.mlp_loss, jmlp.mlp_accuracy, data, batch_size=16,
                 spec=JSpec(faults=STAND_IN))
    with pytest.raises(AttributeError):
        ref.run_round(1)
    for server, spec in (("fedcd", EngineSpec(faults=STAND_IN)),
                         ("fedavg", EngineSpec(straggler=StragglerModel(),
                                               faults=STAND_IN))):
        srv = _server(server, spec)
        with pytest.raises(AttributeError):
            srv.run_round(1)
