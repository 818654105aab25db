"""The port's checkpoint IO and the pieces a resume restores, against the
reference's, on the CPU: every case of ``tests/test_checkpoint.py``
through ``repro_torch.checkpoint``, files written by either package read
by the other, and the unit pieces of elastic resume (registry JSON, the
banks' ``restore``, the fault schedule, ``config.to_dict``).

Bars: round trips exact (bf16 through its float32 widening, int8
verbatim); strict loads raise ``CheckpointError`` naming the offending
keys; the registry JSON, the bank placements and ``to_dict`` equal the
reference's after the same operations.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.core.registry import ModelRegistry as JRegistry  # noqa: E402
from repro.data import scenarios as js  # noqa: E402
from repro.data.bank import DeviceDataBank as JBank  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.checkpoint import (CheckpointError,  # noqa: E402
                                    load_checkpoint, load_registry,
                                    save_checkpoint, save_registry)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.registry import ModelRegistry  # noqa: E402
from repro_torch.data import scenarios as ts  # noqa: E402
from repro_torch.data.bank import DeviceDataBank  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from test_torch_slice import _small_setup  # noqa: E402

CPU = torch.device("cpu")


def tcnn_reference_params():
    from repro.models.cnn import init_cnn
    return init_cnn(jax.random.PRNGKey(0))


def test_pytree_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "d": [torch.zeros((2, 2), dtype=torch.int32)]}
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, tree, step=7, extra={"note": "x"})
    restored, step = load_checkpoint(path, tree)
    assert step == 7
    assert set(np.load(path + ".npz").files) == {"a", "b/c", "d/0"}
    for a, b in ((tree["a"], restored["a"]),
                 (tree["b"]["c"], restored["b"]["c"]),
                 (tree["d"][0], restored["d"][0])):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_registry_roundtrip(tmp_path):
    reg = ModelRegistry.create({"w": torch.zeros(2)}, m_cap=8)
    reg.clone(0, 5, {"w": torch.ones(2)})
    reg.kill(0, 9)
    p = os.path.join(tmp_path, "registry.json")
    save_registry(p, reg.to_json())
    state = load_registry(p)
    assert state["m_cap"] == 8
    entries = {e["id"]: e for e in state["entries"]}
    assert entries[0]["alive"] is False and entries[0]["death"] == 9
    assert entries[1]["parent"] == 0


def test_registry_json_roundtrip_with_deleted_ids():
    """Dead entries survive the JSON roundtrip — id allocation counts
    ALL entries, so dropping them would re-issue a dead model's id."""
    reg = ModelRegistry.create({"w": torch.zeros(2)}, m_cap=8)
    reg.clone(0, 2, {"w": torch.ones(2)})
    reg.clone(0, 2, {"w": torch.ones(2)})
    reg.kill(1, 4)
    back = ModelRegistry.from_json(reg.to_json())
    assert back.genealogy() == reg.genealogy()
    assert back.live_ids() == [0, 2]
    assert back.entries[1].death_round == 4
    assert back.total_created == reg.total_created == 3
    # next id allocates PAST the dead entry, exactly like the original
    assert back.allocate(0, 5) == reg.allocate(0, 5) == 3
    with pytest.raises(ValueError, match="m_cap"):
        ModelRegistry.create({"w": torch.zeros(2)}, m_cap=4).load_json(
            reg.to_json())


def test_registry_json_equals_the_reference():
    """The same operations give the reference's JSON, and each package
    loads the other's."""
    out = []
    for cls, w in ((JRegistry, np.zeros(2)), (ModelRegistry,
                                              torch.zeros(2))):
        reg = cls.create({"w": w}, m_cap=8, stacked=True)
        reg.clone(0, 2, {"w": w + 1})
        reg.clone(1, 3, {"w": w + 2})
        reg.kill(0, 4)
        out.append(reg)
    ref, port = out
    assert port.to_json() == ref.to_json()
    assert JRegistry.from_json(port.to_json()).genealogy() == \
        port.genealogy()
    assert ModelRegistry.from_json(ref.to_json()).genealogy() == \
        ref.genealogy()
    assert port.stacked is port.params.tree
    assert ModelRegistry.create({"w": torch.zeros(2)}).stacked is None
    # the placement the manifest records: the reference's one-shard bank
    pb, rb = port.params, ref.params
    assert (pb.n_shards, pb.rows_per_shard) == (rb.n_shards,
                                                rb.rows_per_shard)
    assert pb.row_of == rb.row_of
    assert pb._used_rows == rb._used_rows


def test_bf16_roundtrip_is_exact(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(16, 8))).bfloat16(),
            "b": torch.from_numpy(rng.normal(size=(8,))).bfloat16()}
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, tree, step=1)
    restored, _ = load_checkpoint(path, tree)
    for k in tree:
        assert restored[k].dtype == torch.bfloat16
        # bf16 -> f32 -> bf16 is lossless (bf16 values are a subset)
        assert torch.equal(tree[k], restored[k])


def test_int8_roundtrip_is_exact(tmp_path):
    """int8 quantized transport buffers store verbatim, no widening."""
    rng = np.random.default_rng(1)
    tree = {"q": torch.from_numpy(rng.integers(-128, 128, size=(32,),
                                               dtype=np.int8)),
            "scale": torch.tensor(rng.normal(), dtype=torch.float32)}
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, tree, step=2)
    assert np.load(path + ".npz")["q"].dtype == np.int8
    restored, _ = load_checkpoint(path, tree)
    assert restored["q"].dtype == torch.int8
    assert torch.equal(tree["q"], restored["q"])


def test_numpy_leaves_load_as_numpy(tmp_path):
    tree = {"a": np.arange(4, dtype=np.int32), "b": [np.ones(2)]}
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, tree)
    restored, step = load_checkpoint(path, tree)
    assert step == 0 and isinstance(restored["b"], list)
    assert restored["a"].dtype == np.int32
    np.testing.assert_array_equal(restored["b"][0], tree["b"][0])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cnn_params_cross_load(tmp_path, writer):
    """A flat port param dict and the reference's nested CNN pytree are one
    file: ``conv.3`` is ``conv/3``. Each package loads the other's."""
    jp = jax.tree.map(np.asarray, tcnn_reference_params())
    tp = params_from_jax(jp)
    path = os.path.join(tmp_path, "ckpt")
    if writer == "ref":
        jio.save_checkpoint(path, jp, step=3)
        restored, step = load_checkpoint(path, tp)
        assert step == 3 and list(restored) == list(tp)
        for k, v in tp.items():
            assert torch.equal(restored[k], v)
    else:
        save_checkpoint(path, tp, step=3)
        restored, step = jio.load_checkpoint(path, jp)
        assert step == 3
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(restored)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_port_cnn_names_are_the_reference_paths(tmp_path):
    params = tcnn.init_cnn(torch.Generator().manual_seed(0))
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, params)
    jp = tcnn_reference_params()
    paths = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path_)
             for path_, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert sorted(np.load(path + ".npz").files) == sorted(paths)


# -- atomicity + strict validation --------------------------------------

@pytest.fixture()
def ckpt(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, tree, step=3)
    return path, tree


def test_no_tmp_residue(ckpt):
    path, _ = ckpt
    d = os.path.dirname(path) or "."
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_missing_meta_is_a_torn_checkpoint(ckpt):
    path, tree = ckpt
    os.remove(path + ".meta.json")
    with pytest.raises(CheckpointError, match="unreadable"):
        load_checkpoint(path, tree)


def test_missing_key_names_it(ckpt):
    path, tree = ckpt
    with pytest.raises(CheckpointError, match="missing keys.*'c'"):
        load_checkpoint(path, {**tree, "c": torch.zeros(2)})


def test_extra_key_names_it(ckpt):
    path, tree = ckpt
    with pytest.raises(CheckpointError, match="extra keys.*'b'"):
        load_checkpoint(path, {"a": tree["a"]})


def test_checksum_mismatch_names_the_key(ckpt):
    path, tree = ckpt
    data = dict(np.load(path + ".npz"))
    data["a"] = data["a"] + 1.0        # corrupt one array in place
    np.savez(path + ".npz", **data)
    with pytest.raises(CheckpointError, match="checksum.*'a'"):
        load_checkpoint(path, tree)
    # non-strict skips validation (salvage mode) and loads the bytes
    restored, _ = load_checkpoint(path, tree, strict=False)
    assert torch.equal(restored["a"], tree["a"] + 1.0)


def test_npz_meta_key_drift_is_rejected(ckpt):
    path, tree = ckpt
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    meta["keys"].append("ghost")
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(CheckpointError, match="ghost"):
        load_checkpoint(path, tree)


def test_reference_checkpoint_errors_are_caught_alike(ckpt):
    """The meta the port writes is the reference's: the reference's
    strict loader accepts it, and rejects a corrupted one naming the
    key."""
    path, tree = ckpt
    like = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    restored, step = jio.load_checkpoint(path, like)
    assert step == 3
    data = dict(np.load(path + ".npz"))
    data["b"] = data["b"] * 2.0
    np.savez(path + ".npz", **data)
    with pytest.raises(jio.CheckpointError, match="checksum.*'b'"):
        jio.load_checkpoint(path, like)


# -- the banks' restore ------------------------------------------------

def _host_rows(m_ids, shape=(3, 2)):
    return {m: {"w": np.full(shape, float(m + 1), np.float32),
                "b": np.full((2,), -float(m), np.float32)} for m in m_ids}


def test_param_bank_restore_writes_in_place():
    reg = ModelRegistry.create({"w": torch.zeros(3, 2), "b": torch.zeros(2)},
                               m_cap=6, stacked=True)
    pb = reg.params
    ptrs = {k: v.data_ptr() for k, v in pb.tree.items()}
    pb.tree["w"][5].fill_(7.0)             # a row the checkpoint omits
    v0 = pb.version
    pb.restore(_host_rows([1, 3]), row_of={0: 0, 1: 1, 2: 2, 3: 3},
               used_rows={0, 1, 2, 3}, load_ewma=np.zeros(1))
    assert {k: v.data_ptr() for k, v in pb.tree.items()} == ptrs
    assert pb.version == v0 + 1
    assert 1 in pb and 3 in pb and 0 not in pb
    assert torch.equal(pb[3]["w"], torch.full((3, 2), 4.0))
    assert torch.equal(pb[1]["b"], torch.full((2,), -1.0))
    assert torch.equal(pb.tree["w"][5], torch.full((3, 2), 7.0))
    assert pb.row_of == {0: 0, 1: 1, 2: 2, 3: 3}
    # another layout's checkpoint (no placement): ids re-place through
    # the least-loaded allocator, as the reference's bank places them;
    # a saved placement restores verbatim, whatever its rows
    rb = JRegistry.create({"w": np.zeros((3, 2), np.float32),
                           "b": np.zeros(2, np.float32)},
                          m_cap=6, stacked=True).params
    for kw in (dict(), dict(row_of={1: 4})):
        rows = _host_rows([2] if not kw else [1])
        pb.restore(rows, **kw)
        rb.restore(rows, **kw)
        assert (pb.row_of, pb._used_rows, pb._present) == \
            (rb.row_of, rb._used_rows, rb._present)
        for m in rows:
            assert torch.equal(pb[m]["w"], torch.from_numpy(rows[m]["w"]))
    assert pb.row_of == {1: 4} and pb.tree["w"][4][0, 0] == 2.0


def _devices(d_ids, fill):
    split = {"train": 4, "val": 2, "test": 2}
    return {d: {k: (np.full((n, 32, 32, 3), fill + d, np.float32),
                    np.full((n,), d % 10, np.int32))
                for k, n in split.items()} for d in d_ids}


@pytest.mark.parametrize("verbatim", [True, False])
def test_data_bank_restore_places_like_the_reference(verbatim):
    """Rows land where the reference's one-shard bank puts them (verbatim
    with ``row_of``; otherwise the lowest free row per sorted id), in
    place, ``version`` moved on once; rows not named keep their data."""
    _, data = _small_setup(n_devices=4, n_train=4, n_eval=2)
    port = DeviceDataBank(data, CPU, n_cap=6, id_cap=9)
    ref = JBank(data, n_cap=6, id_cap=9)
    ptrs = [t.data_ptr() for pair in port.splits.values() for t in pair]
    before = port.splits["train"][0].clone()
    row_of = {1: 3, 5: 0, 7: 4} if verbatim else None
    devices = _devices([1, 5, 7], fill=100.0)
    v0 = port.version
    for bank in (ref, port):
        bank.restore(devices, next_id=8, row_of=row_of)
    assert port.row_of == ref.row_of
    assert port.present_ids() == ref.present_ids() == [1, 5, 7]
    assert port.next_id == ref.next_id == 8
    assert port.version == v0 + 1
    assert [t.data_ptr() for pair in port.splits.values()
            for t in pair] == ptrs
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(port.splits[k][0].numpy(),
                                      np.asarray(ref.splits[k][0]))
        np.testing.assert_array_equal(port.splits[k][1].numpy(),
                                      np.asarray(ref.splits[k][1]))
    untouched = sorted(set(range(6)) - set(port.row_of.values()))
    assert torch.equal(port.splits["train"][0][untouched],
                       before[untouched])
    # a join after the restore takes the lowest free row, as there
    dev = ts.ChurnSchedule(n_train=4, n_val=2, n_test=2).make_device(
        np.random.default_rng(0), 2)
    jdev = js.ChurnSchedule(n_train=4, n_val=2, n_test=2).make_device(
        np.random.default_rng(0), 2)
    assert port.add(dev) == ref.add(jdev) == 8
    assert port.row_of == ref.row_of
    assert port.n_shards == ref.n_shards == 1
    assert port.rows_per_shard == ref.rows_per_shard == 6


# -- fault schedule and config -------------------------------------------

def test_fault_schedule_matches_the_reference():
    assert ts.FAULT_PHASES == js.FAULT_PHASES
    events = [(2, "post-plan"), (4, "mid-save")]
    port = ts.FaultSchedule(tuple(ts.FaultEvent(*e) for e in events))
    ref = js.FaultSchedule(tuple(js.FaultEvent(*e) for e in events))
    for t in range(1, 6):
        for phase in ts.FAULT_PHASES:
            assert port.fires(t, phase) == ref.fires(t, phase)
    port.check(2, "mid-dispatch")
    with pytest.raises(ts.SimulatedCrash, match="round 2 \\(post-plan\\)"):
        port.check(2, "post-plan")
    assert issubclass(ts.SimulatedCrash, RuntimeError)
    with pytest.raises(ValueError, match="unknown fault phase"):
        ts.FaultEvent(1, "mid-lunch")


def test_config_serialises_as_the_reference():
    cfg, _ = _small_setup(quantize_bits=8)
    port = tconfig.FedCDConfig(**dataclasses.asdict(cfg))
    assert tconfig.to_dict(port) == jconfig.to_dict(cfg)
    assert tconfig.to_json(port) == jconfig.to_json(cfg)
    assert json.loads(tconfig.to_json(port))["milestones"] == [2, 5]
    moved = tconfig.override(port, lr=0.5, seed=3)
    assert (moved.lr, moved.seed, moved.n_devices) == (0.5, 3, 8)
    assert tconfig.to_dict(moved) == jconfig.to_dict(
        jconfig.override(cfg, lr=0.5, seed=3))
