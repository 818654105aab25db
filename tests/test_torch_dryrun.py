"""The port's dry-run tooling (``repro_torch.launch.dryrun``, the
production meshes, ``input_specs``) against the reference's, and the
tensor-parallel runtime on the layouts the dry run lays out: the
``decode_2d`` policy and the multi-pod data axes.

* Abstract inputs: for every registered arch at full size, the port's
  ``abstract_params`` / ``abstract_caches`` (``meta`` tensors) have the
  names, shapes and dtypes of the reference's ``jax.eval_shape``
  versions, and ``input_specs`` its ``ShapeDtypeStruct``s.
* Specs on the production meshes: ``param_spec`` (a pure function) of
  every full-size leaf under both policies equals the reference's, for
  ``dp = ("data",)`` and ``("pod", "data")``.
* The runtime: params laid out by ``decode_2d`` on ``model=2, data=2``
  (every cell on the CPU, and cells on the ``cpu`` / ``cpu:0`` device
  objects) run a prefill and four serve steps of the five reduced
  families equal to the port's one-device run (logits 1e-5, ``index`` /
  ``pos`` exact, cache floats 1e-6 of each leaf's scale, reduced Zamba2's
  shared KV 2e-6); on ``pod=2`` meshes reduced Qwen3-4B and Phi-3.5-MoE
  run a train step and four decode steps equal to one device (Phi with a
  capacity no batch here fills, so that one device and the data shards
  drop nothing). Phi's train step is held against the flat mesh of as
  many data cells instead: its load-balance loss is averaged over the
  data shards, as the reference's mesh run does, so it is not one
  device's; the per-shard semantics are held against the reference's own
  pod mesh run in ``tests/test_torch_lm_mesh.py``.
* The dry run end to end (the counterpart of
  ``tests/test_dryrun_integration.py``): xlstm-125m ``decode_32k`` on the
  single- and multi-pod meshes through the CLI, in-process; the
  ``decode_2d`` policy against ``train`` specs; and a reduced Qwen3-4B
  ``train_4k`` step on a ``model=2`` mesh of ``meta`` cells whose counted
  collectives equal a count made by hand from the layout.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.config import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.config import INPUT_SHAPES, override  # noqa: E402
from repro_torch.configs import (all_arch_names, decode_window,  # noqa: E402
                                 get_arch, input_specs, reduced,
                                 shape_supported)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_launch_mesh, make_model_mesh,
                                     make_production_mesh)
from repro_torch.launch.tensor_parallel import Sharded  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = all_arch_names()
FAMILIES = ("qwen3-4b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
            "xlstm-125m", "zamba2-7b")
B, P, N_DEC = 4, 4, 4
LOGIT_TOL, CACHE_TOL = 1e-5, 1e-6
CACHE_TOLS = {("zamba2-7b", "shared.k"): 2e-6,
              ("zamba2-7b", "shared.v"): 2e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(path):
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _ref_abstract(tree):
    return {_path(p): (tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_abstract(flat):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat.items()}


def _ref_params(name):
    cfg = jconfigs.get_arch(name)
    init = jed.init_encdec if cfg.family == "audio" else jtf.init_lm
    return cfg, jax.eval_shape(lambda k: init(cfg, k), jax.random.PRNGKey(0))


# -- abstract inputs ----------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_abstract_inputs_equal_the_reference(name):
    """``abstract_params``, ``abstract_caches`` (every shape the arch
    supports, with its decode window) and ``input_specs``: names, shapes
    and dtypes of the reference's."""
    jc, jp = _ref_params(name)
    tc = get_arch(name)
    tp = dryrun.abstract_params(tc)
    assert all(v.device.type == "meta" for v in tp.values())
    assert _port_abstract(tp) == _ref_abstract(jp)
    for sname, shape in INPUT_SHAPES.items():
        if not shape_supported(tc, shape):
            continue
        jshape = J_SHAPES[sname]
        window = decode_window(tc, shape)
        if jc.family == "audio":
            frames = jax.ShapeDtypeStruct(
                (jshape.global_batch, jc.encdec.source_len, jc.d_model),
                jnp.dtype(jc.compute_dtype))
            want = jax.eval_shape(lambda p, f: jed.init_encdec_caches(
                jc, p, f, jshape.seq_len, window), jp, frames)
        else:
            want = jax.eval_shape(lambda: jtf.init_lm_caches(
                jc, jshape.global_batch, jshape.seq_len, window))
        got = dryrun.abstract_caches(tc, shape, window, tp)
        assert _port_abstract(got) == _ref_abstract(want), sname
        for n_clients in (16, 32):
            want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    jconfigs.input_specs(jc, jshape, n_clients).items()}
            got = {k: (s, str(d).replace("torch.", "")) for k, (s, d) in
                   input_specs(tc, shape, n_clients).items()}
            assert got == want, sname


# -- specs on the production meshes -------------------------------------------

def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("name", ARCHS)
def test_production_param_specs_equal_the_reference(name):
    jc, jp = _ref_params(name)
    tc = get_arch(name)
    leaves = {k: s for k, (s, _) in _ref_abstract(jp).items()}
    for dp in (("data",), ("pod", "data")):
        for policy in ("train", "decode_2d"):
            for k, shape in leaves.items():
                path = tsharding.leaf_path(k)
                nstack = min(tsharding._n_stack_dims(path),
                             max(len(shape) - 1, 0))
                inner = shape[nstack:]
                want = jsharding.param_spec(jc, path, inner, dp, "model",
                                            16, policy)
                got = tsharding.param_spec(tc, path, inner, dp, "model",
                                           16, policy)
                assert [_axes(e) for e in got] == \
                    [_axes(e) for e in want], (k, dp, policy)


def test_production_meshes_and_existing_meshes():
    """The production meshes on ``meta`` cells; every existing launch
    mesh keeps its cells, their order and its axis names."""
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert single.size == 256 and multi.size == 512
    assert single.shape == {"model": 16, "data": 16}
    assert multi.shape == {"model": 16, "data": 16, "pod": 2}
    assert single.axis_names == ("model", "data")
    assert "pod" in multi.axis_names
    assert {d.type for d in multi.devices} == {"meta"}
    assert dryrun.mesh_of("model=2,data=2").shape == {"model": 2, "data": 2}
    assert dryrun.mesh_of("one") is None
    with pytest.raises(ValueError):
        dryrun.mesh_of("model=2,rows=2")
    devs = [torch.device("cpu", i % 2) for i in range(6)]
    for mesh in (make_launch_mesh(2, 3, devices=devs),
                 make_host_mesh(data=3, model=2)):
        assert mesh.axis_names == ("model", "data")
        assert mesh.shape == {"model": 2, "data": 3} and mesh.size == 6
        for sm in range(2):
            for sd in range(3):
                assert mesh.device(sm, sd) == mesh.devices[sm * 3 + sd]
    assert make_launch_mesh(2, 3, devices=devs).devices == devs
    m = make_model_mesh(4, devices=["cpu"] * 4)
    assert m.shape == {"model": 4, "data": 1}
    pod = make_host_mesh(pod=2, data=2, model=2)
    assert pod.size == 8 and pod.shape["pod"] == 2
    assert pod.axis_names == ("model", "pod", "data")
    with pytest.raises(ValueError, match="needs"):
        make_launch_mesh(2, 2, devices=["cpu"] * 3)


# -- the runtime on the new layouts -------------------------------------------

def _init(cfg, seed=0):
    return ttf.init_lm(cfg, torch.Generator().manual_seed(seed))


def _decode(cfg, params, toks, mesh=None, dp_axes=("data",)):
    """A prefill of ``P`` tokens and ``N_DEC`` serve steps; each call's
    logits and whole caches."""
    prefill = TS.make_prefill_step(cfg, mesh=mesh, dp_axes=dp_axes)
    serve = TS.make_serve_step(cfg, mesh=mesh, dp_axes=dp_axes)
    c = ttf.init_lm_caches(cfg, toks.shape[0], P + N_DEC)
    outs = [prefill(params, c, toks[:, :P], P)]
    for j in range(N_DEC):
        outs.append(serve(params, outs[-1][1], toks[:, P + j:P + j + 1]))
    return outs


def _same_decode(name, got, want):
    for j, ((lg, c), (lg0, c0)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(lg.numpy(), lg0.numpy(), atol=LOGIT_TOL,
                                   rtol=0, err_msg=f"{name} {j}")
        assert list(c) == list(c0)
        for k, w in c0.items():
            if w.dtype.is_floating_point:
                tol = CACHE_TOLS.get((name, k), CACHE_TOL)
                scale = max(1.0, float(w.abs().max()))
                np.testing.assert_allclose(c[k].numpy(), w.numpy(),
                                           atol=tol * scale, rtol=0,
                                           err_msg=f"{name} {j} {k}")
            else:
                assert torch.equal(c[k], w), (name, j, k)


def _laid_out(cfg, params, mesh, policy):
    return {k: Sharded.place(params[k], mesh, s.spec) for k, s in
            tsharding.param_shardings(cfg, params, mesh, policy).items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_2d_layout_decodes_as_one_device(name):
    """``decode_2d`` params (every non-attention 2-D weight over
    ``("data", "model")``, gathered where it is used) on ``model=2,
    data=2``, on CPU cells and on the ``cpu`` / ``cpu:0`` device
    objects."""
    cfg = reduced(get_arch(name))
    params = _init(cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P + N_DEC)))
    one = _decode(cfg, params, toks)
    for mesh in (make_host_mesh(model=2, data=2),
                 make_launch_mesh(2, 2, devices=["cpu", "cpu:0", "cpu:0",
                                                 "cpu"])):
        d2 = _laid_out(cfg, params, mesh, "decode_2d")
        combined = [k for k, v in d2.items()
                    if any(len(_axes(e)) > 1 for e in v.spec)]
        assert combined, name
        _same_decode(name, _decode(cfg, d2, toks, mesh), one)


POD_MESHES = ((2, 2, 1), (2, 1, 2))


@pytest.mark.parametrize("name", ("qwen3-4b", "phi3.5-moe-42b-a6.6b"))
@pytest.mark.parametrize("pdm", POD_MESHES,
                         ids=[f"pod{p}x{d}x{m}" for p, d, m in POD_MESHES])
def test_pod_mesh_trains_and_decodes_as_one_device(name, pdm):
    pod, data, model = pdm
    cfg = reduced(get_arch(name))
    if cfg.moe.n_experts:
        cfg = override(cfg, **{"moe.capacity_factor": 4.0})
    mesh = make_host_mesh(pod=pod, data=data, model=model)
    dp = ("pod", "data")
    params = _init(cfg)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 9)))
    scores = torch.tensor([0.25, 0.75])
    # MoE's aux is a mean over the data shards: the flat mesh of as many
    # data cells is its one-device run (module docstring)
    flat = (make_host_mesh(data=pod * data, model=model)
            if cfg.moe.n_experts else None)
    outs = []
    for m in (mesh, flat):
        p = {k: v.clone() for k, v in params.items()}
        q, met = TS.make_train_step(
            cfg, mesh=m, dp_axes=dp if m is mesh else ("data",), lr=0.05,
            remat=False)(p, toks[:, :-1], toks[:, 1:], scores)
        outs.append((q, met))
    for k, v in outs[1][0].items():
        np.testing.assert_allclose(outs[0][0][k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    for key in ("loss", "aux"):
        np.testing.assert_allclose(float(outs[0][1][key]),
                                   float(outs[1][1][key]), atol=1e-6)
    _same_decode(name, _decode(cfg, params, toks, mesh, dp),
                 _decode(cfg, params, toks))
    with pytest.raises(ValueError, match="data-parallel axes"):
        TS.make_serve_step(cfg, mesh=mesh)(
            params, ttf.init_lm_caches(cfg, B, 8), toks[:, :1])


# -- the dry run end to end ---------------------------------------------------

@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_traces_and_reports(mesh, tmp_path):
    dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--mesh",
                 mesh, "--out", str(tmp_path)])
    r = json.loads((tmp_path / f"xlstm-125m_decode_32k_{mesh}.json")
                   .read_text())
    assert r["ok"], r
    assert r["chips"] == (512 if mesh == "multi" else 256)
    t = r["roofline"]
    assert t["t_compute_s"] >= 0 and t["dominant"] in (
        "compute", "memory", "collective")
    assert r["memory"]["temp_bytes"] > 0
    assert t["collectives"]["counts"]["all-reduce"] >= 0
    assert r["cache_layout"] == "cache_shardings"
    assert r["peak_bytes_all_cells"] > 0 and r["trace_s"] > 0


def test_dryrun_decode_2d_against_train_specs():
    """``--decode2d`` on a ``model=2, data=2`` mesh of ``meta`` cells,
    counted by hand from the layout (a decode step: one pass). Under the
    ``train`` specs every cell FSDP-gathers its model block of the 4
    attention and 3 MLP weights of each layer; under ``decode_2d`` only
    the attention weights keep those specs, and the MLP weights and the
    embedding table, split over ``("data", "model")``, are gathered whole
    on each data shard's home cell, which then receives more bytes. Cell
    ``(0, 0)`` also gathers the vocabulary blocks (``train``; the table
    whole again under ``decode_2d``) and joins the data shards' logits."""
    cfg = reduced(get_arch("qwen3-4b"))
    shape = INPUT_SHAPES["decode_32k"]
    mesh = dryrun.mesh_of("model=2,data=2")
    d2 = dryrun.trace_case(cfg, shape, mesh, decode_2d=True)
    tr = dryrun.trace_case(cfg, shape, mesh)
    assert (d2["policy"], tr["policy"]) == ("decode_2d", "train")
    L = cfg.n_layers
    assert cfg.tie_embeddings

    def gathers(r, cell):
        return r["counts"]["cells"][cell]["collective_counts"]["all-gather"]

    assert gathers(tr, "1,0") == 7 * L and gathers(d2, "1,0") == 4 * L
    assert gathers(tr, "0,0") == 7 * L + 2
    assert gathers(d2, "0,0") == 4 * L + 3 * L + 3
    home = [r["counts"]["cells"]["0,1"]["collective_by_kind"]["all-gather"]
            for r in (d2, tr)]
    assert home[0] > home[1] > 0
    assert d2["roofline"]["hlo_flops_per_chip"] > 0


def test_dryrun_collectives_equal_a_count_by_hand():
    """A reduced Qwen3-4B ``train_4k`` step (full remat) on ``model=2``
    (``meta`` cells): per layer one all-reduce after the attention's
    heads and one after the MLP's ``d_ff`` pieces in the forward, one in
    the recompute (the attention's: the recompute stops after the last
    tensor the backward needs, the MLP's last product, so the MLP's sum
    is not run again) and two in the backward; the embedding's one and
    its backward's; the vocabulary blocks' one all-gather of the logits
    and its reduce-scatter; and one all-reduce of the gradient of every
    (per-layer) leaf both cells hold, to each of them."""
    cfg = reduced(get_arch("qwen3-4b"))
    shape = INPUT_SHAPES["train_4k"]
    mesh = dryrun.mesh_of("model=2")
    r = dryrun.trace_case(cfg, shape, mesh)
    cells = r["counts"]["cells"]
    specs = tsharding.param_shardings(cfg, dryrun.abstract_params(cfg),
                                      mesh)
    held_by_both = 0
    for k, s in specs.items():
        if not any(_axes(e) for e in s.spec):
            held_by_both += (cfg.n_layers if ttf.stacked_depth(k) else 1)
    L = cfg.n_layers
    assert cfg.tie_embeddings and held_by_both > 0
    c0, c1 = cells["0,0"], cells["1,0"]
    assert c0["collective_counts"]["all-reduce"] == 5 * L + 2 + held_by_both
    assert c1["collective_counts"]["all-reduce"] == held_by_both
    assert c0["collective_counts"]["all-gather"] == 1
    assert c0["collective_counts"]["reduce-scatter"] == 1
    logits = shape.global_batch * shape.seq_len * cfg.vocab_size * 4
    assert c0["collective_by_kind"]["all-gather"] == logits
    assert c1["collective_counts"]["all-gather"] == 0
    assert r["busiest_cell"] == [0, 0]
    assert r["memory"]["alias_bytes"] > 0
