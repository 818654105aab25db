"""The port's tensor-parallel LM mesh (``FedLLMTrainer(mesh=...)``,
``make_train_step`` / ``make_eval_step`` / ``lm_forward`` /
``mtp_logits`` / ``apply_moe`` with ``mesh=``) against the reference's
mesh runs, on the CPU.

The reference's mesh runs need several devices, so one JAX subprocess on
``--xla_force_host_platform_device_count=4`` runs them all, started when
the file's first test needs it and read when a test compares against it
(the port's runs go on meanwhile): the ``llm`` trainer of
``tests/test_llm_equivalence.py:18-25`` over 8 rounds on
``make_launch_mesh(model=2)`` and ``(model=2, data=2)``, and the forward
of reduced Phi-3.5-MoE at ``data=1`` / ``data=2`` and reduced DeepSeek-V3
(MLA + MoE + MTP) at ``data=2``, and the one-device forwards of those
and of reduced Qwen3-4B, xLSTM and Zamba2 (elsewhere the reference's
mesh keeps the values of its one-device run). The same subprocess runs
the reference's ``make_prefill_step`` / ``make_serve_step`` with
``mesh=make_launch_mesh(model=2, data=2)`` on reduced Phi-3.5-MoE and
DeepSeek-V3 (``DECODE_CASES``), which the port's mesh decode follows,
and, for the capacity case (reduced Phi-3.5-MoE on its forward tokens,
which overflow an expert of one data shard), a train step on a
``(pod=2, data=2, model=1)`` mesh (``dp_axes=("pod", "data")``) and a
prefill and a serve step with params laid out by the ``decode_2d``
policy on ``(model=2, data=2)`` (``POD_CASE``).

The port's mesh is ``make_host_mesh``: every cell on the CPU, the pieces
of a leaf separate tensors; one tier puts the cells on two CPU device
objects (``cpu`` / ``cpu:0``), which makes copies of replicated blocks
and sums their gradients. Bars: discrete state exact, score history
1e-6, params 1e-5, logits 1e-5; ``llm+pipeline`` bit-equal to ``llm``.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as jtf  # noqa: E402
from repro_torch.config import ArchConfig, FedCDConfig  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.spec import EngineSpec  # noqa: E402
from repro_torch.data.scenarios import (FaultEvent,  # noqa: E402
                                        FaultSchedule, SimulatedCrash)
from repro_torch.federated.llm import FedLLMTrainer  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_launch_mesh)
from repro_torch.launch.sharding import (lm_bank_shardings,  # noqa: E402
                                         param_shardings)
from repro_torch.launch.tensor_parallel import Sharded  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KW = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab_size=64, param_dtype="float32",
          compute_dtype="float32")
FK = dict(n_devices=4, devices_per_round=3, score_window=2,
          milestones=(2, 5), late_delete_round=6, max_models=6, lr=0.05,
          seed=0)
CFG, FED = ArchConfig(**KW), FedCDConfig(**FK)
N_CLIENTS, PER, SEQ = 4, 2, 16
ROUNDS = 8
TRAINER_MESHES = ((2, 1), (2, 2))
# the reference's forwards: on one device, and on the meshes listed
FORWARDS = {"deepseek-v3-671b": ((2, 2),),
            "phi3.5-moe-42b-a6.6b": ((2, 1), (2, 2)),
            "qwen3-4b": (), "xlstm-125m": (), "zamba2-7b": ()}
FWD_DIMS = (4, 24)                   # batch, seq of the forward tiers
# its tokens overflow an expert of one data shard that the whole batch
# does not: the reference's mesh run drops other tokens
CAPACITY_CASE = "phi3.5-moe-42b-a6.6b"
# the reference's mesh decode steps on (model=2, data=2): rows, chunk,
# n_valid, decode steps. 8 rows of one token and one row of a 4-token
# chunk (the gateway's admission, which cuts tokens, not rows) are 4
# tokens a data shard, under any capacity (at least 8); the forward's 4
# rows of 24 tokens overflow an expert of one data shard for Phi
DECODE_ARCHS = ("deepseek-v3-671b", "phi3.5-moe-42b-a6.6b")
DECODE_CASES = {"b8": (8, 4, 4, 2), "b1": (1, 4, 3, 1),
                "drop": (4, 24, 24, 0)}
# the pod-mesh train step and the decode_2d steps: lr, client scores
POD_CASE = (0.05, (0.25, 0.75))

_REF_SCRIPT = textwrap.dedent("""
    import json
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np


    def _jax():
        # imported in the workers only (the parent just collects)
        import jax
        from repro.models import transformer as tf
        if not hasattr(tf.init_lm, "lower"):
            tf.init_lm = jax.jit(tf.init_lm, static_argnums=0)
        assert jax.device_count() == 4, jax.device_count()
        return jax, tf


    def path_of(path):
        return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)


    def flat(out, prefix, tree):
        import jax
        for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + path_of(p)] = np.asarray(a)


    def trainer(m, d):
        jax, tf = _jax()
        from repro.config import ArchConfig, FedCDConfig
        from repro.federated.llm import FedLLMTrainer
        from repro.launch.mesh import make_launch_mesh
        out, tag = {{}}, f"trainer/{{m}}x{{d}}/"
        tr = FedLLMTrainer(ArchConfig(**{kw!r}), FedCDConfig(**{fk!r}),
                           {n}, {per}, {seq}, n_archetypes=2,
                           mesh=make_launch_mesh(model=m, data=d), seed=0,
                           spec="llm")
        flat(out, tag + "init/", tr.registry.params[0])
        tr.run({rounds})
        out[tag + "active"] = tr.state.active
        out[tag + "alive"] = tr.state.alive
        out[tag + "history"] = tr.state.history
        out[tag + "live"] = np.array(tr.registry.live_ids())
        out[tag + "genealogy"] = np.array(json.dumps(
            {{str(k): [e.parent, e.birth_round, e.alive]
             for k, e in tr.registry.entries.items()}}))
        out[tag + "trained"] = np.array([x.trained_models
                                         for x in tr.metrics])
        out[tag + "live_per_round"] = np.array([x.live_models
                                                for x in tr.metrics])
        out[tag + "loss"] = np.array([x.mean_loss for x in tr.metrics])
        for mid in tr.registry.live_ids():
            flat(out, tag + f"params/{{mid}}/", tr.registry.params[mid])
        return out


    def forwards():
        jax, tf = _jax()
        from repro.configs import get_arch, reduced
        from repro.launch.mesh import make_launch_mesh
        out = {{}}
        for i, (name, meshes) in enumerate({forwards!r}.items()):
            cfg = reduced(get_arch(name))
            p = tf.init_lm(cfg, jax.random.PRNGKey(0))
            toks = np.random.default_rng(i).integers(
                0, cfg.vocab_size, {dims!r}).astype(np.int32)
            flat(out, f"fwd/{{name}}/params/", p)
            out[f"fwd/{{name}}/tokens"] = toks
            for m, d in ((1, 1),) + tuple(meshes):
                mesh = None if m == 1 else make_launch_mesh(model=m, data=d)

                def fwd(q, t, mesh=mesh):
                    lg, h, aux = tf.lm_forward(cfg, q, t, mesh=mesh)
                    mt = (tf.mtp_logits(cfg, q, h, t, mesh) if cfg.mtp
                          else lg)
                    return lg, aux, mt

                lg, aux, mt = jax.jit(fwd)(p, toks)
                tag = f"fwd/{{name}}/{{m}}x{{d}}/"
                out[tag + "logits"] = np.asarray(lg)
                out[tag + "aux"] = np.asarray(aux)
                out[tag + "mtp"] = np.asarray(mt)
        return out


    def decodes():
        jax, tf = _jax()
        import jax.numpy as jnp
        from repro.configs import get_arch, reduced
        from repro.launch import steps
        from repro.launch.mesh import make_launch_mesh
        mesh = make_launch_mesh(model=2, data=2)
        out = {{}}
        for i, name in enumerate({decode_archs!r}):
            cfg = reduced(get_arch(name))
            p = tf.init_lm(cfg, jax.random.PRNGKey(0))
            prefill = jax.jit(steps.make_prefill_step(cfg, mesh=mesh))
            serve = jax.jit(steps.make_serve_step(cfg, mesh=mesh))
            rng = np.random.default_rng(10 + i)
            for case, (b, s, nv, n) in {decode_cases!r}.items():
                tag = f"dec/{{name}}/{{case}}/"
                toks = rng.integers(0, cfg.vocab_size,
                                    (b, s + n)).astype(np.int32)
                if case == "drop":
                    toks = np.asarray(np.random.default_rng(
                        list({forwards!r}).index(name)).integers(
                            0, cfg.vocab_size, {dims!r}), np.int32)
                out[tag + "tokens"] = toks
                c = tf.init_lm_caches(cfg, b, s + n)
                lg, c = prefill(p, c, toks[:, :s], jnp.asarray(nv, jnp.int32))
                out[tag + "0/logits"] = np.asarray(lg)
                flat(out, tag + "0/caches/", c)
                for j in range(n):
                    lg, c = serve(p, c, toks[:, s + j:s + j + 1])
                    out[tag + f"{{j + 1}}/logits"] = np.asarray(lg)
                    flat(out, tag + f"{{j + 1}}/caches/", c)
            if name == {capacity!r}:
                pods(out, cfg, p)
        return out


    def pods(out, cfg, p):
        # the capacity case on a pod mesh and under decode_2d
        import jax
        import jax.numpy as jnp
        from repro.launch import steps
        from repro.launch.mesh import _make_mesh, make_launch_mesh
        from repro.launch.sharding import param_shardings
        lr, scores = {pod_case!r}
        toks = np.asarray(np.random.default_rng(
            list({forwards!r}).index({capacity!r})).integers(
                0, cfg.vocab_size, {dims!r}), np.int32)
        mesh = _make_mesh((2, 2, 1), ("pod", "data", "model"))
        step = jax.jit(steps.make_train_step(cfg, mesh, ("pod", "data"),
                                             lr=lr, remat=False))
        q, m = step(p, toks[:, :-1], toks[:, 1:],
                    np.asarray(scores, np.float32))
        flat(out, "pod/params/", q)
        out["pod/loss"] = np.asarray(m["loss"])
        out["pod/aux"] = np.asarray(m["aux"])
        mesh = make_launch_mesh(model=2, data=2)
        pd = jax.device_put(p, param_shardings(cfg, p, mesh,
                                               policy="decode_2d"))
        prefill = jax.jit(steps.make_prefill_step(cfg, mesh=mesh))
        serve = jax.jit(steps.make_serve_step(cfg, mesh=mesh))
        b, s = toks.shape
        c = tf_caches(cfg, b, s + 1)
        lg, c = prefill(pd, c, toks, jnp.asarray(s, jnp.int32))
        out["d2/0/logits"] = np.asarray(lg)
        flat(out, "d2/0/caches/", c)
        lg, c = serve(pd, c, toks[:, :1])
        out["d2/1/logits"] = np.asarray(lg)
        flat(out, "d2/1/caches/", c)


    def tf_caches(cfg, b, n):
        from repro.models import transformer as tf
        return tf.init_lm_caches(cfg, b, n)


    if __name__ == "__main__":
        # the runs are independent: one worker process each
        out = {{}}
        ctx = mp.get_context("spawn")
        with ProcessPoolExecutor(4, mp_context=ctx) as ex:
            jobs = [ex.submit(trainer, m, d) for m, d in {trainers!r}]
            jobs.append(ex.submit(forwards))
            jobs.append(ex.submit(decodes))
            for j in jobs:
                out.update(j.result())
        np.savez({path!r}, **out)
""")


class RefJob:
    """The reference's mesh runs, in a process of its own (the forced
    device count must precede jax's start), read on first use."""

    def __init__(self, path):
        code = _REF_SCRIPT.format(
            kw=KW, fk=FK, n=N_CLIENTS, per=PER, seq=SEQ, rounds=ROUNDS,
            dims=FWD_DIMS, trainers=TRAINER_MESHES, forwards=FORWARDS,
            decode_archs=DECODE_ARCHS, decode_cases=DECODE_CASES,
            capacity=CAPACITY_CASE, pod_case=POD_CASE, path=path)
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
        self.path = path
        script = path + ".py"
        with open(script, "w") as f:
            f.write(code)
        self.log = open(path + ".log", "w+")
        # a session of its own: closing kills its workers with it
        self.proc = subprocess.Popen([sys.executable, script], env=env,
                                     stdout=self.log, stderr=self.log,
                                     start_new_session=True)
        self._data = None

    def result(self):
        if self._data is None:
            self.proc.wait(timeout=600)
            self.log.seek(0)
            assert self.proc.returncode == 0, self.log.read()[-4000:]
            self._data = dict(np.load(self.path))
        return self._data

    def close(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self.log.close()


@pytest.fixture(autouse=True, scope="module")
def ref_job(tmp_path_factory):
    job = RefJob(str(tmp_path_factory.mktemp("lmmesh") / "ref.npz"))
    yield job
    job.close()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init(ref_job):
    """The tiny LM's initial model (the reference's jitted ``init_lm`` at
    seed 0, as the subprocess's trainers draw it)."""
    from repro.config import ArchConfig as JArch
    p = jax.jit(jtf.init_lm, static_argnums=0)(JArch(**KW),
                                               jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(np.asarray, p))


def _trainer(init, spec="llm", mesh=None, **kw):
    return FedLLMTrainer(CFG, FED, N_CLIENTS, PER, SEQ, n_archetypes=2,
                         seed=0, spec=spec, mesh=mesh,
                         device=None if mesh is not None else "cpu",
                         init_params=init, **kw)


def _run(init, spec="llm", mesh=None, rounds=ROUNDS):
    tr = _trainer(init, spec, mesh)
    tr.run(rounds)
    return tr


@pytest.fixture(scope="module")
def legacy(init):
    return _run(init, "legacy")


@pytest.fixture(scope="module")
def on_mesh(init):
    return {md: _run(init, "llm", make_host_mesh(model=md[0], data=md[1]))
            for md in TRAINER_MESHES}


def _state(tr):
    return {
        "active": tr.state.active, "alive": tr.state.alive,
        "history": tr.state.history, "live": tr.registry.live_ids(),
        "genealogy": {m: [e.parent, e.birth_round, e.alive]
                      for m, e in tr.registry.entries.items()},
        "trained": [x.trained_models for x in tr.metrics],
        "live_per_round": [x.live_models for x in tr.metrics],
        "params": {m: {k: v.detach().numpy() for k, v in
                       tr.executor.params_of(m).items()}
                   for m in tr.registry.live_ids()}}


def _ref_state(arrays, tag):
    gen = json.loads(str(arrays[tag + "genealogy"]))
    live = [int(m) for m in arrays[tag + "live"]]
    return {
        "active": arrays[tag + "active"], "alive": arrays[tag + "alive"],
        "history": arrays[tag + "history"], "live": live,
        "genealogy": {int(m): v for m, v in gen.items()},
        "trained": list(arrays[tag + "trained"]),
        "live_per_round": list(arrays[tag + "live_per_round"]),
        "params": {m: {k[len(f"{tag}params/{m}/"):]: v
                       for k, v in arrays.items()
                       if k.startswith(f"{tag}params/{m}/")}
                   for m in live}}


def _same_state(a, b, atol=1e-5, exact=False):
    """Discrete state exact, history 1e-6, params ``atol`` (or equal)."""
    assert np.array_equal(a["active"], b["active"])
    assert np.array_equal(a["alive"], b["alive"])
    for key in ("live", "genealogy", "trained", "live_per_round"):
        assert a[key] == b[key], key
    np.testing.assert_allclose(a["history"], b["history"], atol=1e-6,
                               equal_nan=True)
    for m in a["params"]:
        assert set(a["params"][m]) == set(b["params"][m])
        for k, x in a["params"][m].items():
            if exact:
                assert np.array_equal(x, b["params"][m][k]), (m, k)
            else:
                np.testing.assert_allclose(x, b["params"][m][k], atol=atol,
                                           rtol=1e-6, err_msg=f"{m} {k}")


# -- the trainer --------------------------------------------------------------

def test_pipeline_and_legacy_on_the_mesh(init, on_mesh):
    """``llm+pipeline`` on the mesh is ``llm`` on the mesh at 0.0;
    ``legacy`` (unsharded params, the mesh passed to its steps) agrees
    at the params bar."""
    mesh = make_host_mesh(model=2, data=2)
    ref = _state(on_mesh[(2, 2)])
    _same_state(ref, _state(_run(init, "llm+pipeline", mesh)), exact=True)
    _same_state(ref, _state(_run(init, "legacy", mesh)))


def test_cells_on_two_device_objects(init, on_mesh):
    """Cells on the ``cpu`` and ``cpu:0`` device objects: replicated
    blocks get a copy per device, whose gradients are summed in cell
    order; the run is the one-device-object mesh's."""
    mesh = make_launch_mesh(2, 2, devices=["cpu", "cpu:0", "cpu:0", "cpu"])
    tr = _run(init, "llm", mesh)
    bank = tr.registry.params
    table = bank.tree["embed.table"]
    assert len(table.distinct()) == 4 and len(table.groups()) == 2
    _same_state(_state(on_mesh[(2, 2)]), _state(tr), atol=1e-6)


def test_mesh_bank_places_each_piece(init):
    """Every leaf of the mesh bank: each cell's piece is its block of the
    spec (all ``max_models`` rows), on the cell's device; no cell holds a
    whole leaf that its spec splits, and cells with different blocks hold
    different tensors."""
    mesh = make_launch_mesh(2, 2, devices=["cpu", "cpu:0", "cpu:0", "cpu"])
    tr = _trainer(init, "llm", mesh)
    specs = lm_bank_shardings(CFG, init, mesh)
    split = 0
    for k, leaf in tr.registry.params.tree.items():
        assert isinstance(leaf, Sharded) and leaf.spec == specs[k].spec
        full = (FED.max_models,) + tuple(init[k].shape)
        assert tuple(leaf.shape) == full
        for cell, (blk, p) in enumerate(zip(leaf.blocks(), leaf.pieces)):
            want = tuple(n // c for n, (_, c) in zip(full, blk))
            assert tuple(p.shape) == want, (k, cell)
            assert p.device.type == mesh.devices[cell].type
        if any(c > 1 for blk in leaf.blocks() for _, c in blk):
            split += 1
            assert all(tuple(p.shape) != full for p in leaf.pieces), k
            by_block = {}
            for blk, p in zip(leaf.blocks(), leaf.pieces):
                by_block.setdefault(blk, set()).add(id(p))
            ids = [i for s in by_block.values() for i in s]
            assert len(ids) == len(set(ids)), k
    # attention, MLP, the embedding and the head: every matrix splits
    assert split == 9
    row = tr.executor.params_of(0)
    for k, v in init.items():
        assert torch.equal(row[k], v), k


def test_crash_on_the_mesh_resumes_on_one_device_and_back(init, on_mesh,
                                                          tmp_path):
    """A checkpoint crosses layouts: saved on the mesh, resumed on one
    device, and the other way round, both equal to the uninterrupted
    mesh run (params at the mesh bar)."""
    mesh = make_host_mesh(model=2, data=2)
    ref = _state(on_mesh[(2, 2)])
    for tag, save_mesh, resume_mesh in (("a", mesh, None), ("b", None, mesh)):
        root = str(tmp_path / tag)
        crash = EngineSpec(engine="llm", save_every=3, checkpoint_dir=root,
                           faults=FaultSchedule(
                               (FaultEvent(5, "mid-dispatch"),)))
        with pytest.raises(SimulatedCrash):
            _run(init, crash, save_mesh)
        tr = _run(init, EngineSpec(engine="llm", resume_from=root),
                  resume_mesh)
        assert len(tr.metrics) == ROUNDS
        _same_state(ref, _state(tr))


def test_apply_moe_mesh_fallback_and_shared_expert():
    """``apply_moe(mesh=)`` on whole params: tokens that do not split
    over dp take the single-shard path (the one-device values); at
    ``data == 1`` the experts split and the shared expert adds after."""
    cfg = reduced(get_arch("deepseek-v3-671b"))
    p = ttf.init_lm(cfg, torch.Generator().manual_seed(0))
    moe = {k[len("segments.1.moe."):]: v[0] for k, v in p.items()
           if k.startswith("segments.1.moe.")}
    assert cfg.moe.n_shared
    g = torch.Generator().manual_seed(1)
    for shape, (m, d) in (((1, 5, cfg.d_model), (2, 2)),
                          ((2, 6, cfg.d_model), (2, 1))):
        x = torch.randn(shape, generator=g)
        y0, a0 = tmoe.apply_moe(moe, cfg, x)
        y, a = tmoe.apply_moe(moe, cfg, x,
                              mesh=make_host_mesh(model=m, data=d))
        np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=1e-6)
        assert abs(float(a) - float(a0)) < 1e-7


# -- the steps ----------------------------------------------------------------

def _step_inputs(cfg, seed=0, batch=8, seq=16):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g)
    return tok, torch.roll(tok, -1, 1), torch.rand(4, generator=g)


def test_eval_step_on_the_mesh():
    cfg = reduced(get_arch("qwen3-4b"))
    p = ttf.init_lm(cfg, torch.Generator().manual_seed(0))
    tok, lab, _ = _step_inputs(cfg)
    want = TS.make_eval_step(cfg, 4)(p, tok, lab)
    for m, d in ((2, 1), (2, 2)):
        got = TS.make_eval_step(cfg, 4, mesh=make_host_mesh(m, d))(
            p, tok, lab)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_mesh_transport_keeps_the_whole_leaf_blocks(monkeypatch, init):
    """``grad_transport_bits=8`` on the mesh: ``quantize_grads`` of the
    sharded gradients equals that of the same gradients gathered whole,
    bit for bit (the 128-value blocks are the whole leaf's: row-split
    pieces go to the kernels alone, column-split ones are gathered), one
    grouped call of each kernel for the one device; and the mesh step's
    codes are the one-device step's but where its gradient, equal to
    float rounding, sits on a rounding boundary (off by one, a share
    under 1e-3), its scales within 1e-5."""
    mesh = make_host_mesh(model=2, data=2)
    bank_specs = lm_bank_shardings(CFG, init, mesh)
    from repro_torch.core.registry import StackedParamBank
    bank = StackedParamBank(1, init, shardings=bank_specs)
    bank[0] = init
    row = bank[0]
    g = torch.Generator().manual_seed(4)
    whole = {k: torch.randn(v.shape, generator=g) for k, v in init.items()}
    sharded = {}
    for k, v in row.items():
        depth = ttf.stacked_depth(k)
        s = v.map(torch.zeros_like)
        s.copy_(whole[k])
        sharded[k] = s.layers(depth) if depth else s
    calls = []
    real_q = qops.quantize_group

    def q(xs, bits=8):
        out = real_q(xs, bits)
        calls.append(([tuple(x.shape) for x in xs], out))
        return out

    monkeypatch.setattr(qops, "quantize_group", q)
    got = TS.quantize_grads(sharded)
    assert len(calls) == 1
    shapes = calls[0][0]
    assert (1, 2048) in shapes                  # a row-split piece alone
    want = TS.quantize_grads({k: (list(ttf.layer_views(v, 1))
                                  if ttf.stacked_depth(k) else v)
                              for k, v in whole.items()})
    for k, v in got.items():
        parts = v if isinstance(v, list) else [v]
        ref = want[k] if isinstance(want[k], list) else [want[k]]
        for a, b in zip(parts, ref):
            assert torch.equal(a.full(torch.device("cpu")), b), k
    # one call for one device however the mesh names it ("cpu:0" cells,
    # tensors on "cpu")
    named = make_launch_mesh(2, 2, devices=["cpu:0"] * 4)
    calls.clear()
    TS.quantize_grads({k: Sharded.place(whole[k], named, v.spec)
                       for k, v in param_shardings(CFG, init,
                                                   named).items()
                       if not ttf.stacked_depth(k)})
    assert len(calls) == 1
    calls.clear()
    # the step: the mesh step's codes against the one-device step's. The
    # gradients agree to float rounding (the heads' partial sums add in
    # another order), so a code at a rounding boundary may move by one
    seen = {}
    real_qg = TS.quantize_grads

    def capture(tag):
        def q(grads, bits=8):
            out = real_qg(grads, bits)
            seen[tag] = out
            return out
        return q

    for tag, m in (("one", None), ("mesh", mesh)):
        monkeypatch.setattr(TS, "quantize_grads", capture(tag))
        params = ({k: v.clone() for k, v in init.items()} if m is None
                  else row)
        tok, lab, sc = _step_inputs(CFG)
        TS.make_train_step(CFG, mesh=m, lr=0.05, remat=False,
                           grad_transport_bits=8)(params, tok, lab, sc)
    n = off = 0
    for k in init:
        qa, sa = _codes(seen["one"][k])
        qb, sb = _codes(seen["mesh"][k])
        assert torch.abs(qa - qb).max() <= 1, k
        torch.testing.assert_close(sb, sa, rtol=1e-5, atol=0)
        n, off = n + qa.numel(), off + int((qa != qb).sum())
    assert off / n < 1e-3, (off, n)


def _codes(leaf):
    """A transported leaf's int8 codes and block scales, read back from
    its dequantized values over the WHOLE leaf's 128-value blocks (the
    block's largest value is +-127 codes)."""
    parts = leaf if isinstance(leaf, list) else [leaf]
    flat = torch.cat([(p.full(torch.device("cpu")) if isinstance(p, Sharded)
                       else p).reshape(-1).float() for p in parts])
    pad = (-flat.numel()) % 128
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, 128)
    scale = blocks.abs().amax(dim=1) / 127
    return torch.round(blocks / scale.clamp(min=1e-30)[:, None]), scale


def test_hints_keep_the_step_and_drafts_read_gathered_rows(init):
    """``make_train_step(mesh, hints=True)`` (the sharding-hint context
    around the step) moves the params as ``hints=False`` does; a mesh
    trainer's draft rows are the truncation of its rows gathered on cell
    ``(0, 0)``."""
    mesh = make_host_mesh(model=2, data=2)
    tok, lab, sc = _step_inputs(CFG)
    out = []
    for hints in (False, True):
        p = {k: v.clone() for k, v in init.items()}
        TS.make_train_step(CFG, mesh, lr=0.05, remat=False,
                           hints=hints)(p, tok, lab, sc)
        out.append(p)
    for k in init:
        assert torch.equal(out[0][k], out[1][k]), k
    tr = _trainer(init, "llm", mesh, draft_layers=1)
    tr.run(3)
    for m in tr.registry.live_ids():
        row = tr.draft.row_params(tr.draft.row(tr.registry, m))
        whole = tr.executor.params_of(m)
        assert torch.equal(row["segments.0.attn.wq"],
                           whole["segments.0.attn.wq"][:1])
        assert torch.equal(row["embed.table"], whole["embed.table"])


def test_decode_side_mesh_raises_name_15b(init):
    """The decode side takes the trainer's mesh (ROADMAP item 15b.1; the
    bars are in ``tests/test_torch_lm_mesh_decode.py``): the prefill and
    serve steps on a mesh row equal the one-device steps on the row
    gathered, and a gateway serves the sharded bank. The initial params
    laid out by the ``decode_2d`` policy (specs over combined axes,
    gathered where used) decode as they do on one device."""
    mesh = make_host_mesh(model=2)
    tr = _trainer(init, "llm", mesh)
    row = tr.registry.params[0]
    tok = torch.arange(12, dtype=torch.long).reshape(2, 6) % CFG.vocab_size
    outs = []
    for m, p in ((mesh, row), (None, tr.executor.params_of(0))):
        c = ttf.init_lm_caches(CFG, 2, 8)
        last, c = TS.make_prefill_step(CFG, mesh=m, hints=True)(
            p, c, tok, 5)
        lg, c = TS.make_serve_step(CFG, mesh=m)(p, c, tok[:, 5:])
        outs.append((last, lg, c))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    for k, v in outs[1][2].items():
        np.testing.assert_allclose(outs[0][2][k].numpy(), v.numpy(),
                                   atol=1e-6, err_msg=k)
    from repro_torch.serve import ServeGateway
    gw = ServeGateway(CFG, tr.registry, lambda: tr.state)
    req = gw.submit(0, [1, 2, 3], max_new=4)
    gw.drain()
    assert req.done and len(req.tokens) == 4
    d2 = {k: Sharded.place(init[k], mesh, v.spec)
          for k, v in param_shardings(CFG, init, mesh,
                                      policy="decode_2d").items()}
    ref = []
    for m, p in ((mesh, d2), (None, init)):
        c = ttf.init_lm_caches(CFG, 2, 8)
        _, c = ttf.lm_prefill(CFG, p, tok, c, mesh=m)
        ref.append(ttf.lm_decode(CFG, p, tok[:, :1], c, mesh=m))
    np.testing.assert_allclose(ref[0][0].numpy(), ref[1][0].numpy(),
                               atol=1e-5)
    for k, v in ref[1][1].items():
        np.testing.assert_allclose(ref[0][1][k].numpy(), v.numpy(),
                                   atol=1e-6, err_msg=k)


def test_trainer_checks_device_and_mesh(init):
    mesh = make_host_mesh(model=2)
    tr = _trainer(init, "llm", mesh)
    assert tr.device == torch.device("cpu") and tr.mesh is mesh
    FedLLMTrainer(CFG, FED, N_CLIENTS, PER, SEQ, mesh=mesh, device="cpu",
                  init_params=init)
    with pytest.raises(TypeError, match="LaunchMesh"):
        FedLLMTrainer(CFG, FED, N_CLIENTS, PER, SEQ, mesh=object(),
                      device="cpu", init_params=init)


# -- against the reference's runs (read last: the subprocess runs while
# the port-only tests above do) ------------------------------------------

@pytest.mark.parametrize("md", TRAINER_MESHES,
                         ids=[f"{m}x{d}" for m, d in TRAINER_MESHES])
def test_mesh_trainer_matches_the_reference_and_legacy(ref_job, init,
                                                       legacy, on_mesh, md):
    """``test_stacked_matches_legacy_on_tensor_parallel_mesh`` held on
    the port: ``llm`` on the mesh against the reference's mesh run and
    the port's one-device ``legacy``."""
    tr = on_mesh[md]
    assert len(tr.registry.entries) > 1
    assert not all(e.alive for e in tr.registry.entries.values())
    mine = _state(tr)
    _same_state(_state(legacy), mine)
    arrays = ref_job.result()
    tag = "trainer/{}x{}/".format(*md)
    ref_init = {k[len(tag) + 5:]: v for k, v in arrays.items()
                if k.startswith(tag + "init/")}
    assert set(ref_init) == set(init)
    for k, v in init.items():
        assert np.array_equal(ref_init[k], v.numpy()), k
    _same_state(_ref_state(arrays, tag), mine)
    np.testing.assert_allclose([x.mean_loss for x in tr.metrics],
                               arrays[tag + "loss"], atol=1e-5)


def _forward_case(arrays, name):
    tc = reduced(get_arch(name))
    pre = f"fwd/{name}/params/"
    tp = {k[len(pre):]: torch.from_numpy(v) for k, v in arrays.items()
          if k.startswith(pre)}
    t = torch.from_numpy(arrays[f"fwd/{name}/tokens"].astype(np.int64))
    return tc, tp, t


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_mesh_forward_matches_the_reference(ref_job, name):
    """``lm_forward(mesh=)`` (and DeepSeek's ``mtp_logits``) against the
    reference's: its one-device run where its mesh keeps those values
    (``data == 1``; ``data == 2`` without MoE), its MESH run for MoE at
    ``data == 2`` (routing and capacity per data shard, ``aux`` averaged
    over the data shards). There the reference's own mesh run differs
    from its one-device run for Phi (per-shard capacity drops other
    tokens), and the port follows the mesh run."""
    arrays = ref_job.result()
    tc, tp, t = _forward_case(arrays, name)
    one = f"fwd/{name}/1x1/"
    meshes = [(m, d) for m, d in ((2, 1), (4, 1), (2, 2))
              if not (tc.moe.n_experts and d > 1)] + list(FORWARDS[name])
    for m, d in meshes:
        tag = f"fwd/{name}/{m}x{d}/" if (m, d) in FORWARDS[name] else one
        mesh = make_host_mesh(model=m, data=d)
        lg, h, aux = ttf.lm_forward(tc, tp, t, mesh=mesh)
        np.testing.assert_allclose(lg.numpy(), arrays[tag + "logits"],
                                   atol=1e-5, rtol=1e-5, err_msg=tag)
        np.testing.assert_allclose(float(aux), float(arrays[tag + "aux"]),
                                   atol=1e-6, rtol=1e-6)
        if tc.mtp:
            mt = ttf.mtp_logits(tc, tp, h, t, mesh=mesh)
            np.testing.assert_allclose(mt.numpy(), arrays[tag + "mtp"],
                                       atol=1e-5, rtol=1e-5)
        if d > 1 and name == CAPACITY_CASE:
            assert np.abs(arrays[tag + "logits"]
                          - arrays[one + "logits"]).max() > 1e-3


def _ref_caches(arrays, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_mesh_decode_steps_match_the_reference_mesh_run(ref_job, name):
    """``make_prefill_step`` / ``make_serve_step`` on ``(model=2,
    data=2)`` against the reference's own mesh run (``DECODE_CASES``):
    logits 1e-5, caches 1e-6 of each leaf's scale, ``index`` / ``pos``
    exact. 8 rows split over the data shards; the batch-1 admission chunk
    does not, and ``apply_moe_mesh`` cuts its 4 tokens per shard as the
    reference does; in the ``drop`` case the per-shard capacity drops
    tokens (for Phi the reference's mesh prefill differs from the port's
    one-device prefill by more than 1e-3), so a capacity taken over the
    whole batch would fail."""
    arrays = ref_job.result()
    tc, tp, _ = _forward_case(arrays, name)
    mesh = make_host_mesh(model=2, data=2)
    prefill = TS.make_prefill_step(tc, mesh=mesh)
    serve = TS.make_serve_step(tc, mesh=mesh)
    for case, (b, s, nv, n) in DECODE_CASES.items():
        tag = f"dec/{name}/{case}/"
        toks = torch.from_numpy(arrays[tag + "tokens"].astype(np.int64))
        c = ttf.init_lm_caches(tc, b, s + n)
        outs = [prefill(tp, c, toks[:, :s], nv)]
        for j in range(n):
            outs.append(serve(tp, outs[-1][1], toks[:, s + j:s + j + 1]))
        for j, (lg, c) in enumerate(outs):
            np.testing.assert_allclose(lg.numpy(),
                                       arrays[tag + f"{j}/logits"],
                                       atol=1e-5, rtol=1e-5,
                                       err_msg=tag + str(j))
            want = _ref_caches(arrays, tag + f"{j}/caches/")
            assert list(c) == list(want)
            for k, w in want.items():
                if w.dtype.is_floating_point:
                    scale = max(1.0, float(w.abs().max()))
                    np.testing.assert_allclose(c[k].numpy(), w.numpy(),
                                               atol=1e-6 * scale, rtol=0,
                                               err_msg=tag + k)
                else:
                    assert torch.equal(c[k], w), tag + k
        if case == "drop" and name == CAPACITY_CASE:
            one = TS.make_prefill_step(tc)(
                tp, ttf.init_lm_caches(tc, b, s), toks, nv)[0]
            assert np.abs(arrays[tag + "0/logits"]
                          - one.numpy()).max() > 1e-3


def test_pod_mesh_and_decode_2d_match_the_reference_mesh_run(ref_job):
    """The capacity case against the reference's own mesh runs
    (``POD_CASE``): reduced Phi-3.5-MoE's train step on ``make_host_mesh(
    pod=2, data=2)`` with ``dp_axes=("pod", "data")`` (per-shard routing,
    capacity and load-balance loss over the flat data-parallel index:
    params 1e-5, loss and aux 1e-6), and a prefill and a serve step with
    params laid out by ``decode_2d`` on ``(model=2, data=2)`` (logits
    1e-5, caches 1e-6 of each leaf's scale, ``index`` / ``pos`` exact).
    Both differ from the port's one-device run: the tokens overflow an
    expert of one data shard."""
    arrays = ref_job.result()
    tc, tp, t = _forward_case(arrays, CAPACITY_CASE)
    lr, scores = POD_CASE
    scores = torch.tensor(scores)
    runs = []
    for mesh in (make_host_mesh(pod=2, data=2), None):
        p = {k: v.clone() for k, v in tp.items()}
        runs.append(TS.make_train_step(
            tc, mesh=mesh, dp_axes=("pod", "data"), lr=lr, remat=False)(
                p, t[:, :-1], t[:, 1:], scores))
    (q, m), (_, m1) = runs
    want = {k[len("pod/params/"):]: v for k, v in arrays.items()
            if k.startswith("pod/params/")}
    assert set(want) == set(q)
    for k, v in want.items():
        np.testing.assert_allclose(q[k].numpy(), v, atol=1e-5, rtol=0,
                                   err_msg=k)
    for key in ("loss", "aux"):
        np.testing.assert_allclose(float(m[key]),
                                   float(arrays["pod/" + key]), atol=1e-6)
    assert abs(float(arrays["pod/loss"]) - float(m1["loss"])) > 1e-4
    mesh = make_host_mesh(model=2, data=2)
    d2 = {k: Sharded.place(tp[k], mesh, v.spec)
          for k, v in param_shardings(tc, tp, mesh,
                                      policy="decode_2d").items()}
    b, s = t.shape
    c = ttf.init_lm_caches(tc, b, s + 1)
    outs = [TS.make_prefill_step(tc, mesh=mesh)(d2, c, t, s)]
    outs.append(TS.make_serve_step(tc, mesh=mesh)(d2, outs[0][1], t[:, :1]))
    for j, (lg, c) in enumerate(outs):
        np.testing.assert_allclose(lg.numpy(), arrays[f"d2/{j}/logits"],
                                   atol=1e-5, rtol=1e-5, err_msg=str(j))
        want = _ref_caches(arrays, f"d2/{j}/caches/")
        assert list(c) == list(want)
        for k, w in want.items():
            if w.dtype.is_floating_point:
                scale = max(1.0, float(w.abs().max()))
                np.testing.assert_allclose(c[k].numpy(), w.numpy(),
                                           atol=1e-6 * scale, rtol=0,
                                           err_msg=f"{j} {k}")
            else:
                assert torch.equal(c[k], w), (j, k)
    one = TS.make_prefill_step(tc)(tp, ttf.init_lm_caches(tc, b, s + 1), t,
                                   s)[0]
    assert np.abs(arrays["d2/0/logits"] - one.numpy()).max() > 1e-3
