"""The port's decode path on a tensor-parallel mesh (``lm_prefill``,
``lm_decode``, ``lm_spec_verify``, ``lm_spec_propose``,
``lm_cache_rollback``, ``make_prefill_step`` / ``make_serve_step`` and
``ServeGateway`` with ``mesh=``) against the reference's decode path and
the port's one-device run, on the CPU.

Families: reduced Qwen3-4B (dense GQA), Phi-3.5-MoE, DeepSeek-V3 (MLA +
MoE), xLSTM and Zamba2 (hybrid), float32, params the reference's
``init_lm`` through ``params_from_jax``, tokens from a numpy seed. The
sequence: an 11-token prompt through ``make_prefill_step`` in chunks of 4
(the last padded, ``n_valid`` 3), four ``make_serve_step`` decode steps,
a verify of a 4-token chunk whose draft is rejected at its second token
(its rollback), and a propose of 3 tokens that commits it. The reference
runs in-process on one device: it threads the mesh only into
``apply_moe``, so for the non-MoE families its one-device values are its
mesh run's; for the MoE families no capacity drops a token here (4 rows
and chunks of 4: at most 16 tokens, a capacity of at least 8 a shard),
so the per-shard capacity of ``data=2`` keeps the one-device values too
(the dropping cases against the reference's own mesh run are in
``tests/test_torch_lm_mesh.py``).

Layouts: ``make_host_mesh(model=2)`` and ``(model=2, data=2)`` with whole
caches (a serving pool's: cut per cell, returned whole); sharded caches
laid out by ``cache_shardings`` (returned sharded, equal to the whole
run bit for bit); and the cells on the ``cpu`` / ``cpu:0`` device
objects, where each cell computes its own pieces (MLA's latents equal
across the cells of a data shard). Heads that do not divide the cells
run gathered. Bars (those of ``tests/test_torch_lm_decode.py``): logits
1e-5, cache floats 1e-6 of each leaf's scale, ``index`` /
``pos``, verify outputs, ``n_keep`` and proposals exact; against the
reference, reduced Zamba2's cache floats at 2e-6 of their scale: the
port's ONE-DEVICE run already sits 1.06e-6 of its scale from the
reference's on ``shared.k`` (float32 rounding of the shared block at
d_model 256; the 1e-6 bar was set on d_model 64), and the mesh equals
the one-device run, which is held at 1e-6. The gateway serves a tiny
population trained on ``model=2`` in four modes; its greedy streams
equal the one-device gateway's on the same population gathered, and
the bank is unchanged.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.config import ArchConfig, FedCDConfig  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import caches_from_jax, params_from_jax  # noqa: E402
from repro_torch.federated.llm import FedLLMTrainer  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_launch_mesh)
from repro_torch.launch.sharding import cache_shardings  # noqa: E402
from repro_torch.launch.tensor_parallel import Sharded  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import ServeGateway  # noqa: E402

NAMES = ("qwen3-4b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
         "xlstm-125m", "zamba2-7b")
B, P, CH, MAXLEN, N_DEC, K = 4, 11, 4, 24, 4, 3
LOGIT_TOL, CACHE_TOL = 1e-5, 1e-6
# reduced Zamba2's caches against the reference (module docstring)
REF_CACHE_TOL = {"zamba2-7b": 2e-6}
LAYOUTS = ((2, 1), (2, 2))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunks(tokens):
    for s in range(0, tokens.shape[1], CH):
        chunk = tokens[:, s:s + CH]
        nv = chunk.shape[1]
        yield np.pad(chunk, ((0, 0), (0, CH - nv))), nv


def _t(x):
    return torch.from_numpy(np.array(x)).long()


@pytest.fixture(scope="module", params=NAMES)
def ref(request):
    """One family's reference run (jitted, one device)."""
    name = request.param
    jc = jconfigs.reduced(jconfigs.get_arch(name))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    dec = rng.integers(0, jc.vocab_size, (B, N_DEC)).astype(np.int32)
    chunk = rng.integers(0, jc.vocab_size, (B, K + 1)).astype(np.int32)
    jp = jax.jit(lambda k: jtf.init_lm(jc, k))(jax.random.PRNGKey(1))
    prefill = jax.jit(JS.make_prefill_step(jc))
    serve = jax.jit(JS.make_serve_step(jc))
    out = {"name": name, "tc": reduced(get_arch(name)), "prompt": prompt,
           "dec": dec, "chunk": chunk, "steps": []}
    c = jtf.init_lm_caches(jc, B, MAXLEN)
    for tok, nv in _chunks(prompt):
        last, c = prefill(jp, c, tok, jnp.asarray(nv, jnp.int32))
        out["steps"].append((last, c))
    for t in range(N_DEC):
        lg, c = serve(jp, c, dec[:, t:t + 1])
        out["steps"].append((lg, c))
    logits, _ = jax.jit(lambda p, c, t: jtf.lm_prefill(jc, p, t, c))(
        jp, c, chunk)
    draft = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, :-1]
    draft[:, 1] = (draft[:, 1] + 1) % jc.vocab_size
    out["draft"] = draft
    out["verify"] = jax.jit(lambda p, c, t, d: jtf.lm_spec_verify(
        jc, p, t, d, c))(jp, c, chunk, draft)
    n_keep = int(out["verify"][1])
    assert n_keep == 2, n_keep
    cur = np.asarray(out["verify"][0])[:, n_keep - 1:n_keep]
    out["cur"] = cur
    out["propose"] = jax.jit(lambda p, c, t, nk, cu: jtf.lm_spec_propose(
        jc, p, t, nk, cu, K, c))(jp, c, chunk, out["verify"][1], cur)
    out["params"] = params_from_jax(jax.tree.map(np.asarray, jp))
    return out


def _whole(caches):
    return {k: v.full(CPU) if isinstance(v, Sharded) else v
            for k, v in caches.items()}


def _port_run(ref, mesh=None, caches=None):
    """The port's sequence; returns each call's outputs (caches whole on
    the CPU) and the caches after the decode steps as they came back."""
    tc, p = ref["tc"], ref["params"]
    prefill = TS.make_prefill_step(tc, mesh=mesh)
    serve = TS.make_serve_step(tc, mesh=mesh)
    c = ttf.init_lm_caches(tc, B, MAXLEN) if caches is None else caches
    steps = []
    for tok, nv in _chunks(ref["prompt"]):
        last, c = prefill(p, c, _t(tok), nv)
        steps.append((last, _whole(c)))
    for t in range(N_DEC):
        lg, c = serve(p, c, _t(ref["dec"][:, t:t + 1]))
        steps.append((lg, _whole(c)))
    out, nk, vc = ttf.lm_spec_verify(tc, p, _t(ref["chunk"]),
                                     _t(ref["draft"]).int(), c, mesh=mesh)
    props, pc = ttf.lm_spec_propose(tc, p, _t(ref["chunk"]), nk,
                                    _t(ref["cur"]), K, c, mesh=mesh)
    return {"steps": steps, "verify": (out, nk, _whole(vc)),
            "propose": (props, _whole(pc)), "decoded": c, "verified": vc}


def _close_caches(port, want, tol=CACHE_TOL):
    assert list(port) == list(want)
    for k, w in want.items():
        g = port[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.is_floating_point:
            scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       atol=tol * scale, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=k)


def _ref_caches(tree):
    return caches_from_jax(jax.tree.map(np.asarray, tree))


def _match_reference(run, ref):
    tol = REF_CACHE_TOL.get(ref["name"], CACHE_TOL)
    for (lg, c), (rl, rc) in zip(run["steps"], ref["steps"]):
        np.testing.assert_allclose(lg.numpy(), np.asarray(rl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        _close_caches(c, _ref_caches(rc), tol)
    out, nk, vc = run["verify"]
    assert np.array_equal(out.numpy(), np.asarray(ref["verify"][0]))
    assert int(nk) == int(ref["verify"][1])
    _close_caches(vc, _ref_caches(ref["verify"][2]), tol)
    props, pc = run["propose"]
    assert np.array_equal(props.numpy(), np.asarray(ref["propose"][0]))
    _close_caches(pc, _ref_caches(ref["propose"][1]), tol)


def _match_run(a, b):
    """Two port runs: logits 1e-5, caches at the cache bar."""
    for (la, ca), (lb, cb) in zip(a["steps"], b["steps"]):
        np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        _close_caches(ca, cb)
    assert torch.equal(a["verify"][0], b["verify"][0])
    assert int(a["verify"][1]) == int(b["verify"][1])
    _close_caches(a["verify"][2], b["verify"][2])
    assert torch.equal(a["propose"][0], b["propose"][0])
    _close_caches(a["propose"][1], b["propose"][1])


@pytest.fixture(scope="module")
def one_device(ref):
    return _port_run(ref)


@pytest.mark.parametrize("md", LAYOUTS, ids=[f"{m}x{d}" for m, d in LAYOUTS])
def test_mesh_decode_matches_the_reference_and_one_device(ref, one_device,
                                                          md):
    """Whole caches on the mesh: every step against the reference and the
    port's one-device run."""
    run = _port_run(ref, make_host_mesh(model=md[0], data=md[1]))
    assert not any(isinstance(v, Sharded) for v in run["decoded"].values())
    _match_reference(run, ref)
    _match_run(run, one_device)


def test_sharded_caches_keep_their_layout(ref):
    """Caches laid out by ``cache_shardings`` come back sharded with the
    same specs (after decode, verify and its rollback), and the values are
    the whole-cache run's bit for bit."""
    mesh = make_host_mesh(model=2, data=2)
    tc = ref["tc"]
    caches = ttf.init_lm_caches(tc, B, MAXLEN)
    specs = cache_shardings(tc, caches, mesh)
    laid = {k: Sharded.place(v, mesh, specs[k].spec)
            for k, v in caches.items()}
    run = _port_run(ref, mesh, laid)
    whole = _port_run(ref, mesh)
    for tree in (run["decoded"], run["verified"]):
        for k, v in tree.items():
            assert isinstance(v, Sharded) and v.spec == specs[k].spec, k
    for (la, ca), (lb, cb) in zip(run["steps"], whole["steps"]):
        assert torch.equal(la, lb)
        for k in cb:
            assert torch.equal(ca[k], cb[k]), k
    for k, v in whole["verify"][2].items():
        assert torch.equal(run["verify"][2][k], v), k
    if tc.family != "hybrid" and tc.attn_type == "gqa":
        k0 = run["decoded"]["0.k"]
        assert k0.spec[3] == "model" and k0.spec[1] == "data"
        assert tuple(k0.pieces[0].shape) == (k0.shape[0], B // 2, MAXLEN,
                                             tc.n_kv_heads // 2,
                                             tc.resolved_head_dim())


def test_cells_on_two_device_objects(ref):
    """Cells on the ``cpu`` / ``cpu:0`` device objects, caches sharded:
    each cell computes its own pieces; the run is the one-device-object
    mesh's, and MLA's latent caches are equal across the cells of a data
    shard."""
    mesh = make_launch_mesh(2, 2, devices=["cpu", "cpu:0", "cpu:0", "cpu"])
    tc = ref["tc"]
    caches = ttf.init_lm_caches(tc, B, MAXLEN)
    specs = cache_shardings(tc, caches, mesh)
    run = _port_run(ref, mesh, {k: Sharded.place(v, mesh, specs[k].spec)
                                for k, v in caches.items()})
    _match_reference(run, ref)
    for k, v in run["decoded"].items():
        if k.endswith(("c_kv", "k_rope")):
            for sd in range(2):
                a, b = v.piece(0, sd), v.piece(1, sd)
                assert a is not b and torch.equal(a, b), k


def test_heads_that_do_not_divide_run_gathered():
    """Four model cells over two KV heads: the attention runs whole on
    the home cell against a cache whose heads are not split; the values
    are the one-device run's."""
    cfg = ArchConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab_size=64,
                     param_dtype="float32", compute_dtype="float32")
    mesh = make_host_mesh(model=4)
    p = ttf.init_lm(cfg, torch.Generator().manual_seed(0))
    caches = ttf.init_lm_caches(cfg, 2, 16)
    assert all(e is None for e in cache_shardings(cfg, caches, mesh)["0.k"]
               .spec)
    tok = torch.randint(0, 64, (2, 5), generator=torch.Generator()
                        .manual_seed(1))
    outs = []
    for m in (None, mesh):
        lg, c = ttf.lm_prefill(cfg, p, tok, caches, mesh=m)
        lg2, c = ttf.lm_decode(cfg, p, tok[:, :1], c, mesh=m)
        outs.append((lg, lg2, c))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=LOGIT_TOL)
    _close_caches(outs[1][2], outs[0][2])


# -- the gateway over a mesh-trained bank ---------------------------------------

KW = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab_size=64, param_dtype="float32",
          compute_dtype="float32")
FK = dict(n_devices=4, devices_per_round=3, score_window=2,
          milestones=(2, 5), late_delete_round=6, max_models=6, lr=0.05,
          seed=0)
MODES = (("vanilla", {}), ("spec", dict(spec_k=3)),
         ("paged", dict(paged=True)),
         ("spec+paged", dict(spec_k=3, paged=True)))


def _serve(cfg, registry, tr, kw):
    if "spec_k" in kw:
        kw = dict(kw, draft=tr.draft)
    gw = ServeGateway(cfg, registry, lambda: tr.state, max_len=64, lanes=4,
                      chunk=8, **kw)
    rng = np.random.default_rng(0)
    reqs = [gw.submit(d, rng.integers(0, cfg.vocab_size, size=10),
                      max_new=6) for d in range(8)]
    gw.drain()
    assert all(r.done and len(r.tokens) == 6 for r in reqs)
    return [r.tokens for r in reqs], gw


def test_gateway_serves_a_mesh_trained_bank():
    """A tiny population trained on ``model=2`` (5 rounds, clones live),
    served from its sharded bank in the vanilla, spec (k=3), paged and
    spec+paged modes: greedy streams equal token for token to the
    one-device gateway's on the same population gathered; the bank's
    pieces are unchanged by serving."""
    cfg = ArchConfig(**KW)
    fed = dict(FK, n_devices=8)
    init = ttf.init_lm(cfg, torch.Generator().manual_seed(0))
    tr = FedLLMTrainer(cfg, FedCDConfig(**fed), 8, 2, 16, n_archetypes=2,
                       seed=0, spec="llm", mesh=make_host_mesh(model=2),
                       init_params=init, draft_layers=1)
    tr.run(5)
    assert len(tr.registry.live_ids()) >= 2
    bank = tr.registry.params
    before = {k: [p.clone() for p in v.distinct()]
              for k, v in bank.tree.items()}
    one = copy.copy(tr.registry)
    one.params = bank.gathered()
    for mode, kw in MODES:
        streams, gw = _serve(cfg, tr.registry, tr, kw)
        want, _ = _serve(cfg, one, tr, kw)
        assert gw.mesh is bank.tree["embed.table"].mesh
        assert streams == want, mode
    for k, v in bank.tree.items():
        for a, b in zip(v.distinct(), before[k]):
            assert torch.equal(a, b), k
