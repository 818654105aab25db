"""The port's serving gateway (``repro_torch.serve.ServeGateway``), the
trainer's draft rows and ``launch/serve.py`` against the reference's, on
the CPU.

* One module fixture runs the reference's vanilla and spec
  (``spec_k=3``, a 1-layer draft) gateways once each over a two-model
  ``TINY`` population (the reference's ``init_lm`` and a perturbed
  clone, synthetic scores as ``tests/test_gateway.py:95-108``; 8
  requests, prompt 10, ``max_new`` 6, 4 lanes, chunk 8). The port's
  greedy streams, ``dispatches``, ``tokens_out`` and spec counts on the
  same population equal them exactly.
* Port alone: spec / paged / spec+paged ≡ vanilla on ``TINY`` and the
  four gateway configs of ``tests/test_gateway.py:37-55``
  (``tests/test_specdecode.py:160-188``; the populations are the port's
  ``init_lm`` of seed 0 and a perturbed clone); gateway decode ≡ the
  batch-1 ``make_prefill_step`` / ``make_serve_step`` path; lane
  backfill; ``sync`` re-routing on delete (drafts released too); the
  top-k bounds; ``launch/serve.py``'s ``spec_decode`` ≡ greedy decode on
  the five families of ``tests/test_specdecode.py:65-102``.
* ``FedLLMTrainer(draft_layers=1)``: the draft rows after 3 rounds equal
  the reference trainer's (1e-6, the trainer's params bar), and draft
  rows cross packages in checkpoints both ways (a depth mismatch raises,
  missing rows are re-derived).

Paged int8 KV is not bit-equal to dense KV: the equality of streams
holds where no greedy choice is a near-tie within the int8 noise, as in
the reference's own tests.
"""
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.core import scores as jscores  # noqa: E402
from repro.core.spec import EngineSpec as JSpec  # noqa: E402
from repro.federated.llm import FedLLMTrainer as JTrainer  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import ServeGateway as JGateway  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.checkpoint.io import CheckpointError  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import registry as treg  # noqa: E402
from repro_torch.core import scores as tscores  # noqa: E402
from repro_torch.federated.llm import FedLLMTrainer  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import (RequestRejected, ServeGateway,  # noqa: E402
                               draft_config, truncate_lm_params)

F32 = dict(param_dtype="float32", compute_dtype="float32")
COMMON = dict(n_heads=4, d_ff=128, vocab_size=64, d_model=64, **F32)


def _configs(pkg):
    return {
        "tiny": pkg.ArchConfig(name="tiny", n_layers=2, n_kv_heads=2,
                               **COMMON),
        "dense_win": pkg.ArchConfig(name="tw", n_layers=2, n_kv_heads=2,
                                    sliding_window=6, **COMMON),
        "mla": pkg.ArchConfig(
            name="tm", family="moe", attn_type="mla", n_layers=2,
            n_kv_heads=4, mla=pkg.MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                qk_rope_dim=8, v_head_dim=16), **COMMON),
        "ssm": pkg.ArchConfig(name="ts", family="ssm", n_layers=3,
                              n_kv_heads=4,
                              xlstm=pkg.XLSTMConfig(slstm_layers=(1,)),
                              **COMMON),
        "hybrid": pkg.ArchConfig(name="th", family="hybrid", n_layers=5,
                                 n_kv_heads=4, shared_attn_every=2,
                                 shared_attn_lora_rank=4, **COMMON),
    }


TCFG = _configs(tconfig)
TINY = TCFG["tiny"]
JTINY = _configs(jconfig)["tiny"]
GW = dict(max_len=64, lanes=4, chunk=8)
N_REQ, PROMPT, MAX_NEW = 8, 10, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scores(scores_mod, n_dev=8, m_cap=4):
    """Devices 0-3 prefer model 0, 4-7 model 1; all active on both."""
    state = scores_mod.init_scores(n_dev, m_cap, ell=2)
    state.active[:, 1] = True
    state.alive[1] = True
    accs = np.zeros((n_dev, m_cap))
    accs[:4, 0], accs[:4, 1] = 0.9, 0.1
    accs[4:, 0], accs[4:, 1] = 0.1, 0.9
    return scores_mod.push_accuracies(state, accs)


def _perturbed(params, seed=1, scale=0.02):
    rng = np.random.default_rng(seed)
    return {k: (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
            for k, v in params.items()}


def _port_world(cfg, init=None, seed=0):
    """Two models (``init`` — default the port's ``init_lm`` of ``seed``
    — and a perturbed clone) in a stacked registry on the CPU."""
    if init is None:
        init = {k: v.numpy() for k, v in ttf.init_lm(
            cfg, torch.Generator().manual_seed(seed)).items()}
    reg = treg.ModelRegistry.create(
        {k: torch.from_numpy(np.array(v)) for k, v in init.items()},
        m_cap=4, stacked=True)
    reg.clone(0, 1, {k: torch.from_numpy(v)
                     for k, v in _perturbed(init).items()})
    return reg, _scores(tscores)


def _submit(gw, seed=0, n=N_REQ, max_new=MAX_NEW, size=PROMPT):
    rng = np.random.default_rng(seed)
    return [gw.submit(d, rng.integers(0, 64, size=size), max_new=max_new)
            for d in range(n)]


def _streams(gw, seed=0, max_new=MAX_NEW):
    reqs = _submit(gw, seed, max_new=max_new)
    gw.drain()
    assert all(r.done and len(r.tokens) == max_new for r in reqs)
    return [list(r.tokens) for r in reqs]


def _summary(gw, streams):
    out = {"streams": streams, "dispatches": gw.dispatches,
           "tokens_out": gw.tokens_out,
           "routing": gw.stats()["routing"]}
    if gw.spec_k:
        sp = gw.stats()["spec"]
        out["spec"] = {k: sp[k] for k in ("rounds", "proposed", "accepted",
                                          "draft_models")}
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference's vanilla and spec gateways, once each, over the
    two-model TINY population; the population's numpy params."""
    init = jax.jit(lambda k: jtf.init_lm(JTINY, k))(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, init)
    flat = params_from_jax(init)
    numpy_init = {k: v.numpy() for k, v in flat.items()}
    clone = _perturbed(numpy_init)
    # the clone back in the reference's tree, leaf for leaf
    leaves, treedef = jax.tree_util.tree_flatten(init)
    jclone = jax.tree_util.tree_unflatten(
        treedef, [clone[k] for k in flat])
    reg = jreg.ModelRegistry.create(init, m_cap=4, stacked=True)
    reg.clone(0, 1, jclone)
    state = _scores(jscores)
    out = {"init": numpy_init}
    for mode, kw in (("vanilla", {}), ("spec", dict(spec_k=3,
                                                     draft_layers=1))):
        gw = JGateway(JTINY, reg, lambda: state, **GW, **kw)
        out[mode] = _summary(gw, _streams(gw))
    return out


@pytest.mark.parametrize("mode", ["vanilla", "spec"])
def test_gateway_matches_reference(ref, mode):
    reg, state = _port_world(TINY, ref["init"])
    kw = dict(spec_k=3, draft_layers=1) if mode == "spec" else {}
    gw = ServeGateway(TINY, reg, lambda: state, **GW, **kw)
    got = _summary(gw, _streams(gw))
    assert got == ref[mode]
    assert ref["spec"]["streams"] == ref["vanilla"]["streams"]


@pytest.mark.parametrize("mode", ["spec", "paged", "spec_paged"])
def test_gateway_modes_match_vanilla_on_reference_population(ref, mode):
    reg, state = _port_world(TINY, ref["init"])
    kw = {}
    if "spec" in mode:
        kw.update(spec_k=3, draft_layers=1)
    if "paged" in mode:
        kw.update(paged=True, page_slots=8)
    gw = ServeGateway(TINY, reg, lambda: state, **GW, **kw)
    assert _streams(gw) == ref["vanilla"]["streams"]
    st = gw.stats()
    if "spec" in mode:
        sp = st["spec"]
        assert 0 < sp["proposed"] and 0 <= sp["accepted"] <= sp["proposed"]
        assert sp["draft_models"] == 2
        assert sp["rounds"] <= ref["vanilla"]["dispatches"]
    if "paged" in mode:
        pg = st["pools"]["pages"]
        assert pg["pages_in_use"] == 0 <= pg["pages_reserved"]
        assert st["pools"]["bytes_in_use"] <= st["pools"]["bytes"]
    for group in gw.groups.values():
        assert group.pool.free_lanes == GW["lanes"]


@pytest.mark.parametrize("name", ["dense_win", "mla", "ssm", "hybrid"])
def test_gateway_modes_match_vanilla(name):
    cfg = TCFG[name]
    reg, state = _port_world(cfg)
    want = _streams(ServeGateway(cfg, reg, lambda: state, **GW))
    for kw in (dict(spec_k=3, draft_layers=1), dict(paged=True),
               dict(spec_k=3, draft_layers=1, paged=True)):
        gw = ServeGateway(cfg, reg, lambda: state, **GW, **kw)
        assert _streams(gw) == want, kw
        if "paged" in kw:
            assert gw.stats()["pools"]["pages"]["pages_in_use"] == 0


def test_gateway_decode_equals_single_request_path():
    reg, state = _port_world(TINY)
    gw = ServeGateway(TINY, reg, lambda: state, **GW)
    reqs = _submit(gw)
    gw.drain()
    assert all(r.done and len(r.tokens) == MAX_NEW for r in reqs)
    assert all(r.ttft_s is not None and r.total_s is not None for r in reqs)
    prefill, step = make_prefill_step(TINY), make_serve_step(TINY)
    for d in (0, 5):
        params = reg.params[gw.routing.resolve(d)]
        caches = ttf.init_lm_caches(TINY, 1, GW["max_len"])
        prompt = reqs[d].prompt
        for s in range(0, prompt.size, 8):
            part = prompt[s:s + 8]
            nv = part.size
            part = np.pad(part, (0, 8 - nv))
            logits, caches = prefill(params, caches,
                                     torch.from_numpy(part[None]).long(), nv)
        toks = [int(torch.argmax(logits, -1)[0])]
        for _ in range(MAX_NEW - 1):
            logits, caches = step(params, caches,
                                  torch.tensor([[toks[-1]]]))
            toks.append(int(torch.argmax(logits, -1)[0]))
        assert toks == reqs[d].tokens


def test_gateway_backfills_lanes_mid_stream():
    reg, state = _port_world(TINY)
    gw = ServeGateway(TINY, reg, lambda: state, max_len=64, lanes=2,
                      chunk=8)
    rng = np.random.default_rng(1)
    reqs = [gw.submit(0, rng.integers(0, 64, size=6), max_new=n)
            for n in (2, 7, 3, 5, 4)]
    gw.drain()
    assert [len(r.tokens) for r in reqs] == [2, 7, 3, 5, 4]
    group = gw.groups[gw.routing.resolve(0)]
    assert not group.has_work() and group.pool.free_lanes == 2
    assert 0.0 < group.batching_efficiency() <= 1.0
    serial = sum(len(r.tokens) for r in reqs)
    decode = gw.dispatches - sum(-(-r.prompt.size // gw.chunk)
                                 for r in reqs)
    assert decode < serial


@pytest.mark.parametrize("spec", [False, True])
def test_gateway_sync_reroutes_in_flight_on_delete(spec):
    reg, state = _port_world(TINY)
    kw = dict(spec_k=3, draft_layers=1) if spec else {}
    gw = ServeGateway(TINY, reg, lambda: state, **GW, **kw)
    reqs = _submit(gw, seed=2, max_new=12, size=8)
    by_model = {m: [r for r in reqs if r.model == m] for m in (0, 1)}
    gw.step()                                   # tokens in flight
    reg.kill(1, round_=99)
    out = gw.sync()
    assert out["released"] == [1] and out["failed"] == []
    assert {r.rid for r in by_model[1]} <= set(out["rerouted"])
    gw.drain()
    for r in by_model[1]:
        assert r.done and r.rerouted == 1 and r.model == 0
    assert all(r.done and len(r.tokens) == 12 for r in reqs)
    assert 1 not in gw.groups and 1 not in gw.pools.pools
    assert gw.stats()["pools"]["released"] == 1
    if spec:
        assert 1 not in gw.draft.present and 1 not in gw.draft_pools.pools
        assert gw.draft.released == 1
    reg.kill(0, round_=99)                      # nobody left to serve
    assert gw.sync()["released"] == [0]
    with pytest.raises(RequestRejected):
        gw.submit(0, [1, 2], max_new=2)


def test_gateway_topk_acceptance_bounds():
    reg, state = _port_world(TINY)
    # a FULL-depth draft is the target itself: with top_k=1 every
    # proposal is accepted
    gw = ServeGateway(TINY, reg, lambda: state, **GW, spec_k=2,
                      draft_layers=TINY.n_layers, top_k=1, seed=3)
    _streams(gw, seed=3)
    assert gw.stats()["spec"]["acceptance_rate"] == 1.0
    # real top-k sampling with a shallow draft: the rate is a probability,
    # and a seed gives its own stream again
    runs = []
    for _ in range(2):
        gw = ServeGateway(TINY, reg, lambda: state, **GW, spec_k=2,
                          draft_layers=1, top_k=4, seed=4)
        runs.append(_streams(gw, seed=4))
        sp = gw.stats()["spec"]
        assert sp["proposed"] > 0 and 0.0 <= sp["acceptance_rate"] <= 1.0
    assert runs[0] == runs[1]


@pytest.mark.parametrize("name", ["tiny", "dense_win", "mla", "ssm",
                                  "hybrid"])
def test_spec_decode_greedy_equals_vanilla(name):
    """``launch/serve.py``'s ``spec_decode`` emits the greedy stream
    (``tests/test_specdecode.py:65-102``)."""
    cfg = TCFG[name]
    win = cfg.sliding_window
    B, P, N, K, CH = 2, 9, 10, 3, 4
    rng = np.random.default_rng(0)
    params = ttf.init_lm(cfg, torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(rng.integers(0, 64, (B, P)))
    prefill = make_prefill_step(cfg, window=win)
    max_len = P + N + K + 1
    caches = ttf.init_lm_caches(cfg, B, max_len, window=win)
    logits, caches = tserve.chunked_prefill(prefill, params, caches,
                                            prompts, CH)
    tok = torch.argmax(logits, -1)[:, None]
    ref = [tok]
    with torch.no_grad():
        for _ in range(N):
            logits, caches = ttf.lm_decode(cfg, params, tok, caches,
                                           window=win)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            ref.append(tok)
    ref = torch.cat(ref, 1).numpy()
    dcfg = draft_config(cfg, 1)
    dparams = truncate_lm_params(cfg, dcfg, params)
    scaches = ttf.init_lm_caches(cfg, B, max_len, window=win)
    dcaches = ttf.init_lm_caches(dcfg, B, max_len, window=win)
    lg0, scaches = tserve.chunked_prefill(prefill, params, scaches, prompts,
                                          CH)
    _, dcaches = tserve.chunked_prefill(make_prefill_step(dcfg, window=win),
                                        dparams, dcaches, prompts, CH)
    first = torch.argmax(lg0, -1)[:, None]
    spec, proposed, accepted = tserve.spec_decode(
        cfg, params, scaches, dcfg, dparams, dcaches, first, N, K,
        window=win)
    got = np.concatenate([first.numpy(), spec], axis=1)
    np.testing.assert_array_equal(got[:, :N + 1], ref)
    assert proposed > 0 and 0 <= accepted <= proposed


def test_serve_cli(capsys):
    tserve.main(["--arch", "qwen3-4b", "--batch", "2", "--prompt-len", "12",
                 "--decode", "6", "--chunk", "8", "--spec-k", "3",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "match_vanilla=True" in out and "device=cpu" in out


# -- the trainer's draft rows ---------------------------------------------------

KW = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab_size=64, **F32)
FK = dict(n_devices=4, devices_per_round=3, score_window=2,
          milestones=(2, 5), late_delete_round=6, max_models=6, lr=0.05,
          seed=0)
DIMS = (4, 2, 16)
ROUNDS = 3


@pytest.fixture(scope="module")
def ref_trainer(tmp_path_factory):
    """The reference's ``llm`` trainer with 1-layer drafts, 3 rounds (a
    clone at round 2), checkpointed at round 3; its initial model."""
    root = str(tmp_path_factory.mktemp("ref") / "ck")
    tr = JTrainer(jconfig.ArchConfig(**KW), jconfig.FedCDConfig(**FK),
                  *DIMS, n_archetypes=2, seed=0, draft_layers=1,
                  spec=JSpec(engine="llm", save_every=ROUNDS,
                             checkpoint_dir=root))
    init = jax.tree.map(lambda a: np.array(a, copy=True),
                        tr.registry.params[0])
    tr.run(ROUNDS)
    return tr, init, root


def _port_trainer(init, spec="llm", **kw):
    return FedLLMTrainer(tconfig.ArchConfig(**KW), tconfig.FedCDConfig(**FK),
                         *DIMS, n_archetypes=2, seed=0, spec=spec,
                         device="cpu", init_params=init, **kw)


def _draft_rows(tr, package):
    """{model: {flat name: numpy row}} of a trainer's drafts."""
    d = tr.draft
    out = {}
    for m in sorted(d.present):
        r = d.row(tr.registry, m)
        if package == "ref":
            row = params_from_jax(jax.tree.map(lambda a: np.asarray(a[r]),
                                               d.tree))
        else:
            row = d.row_params(r)
        out[m] = {k: v.detach().numpy() for k, v in row.items()}
    return out


def _assert_rows_close(got, want, tol):
    assert list(got) == list(want)
    for m in want:
        assert list(got[m]) == list(want[m])
        for k in want[m]:
            np.testing.assert_allclose(got[m][k], want[m][k], atol=tol,
                                       rtol=0, err_msg=f"{m} {k}")


@pytest.mark.parametrize("spec", ["llm", "legacy"])
def test_trainer_draft_rows_match_reference(ref_trainer, spec):
    jtr, init, _ = ref_trainer
    tr = _port_trainer(init, spec, draft_layers=1)
    tr.run(ROUNDS)
    assert tr.draft.present == jtr.draft.present
    assert (tr.draft.refreshed, tr.draft.released) == (
        jtr.draft.refreshed, jtr.draft.released)
    _assert_rows_close(_draft_rows(tr, "port"), _draft_rows(jtr, "ref"),
                       1e-6)
    # a draft row is the truncation of its model's current row
    for m in tr.draft.present:
        want = truncate_lm_params(tr.arch, tr.draft.dcfg,
                                  tr.executor.params_of(m))
        got = tr.draft.row_params(tr.draft.row(tr.registry, m))
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_draft_checkpoints_cross_packages(ref_trainer, tmp_path):
    jtr, init, root = ref_trainer
    want = _draft_rows(jtr, "ref")
    # reference -> port: the rows verbatim
    tr = _port_trainer(init, draft_layers=1)
    assert tr.restore(root) == ROUNDS
    _assert_rows_close(_draft_rows(tr, "port"), want, 0.0)
    # port -> reference
    path = tr.save(str(tmp_path / "port"))
    jdst = JTrainer(jconfig.ArchConfig(**KW), jconfig.FedCDConfig(**FK),
                    *DIMS, n_archetypes=2, seed=0, draft_layers=1)
    assert jdst.restore(path) == ROUNDS
    _assert_rows_close(_draft_rows(jdst, "ref"), want, 0.0)
    # a depth mismatch raises; a checkpoint without rows re-derives them
    with pytest.raises(CheckpointError, match="draft depth mismatch"):
        _port_trainer(init, draft_layers=2).restore(root)
    plain = _port_trainer(init)
    plain.restore(root)
    bare = plain.save(str(tmp_path / "bare"))
    again = _port_trainer(init, draft_layers=1)
    again.restore(bare)
    _assert_rows_close(_draft_rows(again, "port"), want, 0.0)
    with open(os.path.join(bare, "manifest.json")) as f:
        assert '"draft": null' in f.read()
