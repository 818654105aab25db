"""The port's decode path (``repro_torch.models.transformer``:
``init_lm_caches``, ``lm_prefill``, ``lm_decode``, ``lm_cache_rollback``,
``lm_spec_verify``, ``lm_spec_propose``; ``launch.steps``'
``make_prefill_step`` / ``make_serve_step``) against the reference's, on
the CPU.

Configs: the four of ``tests/test_gateway.py:37-55`` (dense with a
6-slot sliding window, MLA, xLSTM with an sLSTM layer, the Zamba2 hybrid
with LoRA), reduced Qwen3-4B and reduced Phi-3.5-MoE (capacity factor 8,
as ``tests/test_archs_smoke.py:86-87``), float32. Params are the
reference's ``init_lm`` output through ``repro_torch.convert``, caches
cross with ``caches_from_jax``, tokens come from a numpy seed. The
sequence: an 11-token prompt prefilled in chunks of 4 (the last one
padded), 8 decode steps, a verify of a 4-token chunk whose draft is
rejected at its second token, and a propose that commits it. Bars:
logits 1e-5; cache floats 1e-6 of each leaf's scale (its largest
magnitude, at least 1: the sLSTM's stabiliser ``m`` grows to ~30, and a
qk-normed, rotated key of Qwen3 reaches 3.8, where a few float32 ulps of
RoPE's products are 2e-6); ``index``, ``pos``, verify outputs,
``n_keep`` and proposals exact.

Port alone (no reference run): chunked prefill ≡ a token-at-a-time
decode (``tests/test_gateway.py:58-96``, 1e-4); rollback after a verify
bitwise equal to the prefill of the accepted prefix
(``tests/test_specdecode.py:104-140``); decode ≡ teacher-forced forward
on every reduced architecture (``tests/test_archs_smoke.py:77-99``, 2e-3
of the logits' scale); ``torch.func.vmap`` over three lanes at different
positions ≡ a call per lane, for decode and verify (the gateway's lane
batching: greedy tokens and ``n_keep`` exact, logits 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (caches_from_jax, caches_to_numpy,  # noqa: E402
                                 params_from_jax)
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

B, P, CH, MAXLEN, N_DEC, K = 2, 11, 4, 24, 8, 3
LOGIT_TOL = 1e-5
CACHE_TOL = 1e-6


def _gateway(pkg, name):
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    common = dict(n_heads=4, d_ff=128, vocab_size=64, d_model=64, **f32)
    return {
        "dense_win": lambda: pkg.ArchConfig(
            name="tw", n_layers=2, n_kv_heads=2, sliding_window=6,
            **common),
        "mla": lambda: pkg.ArchConfig(
            name="tm", family="moe", attn_type="mla", n_layers=2,
            n_kv_heads=4, mla=pkg.MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                qk_rope_dim=8, v_head_dim=16), **common),
        "ssm": lambda: pkg.ArchConfig(
            name="ts", family="ssm", n_layers=3, n_kv_heads=4,
            xlstm=pkg.XLSTMConfig(slstm_layers=(1,)), **common),
        "hybrid": lambda: pkg.ArchConfig(
            name="th", family="hybrid", n_layers=5, n_kv_heads=4,
            shared_attn_every=2, shared_attn_lora_rank=4, **common),
    }[name]()


def _reduced(cfgs, pkg, arch):
    cfg = cfgs.reduced(cfgs.get_arch(arch))
    if cfg.moe.n_experts:
        cfg = pkg.override(cfg, **{"moe.capacity_factor": 8.0})
    return cfg


def _pair(name):
    if name in ("qwen3-4b", "phi3.5-moe-42b-a6.6b"):
        return (_reduced(jconfigs, jconfig, name),
                _reduced(tconfigs, tconfig, name))
    return _gateway(jconfig, name), _gateway(tconfig, name)


NAMES = ("dense_win", "mla", "ssm", "hybrid", "qwen3-4b",
         "phi3.5-moe-42b-a6.6b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x)).long()


def _chunks(tokens):
    for s in range(0, tokens.shape[1], CH):
        chunk = tokens[:, s:s + CH]
        nv = chunk.shape[1]
        yield np.pad(chunk, ((0, 0), (0, CH - nv))), nv


def _close_caches(port, ref, tol=CACHE_TOL):
    want = caches_from_jax(jax.tree.map(np.asarray, ref))
    assert list(port) == list(want)
    for k, w in want.items():
        g = port[k].detach()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.is_floating_point:
            scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       atol=tol * scale, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=k)


def _close(port, ref, tol=LOGIT_TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=NAMES)
def ref(request):
    """One config's reference run (jitted): params, the prompt's
    chunked prefill, 8 decode steps, a collecting prefill, a verify and
    a propose."""
    name = request.param
    jc, tc = _pair(name)
    win = jc.sliding_window
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    dec = rng.integers(0, jc.vocab_size, (B, N_DEC)).astype(np.int32)
    chunk = rng.integers(0, jc.vocab_size, (B, K + 1)).astype(np.int32)
    jp = jax.jit(lambda k: jtf.init_lm(jc, k))(jax.random.PRNGKey(1))
    caches0 = jtf.init_lm_caches(jc, B, MAXLEN, window=win)
    prefill = jax.jit(lambda p, c, t, nv: JS.make_prefill_step(
        jc, window=win)(p, c, t, nv))
    decode = jax.jit(lambda p, c, t: jtf.lm_decode(jc, p, t, c, window=win))
    out = {"name": name, "jc": jc, "tc": tc, "win": win, "params": jp,
           "prompt": prompt, "dec": dec, "chunk": chunk,
           "caches0": caches0, "prefill": []}
    c = caches0
    for tok, nv in _chunks(prompt):
        last, c = prefill(jp, c, tok, jnp.asarray(nv, jnp.int32))
        out["prefill"].append((last, c))
    out["caches_p"] = cp = c
    out["decode"] = []
    for t in range(N_DEC):
        lg, c = decode(jp, c, dec[:, t:t + 1])
        out["decode"].append((lg, c))
    logits, full, states = jax.jit(lambda p, c, t: jtf.lm_prefill(
        jc, p, t, c, window=win, collect_states=True))(jp, cp, chunk)
    out["collect"] = (logits, full, states)
    draft = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, :-1]
    draft[:, 1] = (draft[:, 1] + 1) % jc.vocab_size
    out["draft"] = draft
    out["verify"] = jax.jit(lambda p, c, t, d: jtf.lm_spec_verify(
        jc, p, t, d, c, window=win))(jp, cp, chunk, draft)
    n_keep = out["verify"][1]
    cur = np.asarray(out["verify"][0])[:, int(n_keep) - 1:int(n_keep)]
    out["cur"] = cur
    out["propose"] = jax.jit(lambda p, c, t, nk, cu: jtf.lm_spec_propose(
        jc, p, t, nk, cu, K, c, window=win))(jp, cp, chunk, n_keep, cur)
    return out


def _port_params(ref):
    return params_from_jax(jax.tree.map(np.asarray, ref["params"]))


def _port_caches(tree):
    return caches_from_jax(jax.tree.map(np.asarray, tree))


def test_init_lm_caches_match(ref):
    tc, win = ref["tc"], ref["win"]
    caches = ttf.init_lm_caches(tc, B, MAXLEN, window=win)
    _close_caches(caches, ref["caches0"], tol=0.0)
    back = caches_to_numpy(caches)
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.tree.map(np.asarray,
                                               ref["caches0"])))


def test_prefill_step_matches(ref):
    """``make_prefill_step`` over the prompt in chunks of 4, the last
    padded: next-token logits and every cache after each chunk."""
    tc, win = ref["tc"], ref["win"]
    tp = _port_params(ref)
    step = TS.make_prefill_step(tc, window=win)
    c = ttf.init_lm_caches(tc, B, MAXLEN, window=win)
    for (tok, nv), (want, wc) in zip(_chunks(ref["prompt"]),
                                     ref["prefill"]):
        last, c = step(tp, c, _t(tok), nv)
        assert last.dtype == torch.float32
        _close(last, want)
        _close_caches(c, wc)


def test_decode_matches(ref):
    """``lm_decode`` (and ``make_serve_step``) for 8 steps from the
    reference's post-prefill caches."""
    tc, win = ref["tc"], ref["win"]
    tp = _port_params(ref)
    serve = TS.make_serve_step(tc, window=win)
    c = _port_caches(ref["caches_p"])
    for t, (want, wc) in enumerate(ref["decode"]):
        tok = _t(ref["dec"][:, t:t + 1])
        lg, c2 = ttf.lm_decode(tc, tp, tok, c, window=win)
        last, c = serve(tp, c, tok)
        assert lg.shape == (B, 1, tc.vocab_size)
        assert torch.equal(last, lg[:, -1])
        _close(lg, want)
        _close_caches(c, wc)
        for k in c:
            assert torch.equal(c[k], c2[k]), k


def test_collecting_prefill_and_rollback_match(ref):
    """``lm_prefill(collect_states=True)``: logits, the full caches and
    the per-step recurrent states; ``lm_cache_rollback`` of the
    reference's (old, full, states) at every ``n_keep``."""
    tc, win = ref["tc"], ref["win"]
    tp = _port_params(ref)
    old = _port_caches(ref["caches_p"])
    logits, full, states = ttf.lm_prefill(tc, tp, _t(ref["chunk"]), old,
                                          window=win, collect_states=True)
    want_l, want_full, want_states = ref["collect"]
    _close(logits, want_l)
    _close_caches(full, want_full)
    _close_caches(states, want_states)
    rb = jax.jit(lambda o, f, s, n: jtf.lm_cache_rollback(
        ref["jc"], o, f, s, n, K + 1, win))
    wf, ws = _port_caches(want_full), _port_caches(want_states)
    for n_keep in (1, 2, K + 1):
        got = ttf.lm_cache_rollback(tc, old, wf, ws, n_keep, K + 1, win)
        want = rb(ref["caches_p"], want_full, want_states,
                  jnp.asarray(n_keep, jnp.int32))
        _close_caches(got, want, tol=0.0)


def test_spec_verify_matches(ref):
    tc, win = ref["tc"], ref["win"]
    out, n_keep, caches = ttf.lm_spec_verify(
        tc, _port_params(ref), _t(ref["chunk"]), _t(ref["draft"]),
        _port_caches(ref["caches_p"]), window=win)
    want_out, want_keep, want_caches = ref["verify"]
    assert out.dtype == n_keep.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    assert int(n_keep) == int(want_keep) == 2
    _close_caches(caches, want_caches)


def test_spec_propose_matches(ref):
    tc, win = ref["tc"], ref["win"]
    props, caches = ttf.lm_spec_propose(
        tc, _port_params(ref), _t(ref["chunk"]), int(ref["verify"][1]),
        _t(ref["cur"]), K, _port_caches(ref["caches_p"]), window=win)
    want_props, want_caches = ref["propose"]
    np.testing.assert_array_equal(props.numpy(), np.asarray(want_props))
    _close_caches(caches, want_caches)


# -- the port alone -----------------------------------------------------------

def test_prefill_matches_token_at_a_time(ref):
    """``tests/test_gateway.py:58-96`` on the port: the chunked prefill
    with a padded tail leaves the logits and caches of a token loop."""
    tc, win = ref["tc"], ref["win"]
    tp = _port_params(ref)
    toks = _t(ref["prompt"])
    cref = ttf.init_lm_caches(tc, B, MAXLEN, window=win)
    for t in range(P):
        want, cref = ttf.lm_decode(tc, tp, toks[:, t:t + 1], cref,
                                   window=win)
    cpre = ttf.init_lm_caches(tc, B, MAXLEN, window=win)
    for tok, nv in _chunks(ref["prompt"]):
        lg, cpre = ttf.lm_prefill(tc, tp, _t(tok), cpre, window=win,
                                  n_valid=torch.tensor(nv, dtype=torch.int32))
        last = lg[:, nv - 1]
    np.testing.assert_allclose(last.numpy(), want[:, 0].numpy(), atol=1e-4,
                               rtol=1e-4)
    for k in cref:
        np.testing.assert_allclose(cpre[k].float().numpy(),
                                   cref[k].float().numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_rollback_bitwise_equals_prefill_of_accepted_prefix(ref):
    """``tests/test_specdecode.py:104-140`` on the port: a verify that
    rejects the draft's second token leaves bitwise the caches of a
    prefill of the chunk with ``n_valid=n_keep``."""
    tc, win = ref["tc"], ref["win"]
    tp = _port_params(ref)
    caches = _port_caches(ref["caches_p"])
    chunk = _t(ref["chunk"])
    probe, _, _ = ttf.lm_prefill(tc, tp, chunk, caches, window=win,
                                 collect_states=True)
    draft = torch.argmax(probe, -1).to(torch.int32)[:, :-1]
    draft[:, 1] = (draft[:, 1] + 1) % tc.vocab_size
    _, n_keep, rolled = ttf.lm_spec_verify(tc, tp, chunk, draft, caches,
                                           window=win)
    assert int(n_keep) == 2
    _, oracle = ttf.lm_prefill(tc, tp, chunk, caches, window=win,
                               n_valid=n_keep)
    assert list(rolled) == list(oracle)
    for k in oracle:
        assert torch.equal(rolled[k], oracle[k]), k


def test_vmapped_lanes_match_per_lane_calls(ref):
    """The serving gateway's lane batching: ``torch.func.vmap`` of
    ``lm_decode`` and ``lm_spec_verify`` over three batch-1 lanes at
    different positions (prompts of 5, 8 and 11 tokens), params closed
    over, against a call per lane. Greedy tokens, verify outputs and
    ``n_keep`` exact, logits 1e-5."""
    tc, win = ref["tc"], ref["win"]
    tp = _port_params(ref)
    lanes = []
    with torch.no_grad():
        for n in (5, 8, 11):
            c = ttf.init_lm_caches(tc, 1, MAXLEN, window=win)
            _, c = ttf.lm_prefill(tc, tp, _t(ref["prompt"][:1, :n]), c,
                                  window=win)
            lanes.append(c)
        stacked = {k: torch.stack([c[k] for c in lanes]) for k in lanes[0]}
        toks = _t(ref["dec"][0, :3])

        def decode(cache, tok):
            lg, nc = ttf.lm_decode(tc, tp, tok[None, None], cache,
                                   window=win)
            return nc, lg[0, -1]

        _, logits = torch.func.vmap(decode)(stacked, toks)
        per = torch.stack([decode(c, toks[i])[1]
                           for i, c in enumerate(lanes)])
        _close(logits, per.numpy())
        assert torch.equal(torch.argmax(logits, -1), torch.argmax(per, -1))

        chunks = torch.cat([toks[:, None], _t(ref["chunk"][:1, 1:]).expand(
            3, K)], dim=1)

        def verify(cache, chunk):
            out, nk, nc = ttf.lm_spec_verify(tc, tp, chunk[None],
                                             chunk[None, 1:], cache,
                                             window=win)
            return nc, out[0], nk

        _, outs, nks = torch.func.vmap(verify)(stacked, chunks)
        for i, c in enumerate(lanes):
            _, out, nk = verify(c, chunks[i])
            assert torch.equal(outs[i], out) and int(nks[i]) == int(nk)


DECODE_ARCHS = tuple(n for n in tconfigs.all_arch_names())


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_matches_forward(name):
    """``tests/test_archs_smoke.py:77-99`` on the port alone: 12 decode
    steps against the teacher-forced forward of every reduced
    architecture (an audio config runs its decoder-only stack, as the
    reference's ``init_lm`` / ``lm_forward`` do)."""
    cfg = tconfigs.reduced(tconfigs.get_arch(name))
    if cfg.moe.n_experts:
        cfg = tconfig.override(cfg, **{"moe.capacity_factor": 8.0})
    params = ttf.init_lm(cfg, torch.Generator().manual_seed(7))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, 12)))
    with torch.no_grad():
        full, _, _ = ttf.lm_forward(cfg, params, toks)
        caches = ttf.init_lm_caches(cfg, B, 12)
        outs = []
        for t in range(12):
            lg, caches = ttf.lm_decode(cfg, params, toks[:, t:t + 1], caches)
            outs.append(lg)
    step = torch.cat(outs, dim=1)
    scale = float(full.abs().max()) + 1e-6
    assert float((full - step).abs().max()) / scale < 2e-3, name
