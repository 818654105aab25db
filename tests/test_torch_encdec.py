"""The port's encoder-decoder model and frontends
(``repro_torch.models.encdec``, ``models.frontends``; the audio branch
of ``launch.steps``) against the reference's, on the CPU.

Reduced whisper-small (2 encoder + 2 decoder layers, d_model 256, 24
source frames, vocab 512), float32. Params are the reference's
``init_encdec`` output through ``repro_torch.convert``; frames and
tokens come from a numpy seed and go to both packages as the same
arrays (the frontends' draws cannot be ``jax.random``'s bits). Bars:
``encode`` and the logits 1e-5; one ``make_train_step`` step's loss
1e-5 and every leaf 1e-6 (1e-5 with the int8 transport: a code one step
off moves a leaf by lr x its block's scale); ``make_eval_step`` 1e-6;
the decode caches 1e-6 of each leaf's scale, ``index`` / ``pos``
exact. The port alone: decode ≡ teacher-forced forward
(``tests/test_archs_smoke.py:102``, 2e-3 of scale), ``remat`` bit-equal,
the frontends' distributions.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.config import override as joverride  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import FedCDConfig, override  # noqa: E402
from repro_torch.convert import caches_from_jax, params_from_jax  # noqa: E402
from repro_torch.federated.llm import FedLLMTrainer  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import frontends  # noqa: E402

JCFG = jconfigs.reduced(jconfigs.get_arch("whisper-small"))
TCFG = tconfigs.reduced(tconfigs.get_arch("whisper-small"))
N_CLIENTS, PER, SEQ = 2, 2, 8
B = N_CLIENTS * PER
LR = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _close_tree(port, ref, atol):
    want = _port(ref)
    assert list(port) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(port[k].detach().numpy(), w.numpy(),
                                   atol=atol, rtol=1e-6, err_msg=k)


def _close_caches(port, ref):
    want = caches_from_jax(jax.tree.map(np.asarray, ref))
    assert list(port) == list(want)
    for k, w in want.items():
        g = port[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.is_floating_point:
            scale = max(1.0, float(w.abs().max()))
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       atol=1e-6 * scale, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=k)


@pytest.fixture(scope="module")
def ref():
    """The reference's params, inputs and jitted forward."""
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(B, JCFG.encdec.source_len,
                              JCFG.d_model)).astype(np.float32)
    toks = rng.integers(0, JCFG.vocab_size, (B, SEQ + 1)).astype(np.int32)
    params = jax.jit(lambda k: jed.init_encdec(JCFG, k))(
        jax.random.PRNGKey(3))
    logits, hidden = jax.jit(lambda p, f, t: jed.encdec_forward(
        JCFG, p, f, t))(params, frames, toks[:, :-1])
    return {"params": params, "frames": frames, "tokens": toks[:, :-1],
            "labels": toks[:, 1:], "logits": logits, "hidden": hidden}


def test_init_encdec_layout():
    """Names, shapes and dtypes of ``init_encdec`` (float32 and bf16)
    are the reference's, stacked leaves per layer."""
    for kw in ({}, {"param_dtype": "bfloat16"}):
        jc, tc = joverride(JCFG, **kw), override(TCFG, **kw)
        shapes = jax.eval_shape(lambda k: jed.init_encdec(jc, k),
                                jax.random.PRNGKey(0))
        want = {".".join(str(p.key) for p in path):
                (tuple(leaf.shape), str(leaf.dtype))
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    shapes)[0]}
        got = ted.init_encdec(tc, torch.Generator().manual_seed(0))
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                for k, v in got.items()} == want
        assert list(got) == list(want)
    assert got["enc_blocks.attn.wq"].shape[0] == TCFG.encdec.n_enc_layers
    assert got["dec_blocks.cross_attn.wq"].shape[0] == TCFG.n_layers


def test_encode_matches(ref):
    want = jax.jit(lambda p, f: jed.encode(JCFG, p, f))(ref["params"],
                                                        ref["frames"])
    got = ted.encode(TCFG, _port(ref["params"]), _t(ref["frames"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_encdec_forward_matches(ref):
    logits, hidden = ted.encdec_forward(TCFG, _port(ref["params"]),
                                        _t(ref["frames"]),
                                        _t(ref["tokens"]).long())
    assert logits.dtype == torch.float32
    assert logits.shape == (B, SEQ, TCFG.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref["logits"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref["hidden"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("microbatches,bits", [(1, 0), (2, 0), (1, 8)])
def test_train_step_matches(ref, microbatches, bits):
    """One audio ``make_train_step`` step (frames split per microbatch),
    from the same params and scores."""
    scores = np.array([0.3, 0.7], np.float32)
    jstep = jax.jit(JS.make_train_step(JCFG, lr=LR, remat=False,
                                       microbatches=microbatches,
                                       grad_transport_bits=bits))
    jp, jm = jstep(ref["params"], ref["tokens"], ref["labels"], scores,
                   ref["frames"])
    step = TS.make_train_step(TCFG, lr=LR, remat=True,
                              microbatches=microbatches,
                              grad_transport_bits=bits)
    tp, tm = step(_port(ref["params"]), _t(ref["tokens"]).long(),
                  _t(ref["labels"]).long(), _t(scores), _t(ref["frames"]))
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=1e-5)
    _close_tree(tp, jp, atol=1e-5 if bits else 1e-6)


def test_remat_equals_no_remat(ref):
    scores = _t(np.array([0.5, 0.5], np.float32))
    outs = [TS.make_train_step(TCFG, lr=LR, remat=r)(
        _port(ref["params"]), _t(ref["tokens"]).long(),
        _t(ref["labels"]).long(), scores, _t(ref["frames"]))
        for r in (False, True)]
    (pa, ma), (pb, mb) = outs
    assert float(ma["loss"]) == float(mb["loss"])
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_eval_step_matches(ref):
    want = jax.jit(JS.make_eval_step(JCFG, N_CLIENTS))(
        ref["params"], ref["tokens"], ref["labels"], ref["frames"])
    got = TS.make_eval_step(TCFG, N_CLIENTS)(
        _port(ref["params"]), _t(ref["tokens"]).long(),
        _t(ref["labels"]).long(), frames=_t(ref["frames"]))
    assert got.shape == (N_CLIENTS,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_caches_and_decode_match(ref):
    """``init_encdec_caches`` then token-by-token ``encdec_decode``
    (through ``make_serve_step``'s audio branch too), every step's
    logits and caches."""
    jinit = jax.jit(lambda p, f: jed.init_encdec_caches(JCFG, p, f, SEQ))
    jdec = jax.jit(lambda p, t, c: jed.encdec_decode(JCFG, p, t, c))
    tp = _port(ref["params"])
    jc = jinit(ref["params"], ref["frames"])
    tc = ted.init_encdec_caches(TCFG, tp, _t(ref["frames"]), SEQ)
    _close_caches(tc, jc)
    serve = TS.make_serve_step(TCFG)
    for t in range(SEQ):
        tok = ref["tokens"][:, t:t + 1]
        want, jc = jdec(ref["params"], tok, jc)
        got, tc2 = ted.encdec_decode(TCFG, tp, _t(tok).long(), tc)
        last, tc = serve(tp, tc, _t(tok).long())
        assert torch.equal(last, got[:, -1])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        _close_caches(tc, jc)
        for k in tc:
            assert torch.equal(tc[k], tc2[k]), k


def test_prefill_step_refuses_audio():
    for make in (JS.make_prefill_step, TS.make_prefill_step):
        with pytest.raises(ValueError, match="encdec driver"):
            make(JCFG if make is JS.make_prefill_step else TCFG)


def test_decode_matches_forward():
    """``tests/test_archs_smoke.py:102`` on the port alone."""
    params = ted.init_encdec(TCFG, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    frames = frontends.synthetic_audio_frames(gen, TCFG, B)
    toks = torch.randint(0, TCFG.vocab_size, (B, SEQ), generator=gen)
    with torch.no_grad():
        full, _ = ted.encdec_forward(TCFG, params, frames, toks)
        caches = ted.init_encdec_caches(TCFG, params, frames, SEQ)
        outs = []
        for t in range(SEQ):
            lg, caches = ted.encdec_decode(TCFG, params, toks[:, t:t + 1],
                                           caches)
            outs.append(lg)
    step = torch.cat(outs, dim=1)
    scale = float(full.abs().max()) + 1e-6
    assert float((full - step).abs().max()) / scale < 2e-3


def test_trainer_refuses_audio():
    """The reference's trainer gives an audio model's step no frames
    (it fails inside the step); the port's refuses at construction."""
    with pytest.raises(ValueError, match="encoder frames"):
        FedLLMTrainer(TCFG, FedCDConfig(n_devices=2), N_CLIENTS, PER, SEQ,
                      device="cpu")


# -- frontends ----------------------------------------------------------------

def test_audio_frame_spec():
    shape, dtype = frontends.audio_frame_spec(
        tconfigs.get_arch("whisper-small"), 3)
    assert shape == (3, 1500, 768) and dtype == torch.bfloat16
    assert frontends.audio_frame_spec(TCFG, 2) == ((2, 24, 256),
                                                   torch.float32)


def test_synthetic_audio_frames_are_standard_normal():
    gen = torch.Generator().manual_seed(0)
    x = frontends.synthetic_audio_frames(gen, TCFG, 64)
    assert x.shape == (64, 24, 256) and x.dtype == torch.float32
    assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1) < 0.01
    again = frontends.synthetic_audio_frames(
        torch.Generator().manual_seed(0), TCFG, 64)
    assert torch.equal(x, again)
    bf = frontends.synthetic_audio_frames(
        gen, override(TCFG, compute_dtype="bfloat16"), 2)
    assert bf.dtype == torch.bfloat16


def test_vision_tokens_mix_text_and_image_codes():
    cfg = tconfigs.get_arch("chameleon-34b")
    V, lo = cfg.vocab_size, int(cfg.vocab_size * 0.75)
    for frac in (0.25, 0.6):
        tok = frontends.vision_tokens(torch.Generator().manual_seed(1), cfg,
                                      32, 512, image_fraction=frac)
        assert tok.shape == (32, 512) and tok.dtype == torch.int32
        assert int(tok.min()) >= 0 and int(tok.max()) < V
        img = tok >= lo
        assert abs(float(img.float().mean()) - frac) < 0.01
        # image codes span their range, text tokens theirs
        assert int(tok[img].min()) < lo + V // 100
        assert int(tok[img].max()) > V - V // 100
        assert int(tok[~img].max()) > lo - lo // 100
