"""The port's LM architecture configs and dense-GQA model pieces against
the reference's, on the CPU (``repro_torch.config``, ``configs``,
``models.common``, ``models.attention``, ``models.transformer``).

Inputs are drawn from a numpy seed; model params are the reference's
``init_lm`` output carried through ``repro_torch.convert``. Bars:
configs, registry, ``reduced`` and ``param_counts`` equal; norms, RoPE,
embed/unembed, MLP and cross-entropy to 1e-6; attention on the naive and
the chunked path and ``lm_forward`` of every reduced dense architecture
to 1e-5 (float32). The bfloat16 tier (bf16 params and compute, the
reference on the CPU too) holds logits to 3e-2 and the final hidden
state to 1.6e-2 absolute (a few bf16 ulps: both round every projection
to bf16, with different accumulation orders), and the argmax to 95% of
positions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

DENSE = ("qwen3-4b", "internlm2-1.8b", "glm4-9b", "llama3-405b",
         "chameleon-34b")
MOE = ("deepseek-v3-671b", "phi3.5-moe-42b-a6.6b")
RECURRENT = ("zamba2-7b", "xlstm-125m")
OTHER = ("whisper-small",)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _arch_pair(name):
    return (jconfigs.reduced(jconfigs.get_arch(name)),
            tconfigs.reduced(tconfigs.get_arch(name)))


# -- configs -----------------------------------------------------------------

def test_registry_names_match():
    assert tconfigs.all_arch_names() == jconfigs.all_arch_names()
    assert len(tconfigs.all_arch_names()) == 10


@pytest.mark.parametrize("name", DENSE + MOE + RECURRENT + OTHER)
def test_arch_configs_reduced_and_param_counts_match(name):
    full = (jconfigs.get_arch(name), tconfigs.get_arch(name))
    red = _arch_pair(name)
    for j, t in (full, red):
        assert tconfig.to_dict(t) == jconfig.to_dict(j)
        assert t.param_counts() == j.param_counts()
        assert t.layout() == j.layout()
        assert t.resolved_head_dim() == j.resolved_head_dim()
    for shape in jconfig.INPUT_SHAPES:
        js, ts = jconfig.INPUT_SHAPES[shape], tconfig.INPUT_SHAPES[shape]
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert (tconfigs.shape_supported(full[1], ts)
                == jconfigs.shape_supported(full[0], js))
        assert (tconfigs.decode_window(full[1], ts)
                == jconfigs.decode_window(full[0], js))


def test_override_takes_dotted_paths_like_the_reference():
    kw = {"moe.top_k": 3, "n_layers": 5, "mla.kv_lora_rank": 16}
    j = jconfig.override(jconfigs.get_arch("deepseek-v3-671b"), **kw)
    t = tconfig.override(tconfigs.get_arch("deepseek-v3-671b"), **kw)
    assert tconfig.to_dict(t) == jconfig.to_dict(j)
    assert tconfig.to_json(t) == jconfig.to_json(j)


# -- common pieces -------------------------------------------------------------

def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    scale = rng.normal(size=(48,)).astype(np.float32)
    bias = rng.normal(size=(48,)).astype(np.float32)
    a = jcommon.rmsnorm({"scale": scale}, x, 1e-5)
    b = tcommon.rmsnorm({"scale": _t(scale)}, _t(x), 1e-5)
    np.testing.assert_allclose(b.numpy(), _np(a), atol=1e-6, rtol=1e-6)
    a = jcommon.layernorm({"scale": scale, "bias": bias}, x, 1e-5)
    b = tcommon.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x),
                          1e-5)
    np.testing.assert_allclose(b.numpy(), _np(a), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("hd,theta", [(64, 1e6), (128, 5e6), (48, 1e4)])
def test_rope_matches(fraction, hd, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 3, hd)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32) * 37       # positions up to 1443
    inv_j = _np(jcommon.rope_frequencies(hd, theta, fraction))
    inv_t = tcommon.rope_frequencies(hd, theta, fraction).numpy()
    assert np.array_equal(inv_t, inv_j)
    a = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction)
    b = tcommon.apply_rope(_t(x), _t(pos), theta, fraction)
    np.testing.assert_allclose(b.numpy(), _np(a), atol=1e-6, rtol=1e-6)


def test_embed_unembed_mlp_and_cross_entropy_match():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(50, 32)).astype(np.float32)
    toks = rng.integers(0, 50, (3, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tcommon.embed({"table": _t(table)}, _t(toks)).numpy(),
        _np(jcommon.embed({"table": table}, toks)))
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.unembed({"table": _t(table)}, _t(x)).numpy(),
        _np(jcommon.unembed({"table": table}, x)), atol=1e-6, rtol=1e-6)
    mlp = {k: rng.normal(0, 0.1, s).astype(np.float32)
           for k, s in (("w_gate", (32, 64)), ("w_up", (32, 64)),
                        ("w_down", (64, 32)))}
    np.testing.assert_allclose(
        tcommon.apply_mlp({k: _t(v) for k, v in mlp.items()}, _t(x)).numpy(),
        _np(jcommon.apply_mlp(mlp, x)), atol=1e-6, rtol=1e-6)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        a = jcommon.softmax_cross_entropy(logits, toks, m)
        b = tcommon.softmax_cross_entropy(
            _t(logits), _t(toks), None if m is None else _t(m))
        np.testing.assert_allclose(float(b), float(a), atol=1e-6, rtol=1e-6)


def test_tree_helpers():
    p = {"a.b": torch.zeros(2, 3), "c": torch.ones(4)}
    assert tcommon.tree_size(p) == 10
    assert all(v.dtype == torch.bfloat16
               for v in tcommon.tree_cast(p, torch.bfloat16).values())
    assert tcommon.dtype_of("bfloat16") == torch.bfloat16


# -- attention -----------------------------------------------------------------

ATTN_CFG = dict(name="attn", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64,
                qk_norm=True, param_dtype="float32",
                compute_dtype="float32")


@pytest.mark.parametrize("S", [48, 2304], ids=["naive", "chunked"])
@pytest.mark.parametrize("window", [0, 700])
def test_attention_forward_matches(S, window):
    assert (S > jattn.CHUNKED_THRESHOLD) == (S > tattn.CHUNKED_THRESHOLD)
    jc = jconfig.ArchConfig(**ATTN_CFG, sliding_window=window)
    tc = tconfig.ArchConfig(**ATTN_CFG, sliding_window=window)
    p = jattn.init_attention(jax.random.PRNGKey(3), jc, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    x = np.random.default_rng(4).normal(size=(1, S, 64)).astype(np.float32)
    a = jattn.attention_forward(p, jc, jnp.asarray(x))
    b = tattn.attention_forward(tp, tc, _t(x))
    np.testing.assert_allclose(b.numpy(), _np(a), atol=1e-5, rtol=1e-5)


# -- the LM ------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_lm_forward_and_init_match_for_reduced_dense_archs(name):
    jc, tc = _arch_pair(name)
    p = jtf.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    own = ttf.init_lm(tc, torch.Generator().manual_seed(0))
    assert list(own) == list(tp)              # names in the pytree order
    for k in own:
        assert own[k].shape == tp[k].shape and own[k].dtype == tp[k].dtype
    toks = np.random.default_rng(5).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    la, ha, aa = jtf.lm_forward(jc, p, jnp.asarray(toks))
    lb, hb, ab = ttf.lm_forward(tc, tp, _t(toks))
    assert lb.dtype == torch.float32
    np.testing.assert_allclose(lb.numpy(), _np(la), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hb.numpy(), _np(ha), atol=1e-5, rtol=1e-5)
    assert float(ab) == float(aa) == 0.0
    # embeds= path and the round trip of the tree
    emb = tcommon.embed({"table": tp["embed.table"]}, _t(toks))
    np.testing.assert_array_equal(
        ttf.lm_forward(tc, tp, embeds=emb)[0].numpy(), lb.numpy())
    back = params_to_numpy(tp)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert np.array_equal(x, _np(y))


@pytest.mark.parametrize("name", DENSE[:4])
def test_lm_forward_chunked_path_matches_for_reduced_dense_archs(name):
    """Past ``CHUNKED_THRESHOLD`` positions every layer takes the online
    softmax over KV blocks (S = 2049, the shortest such run: two full
    blocks and a padded one)."""
    jc, tc = _arch_pair(name)
    p = jtf.init_lm(jc, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    toks = np.random.default_rng(6).integers(
        0, jc.vocab_size, (1, 2049)).astype(np.int32)
    la = jtf.lm_forward(jc, p, jnp.asarray(toks))[0]
    lb = ttf.lm_forward(tc, tp, _t(toks))[0]
    np.testing.assert_allclose(lb.numpy(), _np(la), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["qwen3-4b", "glm4-9b"])
def test_lm_forward_bf16_tier(name):
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jc = jconfig.override(_arch_pair(name)[0], **kw)
    tc = tconfig.override(_arch_pair(name)[1], **kw)
    p = jtf.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    toks = np.random.default_rng(8).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    la, ha, _ = jtf.lm_forward(jc, p, jnp.asarray(toks))
    lb, hb, _ = ttf.lm_forward(tc, tp, _t(toks))
    assert lb.dtype == torch.float32 and hb.dtype == torch.bfloat16
    np.testing.assert_allclose(lb.numpy(), _np(la), atol=3e-2)
    np.testing.assert_allclose(hb.float().numpy(),
                               _np(ha).astype(np.float32), atol=1.6e-2)
    agree = (lb.numpy().argmax(-1) == _np(la).argmax(-1)).mean()
    assert agree >= 0.95


@pytest.mark.parametrize("name", OTHER)
def test_other_families_raise_not_implemented(name):
    """No family raises any more: on an audio config the reference's
    ``init_lm`` / ``lm_forward`` build and run a decoder-only stack
    (``embed``, ``final_norm``, ``lm_head``, ``segments``), ignoring
    ``encdec``, and the port's do the same (the encoder-decoder model is
    ``models.encdec``, ``tests/test_torch_encdec.py``)."""
    jc, tc = _arch_pair(name)
    p = jax.jit(lambda k: jtf.init_lm(jc, k))(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    assert sorted(p) == ["embed", "final_norm", "lm_head", "segments"]
    own = ttf.init_lm(tc, torch.Generator().manual_seed(0))
    assert list(own) == list(tp)
    for k in own:
        assert own[k].shape == tp[k].shape and own[k].dtype == tp[k].dtype
    toks = np.random.default_rng(9).integers(
        0, jc.vocab_size, (1, 4)).astype(np.int32)
    la, ha, _ = jax.jit(lambda q, t: jtf.lm_forward(jc, q, t))(p, toks)
    lb, hb, ab = ttf.lm_forward(tc, tp, _t(toks))
    assert lb.shape == (1, 4, 512) and float(ab) == 0.0
    np.testing.assert_allclose(lb.numpy(), _np(la), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hb.numpy(), _np(ha), atol=1e-5, rtol=1e-5)


def test_mesh_raises_not_implemented():
    """The forward (ROADMAP item 13b.4) and the decode path (item 15b.1)
    take a mesh: on ``model=2`` the forward, a prefill and a decode step
    keep the one-device values (the bars of every family are in
    ``tests/test_torch_lm_mesh.py`` and ``test_torch_lm_mesh_decode.py``).
    A ``decode_2d`` layout (combined axes, gathered where used) keeps
    them too."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.tensor_parallel import Sharded
    _, tc = _arch_pair("qwen3-4b")
    params = ttf.init_lm(tc, torch.Generator().manual_seed(0))
    tok = torch.arange(4, dtype=torch.long)[None] * 7
    mesh = make_host_mesh(model=2)
    lg, _, _ = ttf.lm_forward(tc, params, tok, mesh=mesh)
    np.testing.assert_allclose(lg.numpy(),
                               ttf.lm_forward(tc, params, tok)[0].numpy(),
                               atol=1e-5)
    outs = []
    for m in (mesh, None):
        lp, c = ttf.lm_prefill(tc, params, tok, ttf.init_lm_caches(tc, 1, 8),
                               mesh=m)
        ld, c = ttf.lm_decode(tc, params, tok[:, :1], c, mesh=m)
        outs.append((lp, ld, c))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    for k, v in outs[1][2].items():
        np.testing.assert_allclose(outs[0][2][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
    d2 = {k: Sharded.place(params[k], mesh, v.spec)
          for k, v in param_shardings(tc, params, mesh,
                                      policy="decode_2d").items()}
    lp, c = ttf.lm_prefill(tc, d2, tok, ttf.init_lm_caches(tc, 1, 8),
                           mesh=mesh)
    ld, c = ttf.lm_decode(tc, d2, tok[:, :1], c, mesh=mesh)
    for a, b in zip((lp, ld), outs[1][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    for k, v in outs[1][2].items():
        np.testing.assert_allclose(c[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
