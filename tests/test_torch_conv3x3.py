"""The CNN's 3x3 convolution kernels (``kernels/conv3x3``).

On the CPU the stack runs the plain versions (``ref.py``), and must give
the same bits as the CNN's former formulation — one ``F.conv2d`` per
layer with its permutes, under ``torch.func`` — in value and in the
gradients of x, w and b, under each batching pattern: none, x and w
batched (the pair step's ``vmap(grad(cnn_loss))``) and only x batched
(the eval's ``vmap(cnn_accuracy, in_dims=(None, 0, 0))``).

The tests marked ``cuda`` hold the kernels against the plain versions on
the card (this file imports no jax):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_conv3x3.py

Tolerance on the card: each output against the plain version computed in
float64, to 3e-5 of the same product summed in absolute values (|x| and
|w|, or |dy| masked by y > 0). A float32 sum of n terms of mixed signs
errs by about eps * sqrt(n / 3) of that scale (2.2e-6 at n = 4,096, the
longest sum: a wgrad slice), so 3e-5 is over 10 of its standard
deviations; a wrong index or a missing term errs by the term's size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch.func import grad, vmap  # noqa: E402

from repro_torch import telemetry  # noqa: E402
from repro_torch.kernels.conv3x3 import ops, ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.common import (accuracy,  # noqa: E402
                                       softmax_cross_entropy)

# (Cin, Cout, H) of the CNN's eight layers on 32x32 images
LAYERS = [(3, 32, 32), (32, 32, 32), (32, 64, 16), (64, 64, 16),
          (64, 128, 8), (128, 128, 8), (128, 256, 4), (256, 256, 4)]
TOL = 3e-5


def former_apply(params, x):
    """The CNN's forward before the kernels: NCHW convolutions between
    permutes (``ref.conv3x3_ref`` is one of its layers)."""
    x = x.permute(0, 3, 1, 2)
    for i in range(len(cnn.CHANNELS)):
        w = params[f"conv.{i}"].permute(3, 2, 0, 1)
        x = torch.relu(F.conv2d(x, w, params[f"conv_b.{i}"], padding=1))
        if i % 2 == 1:
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"] + params["fc1_b"])
    return x @ params["fc2"] + params["fc2_b"]


def _loss(apply):
    return lambda p, batch: softmax_cross_entropy(apply(p, batch[0]),
                                                  batch[1])


def _params(seed, device="cpu", pairs=None):
    g = torch.Generator().manual_seed(seed)
    p = cnn.init_cnn(g)
    for k in p:
        if k.startswith("conv_b"):          # nonzero biases
            p[k] = 0.05 * torch.randn(p[k].shape, generator=g)
    if pairs is not None:
        p = {k: v[None] + 0.01 * torch.randn((pairs,) + v.shape,
                                             generator=g)
             for k, v in p.items()}
    return {k: v.to(device) for k, v in p.items()}


def _images(seed, shape, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


def _labels(seed, shape, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 10, shape, generator=g).to(device)


def _equal(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- the plain path on the CPU ---------------------------------------------

@pytest.mark.parametrize("pattern", ["none", "pairs", "eval"])
def test_plain_path_equals_former_formulation(pattern):
    if pattern == "none":
        p, x = _params(0), _images(1, (4, 32, 32, 3))
        y = _labels(2, (4,))
        assert torch.equal(cnn.apply_cnn(p, x), former_apply(p, x))
        g_new, g_old = (grad(lambda q, a: _loss(fn)(q, (a, y)),
                             argnums=(0, 1))(p, x)
                        for fn in (cnn.apply_cnn, former_apply))
        _equal(g_new[0], g_old[0])
        assert torch.equal(g_new[1], g_old[1])            # d loss / d x
    elif pattern == "pairs":
        p, x = _params(0, pairs=2), _images(1, (2, 3, 32, 32, 3))
        y = _labels(2, (2, 3))
        _equal(vmap(grad(_loss(cnn.apply_cnn)))(p, (x, y)),
               vmap(grad(_loss(former_apply)))(p, (x, y)))
    else:
        p, x = _params(0), _images(1, (5, 4, 32, 32, 3))
        y = _labels(2, (5, 4))
        logits = vmap(cnn.apply_cnn, in_dims=(None, 0))(p, x)
        assert torch.equal(logits,
                           vmap(former_apply, in_dims=(None, 0))(p, x))
        acc_old = vmap(lambda q, a, b: accuracy(former_apply(q, a), b),
                       in_dims=(None, 0, 0))(p, x, y)
        with torch.no_grad():
            acc_new = vmap(cnn.cnn_accuracy, in_dims=(None, 0, 0))(p, x, y)
        assert torch.equal(acc_new, acc_old)


def test_plain_path_takes_the_models_dtype():
    """On the CPU the plain versions run in the model's dtype: a float64
    CNN (``init_cnn(dtype=torch.float64)``) gives the former
    formulation's float64 bits, in value and in gradient."""
    p = cnn.init_cnn(torch.Generator().manual_seed(0), dtype=torch.float64)
    x = _images(1, (3, 32, 32, 3)).double()
    y = _labels(2, (3,))
    logits = cnn.apply_cnn(p, x)
    assert logits.dtype == torch.float64
    assert torch.equal(logits, former_apply(p, x))
    _equal(grad(_loss(cnn.apply_cnn))(p, (x, y)),
           grad(_loss(former_apply))(p, (x, y)))


def test_plain_layer_gradients_equal_former_layer():
    """One layer through the stack: value and the gradients of x, w, b."""
    x, dy = _images(3, (2, 8, 8, 16)), _images(4, (2, 8, 8, 32))
    w = 0.1 * _images(5, (3, 3, 16, 32))
    b = 0.1 * _images(6, (32,))
    outs, grads = [], []
    for fn in (lambda *a: ops.conv3x3_stack(a[0], [a[1]], [a[2]], [False]),
               ref.conv3x3_ref):
        args = [t.clone().requires_grad_(True) for t in (x, w, b)]
        out = fn(*args)
        out.backward(dy)
        outs.append(out)
        grads.append([a.grad for a in args])
    assert torch.equal(outs[0], outs[1])
    for new, old in zip(*grads):
        assert torch.equal(new, old)


@pytest.mark.parametrize("x_grad", [False, True])
def test_dgrad_skipped_where_input_needs_no_gradient(monkeypatch, x_grad):
    calls = {"dgrad": 0, "wgrad": 0}

    def counted(name, fn):
        def call(*a):
            calls[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(ops, "conv3x3_dgrad",
                        counted("dgrad", ops.conv3x3_dgrad))
    monkeypatch.setattr(ops, "conv3x3_wgrad",
                        counted("wgrad", ops.conv3x3_wgrad))
    p, x = _params(0, pairs=2), _images(1, (2, 2, 32, 32, 3))
    y = _labels(2, (2, 2))
    argnums = (0, 1) if x_grad else 0
    vmap(grad(lambda q, a, b: _loss(cnn.apply_cnn)(q, (a, b)),
              argnums=argnums))(p, x, y)
    layers = len(cnn.CHANNELS)
    assert calls == {"dgrad": layers - 1 + x_grad, "wgrad": layers}


def test_no_conv_launches_counted_on_cpu():
    before = [fn.launches for fn in (ops.conv3x3_fwd, ops.conv3x3_dgrad,
                                     ops.conv3x3_wgrad)]
    telemetry.reset()
    p, x = _params(0, pairs=2), _images(1, (2, 2, 32, 32, 3))
    y = _labels(2, (2, 2))
    with telemetry.Round("test", 0, 1):
        vmap(grad(_loss(cnn.apply_cnn)))(p, (x, y))
    rec = telemetry.records()[-1]
    assert "conv_launches" not in rec.counters
    assert [fn.launches for fn in (ops.conv3x3_fwd, ops.conv3x3_dgrad,
                                   ops.conv3x3_wgrad)] == before
    telemetry.reset()


@pytest.mark.parametrize("case", ["dtype", "shape", "layout", "cout"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(case):
    x, w, b = torch.zeros(1, 2, 4, 4, 8), torch.zeros(1, 3, 3, 8, 16), \
        torch.zeros(1, 16)
    if case == "dtype":
        x = x.double()
    elif case == "shape":
        w = torch.zeros(1, 3, 3, 4, 16)
    elif case == "layout":
        x = torch.zeros(1, 2, 4, 8, 4).transpose(3, 4)
    else:
        w, b = torch.zeros(1, 3, 3, 8, 6), torch.zeros(1, 6)
    with pytest.raises(ValueError):
        ops.conv3x3_fwd(x, w, b)


def test_tile_rule_follows_the_shape():
    # forward (rows: 32 images' pixels, N = Cout), dgrad (N = Cin) and
    # wgrad (rows 9 * Cin + 1, N = Cout) of the CNN's layers
    fwd = [ops.tile_for(32 * h * h, cout) for _, cout, h in LAYERS]
    dgrad = [ops.tile_for(32 * h * h, cin) for cin, _, h in LAYERS[1:]]
    wgrad = [ops.tile_for(9 * cin + 1, cout) for cin, cout, _ in LAYERS]
    assert [ops.TILES[t][:2] for t in fwd] == [
        (128, 32), (128, 32), (128, 64), (128, 64), (128, 128), (128, 128),
        (128, 128), (128, 128)]
    assert [ops.TILES[t][:2] for t in dgrad] == [
        (128, 32), (128, 32), (128, 64), (128, 64), (128, 128), (128, 128),
        (128, 128)]
    assert [ops.TILES[t][:2] for t in wgrad] == [
        (32, 32), (128, 32), (128, 64), (128, 64), (128, 128), (128, 128),
        (128, 128), (128, 128)]
    # the pair step's wgrad: 64 pairs of 32 images; the slices of the
    # first layers' long pixel sums fill the card and stay <= 4,096 long
    splits = [ops.wgrad_splits(64, 9 * cin + 1, cout, 32 * h * h)
              for cin, cout, h in LAYERS]
    assert splits == [17, 8, 6, 4, 4, 2, 1, 1]
    assert all(-(-32 * h * h // s) <= ops.SLICE_MAX
               for s, (_, _, h) in zip(splits, LAYERS))
    assert ops.wgrad_splits(1, 28, 32, 512) == 1     # a small call


# --- the kernels on the card -----------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer_inputs(cin, cout, h, G, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=device)

    x = rnd(G, n, h, h, cin).relu()            # post-ReLU activations
    w = rnd(G, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
    b = rnd(G, cout, scale=0.05)
    dy = rnd(G, n, h, h, cout)
    return x, w, b, dy


def _close(out, exact, scale, what):
    err = (out.double() - exact).abs()
    bad = err > TOL * scale + 1e-30
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {err.numel()} values off; worst "
        f"{float((err / (scale + 1e-30)).max()):.3g} of the scale")


def _check_layer(cin, cout, h, G, n, device, backward=True):
    x, w, b, dy = _layer_inputs(cin, cout, h, G, n, device)
    y = ops.conv3x3_fwd(x, w, b)
    x64, w64, b64 = x.double(), w.double(), b.double()
    _close(y, ref.conv3x3_fwd_ref(x64, w64, b64),
           ref.conv3x3_fwd_ref(x64.abs(), w64.abs(), b64.abs()), "forward")
    if not backward:
        return
    y64, dy64 = y.double(), dy.double()
    dx = ops.conv3x3_dgrad(dy, y, w)
    _close(dx, ref.conv3x3_dgrad_ref(dy64, y64, w64),
           ref.conv3x3_dgrad_ref(dy64.abs(), y64, w64.abs()), "dgrad")
    dw, db = ops.conv3x3_wgrad(x, dy, y)
    dw_exact, db_exact = ref.conv3x3_wgrad_ref(x64, dy64, y64)
    dw_scale, db_scale = ref.conv3x3_wgrad_ref(x64.abs(), dy64.abs(), y64)
    _close(dw, dw_exact, dw_scale, "wgrad")
    _close(db, db_exact, db_scale, "bias gradient")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 64])
@pytest.mark.parametrize("layer", range(len(LAYERS)))
def test_kernels_match_plain_on_card(cuda, layer, G):
    _check_layer(*LAYERS[layer], G=G, n=32, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", range(len(LAYERS)))
def test_forward_matches_plain_at_eval_fold_on_card(cuda, layer):
    """The eval's call: one model over 30 devices' 128 images, G = 1."""
    _check_layer(*LAYERS[layer], G=1, n=30 * 128, device=cuda,
                 backward=False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 8, 5, 7), (12, 20, 6, 3),
                                   (8, 132, 3, 9)])
def test_kernels_match_plain_at_ragged_shapes_on_card(cuda, shape):
    """Widths off the tiles, non-square images, a ragged last tile."""
    cin, cout, h, w_ = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 3, h, w_, cin, generator=g, device=cuda)
    w = torch.randn(2, 3, 3, cin, cout, generator=g, device=cuda)
    b = torch.randn(2, cout, generator=g, device=cuda)
    dy = torch.randn(2, 3, h, w_, cout, generator=g, device=cuda)
    y = ops.conv3x3_fwd(x, w, b)
    x64, w64, b64, y64, dy64 = (t.double() for t in (x, w, b, y, dy))
    _close(y, ref.conv3x3_fwd_ref(x64, w64, b64),
           ref.conv3x3_fwd_ref(x64.abs(), w64.abs(), b64.abs()), "forward")
    _close(ops.conv3x3_dgrad(dy, y, w), ref.conv3x3_dgrad_ref(dy64, y64, w64),
           ref.conv3x3_dgrad_ref(dy64.abs(), y64, w64.abs()), "dgrad")
    dw, db = ops.conv3x3_wgrad(x, dy, y)
    exact, scale = (ref.conv3x3_wgrad_ref(x64, dy64, y64),
                    ref.conv3x3_wgrad_ref(x64.abs(), dy64.abs(), y64))
    _close(dw, exact[0], scale[0], "wgrad")
    _close(db, exact[1], scale[1], "bias gradient")


@pytest.mark.cuda
def test_kernels_are_deterministic_on_card(cuda):
    for layer in (0, 1, 7):
        x, w, b, dy = _layer_inputs(*LAYERS[layer], G=64, n=32, device=cuda)
        y = ops.conv3x3_fwd(x, w, b)
        assert torch.equal(y, ops.conv3x3_fwd(x, w, b))
        assert torch.equal(ops.conv3x3_dgrad(dy, y, w),
                           ops.conv3x3_dgrad(dy, y, w))
        (dw1, db1), (dw2, db2) = (ops.conv3x3_wgrad(x, dy, y)
                                  for _ in range(2))
        assert torch.equal(dw1, dw2) and torch.equal(db1, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "shape", "layout", "device"])
def test_wrappers_raise_on_card(cuda, case):
    x, w, b, _ = _layer_inputs(32, 64, 8, 2, 4, cuda)
    if case == "dtype":
        x = x.double()
    elif case == "shape":
        b = b[:, :32].contiguous()
    elif case == "layout":
        x = x.transpose(2, 3)
    else:
        w = w.cpu()
    with pytest.raises(ValueError):
        ops.conv3x3_fwd(x, w, b)


@pytest.mark.cuda
def test_pair_step_matches_former_cudnn_step_on_card(cuda):
    """One vmapped pair step of the CNN (64 pairs of 32 images) on the
    kernels and in the former formulation on cuDNN, each against the
    former formulation in float64, as the benchmark's step_gap reads a
    gradient: a pair's gap is its worst leaf's |g - g64| / |g64|, and the
    median pair's gap stays under 1e-3 (step_gap's limit). A pair's own
    gap can be larger where float32 flips a ReLU or a max-pool choice,
    in either formulation. The kernels' calls are counted once each: 8
    forward, 7 dgrad, 8 wgrad."""
    p = _params(0, cuda, pairs=64)
    x = _images(1, (64, 32, 32, 32, 3), cuda)
    y = _labels(2, (64, 32), cuda)
    fns = (ops.conv3x3_fwd, ops.conv3x3_dgrad, ops.conv3x3_wgrad)
    before = [fn.launches for fn in fns]
    telemetry.reset()
    with telemetry.Round("test", 0, 1):
        g_new = vmap(grad(_loss(cnn.apply_cnn)))(p, (x, y))
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(fns, before)] == [8, 7, 8]
    assert telemetry.records()[-1].counters["conv_launches"] == 23
    telemetry.reset()
    g_old = vmap(grad(_loss(former_apply)))(p, (x, y))
    g64 = vmap(grad(_loss(former_apply)))(
        {k: v.double() for k, v in p.items()}, (x.double(), y))

    def median_gap(g):
        gaps = torch.stack([(g[k].double() - g64[k]).flatten(1).norm(dim=1)
                            / g64[k].flatten(1).norm(dim=1) for k in g64])
        return float(gaps.max(0).values.median())

    new, old = median_gap(g_new), median_gap(g_old)
    assert new < 1e-3 and old < 1e-3, (new, old)
    assert all(torch.isfinite(v).all() for v in g_new.values())
