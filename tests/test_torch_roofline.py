"""The port's roofline tooling (``repro_torch.roofline``) against the
reference's (``repro.roofline``), on the CPU.

``model_flops`` and ``roofline_terms`` keep the reference's math
(``roofline_terms`` fed the reference's own TPU constants, read at test
time: the port holds only the H100's). The trace counter stands in for
the reference's HLO analyzer: the programs of ``tests/test_roofline.py``
(a loop of products at 3 and 11 layers, its gradient, full remat, nested
loops) written as torch loops give the FLOPs the analyzer reads from the
same programs compiled by XLA (rel 0.01, the reference's bar), and the
``"dots"`` remat policy lands between grad and full remat, as the
reference's ``dots_with_no_batch_dims_saveable`` does, with gradients
equal to no remat. The memory tracker's peak is held to a count made by
hand, and the collectives' accounting to the mesh runtime's calls.
"""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.config import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_arch as j_arch  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline.hlo_analyzer import analyze as hlo_analyze  # noqa: E402
from repro_torch.config import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import all_arch_names, get_arch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.tensor_parallel import (Sharded,  # noqa: E402
                                                reduce_replicas)
from repro_torch.models.common import remat_call  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline.trace_analyzer import (TraceCounter,  # noqa: E402
                                                 analyze)

WIDTH, BATCH = 64, 32


# -- the term math ------------------------------------------------------------

@pytest.mark.parametrize("arch", all_arch_names())
def test_model_flops_equals_the_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        assert analysis.model_flops(get_arch(arch), shape) == \
            janalysis.model_flops(j_arch(arch), J_SHAPES[name]), name


def test_roofline_terms_equal_the_reference_on_its_constants():
    """``tests/test_roofline.py:69-76``'s inputs, with ``HW`` built from
    the reference's ``HW()``; and the same with a config and shape."""
    j = janalysis.HW()
    hw = analysis.HW(peak_flops=j.peak_flops, hbm_bw=j.hbm_bw,
                     link_bw=j.ici_bw)
    cost = {"flops": 197e12, "bytes accessed": 819e9 * 2}
    coll = {"total_bytes": 50e9 * 0.5, "by_kind": {}, "counts": {}}
    t = analysis.roofline_terms(cost, coll, chips=256, hw=hw)
    assert t == janalysis.roofline_terms(cost, coll, chips=256)
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(2.0)
    assert t["t_collective_s"] == pytest.approx(0.5)
    assert t["dominant"] == "memory"
    for arch in ("qwen3-4b", "deepseek-v3-671b"):
        assert analysis.roofline_terms(
            cost, coll, 256, get_arch(arch), INPUT_SHAPES["train_4k"],
            hw=hw) == janalysis.roofline_terms(
                cost, coll, 256, j_arch(arch), J_SHAPES["train_4k"])


def test_hw_holds_the_h100_datasheet_numbers():
    hw = analysis.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12,
                                                       450e9)


def test_model_flops_moe_uses_active_params():
    ds = get_arch("deepseek-v3-671b")
    counts = ds.param_counts()
    assert counts["total"] > 5e11            # ~671B
    assert counts["active"] < counts["total"] / 10   # ~37B active
    mf = analysis.model_flops(ds, INPUT_SHAPES["train_4k"])
    assert mf == pytest.approx(6 * counts["active"] * 256 * 4096, rel=1e-6)


# -- the counter against the reference's HLO analyzer -------------------------

def _ref_flops(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_analyze(jax.jit(f).lower(*args).compile().as_text())["flops"]


def _ref_loop(remat=None):
    def f(x, w):
        def body(c, wl):
            return jnp.tanh(c @ wl), None
        if remat == "full":
            body = jax.checkpoint(body)
        elif remat == "dots":
            policies = jax.checkpoint_policies
            body = jax.checkpoint(
                body, policy=policies.dots_with_no_batch_dims_saveable)
        y, _ = jax.lax.scan(body, x, w)
        return y.sum()
    return f


def _loop(x, w, remat=False):
    c = x
    for wl in w.unbind(0):
        c = remat_call(lambda h, wl=wl: torch.tanh(h @ wl), remat, c)
    return c.sum()


def _inputs(layers, width=WIDTH, batch=BATCH):
    g = torch.Generator().manual_seed(layers)
    return (torch.randn(batch, width, generator=g).requires_grad_(),
            torch.randn(layers, width, width, generator=g).requires_grad_())


def _flops(fn, *args):
    return analyze(fn, *args)[1]["flops"]


@pytest.mark.parametrize("layers", [3, 11])
def test_counter_counts_every_layer(layers):
    x, w = _inputs(layers)
    got = _flops(_loop, x, w)
    assert got == 2 * BATCH * WIDTH * WIDTH * layers
    assert got == pytest.approx(
        _ref_flops(_ref_loop(), (BATCH, WIDTH), (layers, WIDTH, WIDTH)),
        rel=0.01)


def _grad_flops(remat, layers=7):
    x, w = _inputs(layers)
    return _flops(lambda: torch.autograd.grad(_loop(x, w, remat), (x, w)))


def test_counter_grad_is_3x_forward():
    x, w = _inputs(7)
    fwd = _flops(_loop, x, w)
    bwd = _grad_flops(False)
    ref = _ref_flops(jax.grad(_ref_loop(), argnums=(0, 1)),
                     (BATCH, WIDTH), (7, WIDTH, WIDTH))
    assert bwd == pytest.approx(3 * fwd, rel=0.05)
    assert bwd == pytest.approx(ref, rel=0.01)


def test_counter_full_remat_is_4x_forward():
    fwd = 2 * BATCH * WIDTH * WIDTH * 7
    for remat in (True, "full"):
        got = _grad_flops(remat)
        assert got == pytest.approx(4 * fwd, rel=0.05)
        assert got == pytest.approx(
            _ref_flops(jax.grad(_ref_loop("full"), argnums=(0, 1)),
                       (BATCH, WIDTH), (7, WIDTH, WIDTH)), rel=0.01)


def test_dots_remat_keeps_the_products_and_the_gradients():
    """``remat="dots"``: FLOPs between grad (3x) and full remat (4x), as
    the reference's policy, equal to the reference's count of the same
    program; its gradients equal no remat's (bitwise: the same ops)."""
    fwd = 2 * BATCH * WIDTH * WIDTH * 7
    got = _grad_flops("dots")
    assert 3 * fwd <= got <= 4 * fwd
    assert got == pytest.approx(
        _ref_flops(jax.grad(_ref_loop("dots"), argnums=(0, 1)),
                   (BATCH, WIDTH), (7, WIDTH, WIDTH)), rel=0.01)
    x, w = _inputs(7)
    plain = torch.autograd.grad(_loop(x, w), (x, w))
    for remat in ("dots", "full"):
        for a, b in zip(torch.autograd.grad(_loop(x, w, remat), (x, w)),
                        plain):
            assert torch.equal(a, b), remat
    with pytest.raises(ValueError, match="remat"):
        _loop(x, w, "some")


def test_nested_loops_multiply():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 32, generator=g)
    w = torch.randn(4, 32, 32, generator=g)

    def f(x, w):
        c = x
        for wl in w.unbind(0):
            for _ in range(5):
                c = torch.tanh(c @ wl)
        return c.sum()

    def jf(x, w):
        def outer(c, wl):
            def inner(c2, _):
                return jnp.tanh(c2 @ wl), None
            c3, _ = jax.lax.scan(inner, c, jnp.arange(5))
            return c3, None
        y, _ = jax.lax.scan(outer, x, w)
        return y.sum()

    expect = 2 * 16 * 32 * 32 * 5 * 4
    got = _flops(f, x, w)
    assert got == expect
    assert got == pytest.approx(_ref_flops(jf, (16, 32), (4, 32, 32)),
                                rel=0.02)


# -- bytes alive and traffic --------------------------------------------------

def test_memory_tracker_peak_is_the_count_by_hand():
    """``x`` (4000 bytes, an input) -> ``a`` 4000 -> ``b`` 4000 (``a``
    dies: 4000 alive) -> a view of ``b`` (no bytes) -> its sum over
    halves 2000 -> that repeated 4000: the peak of bytes made is ``b`` +
    the sum + the repeat = 10000 (``a`` + ``b`` was 8000), with the input
    14000; 2 x every result's bytes is the traffic, views not counted."""
    x = torch.ones(1000)

    def f(x):
        a = x * 2
        b = a + 1
        del a
        v = b.view(2, 500)
        return v.sum(0).repeat(2)

    counter = TraceCounter(backward=False)
    counter.add_inputs([(x, [(0, 0)])])
    with counter:
        out = f(x)
    t = counter.result(lambda t: t["flops"])
    assert out.shape == (1000,)
    assert t["argument_bytes"] == 4000
    assert t["temp_bytes"] == 10000
    assert t["peak_bytes"] == 14000
    assert t["peak_bytes_all_cells"] == 14000
    # a, b, the sum (2000) and the repeat (4000)
    assert t["memory_bytes"] == 2 * (4000 + 4000 + 2000 + 4000)
    assert t["flops"] == 0


def test_memory_tracker_on_meta_tensors():
    """The same on ``meta`` tensors (no storage): shapes give the bytes."""
    x = torch.empty(1000, device="meta")
    counter = TraceCounter(backward=False)
    counter.add_inputs([(x, [(0, 0)])])
    with counter:
        a = x * 2
        b = a + 1
        del a
        b.exp()
    assert counter.result(lambda t: 0)["temp_bytes"] == 8000


# -- the mesh runtime's collectives -------------------------------------------

def test_collectives_are_recorded_per_receiving_cell():
    """On ``model=2, data=2``: a ``P("data", "model")`` leaf gathered
    whole on cell (0, 1) is one all-gather of the whole leaf to that
    cell; its FSDP gather to cell (1, 0) one all-gather of the cell's
    model block; the gradients of a replicated leaf one all-reduce to
    each of the four cells; a gathered result that takes a gradient
    records its reduce-scatter in the backward pass. Nothing is recorded
    without a counter."""
    from repro_torch.launch.tensor_parallel import on_cell
    mesh = make_host_mesh(model=2, data=2)
    w = torch.randn(8, 6, requires_grad=True)
    leaf = Sharded.place(w, mesh, ("data", "model"))
    rep = Sharded.place(torch.ones(3), mesh, (None,))
    counter = TraceCounter()
    with counter:
        with on_cell(0, 1):
            whole = leaf.full(torch.device("cpu"), prefer_sd=1)
        with on_cell(1, 0):
            mine = leaf.local(1, 0)
        reduce_replicas(rep)
        torch.autograd.grad((whole.sum() + mine.sum()), w)
    c = counter.cells
    assert whole.shape == (8, 6) and mine.shape == (8, 3)
    assert c[(0, 1)].collective_counts["all-gather"] == 1
    assert c[(0, 1)].collective_bytes["all-gather"] == 8 * 6 * 4
    assert c[(1, 0)].collective_bytes["all-gather"] == 8 * 3 * 4
    assert c[(0, 1)].collective_bytes["reduce-scatter"] == 8 * 6 * 4
    assert c[(1, 0)].collective_bytes["reduce-scatter"] == 8 * 3 * 4
    for cell in ((0, 0), (0, 1), (1, 0), (1, 1)):
        assert c[cell].collective_counts["all-reduce"] == 1, cell
        assert c[cell].collective_bytes["all-reduce"] == 12, cell
    leaf.full(torch.device("cpu"))          # no counter: nothing recorded
    assert c[(0, 0)].collective_counts["all-gather"] == 0
