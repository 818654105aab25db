"""The port's LM sharding specs and hints (``repro_torch.launch.sharding``'s
LM half, ``repro_torch.sharding_hints``) against the reference's, on the
CPU.

The reference's ``param_shardings`` / ``lm_bank_shardings`` /
``auto_shardings`` / ``batch_spec`` run on meshes of up to four devices,
so one JAX subprocess on ``--xla_force_host_platform_device_count=4``
computes them all once (every arch of ``all_arch_names()``, reduced and
at full width through ``jax.eval_shape``, both policies, on the launch
meshes ``1x1``, ``model=2``, ``model=4`` and ``model=2, data=2``) and
dumps each leaf's spec to JSON. The port's specs must equal them leaf
for leaf — the port's ``test_sharding_policies_cover_all_params``. The
reduced archs take the port's own ``init_lm`` / ``init_encdec`` names
and shapes; the full-width ones the reference's abstract shapes (the
rules are functions of a leaf's name and shape).

Also pinned: ``constrain`` is the identity on values (a tensor and a
sharded leaf, in the context and out of it), and a sharded leaf's
gathers and copies invert its split.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import make_launch_mesh  # noqa: E402
from repro_torch.launch.tensor_parallel import (Sharded,  # noqa: E402
                                                all_reduce_sum, split)
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding_hints import (active, constrain,  # noqa: E402
                                        sharding_hints)

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((1, 1), (2, 1), (4, 1), (2, 2))          # (model, data)
POLICIES = ("train", "decode_2d")
CACHE = (4, 32)                                    # batch, max_len
BATCHES = ((4, 2), (3, 3), (8, 4), (1, 2))         # (batch, ndim)

_REF_SCRIPT = textwrap.dedent("""
    import json
    import jax
    from repro.configs import all_arch_names, get_arch, reduced
    from repro.launch.mesh import make_launch_mesh
    from repro.launch.sharding import (auto_shardings, batch_spec,
                                       lm_bank_shardings, param_shardings)
    from repro.models import encdec as ed
    from repro.models import transformer as tf
    assert jax.device_count() == 4, jax.device_count()

    def path_of(path):
        return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)

    def spec_of(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    def specs(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        return {{path_of(p): spec_of(s) for p, s in flat}}

    def shapes(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {{path_of(p): list(a.shape) for p, a in flat}}

    key = jax.random.PRNGKey(0)
    out = {{"specs": {{}}, "bank": {{}}, "cache": {{}}, "batch": {{}},
           "shapes": {{}}}}
    for name in all_arch_names():
        for size in ("reduced", "full"):
            full = get_arch(name)
            cfg = reduced(full) if size == "reduced" else full
            init = ((lambda k: ed.init_encdec(cfg, k))
                    if cfg.family == "audio" else
                    (lambda k: tf.init_lm(cfg, k)))
            out["shapes"][f"{{name}}/{{size}}"] = shapes(
                jax.eval_shape(init, key))
    for m, d in {meshes!r}:
        mesh = make_launch_mesh(model=m, data=d)
        mk = f"{{m}}x{{d}}"
        for name in all_arch_names():
            for size in ("reduced", "full"):
                full = get_arch(name)
                cfg = reduced(full) if size == "reduced" else full
                init = ((lambda k: ed.init_encdec(cfg, k))
                        if cfg.family == "audio" else
                        (lambda k: tf.init_lm(cfg, k)))
                sh = jax.eval_shape(init, key)
                for pol in {policies!r}:
                    out["specs"][f"{{mk}}/{{name}}/{{size}}/{{pol}}"] = \\
                        specs(param_shardings(cfg, sh, mesh, policy=pol))
                if size == "reduced":
                    out["bank"][f"{{mk}}/{{name}}"] = specs(
                        lm_bank_shardings(cfg, sh, mesh))
                    if cfg.family != "audio":
                        caches = jax.eval_shape(
                            lambda: tf.init_lm_caches(cfg, *{cache!r}))
                        out["cache"][f"{{mk}}/{{name}}"] = specs(
                            auto_shardings(caches, mesh))
        for b, nd in {batches!r}:
            out["batch"][f"{{mk}}/{{b}}/{{nd}}"] = spec_of(
                batch_spec(mesh, b, nd))
    with open({path!r}, "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    """Every reference spec of this file, from one process on four
    forced host devices."""
    path = str(tmp_path_factory.mktemp("lmspecs") / "specs.json")
    code = _REF_SCRIPT.format(meshes=MESHES, policies=POLICIES, cache=CACHE,
                              batches=BATCHES, path=path)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


def _mesh(m, d):
    return make_launch_mesh(m, d, devices=["cpu"] * (m * d))


def _spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]


def _port_shapes(cfg):
    g = torch.Generator().manual_seed(0)
    p = (ted.init_encdec(cfg, g) if cfg.family == "audio"
         else ttf.init_lm(cfg, g))
    return {k: tuple(v.shape) for k, v in p.items()}


@pytest.fixture(scope="module")
def reduced_shapes():
    return {name: _port_shapes(tconfigs.reduced(tconfigs.get_arch(name)))
            for name in tconfigs.all_arch_names()}


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=[f"{m}x{d}" for m, d in MESHES])
@pytest.mark.parametrize("size", ("reduced", "full"))
def test_param_shardings_equal_the_reference(ref_specs, reduced_shapes,
                                             mesh_shape, size):
    """Every leaf of every arch, both policies: the port's spec is the
    reference's (and every leaf gets one)."""
    mesh = _mesh(*mesh_shape)
    mk = "{}x{}".format(*mesh_shape)
    for name in tconfigs.all_arch_names():
        full = tconfigs.get_arch(name)
        cfg = tconfigs.reduced(full) if size == "reduced" else full
        ref_shapes = ref_specs["shapes"][f"{name}/{size}"]
        if size == "reduced":
            shapes = reduced_shapes[name]
            assert {k: list(v) for k, v in shapes.items()} == ref_shapes, \
                name
        else:
            shapes = {k: tuple(v) for k, v in ref_shapes.items()}
        for pol in POLICIES:
            port = tsh.param_shardings(cfg, shapes, mesh, policy=pol)
            ref = ref_specs["specs"][f"{mk}/{name}/{size}/{pol}"]
            assert set(port) == set(ref) == set(shapes), (name, pol)
            bad = {k: (_spec(s), ref[k]) for k, s in port.items()
                   if _spec(s) != ref[k]}
            assert not bad, (name, size, pol, bad)


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=[f"{m}x{d}" for m, d in MESHES])
def test_bank_cache_and_batch_specs_equal_the_reference(
        ref_specs, reduced_shapes, mesh_shape):
    """``lm_bank_shardings`` of every reduced arch, ``auto_shardings`` of
    its decode caches, and ``batch_spec``, leaf for leaf."""
    mesh = _mesh(*mesh_shape)
    mk = "{}x{}".format(*mesh_shape)
    for name in tconfigs.all_arch_names():
        cfg = tconfigs.reduced(tconfigs.get_arch(name))
        bank = tsh.lm_bank_shardings(cfg, reduced_shapes[name], mesh)
        assert {k: _spec(s) for k, s in bank.items()} == \
            ref_specs["bank"][f"{mk}/{name}"], name
        if cfg.family == "audio":
            continue
        caches = ttf.init_lm_caches(cfg, *CACHE)
        auto = tsh.auto_shardings(caches, mesh)
        assert {k: _spec(s) for k, s in auto.items()} == \
            ref_specs["cache"][f"{mk}/{name}"], name
    for b, nd in BATCHES:
        assert _spec(tsh.batch_spec(mesh, b, nd)) == \
            ref_specs["batch"][f"{mk}/{b}/{nd}"]
    assert tsh.replicated(mesh, 3).spec == (None, None, None)


def test_partition_spec_normalizes_like_the_reference():
    assert tsh.P(("data",), "model") == ("data", "model")
    assert tsh.P(("data", "model"), None) == (("data", "model"), None)
    assert tsh.P() == ()


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=[f"{m}x{d}" for m, d in MESHES])
def test_constrain_is_the_identity_on_values(mesh_shape):
    """Out of the context and in it, on a tensor and on a sharded leaf,
    ``constrain`` keeps the values; in the context a sharded leaf takes
    the pattern's layout."""
    mesh = _mesh(*mesh_shape)
    x = torch.randn(4, 6, 8, 2, generator=torch.Generator().manual_seed(3))
    pattern = ("dp", None, "tp", None)
    s = Sharded.place(x, mesh, (None, None, None, None))
    assert not active()
    assert constrain(x, pattern) is x and constrain(s, pattern) is s
    with sharding_hints(mesh, ("data",)):
        assert active()
        assert constrain(x, pattern) is x
        assert constrain(x, (None,)) is x          # rank mismatch
        c = constrain(s, pattern)
        assert torch.equal(c.full(torch.device("cpu")), x)
        m, d = mesh_shape
        assert tuple(c.spec) == ("data", None, "model", None)
        assert all(p.shape == (4 // d, 6, 8 // m, 2) for p in c.pieces)
        # a dim the axis does not divide stays whole
        odd = Sharded.place(torch.randn(3, 5, 7, 2), mesh, (None,) * 4)
        assert tuple(constrain(odd, pattern).spec) == (
            "data" if d == 1 else None, None,
            "model" if m == 1 else None, None)
    assert not active()
    with sharding_hints(None):
        assert not active()


def test_sharded_leaf_gathers_and_copies_invert_its_split():
    """A split leaf on two device objects: pieces are its blocks, one per
    cell; ``full`` / ``local`` gather them; ``copy_`` writes a whole
    tensor block by block; the collectives add in cell order."""
    mesh = make_launch_mesh(2, 2, devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    s = Sharded.place(x, mesh, tsh.P("data", "model"))
    assert len(s.distinct()) == 4
    assert [tuple(p.shape) for p in s.pieces] == [(4, 3)] * 4
    cpu = torch.device("cpu")
    assert torch.equal(s.full(cpu), x)
    assert torch.equal(s.local(1, 0), x[:, 3:])
    r = Sharded.place(x, mesh, tsh.P("model", None))   # copies over data
    assert len(r.distinct()) == 4 and len(r.groups()) == 2
    z = Sharded.zeros(mesh, r.spec, (8, 6), torch.float32)
    z.copy_(x)
    assert torch.equal(z.full(cpu), x) and torch.equal(z.piece(1, 1),
                                                       x[4:])
    parts = split(x, 0, [cpu, cpu])
    assert torch.equal(all_reduce_sum(parts, cpu), x[:4] + x[4:])
