"""The port's serving plane pieces (``repro_torch.serve``: routing, KV
pools, paged int8 storage, drafts, admission control) against the
reference's ``repro.serve``, on the CPU, with no trainer run.

* routing on the ``_world`` of ``tests/test_gateway.py:95-108`` in both
  packages: equal tables and equal ``hits`` / ``rebuilds`` /
  ``invalidations`` through swap → invalidate → clone → delete →
  migrate → departed / unknown devices; ``StackedParamBank.swap`` moves
  no ``version``;
* ``_quantize_leaf`` / ``_dequantize_leaf`` on the same cache leaves
  (attention K, MLA latents, the hybrid's shared K; lanes mapped and
  unmapped): codes at ROADMAP's quantize bar (at most one step, on fewer
  than 1e-3 of elements), f16 scales ``rtol=1e-6``, and the dequantized
  leaves of equal codes equal;
* ``draft_depth``, ``draft_config`` and ``truncate_lm_params`` on the
  four gateway configs and reduced Qwen3-4B: exact;
* pool and page accounting, paged idempotence, pool bytes equal to the
  reference's pools', the 3.5x shrink at float32;
* admission (bounded queue, token bucket with a fake clock) on a gateway
  over a ``_world`` registry of ``TINY`` params.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.core import scores as jscores  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import draft as jdraft  # noqa: E402
from repro.serve import gateway as jgw  # noqa: E402
from repro.serve import kv_pool as jkv  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import registry as treg  # noqa: E402
from repro_torch.core import scores as tscores  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import (KVPool, KVPoolManager, OverloadError,  # noqa: E402
                               PagedKVPool, RequestRejected, ServeGateway,
                               draft_config, draft_depth, truncate_lm_params)
from repro_torch.serve import gateway as tgw  # noqa: E402
from repro_torch.serve import kv_pool as tkv  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(pkg, cfgs):
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    common = dict(n_heads=4, d_ff=128, vocab_size=64, d_model=64, **f32)
    return {
        "tiny": pkg.ArchConfig(name="tiny", n_layers=2, n_kv_heads=2,
                               **common),
        "dense_win": pkg.ArchConfig(name="tw", n_layers=2, n_kv_heads=2,
                                    sliding_window=6, **common),
        "mla": pkg.ArchConfig(
            name="tm", family="moe", attn_type="mla", n_layers=2,
            n_kv_heads=4, mla=pkg.MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                qk_rope_dim=8, v_head_dim=16), **common),
        "ssm": pkg.ArchConfig(name="ts", family="ssm", n_layers=3,
                              n_kv_heads=4,
                              xlstm=pkg.XLSTMConfig(slstm_layers=(1,)),
                              **common),
        "hybrid": pkg.ArchConfig(name="th", family="hybrid", n_layers=5,
                                 n_kv_heads=4, shared_attn_every=2,
                                 shared_attn_lora_rank=4, **common),
        "qwen3-4b": cfgs.reduced(cfgs.get_arch("qwen3-4b")),
    }


JCFG = _configs(jconfig, jconfigs)
TCFG = _configs(tconfig, tconfigs)
TINY = TCFG["tiny"]


# -- routing --------------------------------------------------------------------

def _world(reg_mod, scores_mod, zeros, ones, n_dev=6, m_cap=4, n_shards=1):
    """``tests/test_gateway.py:95-108`` in either package: models {0, 1}
    live, devices 0-2 prefer model 0 and 3-5 model 1, all active on
    both."""
    reg = reg_mod.ModelRegistry.create({"w": zeros}, m_cap=m_cap,
                                       stacked=True, n_shards=n_shards)
    reg.clone(0, 1, {"w": ones})
    state = scores_mod.init_scores(n_dev, m_cap, ell=2)
    state.active[:, 1] = True
    state.alive[1] = True
    accs = np.zeros((n_dev, m_cap))
    accs[:3, 0], accs[:3, 1] = 0.9, 0.1
    accs[3:, 0], accs[3:, 1] = 0.1, 0.9
    return reg, scores_mod.push_accuracies(state, accs)


def _jworld(**kw):
    return _world(jreg, jscores, np.zeros(2, np.float32),
                  np.ones(2, np.float32), **kw)


def _tworld(**kw):
    return _world(treg, tscores, torch.zeros(2), torch.ones(2), **kw)


def _script(reg, state, rt_mod, tree_of, clone_params):
    """Drive one package's routing through every lifecycle event;
    return the tables and counters seen after each step."""
    present = {0, 1, 2, 3, 4}
    rt = rt_mod.RoutingTable(reg, lambda: state)
    log = []

    def snap(tag, devices=range(6)):
        routes = []
        for d in devices:
            try:
                routes.append(rt.resolve(d))
            except rt_mod.RequestRejected:
                routes.append(None)
        log.append((tag, routes, rt.hits, rt.rebuilds, rt.invalidations,
                    reg.params.version))

    snap("warm")
    reg.params.swap(tree_of(reg.params))         # a training write
    snap("swap")
    rt.invalidate()                              # scores drifted
    snap("invalidate")
    mid = reg.clone(1, 5, clone_params)
    state.active[:, mid] = True
    state.alive[mid] = True
    state.history[5, mid, :] = 1.0               # device 5 prefers it
    snap("clone")
    state.active[4, 0] = False
    state.active[4, mid] = False                 # device 4: model 1 only
    reg.kill(1, round_=9)
    snap("delete")
    rt_present = rt_mod.RoutingTable(reg, lambda: state,
                                     present_fn=lambda d: d in present)
    routes = []
    for d in (2, 5, 17):
        try:
            routes.append(rt_present.resolve(d))
        except rt_mod.RequestRejected:
            routes.append(None)
    log.append(("departed/unknown", routes, rt_present.hits,
                rt_present.rebuilds, rt_present.invalidations,
                reg.params.version))
    return log


def test_routing_matches_reference_through_lifecycle():
    jr, js = _jworld()
    tr, ts = _tworld()
    want = _script(jr, js, jgw,
                   lambda bank: jax.tree.map(lambda a: a + 1.0, bank.tree),
                   {"w": np.full(2, 2.0, np.float32)})
    got = _script(tr, ts, tgw,
                  lambda bank: {k: v + 1.0 for k, v in bank.tree.items()},
                  {"w": torch.full((2,), 2.0)})
    assert got == want
    # the swap wrote the bank (rows read back +1) without a version bump
    assert torch.equal(tr.params[0]["w"], torch.ones(2))
    assert [entry[5] for entry in got][:3] == [2, 2, 2]


def test_routing_migrate_invalidates_like_reference():
    out = []
    for reg, state, mod in (_jworld(n_shards=2) + (jgw,),
                            _tworld(n_shards=2) + (tgw,)):
        rt = mod.RoutingTable(reg, lambda state=state: state)
        first = rt.resolve(0)
        bank = reg.params
        bank.migrate(0, 1 - bank.shard_of(0))   # pure layout, version bumps
        out.append((first, rt.resolve(0), rt.hits, rt.rebuilds,
                    rt.invalidations, bank.shard_of(0)))
    assert out[0] == out[1]
    assert out[1][4] == 1


def test_llm_engine_training_does_not_reroute():
    """The port's ``llm`` engine trains bank rows in place: the bank's
    ``version`` (and so the routing epoch) does not move on a training
    round, only on a clone."""
    from repro_torch.config import FedCDConfig
    from repro_torch.federated.llm import FedLLMTrainer
    fed = FedCDConfig(n_devices=4, devices_per_round=3, score_window=2,
                      milestones=(3,), max_models=4, lr=0.05, seed=0)
    tr = FedLLMTrainer(TINY, fed, 4, 2, 8, device="cpu")
    bank = tr.registry.params
    v0, w0 = bank.version, bank[0]["embed.table"].clone()
    tr.run(2)
    assert not torch.equal(bank[0]["embed.table"], w0)   # it trained
    assert bank.version == v0
    tr.run(3)                                            # the clone
    assert bank.version == v0 + 1


# -- paged int8: the KV contract ----------------------------------------------

def _leaf_cases():
    """(config, flat cache key, reference tree path) of pageable leaves."""
    return [("tiny", "0.k", (0, "k")), ("mla", "0.c_kv", (0, "c_kv")),
            ("mla", "0.k_rope", (0, "k_rope")),
            ("hybrid", "shared.k", ("shared", "k"))]


@pytest.mark.parametrize("name,key,path", _leaf_cases(),
                         ids=lambda v: str(v))
def test_quantize_leaf_matches_reference(name, key, path):
    lanes, max_len, ps = 3, 20, 8                # 20 slots: a ragged page
    tmpl = ttf.init_lm_caches(TCFG[name], 1, max_len)[key]
    ax = tkv._PAGED_KEYS[tkv._key_name(key)]
    tspec = tkv._LeafSpec(tuple(tmpl.shape), ax, ps, tmpl.dtype)
    jspec = jkv._LeafSpec(tuple(tmpl.shape), ax, ps, jnp.float32)
    n_pages = lanes * tspec.R * tspec.P + 5
    rng = np.random.default_rng(3)
    pt = rng.permutation(n_pages)[:lanes * tspec.R * tspec.P].reshape(
        lanes, tspec.R, tspec.P).astype(np.int32)
    pt[1] = tkv.FREE                              # lane 1 unmapped
    x = rng.standard_normal((lanes,) + tuple(tmpl.shape)).astype(np.float32)
    x *= rng.uniform(0.01, 30.0, size=x.shape[:-1] + (1,)).astype(np.float32)
    zero = [0] + [slice(None)] * (x.ndim - 1)
    zero[x.ndim + ax] = slice(0, 2)
    x[tuple(zero)] = 0.0                          # all-zero rows: scale 1e-6
    jp, js = jkv._quantize_leaf(
        jnp.zeros((n_pages, tspec.ps, tspec.T), jnp.int8),
        jnp.zeros((n_pages, tspec.ps), jnp.float16), jnp.asarray(pt),
        jnp.asarray(x), jspec, lanes)
    tp = torch.zeros((n_pages + 1, tspec.ps, tspec.T), dtype=torch.int8)
    ts = torch.zeros((n_pages + 1, tspec.ps), dtype=torch.float16)
    tkv._quantize_leaf(tp, ts, pt, torch.from_numpy(x), tspec, lanes)
    codes, want = tp[:-1].numpy().astype(int), np.asarray(jp).astype(int)
    step = np.abs(codes - want)
    assert step.max() <= 1 and (step > 0).mean() < 1e-3
    np.testing.assert_allclose(ts[:-1].numpy().astype(np.float32),
                               np.asarray(js).astype(np.float32), rtol=1e-6)
    # the dequantized leaf of the same pages, mapped lanes and unmapped
    jdense = jkv._dequantize_leaf(jp, js, jnp.asarray(pt), jspec, lanes)
    tdense = tkv._dequantize_leaf(
        torch.cat([torch.from_numpy(np.array(jp)), tp[-1:]]),
        torch.cat([torch.from_numpy(np.array(js)), ts[-1:]]), pt, tspec,
        lanes)
    np.testing.assert_array_equal(tdense.numpy(), np.asarray(jdense))
    assert not tdense[1].any()                    # unmapped reads zeros
    err = np.abs(tdense[0].numpy() - x[0]).max()
    assert err <= np.abs(x[0]).max() / 127 / 2 * 1.01


def test_paged_pool_roundtrip_idempotent_and_page_accounting():
    pool = PagedKVPool(TINY, lanes=2, max_len=16, page_slots=8, device=CPU)
    arena_free0 = {k: len(a._free) for k, a in pool.arenas.items()}
    assert pool.acquire() == 0 and pool.acquire() == 1
    gen = torch.Generator().manual_seed(5)
    noisy = {k: torch.randn(v.shape, generator=gen)
             if v.dtype.is_floating_point else v
             for k, v in pool.read().items()}
    pool.write(noisy)
    r1 = pool.read()
    pool.write(r1)
    r2 = pool.read()
    # quantize(dequantize(q)) is exact from the first write on
    for k in r1:
        assert torch.equal(r1[k], r2[k]), k
    occupied = pool.nbytes_in_use()
    assert occupied > 0
    pool.release(0)
    pool.release(1)
    assert {k: len(a._free) for k, a in pool.arenas.items()} == arena_free0
    assert sum(pool._mapped_pages().values()) == 0
    assert pool.nbytes_in_use() < occupied
    with pytest.raises(ValueError):
        pool.release(0)                           # double release


def test_arena_growth_keeps_page_ids():
    pool = PagedKVPool(TINY, lanes=2, max_len=64, page_slots=4, device=CPU)
    arena = next(iter(pool.arenas.values()))
    assert arena.capacity == tkv.GROW
    pool.acquire()
    before = {k: v.copy() for k, v in pool._tables.items() if v is not None}
    data = {k: torch.randn(v.shape) if v.dtype.is_floating_point else v
            for k, v in pool.read().items()}
    pool.write(data)
    first = pool.read()
    pool.acquire()                                # needs more pages: grows
    assert arena.capacity > tkv.GROW
    assert arena.storage.shape[0] == arena.capacity + 1
    for k, v in before.items():
        np.testing.assert_array_equal(pool._tables[k][0], v[0])
    again = pool.read()
    for k in first:
        assert torch.equal(again[k][0], first[k][0]), k


@pytest.mark.parametrize("name", ["tiny", "mla", "ssm", "hybrid"])
def test_pool_bytes_match_reference(name):
    lanes, max_len = 4, 24
    jd = jkv.KVPool(JCFG[name], lanes=lanes, max_len=max_len)
    td = KVPool(TCFG[name], lanes=lanes, max_len=max_len, device=CPU)
    assert td.nbytes() == jd.nbytes()
    jp = jkv.PagedKVPool(JCFG[name], lanes=lanes, max_len=max_len,
                         page_slots=8)
    tp = PagedKVPool(TCFG[name], lanes=lanes, max_len=max_len,
                     page_slots=8, device=CPU)
    for _ in range(3):
        assert tp.acquire() == jp.acquire()
    tp.release(1)
    jp.release(1)
    assert tp.nbytes_in_use() == jp.nbytes_in_use()
    assert tp._mapped_pages() == jp._mapped_pages()
    assert ({k: (a.capacity, a.pages_in_use) for k, a in tp.arenas.items()}
            == {k: (a.capacity, a.pages_in_use)
                for k, a in jp.arenas.items()})


def test_paged_int8_shrinks_kv_bytes_3p5x():
    lanes, max_len = 4, 64
    dense = KVPool(TINY, lanes=lanes, max_len=max_len, device=CPU)
    paged = PagedKVPool(TINY, lanes=lanes, max_len=max_len, page_slots=8,
                        device=CPU)
    for _ in range(lanes):
        paged.acquire()                           # fully occupied
    ratio = dense.nbytes() / paged.nbytes_in_use()
    assert ratio >= 3.5, f"paged int8 shrink {ratio:.2f}x < 3.5x"


def test_kv_pool_lane_accounting():
    pool = KVPool(TINY, lanes=2, max_len=8, device=CPU)
    assert pool.nbytes() > 0
    a, b = pool.acquire(), pool.acquire()
    assert (a, b) == (0, 1) and pool.free_lanes == 0
    with pytest.raises(IndexError):
        pool.acquire()
    pool.release(a)
    with pytest.raises(ValueError):
        pool.release(a)                           # double release
    assert pool.acquire() == a                    # lowest free lane first


def test_kv_pool_manager_follows_genealogy():
    class _Entry:
        def __init__(self, parent):
            self.parent = parent

    class _Reg:
        entries = {0: _Entry(None), 1: _Entry(0), 2: _Entry(1)}
        live = [0, 1]

        def live_ids(self):
            return list(self.live)

    reg = _Reg()
    mgr = KVPoolManager(TINY, lanes=2, max_len=8, device=CPU)
    mgr.get(0)
    mgr.get(1)
    assert mgr.created == 2
    reg.live = [0, 2]
    prewarmed, released = mgr.sync(reg)
    assert released == [1] and prewarmed == [2]
    assert sorted(mgr.pools) == [0, 2]
    assert (mgr.created, mgr.released) == (3, 1)
    assert mgr.sync(reg) == ([], [])


def test_pools_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (KVPool, PagedKVPool):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(TINY, lanes=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVPoolManager(TINY, lanes=1, max_len=8)


# -- drafts ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dense_win", "mla", "ssm", "hybrid",
                                  "qwen3-4b"])
def test_draft_truncation_matches_reference(name):
    jc, tc = JCFG[name], TCFG[name]
    jp = jax.jit(lambda k: jtf.init_lm(jc, k))(jax.random.PRNGKey(0))
    full = params_from_jax(jax.tree.map(np.asarray, jp))
    for d in range(1, tc.n_layers + 2):
        assert draft_depth(tc, d) == jdraft.draft_depth(jc, d)
        dj, dt = jdraft.draft_config(jc, d), draft_config(tc, d)
        assert dataclasses.asdict(dt) == dataclasses.asdict(dj)
        assert dt.layout() == tc.layout()[:dt.n_layers] and not dt.mtp
        want = params_from_jax(jax.tree.map(
            np.asarray, jdraft.truncate_lm_params(jc, dj, jp)))
        got = truncate_lm_params(tc, dt, full)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (d, k)
        # views of the target: no copy
        assert all(got[k].data_ptr() == full[k].data_ptr() for k in got)
        # the draft's names and shapes are a draft model's
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in ttf.init_lm(
                dt, torch.Generator().manual_seed(0),
                device="meta").items()}
    with pytest.raises(ValueError):
        draft_depth(tc, 0)


# -- admission control --------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_world():
    """A ``_world``-style registry of two TINY models (the init and a
    perturbed clone) with synthetic scores: devices 0-3 prefer model 0,
    4-7 model 1."""
    params = ttf.init_lm(TINY, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    reg = treg.ModelRegistry.create(params, m_cap=4, stacked=True)
    reg.clone(0, 1, {k: v + 0.02 * torch.randn(v.shape, generator=gen)
                     for k, v in params.items()})
    state = tscores.init_scores(8, 4, ell=2)
    state.active[:, 1] = True
    state.alive[1] = True
    accs = np.zeros((8, 4))
    accs[:4, 0], accs[:4, 1] = 0.9, 0.1
    accs[4:, 0], accs[4:, 1] = 0.1, 0.9
    return reg, tscores.push_accuracies(state, accs)


def test_admission_bounded_queue_rejects_overload(tiny_world):
    reg, state = tiny_world
    gw = ServeGateway(TINY, reg, lambda: state, max_len=64, lanes=1,
                      chunk=8, max_queue=1)
    rng = np.random.default_rng(6)
    gw.submit(0, rng.integers(0, 64, size=8), max_new=4)   # takes the lane
    gw.submit(0, rng.integers(0, 64, size=8), max_new=4)   # queues
    with pytest.raises(OverloadError):
        gw.submit(0, rng.integers(0, 64, size=8), max_new=4)
    assert gw.stats()["admission"]["rejected_overload"] == 1
    done = gw.drain()                             # queued work completes
    assert len(done) == 2 and all(len(r.tokens) == 4 for r in done)


def test_admission_token_bucket_rate_limits_per_device(tiny_world):
    reg, state = tiny_world
    clk = [0.0]
    gw = ServeGateway(TINY, reg, lambda: state, max_len=64, lanes=4,
                      chunk=8, rate_limit=10.0, rate_burst=20.0,
                      clock=lambda: clk[0])
    gw.submit(0, np.arange(8) % 64, max_new=4)       # cost 12 <= 20
    with pytest.raises(OverloadError):
        gw.submit(0, np.arange(8) % 64, max_new=4)   # 12 > 8 left
    assert gw.stats()["admission"]["rejected_rate"] == 1
    gw.submit(1, np.arange(8) % 64, max_new=4)       # independent budget
    clk[0] = 1.0                                     # refill 10 tokens
    gw.submit(0, np.arange(8) % 64, max_new=4)
    # an unroutable device drains no bucket (the rate check runs after
    # routing) and raises the plain rejection type
    with pytest.raises(RequestRejected):
        gw.submit(999, [1, 2], max_new=2)
    assert 999 not in gw._buckets
    gw.drain()


def test_gateway_rejects_oversized_unroutable_and_dict_banks(tiny_world):
    reg, state = tiny_world
    gw = ServeGateway(TINY, reg, lambda: state, max_len=16, lanes=2,
                      chunk=8, present_fn=lambda d: d != 3)
    with pytest.raises(RequestRejected):
        gw.submit(0, np.arange(12), max_new=8)        # 12 + 8 > max_len
    with pytest.raises(RequestRejected):
        gw.submit(3, [1, 2], max_new=2)               # departed device
    with pytest.raises(RequestRejected):
        gw.submit(999, [1, 2], max_new=2)             # unknown device
    with pytest.raises(ValueError):
        gw.submit(0, [], max_new=2)                   # empty prompt
    with pytest.raises(ValueError, match="stacked param bank"):
        ServeGateway(TINY, treg.ModelRegistry.create(
            reg.params[0], m_cap=2), lambda: state)
    with pytest.raises(ValueError, match="draft"):
        ServeGateway(TINY, reg, lambda: state, spec_k=2)
    with pytest.raises(ValueError, match="exceeds cache slots"):
        ServeGateway(TINY, reg, lambda: state, max_len=4, spec_k=4,
                     draft_layers=1)
