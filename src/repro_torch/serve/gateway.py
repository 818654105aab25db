"""Personalized serving gateway (port of ``repro/serve/gateway.py``;
DESIGN.md §15): route each device's request to its cluster's preferred
model, decode same-model requests as ONE grouped dispatch against the
device-resident bank row, back every live model with a per-model KV
pool.

Three pieces:

* :class:`RoutingTable` — device → preferred-model map derived from the
  score state (``argmax(where(active, c, -1))``), cached and invalidated
  on the ``(bank.version, live_ids)`` epoch so clone/delete/migrate
  events re-route correctly. The bank version counter alone is NOT
  enough: deletions don't bump it (``pop`` is a mask flip), so liveness
  joins the epoch explicitly; training writes (the LM engine's in-place
  steps, :meth:`~repro_torch.core.registry.StackedParamBank.swap`) bump
  neither, so a training round re-routes nothing.
* :class:`ServeGateway` — admission (chunked prefill at batch 1 into a
  fresh lane cache, one copy into the lane), steady state (one
  ``torch.func.vmap`` of ``lm_decode`` over the pool's lane axis per
  model group per token, params closed over — the lanes share the bank
  row, read as views ``bank.tree[k][row]`` with the host ``row_of``, no
  gather and no copy), and sampling (argmax, ties to the first index as
  ``jnp.argmax``; or top-k) done on the device, so the host sees one
  token readback per group per step and one first-token read per
  admission.
* per-model KV pools (``serve.kv_pool``) allocated lazily on first
  routed request, released on delete, pre-warmed for clones via the
  registry genealogy; a released pool's in-flight requests re-route and
  re-prefill their full context on the successor model.

Three layers on top (DESIGN.md §16):

* speculative decoding (``spec_k``): each model group carries a
  cluster-shared truncated-depth draft (``serve.draft.DraftBank``, rows
  mirroring the target bank's layout) that proposes k tokens per lane
  per round in one vmapped commit+propose dispatch; the target verifies
  every lane's k+1-token chunk in ONE vmapped chunked prefill with
  accept counting and cache rollback on the device. Greedy spec decode
  is bit-identical to vanilla greedy decode.
* paged int8 KV pools (``paged=True``): ring-slot cache leaves live in
  shared per-family page arenas as int8 rows + f16 scales; draft and
  target pools draw from the same arenas.
* admission control: bounded gateway queue (``max_queue``) and a per-
  device token bucket (``rate_limit`` tokens/sec, ``rate_burst``
  capacity) in ``submit``, rejecting with :class:`OverloadError`.

Random draws: ``torch.func.vmap`` refuses random operations, so top-k
sampling draws its Gumbel noise outside the vmapped call from the
gateway's own ``torch.Generator`` (seeded by ``seed``, on the bank's
device) and passes it in. Top-k streams therefore differ from the
reference's (threefry against Philox); greedy streams are equal.

The gateway and its pools live on the bank's device. A bank on a
tensor-parallel mesh (``FedLLMTrainer(mesh=...)``: :class:`Sharded`
leaves) is served on that mesh: every prefill, decode, draft and verify
dispatch passes the bank's mesh to the decode path, which cuts each
cell's share of a lane's cache from the pool and returns it whole. The
pools and page arenas stay on cell ``(0, 0)``, the bank's first device
(one card: the cut is views; distinct cards: copies each step).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.config import ArchConfig
from repro_torch.core.registry import StackedParamBank
from repro_torch.core.scores import normalized_scores
from repro_torch.federated.simulation import to_device
from repro_torch.launch.tensor_parallel import Sharded
from repro_torch.models import transformer as tf
from repro_torch.models.common import Params
from repro_torch.serve.batcher import ModelGroup, Request
from repro_torch.serve.draft import DraftBank
from repro_torch.serve.kv_pool import KVPoolManager


class RequestRejected(Exception):
    """The gateway cannot serve this request (unknown/departed device,
    no live preferred model, or capacity exceeded)."""


class OverloadError(RequestRejected):
    """Admission control rejected the request: the gateway queue is at
    capacity or the device exceeded its token-rate budget. Transient —
    the client should back off and retry."""


class RoutingTable:
    """Cached device → preferred-model routing (module docstring).

    ``state_fn`` returns the live :class:`~repro_torch.core.scores.
    ScoreState`; ``present_fn(device) -> bool`` (optional) gates departed
    devices.
    """

    def __init__(self, registry: Any, state_fn: Callable[[], Any],
                 present_fn: Optional[Callable[[int], bool]] = None):
        self.registry = registry
        self.state_fn = state_fn
        self.present_fn = present_fn
        self._table: Optional[np.ndarray] = None
        self._epoch: Optional[Tuple] = None
        self.hits = 0
        self.rebuilds = 0
        self.invalidations = 0

    def epoch(self) -> Tuple:
        """(bank row-write version, live model ids): changes on clone
        (row write), migrate (row move), restore, AND delete (liveness),
        covering every event that can re-route a device."""
        version = getattr(self.registry.params, "version", None)
        return (version, tuple(self.registry.live_ids()))

    def resolve(self, device: int) -> int:
        """The model id serving ``device``, re-deriving the table when
        the epoch moved. Raises :class:`RequestRejected` for departed
        devices and devices with no live active model."""
        if self.present_fn is not None and not self.present_fn(device):
            raise RequestRejected(f"device {device} is not present")
        ep = self.epoch()
        if self._table is None or ep != self._epoch:
            if self._table is not None:
                self.invalidations += 1
            self._rebuild(ep)
        else:
            self.hits += 1
        if not 0 <= device < len(self._table):
            raise RequestRejected(f"unknown device id {device}")
        m = int(self._table[device])
        if m < 0:
            raise RequestRejected(
                f"device {device} holds no live active model")
        return m

    def invalidate(self) -> None:
        """Drop the cached table. The epoch only tracks lifecycle events
        (clone/delete/migrate); call this when the SCORES moved under an
        unchanged population (e.g. between trainer rounds) so routing
        picks up drifted preferences."""
        self._table = None

    def _rebuild(self, ep: Tuple) -> None:
        state = self.state_fn()
        c = normalized_scores(state)
        live = np.zeros(state.m_cap, bool)
        live[list(ep[1])] = True
        masked = np.where(state.active & live[None, :], c, -1.0)
        pref = np.argmax(masked, axis=1)
        pref[masked.max(axis=1) < 0.0] = -1
        self._table = pref
        self._epoch = ep
        self.rebuilds += 1


def _rows(tree: Params, row: int) -> Params:
    # a bank row as views: every dispatch of a group reads the same row
    return {k: v[row] for k, v in tree.items()}


class ServeGateway:
    """Group-by-model continuous-batching gateway over a stacked LM bank
    (module docstring).

    ``registry.params`` must be a :class:`StackedParamBank` (the LM
    engine's per-layer-stacked bank — ``FedLLMTrainer`` with
    ``engine="llm"``); ``state_fn`` supplies the score state the routing
    derives from (e.g. ``lambda: trainer.state``).
    """

    def __init__(self, cfg: ArchConfig, registry: Any,
                 state_fn: Callable[[], Any], *, max_len: int = 128,
                 lanes: int = 8, chunk: int = 16, window: int = 0,
                 eos_id: Optional[int] = None, top_k: int = 0,
                 seed: int = 0,
                 present_fn: Optional[Callable[[int], bool]] = None,
                 spec_k: int = 0, draft: Optional[DraftBank] = None,
                 draft_layers: int = 0, paged: bool = False,
                 page_slots: int = 8, max_queue: int = 0,
                 rate_limit: float = 0.0, rate_burst: float = 0.0,
                 clock: Optional[Callable[[], float]] = None):
        if not isinstance(registry.params, StackedParamBank):
            raise ValueError(
                "ServeGateway needs a stacked param bank "
                "(ModelRegistry.create(..., stacked=True))")
        leaf = next(iter(registry.params.tree.values()))
        # a tensor-parallel bank is served on its mesh (module docstring)
        self.mesh = leaf.mesh if isinstance(leaf, Sharded) else None
        self.cfg = cfg
        self.registry = registry
        self.device = registry.params.devices[0]
        self.window = window
        self.chunk = min(chunk, window) if window else chunk
        self.max_len = max_len
        self.eos_id = eos_id
        self.routing = RoutingTable(registry, state_fn, present_fn)
        self.paged = paged
        self.pools = KVPoolManager(cfg, lanes, max_len, window=window,
                                   paged=paged, page_slots=page_slots,
                                   device=self.device)
        self.groups: Dict[int, ModelGroup] = {}
        self._top_k = top_k
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_rid = 0
        self.dispatches = 0          # decode dispatches (all groups)
        self.tokens_out = 0          # generated tokens (incl. prefill's)
        # -- speculative decoding (DESIGN.md §16) --------------------------
        if spec_k:
            lim = min(max_len, window) if window else max_len
            if spec_k + 1 > lim:
                raise ValueError(
                    f"spec_k {spec_k} + 1 exceeds cache slots {lim}")
            if draft is None:
                if not draft_layers:
                    raise ValueError("spec_k needs a DraftBank: pass "
                                     "draft= or draft_layers=")
                draft = DraftBank(cfg, draft_layers, registry.m_cap,
                                  _rows(registry.params.tree, 0))
                draft.refresh(registry)
        self.spec_k = spec_k
        self.draft = draft if spec_k else None
        self.draft_pools: Optional[KVPoolManager] = None
        self.spec_rounds = 0
        if spec_k:
            # draft pools draw from the SAME page arenas as the target's
            # ("one arena per model family"), so a request's draft +
            # target caches pack together
            self.draft_pools = KVPoolManager(
                self.draft.dcfg, lanes, max_len, window=window,
                paged=paged, page_slots=page_slots,
                arenas=self.pools.arenas if paged else None,
                device=self.device)
        # -- admission control ---------------------------------------------
        self.max_queue = max_queue            # 0 = unbounded
        self.rate_limit = float(rate_limit)   # tokens/sec/device; 0 = off
        self.rate_burst = (float(rate_burst) if rate_burst
                           else 2.0 * float(rate_limit))
        self._clock = clock if clock is not None else time.monotonic
        self._buckets: Dict[int, Tuple[float, float]] = {}
        self.rejected_overload = 0
        self.rejected_rate = 0

    # -- device-side pieces ------------------------------------------------
    def _noise(self, *shape: int) -> Optional[torch.Tensor]:
        """Gumbel noise for top-k sampling, ``shape + (top_k,)``, from the
        gateway's generator (``None`` for greedy decoding)."""
        if not self._top_k:
            return None
        u = torch.rand(shape + (self._top_k,), generator=self._gen,
                       device=self.device)
        return -torch.log(-torch.log(u))

    def _sample(self, logits: torch.Tensor,
                noise: Optional[torch.Tensor]) -> torch.Tensor:
        """(..., V) logits -> (...) int32 tokens: argmax (ties to the
        first index), or a categorical draw over the top-k logits (a
        stable descending sort: ties keep the lower token id first) with
        the given Gumbel noise."""
        if noise is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :self._top_k], idx[..., :self._top_k]
        choice = torch.argmax(vals + noise, dim=-1, keepdim=True)
        return torch.gather(idx, -1, choice)[..., 0].to(torch.int32)

    def _upload(self, a: Any, dtype=np.int64) -> torch.Tensor:
        # a copy: the host arrays change while a dispatch may read them
        return to_device(np.array(a, dtype), dtype, self.device)

    def _prefill(self, cfg: ArchConfig, params: Params, cache: Params,
                 part: np.ndarray, nv: int,
                 sample: bool = True) -> Tuple[Optional[torch.Tensor],
                                               Params]:
        logits, cache = tf.lm_prefill(cfg, params,
                                      self._upload(part[None]), cache,
                                      window=self.window, n_valid=nv,
                                      mesh=self.mesh)
        if not sample:
            return None, cache
        return self._sample(logits[:, nv - 1], self._noise(1)), cache

    def _decode(self, params: Params, stacked: Params, toks: torch.Tensor
                ) -> Tuple[Params, torch.Tensor]:
        def one_lane(cache, tok):
            logits, nc = tf.lm_decode(self.cfg, params, tok[None, None],
                                      cache, window=self.window,
                                      mesh=self.mesh)
            return nc, logits[0, -1]

        # params enter by closure (vmap in_dims=None): every lane shares
        # the row, so the products stay batched over lanes
        new_stacked, logits = vmap(one_lane)(stacked, toks)
        return new_stacked, self._sample(logits, self._noise(toks.shape[0]))

    @staticmethod
    def _insert(stacked: Params, single: Params, lane: int) -> Params:
        # out of place: a vmapped dispatch may return a leaf it did not
        # batch as an expanded view, which takes no write
        out = {}
        for k, v in stacked.items():
            out[k] = v.clone()
            out[k][lane] = single[k]
        return out

    def _draft_propose(self, dparams: Params, dstacked: Params,
                       prev_chunks: torch.Tensor, prev_keeps: torch.Tensor,
                       cur_toks: torch.Tensor) -> Tuple[Params, torch.Tensor]:
        """Fused draft round: commit the previous chunk's accepted
        prefix (n_valid=prev_keep; 0 is a no-op) then greedily propose
        k tokens per lane. One dispatch for the whole group."""
        def one_lane(cache, prev, pk, cur):
            props, cache = tf.lm_spec_propose(
                self.draft.dcfg, dparams, prev[None], pk, cur[None, None],
                self.spec_k, cache, window=self.window, mesh=self.mesh)
            return cache, props[0]

        return vmap(one_lane)(dstacked, prev_chunks, prev_keeps, cur_toks)

    def _verify(self, params: Params, stacked: Params, chunks: torch.Tensor
                ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
        """Grouped verify: every lane's (k+1)-token chunk through ONE
        vmapped chunked prefill; per-lane accept count + cache rollback
        of the rejected suffix, on the device."""
        def one_lane(cache, chunk, noise):
            sf = None if noise is None else \
                (lambda lg: self._sample(lg, noise[None]))
            out, nk, cache = tf.lm_spec_verify(
                self.cfg, params, chunk[None], chunk[None, 1:], cache,
                window=self.window, sample_fn=sf, mesh=self.mesh)
            return cache, out[0], nk

        noise = self._noise(chunks.shape[0], self.spec_k + 1)
        if noise is None:
            return vmap(lambda c, ch: one_lane(c, ch, None))(stacked, chunks)
        return vmap(one_lane)(stacked, chunks, noise)

    # -- request path ------------------------------------------------------
    def submit(self, device: int, prompt: Any, max_new: int) -> Request:
        """Route + enqueue one request; admits immediately when the
        target group has a free lane. Raises :class:`RequestRejected`
        when the device cannot be served."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if not self.window and prompt.size + max_new > self.max_len:
            raise RequestRejected(
                f"prompt {prompt.size} + max_new {max_new} exceeds "
                f"max_len {self.max_len} (no ring window)")
        if self.max_queue:
            queued = sum(len(g.queue) for g in self.groups.values())
            if queued >= self.max_queue:
                self.rejected_overload += 1
                raise OverloadError(
                    f"gateway queue full ({queued} >= {self.max_queue})")
        model = self.routing.resolve(device)
        if self.rate_limit:
            # token bucket per device: a request costs its whole token
            # footprint (prompt + decode budget) up front
            cost = float(prompt.size + max_new)
            now = self._clock()
            avail, last = self._buckets.get(device, (self.rate_burst, None))
            if last is not None:
                avail = min(self.rate_burst,
                            avail + (now - last) * self.rate_limit)
            if cost > avail:
                self._buckets[device] = (avail, now)
                self.rejected_rate += 1
                raise OverloadError(
                    f"device {device} over token-rate limit: cost "
                    f"{cost:.0f} > {avail:.1f} available")
            self._buckets[device] = (avail - cost, now)
        req = Request(rid=self._next_rid, device=device, prompt=prompt,
                      max_new=max_new, submit_t=time.perf_counter())
        self._next_rid += 1
        self._enqueue(req, model)
        return req

    def _enqueue(self, req: Request, model: int) -> None:
        group = self.groups.get(model)
        if group is None:
            draft_pool, k = None, 0
            if self.spec_k and model in self.draft.present:
                draft_pool = self.draft_pools.get(model)
                k = self.spec_k
            group = ModelGroup(model, self.pools.get(model),
                               draft_pool=draft_pool, spec_k=k)
            self.groups[model] = group
        group.queue.append(req)
        self._admit(group)

    def _context(self, req: Request) -> np.ndarray:
        """The token context a (re-)admission prefills: the prompt plus
        anything already generated (re-routes continue the stream)."""
        if not req.tokens:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])

    @torch.no_grad()
    def _admit(self, group: ModelGroup) -> List[Request]:
        """Fill free lanes from the queue: chunked prefill at batch 1
        into a fresh cache, one lane copy, first token recorded. In spec
        mode the draft cache prefills the same context and lands in the
        lockstep draft-pool lane."""
        finished: List[Request] = []
        if not (group.queue and group.pool.free_lanes):
            return finished
        row = self.registry.params.row_of[group.model]
        params = _rows(self.registry.params.tree, row)
        dparams = (self.draft.row_params(row)
                   if group.draft_pool is not None else None)
        stacked = group.pool.read()
        dstacked = (group.draft_pool.read() if group.draft_pool is not None
                    else None)
        while group.queue and group.pool.free_lanes:
            req = group.queue.popleft()
            ctx = self._context(req)
            cache = group.pool.template
            dcache = (group.draft_pool.template
                      if group.draft_pool is not None else None)
            tok = None
            for s in range(0, ctx.size, self.chunk):
                part = ctx[s:s + self.chunk]
                nv = part.size
                if nv < self.chunk:
                    part = np.pad(part, (0, self.chunk - nv))
                tok, cache = self._prefill(self.cfg, params, cache, part, nv)
                self.dispatches += 1
                if dcache is not None:
                    _, dcache = self._prefill(self.draft.dcfg, dparams,
                                              dcache, part, nv, sample=False)
                    self.dispatches += 1
            lane = group.pool.acquire()
            stacked = self._insert(stacked, cache, lane)
            if dcache is not None:
                dlane = group.draft_pool.acquire()
                assert dlane == lane, "draft/target lane desync"
                dstacked = self._insert(dstacked, dcache, dlane)
            first = int(tok[0])               # the admission's one read
            group.admit(req, lane, first)
            self.tokens_out += 1
            if len(req.tokens) >= req.max_new or first == self.eos_id:
                finished.append(group.finish(lane))
        group.pool.write(stacked)
        if dstacked is not None:
            group.draft_pool.write(dstacked)
        return finished

    @torch.no_grad()
    def step(self) -> List[Request]:
        """One decode token for EVERY model group with live lanes: one
        dispatch per group, one (lanes,) readback, finished requests
        free their lanes and queued requests back-fill mid-stream."""
        finished: List[Request] = []
        bank = self.registry.params
        for model in sorted(self.groups):
            group = self.groups[model]
            if not group.active:
                if group.queue:
                    finished.extend(self._admit(group))
                continue
            if group.spec_k:
                finished.extend(self._spec_step(group))
                finished.extend(self._admit(group))
                continue
            params = _rows(bank.tree, bank.row_of[model])
            work, nxt = self._decode(params, group.pool.read(),
                                     self._upload(group.cur_tok))
            group.pool.write(work)
            self.dispatches += 1
            group.steps += 1
            group.lane_steps += len(group.active)
            nxt_host = nxt.cpu().numpy()
            for lane in sorted(group.active):
                req = group.active[lane]
                t = int(nxt_host[lane])
                req.tokens.append(t)
                self.tokens_out += 1
                if len(req.tokens) >= req.max_new or t == self.eos_id:
                    finished.append(group.finish(lane))
                else:
                    group.cur_tok[lane] = t
            finished.extend(self._admit(group))
        return finished

    def _spec_step(self, group: ModelGroup) -> List[Request]:
        """One speculative round for a group: ONE draft dispatch
        (commit previous accepted prefix + propose k per lane) and ONE
        target dispatch (verify all k via chunked prefill + rollback),
        emitting 1..k+1 tokens per lane. The proposals, outputs and
        accept counts come back in one readback."""
        finished: List[Request] = []
        bank = self.registry.params
        row = bank.row_of[group.model]
        k = group.spec_k
        cur = self._upload(group.cur_tok)
        dwork, props = self._draft_propose(
            self.draft.row_params(row), group.draft_pool.read(),
            self._upload(group.prev_chunk),
            self._upload(group.prev_keep, np.int32), cur)
        group.draft_pool.write(dwork)
        chunks = torch.cat([cur[:, None], props.long()], dim=1)
        work, outs, nks = self._verify(_rows(bank.tree, row),
                                       group.pool.read(), chunks)
        group.pool.write(work)
        self.dispatches += 2
        self.spec_rounds += 1
        group.steps += 1
        group.lane_steps += len(group.active)
        host = torch.cat([chunks, outs.long(), nks.long()[:, None]],
                         dim=1).cpu().numpy()
        chunks_h, outs_h, nks_h = (host[:, :k + 1], host[:, k + 1:-1],
                                   host[:, -1])
        for lane in sorted(group.active):
            req = group.active[lane]
            nk = int(nks_h[lane])
            group.spec_proposed += k
            group.spec_accepted += nk - 1
            group.prev_chunk[lane] = chunks_h[lane]
            group.prev_keep[lane] = nk
            done = False
            for t in outs_h[lane, :nk]:
                t = int(t)
                req.tokens.append(t)
                self.tokens_out += 1
                if len(req.tokens) >= req.max_new or t == self.eos_id:
                    finished.append(group.finish(lane))  # resets prev_keep
                    done = True
                    break
                group.cur_tok[lane] = t
            if not done:
                group.cur_tok[lane] = int(req.tokens[-1])
        return finished

    def drain(self, max_steps: int = 10_000) -> List[Request]:
        """Step until no group holds work. Returns finished requests in
        completion order."""
        finished: List[Request] = []
        for _ in range(max_steps):
            if not any(g.has_work() for g in self.groups.values()):
                return finished
            finished.extend(self.step())
        raise RuntimeError(f"drain exceeded {max_steps} steps")

    # -- lifecycle sync ----------------------------------------------------
    def sync(self) -> Dict[str, List]:
        """Reconcile with the registry after clone/delete/migrate (call
        between trainer rounds). Dead models' pools release and their
        in-flight requests re-route (re-prefilling full context on the
        successor model, counted in ``Request.rerouted``); requests whose
        device no longer maps to any live model fail cleanly."""
        self.routing.invalidate()     # scores moved since last round
        if self.draft is not None:
            # drafts are population state: re-truncate live models'
            # rows (clones pre-warm — their row is the parent's weights
            # until divergence), drop deleted models' drafts
            self.draft.refresh(self.registry)
        prewarmed, released = self.pools.sync(self.registry)
        if self.draft_pools is not None:
            self.draft_pools.sync(self.registry)
        orphans: List[Request] = []
        for m in released:
            group = self.groups.pop(m, None)
            if group is not None:
                orphans.extend(group.evict_all())
        failed = []
        for req in orphans:
            req.rerouted += 1
            try:
                model = self.routing.resolve(req.device)
            except RequestRejected as e:
                req.failed = str(e)
                failed.append(req)
                continue
            self._enqueue(req, model)
        return {"prewarmed": prewarmed, "released": released,
                "rerouted": [r.rid for r in orphans if not r.failed],
                "failed": [r.rid for r in failed]}

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        pools: Dict[str, Any] = {
            "live": len(self.pools.pools),
            "created": self.pools.created,
            "released": self.pools.released,
            # reserved: dense pools / whole shared arenas (draft pages
            # included when spec+paged — the arenas are shared);
            # in_use: bytes mapped by occupied lanes only
            "bytes": self.pools.nbytes(),
            "bytes_in_use": self.pools.nbytes_in_use()}
        if self.paged:
            pools["pages"] = self.pools.page_stats()
        out: Dict[str, Any] = {
            "dispatches": self.dispatches,
            "tokens_out": self.tokens_out,
            "routing": {"hits": self.routing.hits,
                        "rebuilds": self.routing.rebuilds,
                        "invalidations": self.routing.invalidations},
            "pools": pools,
            "admission": {"rejected_overload": self.rejected_overload,
                          "rejected_rate": self.rejected_rate},
            "batching_efficiency": {
                m: round(g.batching_efficiency(), 4)
                for m, g in self.groups.items()},
        }
        if self.spec_k:
            proposed = sum(g.spec_proposed for g in self.groups.values())
            accepted = sum(g.spec_accepted for g in self.groups.values())
            out["spec"] = {
                "k": self.spec_k,
                "rounds": self.spec_rounds,
                "proposed": proposed,
                "accepted": accepted,
                "acceptance_rate": (accepted / proposed if proposed
                                    else 0.0),
                "draft_layers": self.draft.dcfg.n_layers,
                "draft_models": len(self.draft.present),
                "draft_bytes": self.draft.nbytes(),
                "draft_pool_bytes_in_use":
                    self.draft_pools.nbytes_in_use()}
        return out
