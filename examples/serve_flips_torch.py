"""Classify the greedy flips of the serving plane's bf16 modes (the
spec and paged gateways against vanilla) by the reference stream's
top-2 logit gap, on the PyTorch port.

It rebuilds ``chip_smoke.py``'s phase 18.2: Qwen3-4B at phase 14's tier
(12 of 36 layers, bf16, every width kept) trained by the LM trainer with
2-layer draft rows until two models are live, then 16 requests of
128-token prompts and 32 new tokens on 8 lanes in the vanilla, spec
(k=3) and paged int8 modes. Each gateway records the float32 logits
every emitted token was chosen from (admission prefill, decode step or
verify chunk). For each request, the first token where a mode's stream
leaves vanilla's is a flip; later tokens follow from another context and
are not classified. A flip is noise when vanilla's top-2 gap there is
below the bar: the largest logit difference between the two modes at
the tokens where the request's streams still agree (the same context).
A flip above the bar would be a fault.

  PYTHONPATH=src python examples/serve_flips_torch.py [--device cpu --reduced]

Runs on the card unless ``--device cpu`` is given; ``--reduced`` takes
the reduced config (a rehearsal on the CPU). Prints one line per mode
and a JSON line of every flip.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.func import vmap

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from repro_torch.config import FedCDConfig, override  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.federated.llm import FedLLMTrainer  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import ServeGateway  # noqa: E402
from repro_torch.serve.batcher import ModelGroup  # noqa: E402

MODES = (("vanilla", {}), ("spec", dict(spec_k=3)),
         ("paged", dict(paged=True, page_slots=8)))


class Recording(ServeGateway):
    """A gateway that keeps, for each request, the logits each of its
    tokens was chosen from (``req.logits``, float32 on the host)."""

    def _prefill(self, cfg, params, cache, part, nv, sample=True):
        logits, cache = tf.lm_prefill(cfg, params, self._upload(part[None]),
                                      cache, window=self.window, n_valid=nv,
                                      mesh=self.mesh)
        if not sample:
            return None, cache
        self.admitted = logits[0, nv - 1].float().cpu()
        return self._sample(logits[:, nv - 1], self._noise(1)), cache

    def _decode(self, params, stacked, toks):
        def one_lane(cache, tok):
            logits, nc = tf.lm_decode(self.cfg, params, tok[None, None],
                                      cache, window=self.window,
                                      mesh=self.mesh)
            return nc, logits[0, -1]

        new, logits = vmap(one_lane)(stacked, toks)
        self.decoded.append(logits.float().cpu())
        return new, self._sample(logits, None)

    def _verify(self, params, stacked, chunks):
        def one_lane(cache, chunk):
            S = chunk.shape[0]
            logits, full, states = tf.lm_prefill(
                self.cfg, params, chunk[None], cache, window=self.window,
                mesh=self.mesh, collect_states=True)
            out = torch.argmax(logits, dim=-1).to(torch.int32)
            ok = (chunk[None, 1:] == out[:, :-1]).to(torch.int32)
            nk = (1 + torch.min(torch.sum(torch.cumprod(ok, dim=1), dim=1))
                  ).to(torch.int32)
            cache = tf.lm_cache_rollback(self.cfg, cache, full, states, nk,
                                         S, self.window)
            return cache, out[0], nk, logits[0]

        cache, out, nk, logits = vmap(one_lane)(stacked, chunks)
        self.verified = logits.float().cpu()
        return cache, out, nk

    def step(self):
        active = [(m, dict(g.active)) for m, g in sorted(self.groups.items())
                  if g.active and not g.spec_k]
        before = {id(r): len(r.tokens) for g in self.groups.values()
                  for r in g.active.values()}
        self.decoded = []
        out = super().step()
        for (_, lanes), logits in zip(active, self.decoded):
            for lane, req in lanes.items():
                if len(req.tokens) > before[id(req)]:
                    req.logits.append(logits[lane])
        return out

    def _spec_step(self, group):
        lanes = dict(group.active)
        before = {lane: len(r.tokens) for lane, r in lanes.items()}
        out = super()._spec_step(group)
        for lane, req in lanes.items():
            for j in range(len(req.tokens) - before[lane]):
                req.logits.append(self.verified[lane, j])
        return out


def _admit_hook():
    """Record the admission's logits as each request's first."""
    real = ModelGroup.admit

    def admit(group, req, lane, first):
        req.logits = [CURRENT[0].admitted]
        return real(group, req, lane, first)

    ModelGroup.admit = admit


CURRENT = [None]


def classify(base, other):
    """(bar, flips): flips as (request, token index, vanilla's top-2 gap,
    vanilla's token, the mode's token)."""
    bar, flips = 0.0, []
    for i, (a, b) in enumerate(zip(base, other)):
        for t, (x, y) in enumerate(zip(a.tokens, b.tokens)):
            if x != y:
                top = torch.topk(a.logits[t], 2).values
                flips.append((i, t, float(top[0] - top[1]), x, y))
                break
            bar = max(bar, float((a.logits[t] - b.logits[t]).abs().max()))
    return bar, flips


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    device = resolve_device(args.device)
    arch = override(get_arch(cs.LM_ARCH), **cs.FULL_LM_CUT)
    n, prompt, new = cs.SERVE_FULL
    gw_kw = dict(cs.SERVE_FULL_GW)
    dims = (cs.FULL_LM_CLIENTS, cs.FULL_LM_PER, cs.FULL_LM_SEQ)
    if args.reduced:
        arch = reduced(get_arch(cs.LM_ARCH))
        n, prompt, new = 8, 12, 6
        gw_kw = dict(max_len=64, lanes=4, chunk=8)
        dims = (cs.FULL_LM_CLIENTS, 2, 16)
    t0 = time.perf_counter()
    init = tf.init_lm(arch, torch.Generator(device=device).manual_seed(0),
                      device=device)
    tr = FedLLMTrainer(arch, FedCDConfig(**cs.FULL_LM_FED), *dims, seed=0,
                       spec="llm", device=device, init_params=init,
                       draft_layers=cs.SERVE_DRAFT_LAYERS)
    for t in range(1, cs.FULL_LM_ROUNDS + 1):
        tr.run_round(t)
        if len(tr.registry.live_ids()) >= 2:
            break
    del init
    prompts = np.random.default_rng(0).integers(0, arch.vocab_size,
                                                (n, prompt))
    devices = [i % cs.FULL_LM_CLIENTS for i in range(n)]
    _admit_hook()
    runs = {}
    for mode, kw in MODES:
        if "spec_k" in kw:
            kw = dict(kw, draft=tr.draft)
        gw = Recording(arch, tr.registry, lambda: tr.state, **gw_kw, **kw)
        CURRENT[0] = gw
        reqs = [gw.submit(d, p, new) for d, p in zip(devices, prompts)]
        gw.drain()
        assert all(len(r.logits) == len(r.tokens) == new for r in reqs)
        runs[mode] = reqs
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True) \
        if device.type == "cuda" else None
    card = smi.stdout.strip() if smi is not None else "cpu"
    out = {}
    for mode in ("spec", "paged"):
        bar, flips = classify(runs["vanilla"], runs[mode])
        equal = cs.agreement(runs[mode], runs["vanilla"])
        above = [f for f in flips if f[2] > bar]
        print(f"[flips {mode}] {arch.name} {arch.n_layers} layers, "
              f"{arch.param_dtype}, live={tr.registry.live_ids()}: tokens "
              f"equal to vanilla's={equal:.4f}; {len(flips)} of {n} "
              f"requests flip; noise bar={bar}; gaps at the first flips="
              f"{sorted(round(f[2], 6) for f in flips)}; above the bar: "
              f"{len(above)} ({card})", flush=True)
        out[mode] = {"bar": bar, "equal": equal, "flips": flips,
                     "above": above}
    print(json.dumps(out))
    print(f"[flips] wall_s={time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
