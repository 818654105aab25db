"""Batched serving driver (port of ``repro/launch/serve.py``, with
``--device``): chunked-prefill a prompt batch in one call per chunk, then
decode N tokens per request against KV/state caches (ring-buffer window
optional).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --batch 4 --prompt-len 64 --decode 32 [--device cpu]

Pass ``--no-reduced`` to run the full-size architecture (``--reduced`` is
a ``BooleanOptionalAction`` here, as in the reference); ``--spec-k K
--draft-layers D`` adds a greedy speculative pass (truncated-depth draft
proposes K tokens/step, the target verifies the whole chunk in one
prefill call) and checks it emits the identical token stream. The run
is on the card (the default) unless ``--device cpu`` is given. The
multi-model request path (routing, group-by-model continuous batching,
per-cluster drafts, paged int8 pools) lives in
``repro_torch.serve.gateway``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as tf
from repro_torch.serve.draft import draft_config, truncate_lm_params


def chunked_prefill(prefill, params, caches, prompts: torch.Tensor,
                    chunk: int):
    """Drive a ``make_prefill_step`` step over a (B, P) prompt batch in
    fixed-shape chunks (ragged tail padded + masked via n_valid).
    Returns (last-token logits (B, V), caches)."""
    P = prompts.shape[1]
    logits = None
    for s in range(0, P, chunk):
        part = prompts[:, s:s + chunk]
        nv = part.shape[1]
        if nv < chunk:
            part = torch.nn.functional.pad(part, (0, chunk - nv))
        logits, caches = prefill(params, caches, part, nv)
    return logits, caches


@torch.no_grad()
def spec_decode(cfg, params, caches, dcfg, dparams, dcaches,
                first_tok: torch.Tensor, decode: int, k: int,
                window: int = 0):
    """Greedy speculative loop over a (B,) batch: draft proposes ``k``
    tokens per lane, the target verifies the [cur, d_1..d_k] chunk in
    ONE prefill call, and the batch advances by the MINIMUM lane
    acceptance (``lm_spec_verify``'s shared n_keep — the single-model
    driver's simplification; the gateway vmaps per lane). Reads each
    round's n_keep on the host. Returns the (B, >=decode) emitted token
    matrix plus (proposed, accepted)."""
    B = first_tok.shape[0]
    prev = torch.zeros((B, k + 1), dtype=torch.long,
                       device=first_tok.device)
    keep = torch.zeros((), dtype=torch.int32, device=first_tok.device)
    cur = first_tok
    emitted, proposed, accepted = [], 0, 0
    n_out = 0
    while n_out < decode:
        props, dcaches = tf.lm_spec_propose(dcfg, dparams, prev, keep, cur,
                                            k, dcaches, window=window)
        chunk = torch.cat([cur, props.long()], dim=1)
        out, nk, caches = tf.lm_spec_verify(cfg, params, chunk, props,
                                            caches, window=window)
        nk_h = int(nk)
        proposed += k
        accepted += nk_h - 1
        emitted.append(out[:, :nk_h].cpu().numpy())
        n_out += nk_h
        prev, keep = chunk, nk
        cur = out[:, nk_h - 1][:, None].long()
    return np.concatenate(emitted, axis=1), proposed, accepted


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the architecture (--no-reduced for full)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk length (one call per chunk)")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative tokens per step (0 = off)")
    ap.add_argument("--draft-layers", type=int, default=1,
                    help="draft depth for --spec-k (truncated target)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family == "audio":
        raise ValueError("use whisper driver paths in examples/")
    chunk = min(args.chunk, args.window) if args.window else args.chunk
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_lm(cfg, gen, device=device)
    max_len = args.prompt_len + args.decode
    caches = tf.init_lm_caches(cfg, args.batch, max_len, window=args.window,
                               device=device)
    prefill = make_prefill_step(cfg, window=args.window)
    step = make_serve_step(cfg, window=args.window)

    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device)
    t0 = time.time()
    logits, caches = chunked_prefill(prefill, params, caches, prompts, chunk)
    logits.cpu()
    prefill_s = time.time() - t0
    logits0 = logits

    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    t0 = time.time()
    for _ in range(args.decode):
        logits, caches = step(params, caches, tok)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    logits.cpu()
    decode_s = time.time() - t0
    toks = args.batch * args.decode
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"decode={args.decode} chunk={chunk} window={args.window} "
          f"device={device}")
    print(f"prefill: {prefill_s:.2f}s  decode: {decode_s:.2f}s "
          f"({toks / max(decode_s, 1e-9):.1f} tok/s)")
    seq = torch.cat(out, dim=1).cpu().numpy()
    print("sample token ids:", seq[0][:16].tolist())

    if args.spec_k:
        k = args.spec_k
        dcfg = draft_config(cfg, args.draft_layers)
        dparams = truncate_lm_params(cfg, dcfg, params)
        # headroom: each verify round writes a full k+1 chunk, so the
        # last round may run past prompt+decode
        scaches = tf.init_lm_caches(cfg, args.batch, max_len + k + 1,
                                    window=args.window, device=device)
        dcaches = tf.init_lm_caches(dcfg, args.batch, max_len + k + 1,
                                    window=args.window, device=device)
        _, scaches = chunked_prefill(prefill, params, scaches, prompts,
                                     chunk)
        dprefill = make_prefill_step(dcfg, window=args.window)
        _, dcaches = chunked_prefill(dprefill, dparams, dcaches, prompts,
                                     chunk)
        first = torch.argmax(logits0, dim=-1)[:, None]
        t0 = time.time()
        spec, proposed, accepted = spec_decode(
            cfg, params, scaches, dcfg, dparams, dcaches, first,
            args.decode, k, window=args.window)
        spec_s = time.time() - t0
        spec_seq = np.concatenate([first.cpu().numpy(), spec], axis=1)
        match = bool(np.array_equal(spec_seq[:, :args.decode + 1], seq))
        rate = accepted / max(proposed, 1)
        print(f"spec: k={k} draft_layers={dcfg.n_layers} "
              f"{spec_s:.2f}s ({toks / max(spec_s, 1e-9):.1f} tok/s) "
              f"acceptance={rate:.3f} match_vanilla={match}")
        if not match:
            raise SystemExit("speculative stream diverged from vanilla")


if __name__ == "__main__":
    main()
