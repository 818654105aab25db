"""Serving example on the PyTorch port (``examples/serve_decode.py``
through ``repro_torch``): chunked prefill + batched decode with KV /
recurrent-state caches for four architecture families, incl. a
sliding-window ring buffer.

  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.serve import chunked_prefill
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as tf


def serve(name: str, device: torch.device, window: int = 0, batch: int = 2,
          steps: int = 16, prompt: int = 12):
    cfg = reduced(get_arch(name))
    gen = torch.Generator(device=device).manual_seed(0)
    params = tf.init_lm(cfg, gen, device=device)
    caches = tf.init_lm_caches(cfg, batch, max_len=prompt + steps + 8,
                               window=window, device=device)
    prefill = make_prefill_step(cfg, window=window)
    step = make_serve_step(cfg, window=window)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=device)
    chunk = min(8, window) if window else 8
    logits, caches = chunked_prefill(prefill, params, caches, prompts, chunk)
    tok = torch.argmax(logits, dim=-1)[:, None]
    logits, caches = step(params, caches, tok)     # warm-up
    t0 = time.time()
    for _ in range(steps):
        logits, caches = step(params, caches, tok)
        tok = torch.argmax(logits, dim=-1)[:, None]
    logits.cpu()
    dt = time.time() - t0
    kind = ("ring-buffer KV" if window else
            "recurrent state" if cfg.family in ("ssm", "hybrid")
            else "full KV")
    print(f"{name:22s} [{kind:15s}] {batch * steps / dt:7.1f} tok/s")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="'cuda' (default) or "
                    "'cpu'")
    device = resolve_device(ap.parse_args().device)
    serve("qwen3-4b", device)                 # dense GQA, full KV cache
    serve("glm4-9b", device, window=8)        # sliding-window ring buffer
    serve("xlstm-125m", device)               # O(1) recurrent state
    serve("zamba2-7b", device)                # hybrid mamba2 + shared attn


if __name__ == "__main__":
    main()
