"""End-to-end federated LM training CLI (port of
``repro/launch/train.py``, with ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --reduced --rounds 50 --clients 8 --seq 128 [--device cpu]

Runs FedCD (mode B) over a population of global models of the selected
architecture, with archetype-conditioned synthetic token streams, score
bookkeeping, clone/delete milestones, and checkpointing. ``--reduced``
shrinks the architecture for single-host runs (full configs are traced
on the production meshes by ``repro_torch.launch.dryrun``, on meta
cells).

Elastic resume (DESIGN.md §13): ``--save-every N`` snapshots the
complete trainer state (params, registry, scores, RNG stream position,
metrics) under ``<out>/ckpts/step_*`` every N rounds — atomically, so a
kill mid-save never leaves a loadable torn checkpoint — and ``--resume
<dir>`` continues a preempted run from the latest valid step:

  python -m repro_torch.launch.train --rounds 50 --save-every 5
  # ...preempted at round 23...
  python -m repro_torch.launch.train --rounds 50 --save-every 5 \
      --resume experiments/train/ckpts

The run is on the card (``--device cuda``, the default) unless
``--device cpu`` is given. ``--reduced`` is declared as the reference
declares it (``store_true`` with ``default=True``), so the flag cannot
be turned off from the command line; full width is reached through
:class:`~repro_torch.federated.llm.FedLLMTrainer` itself.
"""
from __future__ import annotations

import argparse
import json
import os

from typing import List, Optional

from repro_torch.checkpoint import save_checkpoint, save_registry
from repro_torch.config import FedCDConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.core.spec import EngineSpec
from repro_torch.federated.llm import FedLLMTrainer


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--per-client", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--archetypes", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--milestones", default="5,15")
    ap.add_argument("--max-models", type=int, default=8)
    ap.add_argument("--out", default="experiments/train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="llm",
                    help="EngineSpec preset: 'llm' (stacked dispatch, "
                         "default), 'llm+pipeline' (input prefetch), or "
                         "'legacy' (per-model loop oracle)")
    ap.add_argument("--save-every", type=int, default=0, metavar="N",
                    help="snapshot full trainer state every N rounds "
                         "under <out>/ckpts (0 = off)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume from a checkpoint directory (or a "
                         "ckpts root — picks the latest valid step)")
    ap.add_argument("--device", default="cuda",
                    help="where the models live: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    fed = FedCDConfig(
        n_devices=args.clients, devices_per_round=max(args.clients // 2, 1),
        local_epochs=1, milestones=tuple(
            int(x) for x in args.milestones.split(",") if x),
        max_models=args.max_models, lr=args.lr, seed=args.seed,
        late_delete_round=max(args.rounds // 2, 8))

    # checkpoint cadence rides the EngineSpec (the trainer saves/resumes
    # internally — same elastic path as FedCDServer/FedAvgServer)
    base = EngineSpec.parse(args.engine)
    spec = EngineSpec(
        engine=base.engine, pipeline=base.pipeline,
        save_every=args.save_every,
        checkpoint_dir=(os.path.join(args.out, "ckpts")
                        if args.save_every else None),
        resume_from=args.resume)
    trainer = FedLLMTrainer(arch, fed, args.clients, args.per_client,
                            args.seq, args.archetypes, seed=args.seed,
                            spec=spec, device=args.device)
    if args.resume:
        print(f"resumed from round {len(trainer.metrics)} ({args.resume})")
    trainer.run(args.rounds, log_every=5)

    os.makedirs(args.out, exist_ok=True)
    for m in trainer.registry.live_ids():
        save_checkpoint(os.path.join(args.out, f"model_{m}"),
                        trainer.registry.params[m], step=args.rounds)
    save_registry(os.path.join(args.out, "registry.json"),
                  trainer.registry.to_json())
    hist = [{"round": m.round, "loss": m.mean_loss,
             "acc": float(m.client_acc.mean()), "live": m.live_models}
            for m in trainer.metrics]
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(hist, f, indent=2)
    print(f"done: {len(trainer.registry.live_ids())} live models, "
          f"final acc {trainer.metrics[-1].client_acc.mean():.3f}; "
          f"artifacts in {args.out}")


if __name__ == "__main__":
    main()
