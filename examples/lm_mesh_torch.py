"""The mode-B LM trainer on a tensor-parallel mesh of the PyTorch/CUDA
port, timed beside the same trainer on one card.

Builds ``--arch`` at every published width (``--layers`` cuts its depth;
``--reduced`` takes the reduced config), bf16 as registered, from seeded
random params, and runs ``--rounds`` rounds of ``FedLLMTrainer`` on the
``llm`` engine: first on one card (``--one-card``), then on a
``(--model, --data)`` launch mesh whose cells are the first ``model *
data`` cards. FedCD
runs on 8 clients x 2 sequences x 128 tokens, 4 a round, 4 bank rows, a
milestone clone at round 2 (``chip_smoke.py``'s full-width tier).

Per round it prints the wall (host clock, every card synchronized),
the train and eval steps' wall (the same clock around each step), the
trained models and the loss; per run the peak memory of each card.

  PYTHONPATH=src python examples/lm_mesh_torch.py --arch qwen3-4b \\
      --model 4 --one-card                    # four cards
  PYTHONPATH=src python examples/lm_mesh_torch.py --reduced --model 2 \\
      --data 2 --device cpu                   # rehearsal on the CPU
"""
import argparse
import subprocess
import time

import torch

from repro_torch.config import FedCDConfig, override
from repro_torch.configs import get_arch, reduced
from repro_torch.federated import simulation as sim
from repro_torch.federated.llm import FedLLMTrainer, make_acc_step
from repro_torch.launch import steps
from repro_torch.launch.mesh import dp_axes_of, make_launch_mesh
from repro_torch.models import transformer as tf

FED = dict(n_devices=8, devices_per_round=4, milestones=(2,), max_models=4,
           lr=0.01, late_delete_round=8)
DIMS = (8, 2, 128)                    # clients, per client, seq


def sync(devices):
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def timed_steps(tr, devices, clock):
    """Swap the trainer's steps for ones built as its own, each timed by
    the host clock with every card synchronized around it."""
    mesh = tr.mesh
    dp = ("data",) if mesh is None else dp_axes_of(mesh)

    def timed(fn, kind):
        def call(*args, **kw):
            sync(devices)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(devices)
            clock[kind] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    train = timed(steps.make_train_step(tr.arch, mesh, dp, lr=tr.fed.lr,
                                        remat=False), "train")
    acc = timed(make_acc_step(tr.arch, tr.n_clients, mesh, dp,
                              batch_size=tr.n_clients * tr.per_client),
                "eval")
    tr.executor._round = sim.make_llm_round(train, acc)
    tr.executor._eval = sim.make_llm_eval(acc)


def run(tag, arch, init, rounds, device=None, mesh=None):
    devices = mesh.devices if mesh is not None else [device]
    cards = sorted({torch.device(d).index or 0 for d in devices
                    if torch.device(d).type == "cuda"})
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    tr = FedLLMTrainer(arch, FedCDConfig(**FED), *DIMS, seed=0, spec="llm",
                       device=device, mesh=mesh, init_params=init)
    clock = {"train": 0.0, "eval": 0.0}
    timed_steps(tr, devices, clock)
    for t in range(1, rounds + 1):
        clock.update(train=0.0, eval=0.0)
        sync(devices)
        t0 = time.perf_counter()
        m = tr.run_round(t)
        sync(devices)
        wall = time.perf_counter() - t0
        step = clock["train"] / max(m.trained_models, 1)
        print(f"[{tag} round {t}] wall_s={wall:.4f} train_ms="
              f"{clock['train']:.3f} step_ms={step:.3f} eval_ms="
              f"{clock['eval']:.3f} trained_models={m.trained_models} "
              f"live={m.live_models} loss={m.mean_loss}", flush=True)
    peaks = {i: torch.cuda.max_memory_allocated(i) for i in cards}
    print(f"[{tag}] peak memory per card (GiB): "
          f"{ {i: round(p / 2**30, 2) for i, p in peaks.items()} }",
          flush=True)
    del tr
    if cards:
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: whole)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--one-card", action="store_true",
                    help="first run the same trainer on one card")
    ap.add_argument("--device", default=None,
                    help="cpu: every cell on the CPU (a rehearsal)")
    args = ap.parse_args()

    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    if args.layers:
        arch = override(arch, n_layers=args.layers)
    n = args.model * args.data
    if args.device == "cpu":
        home, cells = "cpu", ["cpu"] * n
    else:
        home, cells = "cuda:0", None
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True)
        print(smi.stdout.strip(), flush=True)
    init = tf.init_lm(arch, torch.Generator(device=home).manual_seed(0),
                      device=home)
    n_params = sum(v.numel() for v in init.values())
    init = {k: v.cpu() for k, v in init.items()}
    print(f"{arch.name}: {arch.n_layers}x{arch.d_model} vocab "
          f"{arch.vocab_size} {arch.param_dtype}, {n_params} params; "
          f"{DIMS[0]} clients x {DIMS[1]} x {DIMS[2]} tokens", flush=True)
    if args.one_card:
        run("one card", arch, init, args.rounds, device=home)
    mesh = make_launch_mesh(args.model, args.data, devices=cells)
    run(f"mesh model={args.model} data={args.data} "
        f"on {sorted({str(d) for d in mesh.devices})}", arch, init,
        args.rounds, mesh=mesh)


if __name__ == "__main__":
    main()
