"""FedCD driving a population of language models on the PyTorch/CUDA
port (the run of ``examples/federated_llm.py`` on ``src/repro_torch``):
clients with different token archetypes self-select into specialized LMs
via the paper's clone/delete mechanism (paper Fig 7).

  PYTHONPATH=src python examples/federated_llm_torch.py [--rounds 30] \
      [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.config import ArchConfig, FedCDConfig
from repro_torch.core.scores import normalized_scores
from repro_torch.federated.llm import FedLLMTrainer

TINY = ArchConfig(name="tiny-lm", n_layers=2, d_model=128, n_heads=4,
                  n_kv_heads=2, d_ff=256, vocab_size=256,
                  param_dtype="float32", compute_dtype="float32")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args()

    fed = FedCDConfig(n_devices=args.clients, devices_per_round=args.clients,
                      milestones=(6,), max_models=4, lr=0.35,
                      late_delete_round=18)
    trainer = FedLLMTrainer(TINY, fed, n_clients=args.clients, per_client=4,
                            seq=128, n_archetypes=2, device=args.device)
    trainer.run(args.rounds, log_every=2)

    m = trainer.metrics[-1]
    print(f"\nfinal: live_models={m.live_models} "
          f"mean client token-acc={m.client_acc.mean():.3f} "
          f"score_std={m.score_std:.3f}")
    # which model does each client prefer? (archetype = client % 2)
    c = normalized_scores(trainer.state)
    pref = np.argmax(np.where(trainer.state.active, c, -1), axis=1)
    print("client -> preferred model:", pref.tolist())
    print("archetypes               :",
          [i % 2 for i in range(args.clients)])
    a0 = {pref[i] for i in range(args.clients) if i % 2 == 0}
    a1 = {pref[i] for i in range(args.clients) if i % 2 == 1}
    if a0.isdisjoint(a1):
        print("==> clients fully segregated by archetype (paper Fig 7)")


if __name__ == "__main__":
    main()
