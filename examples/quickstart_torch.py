"""Quickstart on the PyTorch/CUDA port: FedCD vs FedAvg on non-IID data
(the same run as ``examples/quickstart.py``, on ``src/repro_torch``).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.config import FedCDConfig
from repro_torch.core.fedavg import FedAvgServer
from repro_torch.core.fedcd import FedCDServer
from repro_torch.data.partition import hierarchical_devices, stack_devices
from repro_torch.models.mlp import (init_mlp_classifier, mlp_accuracy,
                                    mlp_loss)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args()
    # 30 devices, 10 label-archetypes in 2 meta-archetypes (paper §3.2)
    devices = hierarchical_devices(seed=0, n_train=128, n_val=64, n_test=64)
    data = stack_devices(devices)
    cfg = FedCDConfig(n_devices=30, devices_per_round=15, local_epochs=2,
                      milestones=(3, 8), late_delete_round=10, lr=0.08)
    params = init_mlp_classifier(torch.Generator().manual_seed(0),
                                 hidden=64)
    fedcd = FedCDServer(cfg, params, mlp_loss, mlp_accuracy, data,
                        batch_size=32, device=args.device)
    fedavg = FedAvgServer(cfg, params, mlp_loss, mlp_accuracy, data,
                          batch_size=32, device=args.device)
    print(f"{'round':>5} {'FedCD acc':>10} {'FedAvg acc':>10} "
          f"{'live models':>12}")
    for t in range(1, 16):
        m = fedcd.run_round(t)
        f = fedavg.run_round(t)
        print(f"{t:>5} {m.test_acc.mean():>10.3f} {f.test_acc.mean():>10.3f}"
              f" {m.live_models:>12}")
    gap = fedcd.metrics[-1].test_acc.mean() - fedavg.metrics[-1].test_acc.mean()
    print(f"\nFedCD - FedAvg final gap: {gap:+.3f} "
          f"(paper: FedCD higher + faster convergence)")


if __name__ == "__main__":
    main()
