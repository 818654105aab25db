"""The paper's own experimental config (port of
``repro/configs/fedcd_cifar.py``): 10-layer CNN on CIFAR-shaped data,
30 devices, 15 per round, milestones {5,15,25,30} (paper §3.1-3.2);
plus the Dirichlet(α) non-IID scenario with its α sweep."""
from repro_torch.config import FedCDConfig

HIERARCHICAL = FedCDConfig(
    n_devices=30, devices_per_round=15, local_epochs=2, score_window=3,
    milestones=(5, 15, 25, 30), late_delete_round=20,
    late_delete_threshold=0.3, max_models=16, lr=0.08, seed=0)

HYPERGEOMETRIC = FedCDConfig(
    n_devices=30, devices_per_round=15, local_epochs=2, score_window=3,
    milestones=(5, 15, 25, 30), late_delete_round=20,
    late_delete_threshold=0.3, max_models=16, lr=0.08, seed=0)

DIRICHLET = FedCDConfig(
    n_devices=30, devices_per_round=15, local_epochs=2, score_window=3,
    milestones=(5, 15, 25, 30), late_delete_round=20,
    late_delete_threshold=0.3, max_models=16, lr=0.08, seed=0)

DIRICHLET_ALPHAS = (0.1, 0.5, 1.0, 10.0)
