"""PyTorch/CUDA port of the FedCD reproduction.

Module paths mirror ``src/repro/`` file for file; each port module names
the reference module it is held against. The package imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro``. The kernels on
the round's path are CUDA C++ for Hopper (``csrc/``), built at first use
by :mod:`repro_torch.kernels.build`.
"""
