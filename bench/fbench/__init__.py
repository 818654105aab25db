"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

Everything that measures lives here: the cell files' loader, the
frozen input generators, the plain references, the FLOP and byte
counts, the table of peaks, the profiler's reduction and the result
line. Nothing here imports ``jax`` or the JAX package ``repro``.
"""
