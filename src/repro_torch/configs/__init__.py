"""Assigned architecture configs (port of ``repro/configs``). Importing
this package populates the registry (each module calls ``register``).
The architecture files are data only, copied from the reference."""
from repro_torch.configs import (chameleon_34b, deepseek_v3_671b,
                                 fedcd_cifar, glm4_9b, internlm2_1_8b,
                                 llama3_405b, phi35_moe_42b, qwen3_4b,
                                 whisper_small, xlstm_125m, zamba2_7b)
from repro_torch.configs.base import (ARCH_REGISTRY, all_arch_names,
                                      decode_window, get_arch, input_specs,
                                      reduced, shape_supported)

__all__ = ["ARCH_REGISTRY", "all_arch_names", "chameleon_34b",
           "decode_window", "deepseek_v3_671b", "fedcd_cifar", "get_arch",
           "glm4_9b", "input_specs", "internlm2_1_8b", "llama3_405b",
           "phi35_moe_42b", "qwen3_4b", "reduced", "shape_supported",
           "whisper_small", "xlstm_125m", "zamba2_7b"]
