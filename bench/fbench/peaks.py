"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet,
dense rates, at the full 700 W power limit). A share of a peak is
stated against these, with the card's ``power.limit`` beside it in the
result line (``device.power_limit_w``)."""

FLOAT32_FLOPS = 67e12        # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12          # bf16 and fp16 on the tensor cores
FP8_FLOPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9

FLOPS = {"float32": FLOAT32_FLOPS, "tf32": TF32_FLOPS,
         "bfloat16": BF16_FLOPS, "fp8": FP8_FLOPS}
