"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the yardstick of every roofline and `mfu`
share. Copied here so that the program cannot move it."""

BF16_FLOPS = 989e12  # bf16 / fp16 dense tensor-core rate
HBM_BYTES_PER_S = 3.35e12
