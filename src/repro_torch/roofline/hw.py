"""Hardware constants of the port's target: one NVIDIA H100 80GB HBM3 (SXM)
at its 700 W power limit (NVIDIA's data sheet; dense rates, no sparsity).

A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
slower under load: a share of these peaks is stated beside the card's name
and power limit.
"""

# dense bf16 tensor-core operations/s: the roofline's compute peak, and
# the bound of a bf16 kernel's products
BF16_TENSOR_OPS_PER_S = 989e12
# float32 and integer operations/s on the CUDA cores (outside the tensor
# cores): the bound of a float32 or integer kernel
OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12      # HBM3
# NVLink 4, bytes/s each way: it enters only a collective term, which is 0
# on one card
NVLINK_BYTES_PER_S = 450e9
HBM_PER_CHIP = 80 * 10**9      # 80 GB
