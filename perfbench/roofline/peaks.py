"""The chip's published peaks, the yardstick of every share.

NVIDIA H100 SXM5 80 GB data sheet (dense rates, no sparsity), at the
card's full 700 W power limit: a card set below it reads lower shares,
so every reading is printed beside ``nvidia-smi``'s power limit.
"""

BF16_FLOPS = 989e12          # bf16 tensor-core FLOP/s, dense
HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth, bytes/s
HBM_BYTES = 80e9             # device memory, bytes
