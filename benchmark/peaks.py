"""Published peaks of the card (NVIDIA's H100 SXM data sheet; rates at
the full 700 W power limit)."""

H100_HBM_BYTES_PER_S = 3.35e12
