"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
its full 700 W power limit). Rooflines and MFU are stated against these,
with the card's power limit printed beside each run."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
