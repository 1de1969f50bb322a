"""The table of peaks: one NVIDIA H100 SXM (data sheet, dense, at its 700 W
power limit). The card's power limit is printed beside every reading."""

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
