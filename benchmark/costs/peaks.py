"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit). A card set to a lower `power.limit` runs
slower under load; the harness prints the card's limit beside every run
(`run.py:card_line`), and a share of a peak is always of these numbers."""

BF16_FLOP_PER_S = 989e12   # bf16 on the tensor cores
TF32_FLOP_PER_S = 495e12   # TF32 on the tensor cores
F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
