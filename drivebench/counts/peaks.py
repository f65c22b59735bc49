"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_S = 989e12  # FLOP/s, bf16 and fp16 tensor cores
TF32_S = 495e12  # FLOP/s, TF32 tensor cores
F32_S = 67e12  # FLOP/s, float32 outside the tensor cores
BYTES_S = 3.35e12  # B/s, HBM3


def product_peaks(tf32: bool) -> dict:
    """FLOP/s of a product by the precision it runs in; a float32 product
    runs in TF32 when the card's settings allow it."""
    return {"bf16": BF16_S, "f32": TF32_S if tf32 else F32_S}
