"""Postfilter constants read by the fused GSC + Zelinski recursion."""

SPECTRAL_FLOOR = 1.0e-4  # postfilter.cc:56

__all__ = ["SPECTRAL_FLOOR", "PostFilterType"]


class PostFilterType:
    """Bit flags per postfilter.h (TYPE_ZELINSKI1_REAL etc.)."""

    ZELINSKI1_REAL = 0x01
    ZELINSKI1_ABS = 0x02
    APAB = 0x04
    ZELINSKI2 = 0x08
