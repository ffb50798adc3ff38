"""Subband transforms: DFT matrices, plain torch filterbanks and their CUDA kernels."""
