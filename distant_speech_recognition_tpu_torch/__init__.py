"""PyTorch/CUDA port of the distant-speech enhancement front end.

Runs the flagship chain of ``distant_speech_recognition_tpu`` — oversampled
DFT analysis bank, adaptive GSC-RLS beamformer with the Zelinski postfilter,
synthesis bank — on ``x [B, C, T]`` utterance batches.  On a CUDA device the
three stages are hand-written kernels (``csrc/``); on the CPU the same
functions run their plain torch versions.  The package imports torch and
never jax.

Entry point: `models.pipeline.build_pipeline`.
"""

__version__ = "0.1.0"
