"""The port's hand-written CUDA kernels: build, binding and launch counts.

Each kernel wrapper keeps a plain integer attribute ``launches`` that it
increments exactly where it launches its kernel, so a run can show that a
path went through the kernels:

- K1 `ops.filterbank_kernels.analysis_tm_fused` (``csrc/analysis_tm.cu``);
- K2 `models.fused_scan.gsc_rls_zelinski` and K6
  `models.fused_scan.gsc_rls_zelinski_steered` (``csrc/gsc_rls_zelinski.cu``);
- the LMS scan `models.fused_scan.gsc_lms_zelinski`, its per-utterance form
  `models.fused_scan.gsc_lms_zelinski_steered`, and their silence gates
  `models.fused_scan.lms_gates`, which the scan's wrappers launch first
  (``csrc/gsc_lms_zelinski.cu``; they replace no TPU kernel: the JAX package
  runs that recursion in XLA);
- K3 `ops.filterbank_kernels.synthesis_tm_fused` (``csrc/synthesis_tm.cu``);
- K4 `models.fused_scan.analysis_gsc_synthesis` and K5
  `models.fused_scan.analysis_gsc_rls_zelinski` (``csrc/gsc_mono.cu``);
- K7 `models.fixed_weight.zelinski_apply` and its per-utterance form
  `models.fixed_weight.zelinski_apply_steered` (``csrc/zelinski_apply.cu``);
- the McCowan, Lefkimmiatis and APAB postfilters
  `models.coherence_postfilter.coherence_postfilter`
  (``csrc/coherence_postfilter.cu``; it replaces no TPU kernel: the JAX
  package runs them in XLA);
- K8 `models.fixed_weight.analysis_fw_synthesis` (``csrc/fw_mono.cu``);
- K9 `ops.aec_kernels.aec_scan` (``csrc/aec_scan.cu``);
- K10 `ops.wpe_kernels.wpe_stats`, K11 `ops.wpe_kernels.wpe_resid`, K12
  `ops.wpe_kernels.gj_solve` (``csrc/wpe_stats.cu``, ``wpe_resid.cu``,
  ``gj_solve.cu``);
- K13 `ops.filterbank_kernels.polyphase_fir` (``csrc/polyphase_fir.cu``).
"""

from __future__ import annotations

import torch

__all__ = [
    "launch_counts", "reset_launch_counts", "check_cuda_tensor", "complex_view", "stream_handle",
]


def _wrappers():
    from ..models.coherence_postfilter import coherence_postfilter
    from ..models.fixed_weight import analysis_fw_synthesis, zelinski_apply, zelinski_apply_steered
    from ..models.fused_scan import (
        analysis_gsc_rls_zelinski,
        analysis_gsc_synthesis,
        gsc_lms_zelinski,
        gsc_lms_zelinski_steered,
        gsc_rls_zelinski,
        gsc_rls_zelinski_steered,
        lms_gates,
    )
    from ..ops.aec_kernels import aec_scan
    from ..ops.filterbank_kernels import analysis_tm_fused, polyphase_fir, synthesis_tm_fused
    from ..ops.wpe_kernels import gj_solve, wpe_resid, wpe_stats

    return {
        "analysis_tm": analysis_tm_fused,
        "gsc_rls_zelinski": gsc_rls_zelinski,
        "synthesis_tm": synthesis_tm_fused,
        "aec_scan": aec_scan,
        "wpe_stats": wpe_stats,
        "wpe_resid": wpe_resid,
        "gj_solve": gj_solve,
        "gsc_rls_zelinski_steered": gsc_rls_zelinski_steered,
        "zelinski_apply": zelinski_apply,
        "fw_mono": analysis_fw_synthesis,
        "gsc_mono": analysis_gsc_synthesis,
        "gsc_analysis": analysis_gsc_rls_zelinski,
        "polyphase_fir": polyphase_fir,
        "gsc_lms_zelinski": gsc_lms_zelinski,
        "lms_gates": lms_gates,
        "coherence_postfilter": coherence_postfilter,
        "gsc_lms_zelinski_steered": gsc_lms_zelinski_steered,
        "zelinski_apply_steered": zelinski_apply_steered,
    }


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last `reset_launch_counts`."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def check_cuda_tensor(name: str, t: torch.Tensor, shape: tuple | None = None) -> None:
    """Validate a tensor before its pointer is handed to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def complex_view(name: str, t: torch.Tensor, shape: tuple | None = None) -> torch.Tensor:
    """Validated float32 view ``[..., 2]`` (interleaved re, im) of a
    complex64 CUDA tensor of the given ``shape``, made contiguous."""
    if t.dtype != torch.complex64:
        raise ValueError(f"{name} must be complex64, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    v = torch.view_as_real(t.resolve_conj().contiguous())
    check_cuda_tensor(name, v)
    return v


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
