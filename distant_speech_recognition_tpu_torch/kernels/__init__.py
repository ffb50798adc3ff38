"""The port's hand-written CUDA kernels: build, binding and launch counts.

Each kernel wrapper (`ops.filterbank_kernels.analysis_tm_fused`,
`ops.filterbank_kernels.synthesis_tm_fused`,
`models.fused_scan.gsc_rls_zelinski`, `ops.aec_kernels.aec_scan`,
`ops.wpe_kernels.wpe_stats`, `ops.wpe_kernels.wpe_resid`,
`ops.wpe_kernels.gj_solve`) keeps a plain integer attribute
``launches`` that it increments exactly where it launches its kernel, so a
run can show that the main path went through the kernels.
"""

from __future__ import annotations

import torch

__all__ = ["launch_counts", "reset_launch_counts", "check_cuda_tensor", "stream_handle"]


def _wrappers():
    from ..models.fused_scan import gsc_rls_zelinski
    from ..ops.aec_kernels import aec_scan
    from ..ops.filterbank_kernels import analysis_tm_fused, synthesis_tm_fused
    from ..ops.wpe_kernels import gj_solve, wpe_resid, wpe_stats

    return {
        "analysis_tm": analysis_tm_fused,
        "gsc_rls_zelinski": gsc_rls_zelinski,
        "synthesis_tm": synthesis_tm_fused,
        "aec_scan": aec_scan,
        "wpe_stats": wpe_stats,
        "wpe_resid": wpe_resid,
        "gj_solve": gj_solve,
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


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
