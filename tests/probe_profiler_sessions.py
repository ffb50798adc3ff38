"""How many back-to-back torch.profiler sessions in one process record the
card's kernels, and where the recorded kernels fall against the CPU range
that marks the measured calls.

Each session profiles one warm-up call and then ``n`` measured calls inside
a ``record_function`` range, as ``chip_smoke.py``'s ``profile_path`` does.
Per session it prints the device events recorded, how many start at or
after the range's CPU start, the earliest and latest of them relative to
that start (µs), and how many start after a marker kernel launched between
the warm-up and the measured calls (device clock only).

    python3 tests/probe_profiler_sessions.py [--sessions 14] [--n 3]
"""

import argparse
import json

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=14)
    ap.add_argument("--n", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    a = torch.randn((4096, 4096), device=dev)
    x = torch.randn((1 << 16, 512), device=dev)
    marker = torch.zeros(7, device=dev)

    def fn():
        torch.matmul(a, a)
        torch.fft.rfft(x, dim=-1)

    rows = []
    for s in range(args.sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            marker.add_(1.0)
            with record_function("dsr_measured"):
                for _ in range(args.n):
                    fn()
                torch.cuda.synchronize()
        events = list(prof.events())
        t0 = min(e.time_range.start for e in events if e.name == "dsr_measured")
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name != "dsr_measured"]
        after = [e for e in device if e.time_range.start >= t0]
        marks = [e.time_range.start for e in device if "add" in e.name.lower()
                 or "elementwise" in e.name.lower()]
        m0 = min(marks) if marks else None
        rows.append(dict(
            session=s, events=len(events), device=len(device), device_after_t0=len(after),
            first_us=(min(e.time_range.start for e in device) - t0) if device else None,
            last_us=(max(e.time_range.end for e in device) - t0) if device else None,
            after_marker=None if m0 is None else sum(e.time_range.start > m0 for e in device)))
        print(json.dumps(rows[-1]), flush=True)


if __name__ == "__main__":
    main()
