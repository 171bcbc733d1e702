"""Device time of a kernel call on the card, and its least possible time.

`time_ms` times one call with CUDA events, from a cold L2 and with the
call's host work kept out of the event window: before the start event it
flushes the 50 MB L2 and queues a device spin (`torch.cuda._sleep`).  The
host then enqueues the call while the card is still spinning, so the
checks, allocation and ctypes call of a wrapper cannot land between the
two events, however fast the kernel.

The flush reads a 256 MB buffer, which leaves the L2 full of clean lines.
Zeroing the buffer instead would leave up to 50 MB of dirty lines, whose
write-back to HBM would then be charged to the timed call.

`floor_ms` is `time_ms` of an empty launch: what the timer reads for a
kernel that does nothing.

`bound_ms` is the larger of bytes over the HBM rate and operations over
the ALU rate (NVIDIA H100 SXM data sheet, at its 700 W limit).
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Integer and compare ops run on the SM's ALUs; the data sheet's 67 TFLOP/s
# float32 (non-tensor) rate is the table's closest line.
ALU_OPS_PER_S = 67e12
# ~0.1 ms at the H100's 1.98 GHz boost clock: longer than a wrapper's
# host work.
SPIN_CYCLES = 200_000


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms over `reps` timed calls."""
    buf = torch.zeros(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        buf.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del buf
    return float(np.median(times))


def floor_ms() -> float:
    """The timer's floor: `time_ms` of an empty launch (a device spin of 0
    cycles, one thread)."""
    return time_ms(lambda: torch.cuda._sleep(0))


def bound_ms(bytes_moved: float, ops: float):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
