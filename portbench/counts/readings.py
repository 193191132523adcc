"""Arithmetic the per-layer metrics share over a traced run's readings.

A roofline share is the sum of the floors (counts/kernels.py) of a kernel's
calls in the traced span over the device time of that kernel's launches in
the trace.  Each call launches one kernel of each of its wrapper's roles,
in whichever form the call takes.  Should the profiler drop a record, the
time is the traced mean per launch times the calls made; where a role's
traced launches differ from the calls by more than `LOST_RECORDS`, a form
has a name that no tag knows (or a launch went elsewhere), and there is no
share.  No launch traced, no share.
"""
from __future__ import annotations

from typing import Iterable, Optional

from . import kernels

PEAK_16BIT = kernels.PEAK_16BIT
# The most records a trace has been seen to lose of one kernel.
LOST_RECORDS = 1
# The kernels' names in a profiler trace, by wrapper and role: every form
# of each (K1: wgmma, wgmma_wide, CUDA cores; K2: wgmma, mma, CUDA cores).
# K2 launches two kernels a call: dQ, then dK and dV.
TAGS = {
    "flash": (("flash_fwd_wgmma_kernel<", "flash_fwd_wgmma_wide_kernel<",
               "flash_fwd_cc_kernel<"),),
    "flash_bwd": (("flash_bwd_dq_kernel<", "::mma::dq_kernel<", "::cc::dq_kernel<"),
                  ("flash_bwd_dkdv_kernel<", "::mma::dkdv_kernel<", "::cc::dkdv_kernel<")),
    "gn": (("group_norm_fwd_kernel<",),),
    "gn_bwd": (("group_norm_bwd_kernel<",),),
}


def _matches(name: str, tags) -> bool:
    return any(t in name for t in tags)


def kernel_time_us(readings: dict, wrapper: str) -> Optional[float]:
    """Device time of `wrapper`'s calls in the traced span, by role: each
    role's traced time scaled to the calls made; None where a role's
    launches and the calls disagree (module docstring)."""
    calls = sum(readings["kernel_calls"][wrapper].values())
    total = 0.0
    for role in TAGS[wrapper]:
        hits = [(n, us) for name, (n, us) in readings["trace"]["kernels"].items()
                if _matches(name, role)]
        launches = sum(n for n, _ in hits)
        if not launches or abs(launches - calls) > LOST_RECORDS:
            return None
        total += sum(us for _, us in hits) * calls / launches
    return total


def roofline_percent(readings: dict, wrappers: Iterable[str]) -> Optional[float]:
    floor_s, time_us = 0.0, 0.0
    for w in wrappers:
        calls = readings["kernel_calls"][w]
        if not calls:
            continue
        us = kernel_time_us(readings, w)
        if us is None:
            return None
        floor_s += sum(kernels.floor_s(w, key) * n for key, n in calls.items())
        time_us += us
    return 100.0 * floor_s / (time_us / 1e6) if time_us else None


def library_ms(readings: dict) -> float:
    """Device time of every traced kernel that is none of the four, in any
    form, per traced unit (step or image), in ms."""
    ours = tuple(t for roles in TAGS.values() for role in roles for t in role)
    us = sum(v[1] for name, v in readings["trace"]["kernels"].items()
             if not _matches(name, ours))
    return us / 1e3 / readings["traced_units"]


def idle_percent(readings: dict) -> float:
    t = readings["trace"]
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])


def mfu_percent(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAK_16BIT
