"""The experiment tools' clocks and counters.

* `best_ms`: the best of a few timed calls after a warm-up, by CUDA events
  on the card (the host clock on the CPU);
* `synced_reads`: the host reads (stream synchronizations) a call makes on
  the card, from torch's sync debug mode;
* `device_profile`: the kernel launches and summed device time of a call
  on the card, from torch.profiler.
On the CPU the two counters return None: there is no device to wait for.
"""

from __future__ import annotations

import time
import warnings

_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def best_ms(fn, device, reps: int = 3) -> float:
    """The least milliseconds of `reps` calls of fn() after one warm-up
    call.  On the card each call is bracketed by CUDA events, so host gaps
    between its launches count, as they do for a user."""
    import torch
    cuda = torch.device(device).type == "cuda"
    fn()
    synchronize(device)
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop)
        else:
            t0 = time.perf_counter()
            fn()
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms)
    return best


def synced_reads(fn, device):
    """(fn()'s result, the number of synchronizing CUDA calls it made, or
    None on the CPU).  Counted by torch.cuda's sync debug mode, which warns
    at each synchronizing call (.item(), bool(), .cpu(), nonzero)."""
    import torch
    if torch.device(device).type != "cuda":
        return fn(), None
    synchronize(device)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def device_profile(fn, device):
    """(kernel launches, summed device ms) of one fn() call on the card
    (torch.profiler), or (None, None) on the CPU."""
    import torch
    if torch.device(device).type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile
    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        synchronize(device)
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in _LAUNCH_KEYS)
    busy_us = sum(e.self_device_time_total for e in events
                  if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return launches, busy_us / 1e3
