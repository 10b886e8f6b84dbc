"""Profiling and tracing helpers (`fastforward_tpu/utils/profiling.py`).

`trace_to` records a `torch.profiler` trace (CPU and, where CUDA is
available, CUDA activities) and writes it into ``log_dir`` as a Chrome
trace on exit; `annotate` names a region of it (``record_function``);
`benchmark` times a callable by the wall clock, synchronizing the devices
of the tensors it returns; `device_memory_stats` reads the CUDA caching
allocator's statistics, with the JAX keys beside torch's.
"""

import contextlib
import os
import time
from typing import Any, Callable, Iterator, Optional

import torch
from torch.utils import _pytree as pytree

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; write ``<log_dir>/trace.json`` (open it in
    chrome://tracing or Perfetto) on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region that shows up in profiles."""
    with torch.profiler.record_function(name):
        yield


def _synchronize(result: Any) -> None:
    devices = {leaf.device for leaf in pytree.tree_leaves(result)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def benchmark(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 10,
    warmup: int = 1,
    **kwargs: Any,
) -> dict[str, float]:
    """Wall-clock ``fn``: {mean_s, best_s, iters}. Each call waits for the
    devices of the tensors it returns; the first ``warmup`` calls are not
    counted."""
    for _ in range(warmup):
        _synchronize(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _synchronize(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {
        "mean_s": sum(times) / len(times),
        "best_s": min(times),
        "iters": float(iters),
    }


def device_memory_stats(device: Optional[Any] = None) -> dict[str, int]:
    """`torch.cuda.memory_stats` of a CUDA device (default: the current
    one) with the JAX keys ``bytes_in_use``, ``peak_bytes_in_use`` and
    ``bytes_limit`` added; an empty dict on the CPU or without CUDA."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    stats["bytes_limit"] = torch.cuda.get_device_properties(
        device if device is not None else torch.cuda.current_device()).total_memory
    return stats
