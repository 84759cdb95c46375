"""Measurement helpers of the port's entry points (`bench.py`,
`tools/bench_budget.py`, `tools/bench_imap.py`, `tools/bench_sync_modes.py`)
and of `scripts/port_profile_room0.py`.

- `wall_s(fn, device)`: the host clock around `fn()` with the device
  synchronized on both sides, so the time holds the device work.  (The
  JAX benches fetch a value as their barrier, a need of the TPU stack
  alone.)
- `event_ms(fn, device, reps)`: the median per call of `fn`, one call
  between two CUDA events at a time (the host clock on the CPU).
- `busy_share(kernel_spans(prof), wall_us)`: the union of the device's
  kernel intervals in a `torch.profiler` trace over a call's wall time;
  `busy_share_of(fn, device)` runs `fn` under the profiler and returns
  that share.
- `reset_launch_counts()` / `launch_counts()`: every row kernel's
  `LAUNCHES` (ops/expand.py, ops/gather.py, ops/fused_mlp.py,
  ops/roofline.py).  A wrapper counts a launch only on a CUDA tensor, so on
  the CPU every count stays 0.
- `card(device)`: the card's name and power limit as `nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader` gives them, read
  once; 'cpu' on the CPU.
- `true_f32()`: TF32 off, as `SlamSystem` sets it, for the entry points
  that call the tracker and the mapper directly (DESIGN.md section 7: a
  non-finite pose under reduced-precision products).
"""

from __future__ import annotations

import functools
import statistics
import subprocess
import time

import torch


def sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def wall_s(fn, device: torch.device):
    """(fn(), the seconds it took with the device synchronized before and
    after)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def event_ms(fn, device: torch.device, reps: int = 21) -> float:
    """Median ms per call of `fn` over `reps` calls after one warm-up call:
    CUDA events around each call on the card, the host clock on the
    CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            times.append(wall_s(fn, device)[1] * 1e3)
    return statistics.median(times)


def kernel_spans(prof) -> list[tuple[float, float]]:
    """(start, end) in us of every device activity (kernels, copies) of a
    finished `torch.profiler.profile`, read from its raw trace: building
    the Python events of `prof.events()` takes seconds per 10^4 kernels."""
    from torch.autograd import DeviceType
    return [(e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


def busy_share(spans, wall_us: float) -> tuple[float, int]:
    """Union of the device intervals `spans` (`kernel_spans`) over the
    wall time, and the number of intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / wall_us, len(spans)


def busy_share_of(fn, device: torch.device) -> float | None:
    """Run `fn` once under torch.profiler and return the device's busy
    share of its synchronized wall time; on the CPU, which has no device
    trace, None without running `fn`."""
    from torch.profiler import ProfilerActivity, profile
    if device.type != 'cuda':
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = wall_s(fn, device)
    return busy_share(kernel_spans(prof), wall * 1e6)[0]


def _counters():
    from nice_slam_tpu_torch.ops import expand, fused_mlp, gather, roofline
    return (expand, gather, fused_mlp, roofline)


def reset_launch_counts() -> None:
    for mod in _counters():
        mod.reset_launch_counts()


def launch_counts() -> dict:
    out = {}
    for mod in _counters():
        out.update(mod.LAUNCHES)
    return out


@functools.cache
def _nvidia_smi() -> tuple[str, ...]:
    try:
        res = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ()
    return tuple(ln.strip() for ln in res.stdout.splitlines() if ln.strip())


def card(device: torch.device) -> str:
    """'NAME, LIMIT W' of the card `device` is on (nvidia-smi's line);
    the CUDA name alone when nvidia-smi cannot be read; 'cpu'."""
    if device.type != 'cuda':
        return 'cpu'
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    lines = _nvidia_smi()
    if index < len(lines):
        return lines[index]
    return f'{torch.cuda.get_device_name(index)}, power limit not read'


def true_f32() -> None:
    """True float32 products: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
