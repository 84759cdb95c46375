"""Measurement helpers of the port's entry points (`bench.py` and the
`tools/bench_*`, `profile_*`, `ablate_*` and `diagnose_strict` scripts) and
of `scripts/port_profile_room0.py`.

- `wall_s(fn, device)`: the host clock around `fn()` with the device
  synchronized on both sides, so the time holds the device work.  (The
  JAX benches fetch a value as their barrier, a need of the TPU stack
  alone.)
- `event_ms(fn, device, reps)`: the median per call of `fn`, one call
  between two CUDA events at a time (the host clock on the CPU).
- `timeit(fn, device, n)`: the JAX profile_components' pair, ms per call
  synchronized after every call (median) and ms per call of n calls
  launched back to back with one synchronize (pipelined).
- `busy_share(kernel_spans(prof), wall_us)`: the union of the device's
  kernel intervals in a `torch.profiler` trace over a call's wall time;
  `profiled(fn, device)` runs `fn` once under the profiler and returns its
  wall ms, device ms (that union), busy share and kernel count with the
  profile; `busy_share_of(fn, device)` returns the share alone.
- `reset_launch_counts()` / `launch_counts()`: every row kernel's
  `LAUNCHES` (ops/expand.py, ops/gather.py, ops/fused_mlp.py,
  ops/roofline.py).  A wrapper counts a launch only on a CUDA tensor, so on
  the CPU every count stays 0.
- `build_kernels(device)`: the row kernels' libraries and the mesher's
  host library built before a clock starts (on the CPU nothing).
- `reset_peak(device)` / `peak_mem_gb(device)`: the peak of
  `torch.cuda.max_memory_allocated` in GB since the reset; None on the CPU.
- `no_sort()`: a context in which `torch.sort` leaves its values unsorted
  (the renderer merges its stratified and surface samples without the
  depth sort), the ablation scripts' timing-only variant (WRONG math).
- `card(device)`: the card's name and power limit as `nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader` gives them, read
  once; 'cpu' on the CPU.
- `true_f32()`: TF32 off, as `SlamSystem` sets it, for the entry points
  that call the tracker and the mapper directly (DESIGN.md section 7: a
  non-finite pose under reduced-precision products).
"""

from __future__ import annotations

import contextlib
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


def timeit(fn, device: torch.device, n: int = 20) -> tuple[float, float]:
    """(median ms of n calls each synchronized, ms per call of n calls
    launched back to back and synchronized once) after one warm-up call."""
    fn()
    sync(device)
    lat = statistics.median(wall_s(fn, device)[1] for _ in range(n))
    _, total = wall_s(lambda: [fn() for _ in range(n)], device)
    return lat * 1e3, total / n * 1e3


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


def profiled(fn, device: torch.device):
    """Run `fn` once under torch.profiler on the card, synchronized
    before and after: ({'wall_ms', 'device_ms' (the union of its device
    intervals), 'busy_share', 'kernels'}, the finished profile)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = wall_s(fn, device)
    share, n = busy_share(kernel_spans(prof), wall * 1e6)
    return {'wall_ms': wall * 1e3, 'device_ms': share * wall * 1e3,
            'busy_share': share, 'kernels': n}, prof


def busy_share_of(fn, device: torch.device) -> float | None:
    """Run `fn` once under torch.profiler and return the device's busy
    share of its synchronized wall time; on the CPU, which has no device
    trace, None without running `fn`."""
    if device.type != 'cuda':
        return None
    return profiled(fn, device)[0]['busy_share']


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


def build_kernels(device: torch.device) -> None:
    """Load the libraries of the kernels on the SLAM path and of the
    mesher, building those missing or older than their sources (a library
    is built at its first use otherwise, inside whatever is being timed);
    nothing on the CPU."""
    if device.type != 'cuda':
        return
    from nice_slam_tpu_torch.mesh import native
    from nice_slam_tpu_torch.ops import expand, fused_mlp, gather
    for mod in (expand, gather, fused_mlp):
        mod._library()
    native.get_lib()


def reset_peak(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)


def peak_mem_gb(device: torch.device) -> float | None:
    """`torch.cuda.max_memory_allocated` in GB since `reset_peak`; None
    on the CPU."""
    if device.type != 'cuda':
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


@contextlib.contextmanager
def no_sort():
    """`torch.sort` as the identity on its values (WRONG math, for timing
    only), as the JAX ablation scripts' `jnp.sort`: the renderer merges its
    stratified and surface samples unsorted, and the tracker's masked
    median reads the unsorted depths.  A stable sort, whose indices order
    the importance samples (the JAX renderer's `argsort`, which the JAX
    scripts leave), still sorts.  Restored on exit, also on an error."""
    real = torch.sort

    def identity(x, dim=-1, descending=False, stable=False, **kw):
        if stable:
            return real(x, dim=dim, descending=descending, stable=True, **kw)
        return torch.return_types.sort((x, None))

    torch.sort = identity
    try:
        yield
    finally:
        torch.sort = real


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
