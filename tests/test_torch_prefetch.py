"""The port's host-side frame prefetcher (nice_slam_tpu_torch/io/prefetch.py):
the counterpart of tests/test_prefetch.py, on the same slow reader."""

import time

import numpy as np
import pytest

from nice_slam_tpu_torch.io.prefetch import Prefetcher


class SlowReader:
    def __init__(self, n=10, delay=0.01):
        self.n = n
        self.delay = delay
        self.reads = []

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        time.sleep(self.delay)
        self.reads.append(idx)
        return (idx, np.full((4, 4), idx, np.float32))


def test_sequential_order_and_values():
    r = SlowReader(8)
    p = Prefetcher(r, ahead=3)
    for i in range(8):
        idx, arr = p[i]
        assert idx == i and arr[0, 0] == i
    p.close()


def test_decode_runs_ahead():
    r = SlowReader(6, delay=0.02)
    p = Prefetcher(r, ahead=3)
    _ = p[0]
    time.sleep(0.15)          # worker should fill the queue meanwhile
    assert len(r.reads) >= 4  # decoded ahead of consumption
    p.close()


def test_random_access_bypasses_queue():
    r = SlowReader(6)
    p = Prefetcher(r, ahead=2)
    idx, _ = p[4]             # out-of-order: direct read
    assert idx == 4
    idx, _ = p[0]             # sequential stream still intact
    assert idx == 0
    p.close()


def test_reader_exception_propagates():
    class Bad(SlowReader):
        def __getitem__(self, idx):
            if idx == 2:
                raise ValueError('decode failed')
            return super().__getitem__(idx)

    p = Prefetcher(Bad(5, delay=0.0), ahead=2)
    assert p[0][0] == 0
    assert p[1][0] == 1
    with pytest.raises(ValueError):
        p[2]
    p.close()


def test_close_is_idempotent_and_fast():
    p = Prefetcher(SlowReader(100, delay=0.01), ahead=2)
    _ = p[0]
    t0 = time.time()
    p.close()
    p.close()
    assert time.time() - t0 < 3.0


def test_workers_deliver_in_order():
    r = SlowReader(12, delay=0.005)
    p = Prefetcher(r, start=2, ahead=3, workers=3)
    assert [p[i][0] for i in range(2, 12)] == list(range(2, 12))
    p.close()
    assert not any(t.is_alive() for t in p._threads)


def test_synthetic_reader_advertises_workers():
    from nice_slam_tpu_torch.io.datasets import SyntheticBox
    assert SyntheticBox.prefetch_workers == 4
