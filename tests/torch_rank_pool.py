"""A pool of rank processes for the parallel tests of the PyTorch port
(tests/test_torch_parallel*.py).

`RankPool(n, tasks_module)` starts n processes once; each joins a gloo
world on the CPU through the NSTPU_* variables (`parallel/distributed.
initialize_from_env`, the bring-up under test) and then serves tasks:
`pool.run(name, **kwargs)` calls `tasks_module.name(world, **kwargs)` on
every rank and returns the results in rank order.  Arguments and results
travel pickled over a local connection, so they are numpy arrays and plain
Python values.  A rank imports no JAX and nothing of the JAX package, and
checks so after every task.

    python -m tests.torch_rank_pool HOST PORT AUTHKEY TASKS_MODULE

is a rank's entry point (the pool sets its NSTPU_* variables).
"""

from __future__ import annotations

import importlib
import os
import secrets
import socket
import subprocess
import sys
import tempfile
import threading
import traceback
from multiprocessing.connection import Client, Listener

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


class RankPool:
    """n rank processes serving the tasks of `tasks_module`."""

    def __init__(self, n: int, tasks_module: str, timeout: float = 120.0):
        self.n = n
        self.timeout = timeout
        key = secrets.token_bytes(16)
        self._listener = Listener(('localhost', 0), authkey=key)
        host, port = self._listener.address
        env = dict(os.environ)
        env.update(NSTPU_COORDINATOR=f'localhost:{free_port()}',
                   NSTPU_NUM_PROCESSES=str(n), NSTPU_CPU_SIM='1',
                   OMP_NUM_THREADS='1', PYTHONPATH=REPO)
        env.pop('NSTPU_LOCAL_DEVICES', None)
        self._procs, self._logs = [], []
        for rank in range(n):
            env['NSTPU_PROCESS_ID'] = str(rank)
            log = tempfile.TemporaryFile(mode='w+')
            self._logs.append(log)
            self._procs.append(subprocess.Popen(
                [sys.executable, '-m', 'tests.torch_rank_pool', host,
                 str(port), key.hex(), tasks_module],
                env=dict(env), cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT))
        self._conns = [None] * n

        def accept():
            for _ in range(n):
                conn = self._listener.accept()
                self._conns[conn.recv()] = conn

        waiter = threading.Thread(target=accept, daemon=True)
        waiter.start()
        waiter.join(timeout)
        if None in self._conns:
            for proc in self._procs:
                proc.kill()
            raise RuntimeError(f'the ranks did not start in {timeout} s:\n'
                               + self.close())

    def run(self, name: str, **kwargs) -> list:
        """`name(world, **kwargs)` on every rank; the results in rank
        order.  A task that raises on a rank raises here with its
        traceback."""
        self.submit(name, **kwargs)
        return self.collect(name)

    def submit(self, name: str, **kwargs) -> None:
        """Start `name(world, **kwargs)` on every rank (`collect` waits)."""
        for conn in self._conns:
            conn.send((name, kwargs))

    def collect(self, name: str) -> list:
        """The results of the task `submit` started, in rank order."""
        results, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(self.timeout):
                self.close()
                raise TimeoutError(f'rank {rank}: no result from {name} '
                                   f'in {self.timeout} s')
            ok, value = conn.recv()
            if not ok:
                errors.append(f'rank {rank}:\n{value}')
            results.append(value)
        if errors:
            raise RuntimeError('\n'.join(errors))
        return results

    def close(self) -> str:
        """Stop the ranks; returns their output."""
        for conn in self._conns:
            if conn is not None:
                try:
                    conn.send(None)
                except OSError:
                    pass
        out = []
        for proc, log in zip(self._procs, self._logs):
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.seek(0)
            out.append(log.read())
            log.close()
        self._listener.close()
        return '\n'.join(out)


def _serve(host: str, port: int, key: bytes, tasks_module: str) -> None:
    import torch

    from nice_slam_tpu_torch.parallel.distributed import (
        initialize_from_env, shutdown)
    torch.set_num_threads(1)
    world = initialize_from_env()
    tasks = importlib.import_module(tasks_module)
    conn = Client((host, port), authkey=key)
    conn.send(world.rank)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            name, kwargs = msg
            try:
                result = (True, getattr(tasks, name)(world, **kwargs))
                leaked = [m for m in ('jax', 'nice_slam_tpu')
                          if m in sys.modules]
                if leaked:
                    result = (False, f'a rank imported {leaked}')
            except Exception:
                result = (False, traceback.format_exc())
            conn.send(result)
    finally:
        conn.close()
        shutdown()


if __name__ == '__main__':
    _serve(sys.argv[1], int(sys.argv[2]), bytes.fromhex(sys.argv[3]),
           sys.argv[4])
