"""Start a local ``torch.distributed`` world and run one function on every
rank: the port's counterpart of the JAX package's single-controller mesh.

:func:`start` spawns ``nprocs`` processes (the ``spawn`` start method: a
forked child would inherit the parent's threads), each of which joins a
process group that meets through a ``file://`` store in a fresh temporary
directory (no TCP port, so concurrent worlds on one host never collide),
calls ``fn(rank, nprocs, *args)`` and hands its return value back; it
returns a :class:`World` that the caller joins for as long as it likes (a
server runs until it is stopped). :func:`run` starts a world and joins it
with a time limit. When one rank raises or dies, every other rank is ended
and the join raises with the failing rank's traceback, so a rank waiting
in an all-reduce for a dead peer never hangs the caller.

On a host with a GPU the served CUDA kernels are built in the parent
before the children start, so the ranks load one set of libraries
(``ops._build`` writes each library atomically, so two first builds of one
source never race either).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, nprocs: int, fn: Callable, args: tuple, store: str, out_dir: str,
               collective_timeout: float, threads: Optional[int]) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=nprocs,
                            timeout=datetime.timedelta(seconds=collective_timeout))
    try:
        result = fn(rank, nprocs, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()  # no rank leaves while a peer may still need it
    except BaseException:
        # stamped, so that the caller can tell the first failure from the
        # peers it brought down
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(out_dir: str, nprocs: int) -> Optional[tuple[int, str]]:
    """The rank that failed first and its traceback, from the ranks'
    stamped reports (None where no rank wrote one)."""
    found = []
    for r in range(nprocs):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            stamp, tb = open(path).read().split("\n", 1)
            found.append((float(stamp), r, tb))
    return min(found)[1:] if found else None


def build_served_kernels() -> None:
    """Build the libraries of the kernels the engines launch (K1-K6)."""
    from flute_tpu_torch.ops import lut_gemm, paged_attention

    lut_gemm.build_kernels()
    for kernel in paged_attention._ENTRIES:
        paged_attention._kernel_fn(kernel)


class World:
    """The rank processes of a started world and their reports."""

    def __init__(self, ctx, tmp: str, nprocs: int):
        self._ctx, self._tmp, self.nprocs = ctx, tmp, nprocs

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait up to ``timeout`` seconds: True once every rank has
        returned. When a rank fails, every other rank is ended and this
        raises ``RuntimeError`` with the traceback of the rank that failed
        first, or ``torch.multiprocessing.ProcessExitedException`` when a
        rank died without one."""
        try:
            return self._ctx.join(timeout=timeout)
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            first = _first_failure(self._tmp, self.nprocs)
            if first is None:
                raise
            raise RuntimeError(f"rank {first[0]} of {self.nprocs} failed:\n{first[1]}") from e

    def results(self) -> list:
        """The ranks' return values in rank order (after a join gave True)."""
        return [torch.load(os.path.join(self._tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(self.nprocs)]

    def terminate(self) -> None:
        """Kill every rank still running and wait for each."""
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()
        for p in self._ctx.processes:
            p.join()

    def close(self) -> None:
        """Remove the world's store and reports."""
        shutil.rmtree(self._tmp, ignore_errors=True)


def start(
    fn: Callable,
    nprocs: int,
    *args: Any,
    collective_timeout: float = 1800.0,
    threads: Optional[int] = None,
) -> World:
    """Start ``fn(rank, nprocs, *args)`` on each rank of a new world of
    ``nprocs`` processes and return at once. The world's process group is
    gloo, which also reduces CUDA tensors (through the host), so several
    ranks may share one card; a collective that waits longer than
    ``collective_timeout`` seconds for a peer raises on its rank.

    ``fn`` must be importable by the children (a module-level function of
    a module that imports no JAX); its results are saved with
    ``torch.save``. ``threads`` sets each rank's intra-op threads. The
    caller joins the world and closes it (:meth:`World.close`)."""
    if torch.cuda.is_available():
        build_served_kernels()
    tmp = tempfile.mkdtemp(prefix="flute_world_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(nprocs, fn, args, os.path.join(tmp, "store"), tmp,
                              collective_timeout, threads),
            nprocs=nprocs, join=False, start_method="spawn")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return World(ctx, tmp, nprocs)


def run(
    fn: Callable,
    nprocs: int,
    *args: Any,
    timeout: float = 600.0,
    threads: Optional[int] = None,
) -> list:
    """Run ``fn(rank, nprocs, *args)`` on each rank of a new world of
    ``nprocs`` processes (:func:`start`) and return the ranks' results in
    rank order. ``timeout`` bounds both the world and each collective.
    Raises ``TimeoutError`` past ``timeout`` seconds (every rank ended), and
    as :meth:`World.join` does when a rank fails."""
    world = start(fn, nprocs, *args, collective_timeout=timeout, threads=threads)
    try:
        deadline = time.monotonic() + timeout
        while not world.join(timeout=0.5):  # raises as soon as one rank fails
            if time.monotonic() > deadline:
                world.terminate()
                raise TimeoutError(f"a world of {nprocs} ranks ran past {timeout} s")
        return world.results()
    finally:
        world.close()
