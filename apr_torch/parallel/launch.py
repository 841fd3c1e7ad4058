"""Run a function on every rank of a new process group, one spawned process
per rank, and bring back each rank's result.

    results = spawn(fn, 2, args=(...,), devices="cpu",
                    init_file="/some/dir/rendezvous")

Each rank joins the group (``make_mesh`` with a ``file://`` rendezvous,
never a fixed port), calls ``fn(mesh, *args)`` and returns its (picklable)
result.  A hung collective fails at the group's ``timeout``; the parent
joins every rank with a ``deadline``, and a rank's exception, with its
traceback, is raised in the parent after the other ranks are stopped.
``fn`` must be importable by name from a module the children can import
(one that imports no JAX when the tests launch it), and should return
numpy arrays, not tensors: a tensor travels through shared memory that
its rank frees when it exits.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch


def _rank_main(rank, world_size, init_method, devices, backend, timeout_s,
               threads, fn, args, out):
    import torch.distributed as dist

    from apr_torch.parallel.mesh import make_mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = make_mesh(devices, backend=backend, rank=rank,
                         world_size=world_size, init_method=init_method,
                         timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(mesh, *args)
        out.put((rank, "ok", result))
    except BaseException:
        out.put((rank, "err", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence[Any] = (),
          devices="cpu", backend: Optional[str] = None,
          init_file: Optional[str] = None, timeout: float = 60.0,
          deadline: float = 600.0, threads: Optional[int] = 1
          ) -> List[Any]:
    """``fn(mesh, *args)`` on ``world_size`` spawned ranks; their results
    in rank order.  ``devices`` names each rank's device (see
    ``apr_torch.parallel.mesh.rank_device``); ``backend`` defaults to NCCL
    on CUDA and gloo on the CPU; ``init_file`` is the rendezvous file (a
    fresh temporary one by default, which must not exist yet);
    ``timeout`` bounds each collective and ``deadline`` the whole run, in
    seconds; ``threads`` sets each rank's torch threads (None keeps
    torch's default)."""
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="apr_torch_rdzv_")
        init_file = os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, name=f"apr_torch-rank{r}",
        args=(r, world_size, "file://" + os.path.abspath(init_file), devices,
              backend, timeout, threads, fn, tuple(args), out))
        for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    end = time.monotonic() + deadline
    try:
        # drain the queue before joining: a child blocks on a full pipe
        while len(results) + len(errors) < world_size:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(results))}"
                    f" did not finish within {deadline:.0f} s")
            try:
                rank, kind, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                # a rank killed before it could report (a signal, the
                # out-of-memory killer)
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead and out.empty():
                    errors.update({r: f"rank {r} exited with code "
                                      f"{procs[r].exitcode} and no result"
                                   for r in dead})
                    break
                continue
            (results if kind == "ok" else errors)[rank] = payload
            if errors:
                break
        if errors:
            rank = min(errors)
            raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                               f"{errors[rank]}")
        return [results[r] for r in range(world_size)]
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        if tmp is not None:
            for name in os.listdir(tmp):
                os.unlink(os.path.join(tmp, name))
            os.rmdir(tmp)
