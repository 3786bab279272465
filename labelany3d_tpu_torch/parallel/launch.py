"""Launch a function on several ranks, each a process with its own group.

`run_ranks(fn, world)` starts `world` fresh interpreters (`python -c`, so
a child imports the port and whatever `fn` needs, never the caller's main
module or JAX), gives each a `torch.distributed` group through a
`FileStore` in a temporary directory (no TCP port to race for), calls
`fn(rank, world, *args)` in each, and returns the results in rank order.
A rank that raises, dies or outlives the deadline makes it raise; it never
waits on anyone else's clock. `process_group` is the same set-up for the
calling process alone (one rank, or a rank another launcher started).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from labelany3d_tpu_torch.utils.device import resolve_device

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CHILD = ("import sys; from labelany3d_tpu_torch.parallel.launch import _child_main; "
          "_child_main(sys.argv[1], int(sys.argv[2]))")


def backend_for(device) -> str:
    """NCCL for CUDA, gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


@contextlib.contextmanager
def process_group(rank: int = 0, world: int = 1, device=None, store_path: str | None = None,
                  timeout: float = 120.0):
    """Initialise the default process group for this rank on a `FileStore`
    (a fresh temporary file when `store_path` is None, which only a world of
    one can share) and destroy it on exit. On CUDA the rank takes device
    `rank % device_count()`."""
    dev = resolve_device(device)
    with contextlib.ExitStack() as stack:
        if store_path is None:
            store_path = os.path.join(stack.enter_context(tempfile.TemporaryDirectory()),
                                      "store")
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend_for(dev), store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            yield
        finally:
            dist.destroy_process_group()


def _child_main(job_dir: str, rank: int) -> None:
    """A rank's process: the job from `job_dir`, its result (or traceback)
    written back there."""
    torch.set_num_threads(1)
    with open(os.path.join(job_dir, "job.pkl"), "rb") as f:
        fn, args, world, device, timeout = pickle.load(f)
    try:
        with process_group(rank, world, device, os.path.join(job_dir, "store"), timeout):
            out = fn(rank, world, *args)
    except BaseException:  # reported to the parent, which raises
        with open(os.path.join(job_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    tmp = os.path.join(job_dir, f"rank{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(job_dir, f"rank{rank}.pkl"))


def _failure(job_dir: str, rank: int, proc: subprocess.Popen) -> str:
    err = os.path.join(job_dir, f"rank{rank}.err")
    if os.path.exists(err):
        with open(err) as f:
            return f"rank {rank} failed:\n{f.read()}"
    with open(os.path.join(job_dir, f"rank{rank}.log"), errors="replace") as f:
        return f"rank {rank} exited with code {proc.returncode}:\n{f.read()[-4000:]}"


def run_ranks(fn, world: int, device=None, args: tuple = (), timeout: float = 120.0) -> list:
    """`fn(rank, world, *args)` on `world` ranks, each a process in a group
    on `device` (None: CUDA, NCCL; "cpu": gloo). `fn` and `args` must
    pickle (a module-level function of the package). Returns the results
    in rank order; raises `RuntimeError` with the rank's traceback if one
    fails or dies, or if any is still running `timeout` seconds after the
    start (its collectives time out before that)."""
    resolve_device(device)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([_PACKAGE_ROOT, *filter(None, [
                   os.environ.get("PYTHONPATH")])]))
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as job_dir:
        with open(os.path.join(job_dir, "job.pkl"), "wb") as f:
            pickle.dump((fn, args, world, device, max(timeout - 10.0, 5.0)), f)
        procs, logs = [], []
        failure = None
        try:
            for r in range(world):
                logs.append(open(os.path.join(job_dir, f"rank{r}.log"), "w"))
                procs.append(subprocess.Popen([sys.executable, "-c", _CHILD, job_dir, str(r)],
                                              env=env, stdout=logs[-1],
                                              stderr=subprocess.STDOUT))
            while failure is None and any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
                if bad:
                    failure = _failure(job_dir, bad[0], procs[bad[0]])
                elif time.monotonic() > deadline:
                    failure = (f"ranks {[r for r, p in enumerate(procs) if p.poll() is None]} "
                               f"still running after {timeout:.0f} s")
                else:
                    time.sleep(0.05)
            if failure is None:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failure = _failure(job_dir, bad[0], procs[bad[0]])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
            for log in logs:
                log.close()
        if failure is not None:
            raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, world={world}): "
                               f"{failure}")
        out = []
        for r in range(world):
            with open(os.path.join(job_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
