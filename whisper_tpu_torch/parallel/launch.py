"""Start the ranks of a parallel run as processes on this host.

    from whisper_tpu_torch.parallel.launch import spawn
    results = spawn("my_module:run_rank", 2, args=(path,), device="cpu")

starts ``nprocs`` fresh interpreters, one per rank. Each one sets
``torch.set_num_threads(threads)``, joins the group through a file in a
fresh temporary directory (``init_distributed("file://...")``, so two runs
on one host never compete for a port), calls ``run_rank(*args)`` and
hands its return value back; ``spawn`` returns them in rank order. The
target is given by import path (``module:function``), so the children
import only what it needs. ``torchrun --nproc-per-node N script.py``,
whose script calls ``init_distributed()``, is the other way to start
ranks.

If a rank fails, the others are killed (they would wait in a collective)
and ``spawn`` raises with the failing rank's error output; after
``timeout`` seconds every rank is killed and it raises too.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def spawn(target: str, nprocs: int, args: tuple = (), device: str = "cuda",
          backend: str | None = None, timeout: float = 120.0, threads: int = 1) -> list:
    """Run ``target(*args)`` on ranks 0..nprocs-1 (one process each, on
    ``device`` with ``backend``: ``init_distributed``'s defaults) and
    return their results in rank order."""
    with tempfile.TemporaryDirectory(prefix="wt_spawn_") as tmp:
        torch.save(args, os.path.join(tmp, "args.pt"))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
        procs = []
        for rank in range(nprocs):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            cmd = [sys.executable, "-m", "whisper_tpu_torch.parallel.launch", target, tmp,
                   str(rank), str(nprocs), device, backend or "", str(threads)]
            procs.append((subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT), log))
        try:
            failed = _wait(procs, time.monotonic() + timeout)
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
                log.close()
        if failed:
            raise RuntimeError("\n".join(
                f"rank {rank} of {target} {why}:\n{Path(tmp, f'rank{rank}.log').read_text()[-6000:]}"
                for rank, why in failed))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]


GRACE_S = 2.0      # seconds the other ranks get to exit after one failed


def _wait(procs, deadline: float) -> list[tuple[int, str]]:
    """Poll the ranks until every one exited 0 (returns []), one failed,
    or the deadline passed (the ranks still running). After a failure the
    others get GRACE_S to exit too (a rank that lost its peer in a
    collective fails soon after it), and every rank that exited non-zero
    is returned with its code, so the first cause is among them."""
    while True:
        codes = [proc.poll() for proc, _ in procs]
        if any(c not in (None, 0) for c in codes):
            end = time.monotonic() + GRACE_S
            while time.monotonic() < end and any(p.poll() is None for p, _ in procs):
                time.sleep(0.05)
            codes = [proc.poll() for proc, _ in procs]
            return [(r, f"exited with code {c}") for r, c in enumerate(codes) if c not in (None, 0)]
        if all(c == 0 for c in codes):
            return []
        if time.monotonic() > deadline:
            return [(r, "timed out after the run's deadline") for r, c in enumerate(codes) if c is None]
        time.sleep(0.05)


def _child(target: str, tmp: str, rank: int, nprocs: int, device: str, backend: str,
           threads: int) -> None:
    import torch.distributed as dist

    from whisper_tpu_torch.api.devices import init_distributed

    torch.set_num_threads(threads)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    init_distributed(f"file://{tmp}/store", nprocs, rank, device=device, backend=backend or None)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


if __name__ == "__main__":
    target, tmp, rank, nprocs, device, backend, threads = sys.argv[1:]
    _child(target, tmp, int(rank), int(nprocs), device, backend, int(threads))
