"""A world of ranks for the port's mesh tests: ``run_world(n, target)``
starts ``n`` processes on this host with ``torchrun``'s environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), each of which joins the gloo group
through ``multihost.initialize``, calls ``target`` (``"module:function"``
of ``tests/``) and saves what it returns; the caller gets every rank's
result in rank order.

Every world has a deadline: a rank that fails or a world that outlives
``timeout`` seconds kills every rank and fails the caller with each
rank's last output. A rank imports the port and never JAX.

As a program (one rank): ``python tests/_torch_world.py <target> <out>``.
"""
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n: int, target: str, timeout: float = 240.0, env=None):
    """Every rank's result of ``target`` in a world of ``n`` ranks;
    ``env`` adds to each rank's environment."""
    import torch
    out = tempfile.mkdtemp(prefix="tmog_world_")
    port = _free_port()
    procs = []
    for r in range(n):
        rank_env = dict(os.environ, **(env or {}))
        rank_env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                        LOCAL_WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), target, out],
            cwd=ROOT, env=rank_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    failed = None
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs)
               if p.poll() is not None and p.returncode != 0]
        if bad or time.monotonic() > deadline:
            failed = (f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                      if bad else f"the world outlived {timeout:.0f} s")
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    logs = [p.communicate()[0] for p in procs]
    if failed is None:
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    if failed is not None:
        tails = "\n".join(f"--- rank {r} ---\n{log[-3000:]}"
                          for r, log in enumerate(logs))
        raise AssertionError(f"world of {n} for {target}: {failed}\n{tails}")
    res = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(n)]
    shutil.rmtree(out, ignore_errors=True)
    return res


def _rank_main(target: str, out: str) -> None:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import importlib

    import torch
    torch.set_num_threads(1)
    from transmogrifai_tpu_torch.parallel import multihost
    assert multihost.initialize(), "the world did not form"
    mod, fn = target.split(":")
    res = getattr(importlib.import_module(mod), fn)()
    rank = int(os.environ["RANK"])
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    multihost.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
