"""Start the ranks of a sharded run: the counterpart of a JAX mesh over
``jax.devices()``.

``spawn(fn, world, backend=..., device=...)`` starts ``world`` processes
with the ``spawn`` start method. Each one joins a process group through a
``file://`` store in a temporary directory of its own (no TCP port, so runs
side by side never collide), sets one torch thread, and calls ``fn(rank,
world, device, *args)``; ``spawn`` returns each rank's result, in rank
order, or raises with the first failing rank's traceback. ``fn`` must be a
module-level function of an importable module that does not import JAX
(the child imports the module that defines it).

The backend and the device are the caller's explicit choice; nothing picks
another behind it:

* ``backend="nccl"``: rank r on ``cuda:r``; it raises when the machine has
  fewer cards than ranks (NCCL refuses two ranks on one card).
* ``backend="gloo", device="cuda"``: every rank on ``cuda:0``. The kernels
  run on the card at each rank's sharded shapes; the collectives are staged
  through the host (``parallel/collectives.py``). This shows that the
  sharded program is right on the card, not the speed of several cards.
* ``backend="gloo", device="cpu"``: CPU ranks, as the tests run them.

Every collective and the join wait at most ``timeout_s``: a rank that hangs
fails the call (its processes are killed) instead of running into an outer
time limit.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

BACKENDS = ("nccl", "gloo")


def _devices(backend: str, device: str, world: int):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if backend == "nccl":
        import torch

        if device != "cuda":
            raise ValueError("the nccl backend runs on the card: pass device='cuda'")
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"nccl needs a card a rank: {world} ranks, {torch.cuda.device_count()} cards")
        return [f"cuda:{r}" for r in range(world)]
    return ["cuda:0" if device == "cuda" else "cpu"] * world


def _entry(rank: int, world: int, backend: str, device: str, store: str, timeout_s: float, payload: str, out: str):
    """A rank: join the group, run ``fn`` (read with its arguments from the
    ``payload`` file), write its result (or traceback)."""
    result = None
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = ("ok", fn(rank, world, device, *args))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent raises it with the rank's traceback
        result = ("error", traceback.format_exc())
    with open(out + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".part", out)
    if result[0] == "error":
        os._exit(1)


@contextlib.contextmanager
def _main_without_a_missing_file():
    """A child re-runs the parent's main script from its ``__file__``; a main
    read from stdin has the name ``<stdin>``, which no child can open. The
    ranks never need the main module (``fn`` lives in an importable one),
    so such a name is hidden while the children start."""
    main = sys.modules.get("__main__")
    path = getattr(main, "__file__", None)
    hide = path is not None and not os.path.exists(path)
    if hide:
        del main.__file__
    try:
        yield
    finally:
        if hide:
            main.__file__ = path


def spawn(fn, world: int, *args, backend: str, device: str, timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks (module
    docstring); returns the ranks' results in rank order. Raises
    ``RuntimeError`` with the traceback of the first rank that failed, and
    ``TimeoutError`` when the ranks have not all ended within ``timeout_s``
    (then every rank still running is killed)."""
    if world < 1:
        raise ValueError(f"world must be at least 1, got {world}")
    devices = _devices(backend, device, world)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ff_ranks_")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
    # The function and its arguments go through a file: a start's pipe
    # then carries a few hundred bytes, so a child that dies at start-up
    # cannot leave the parent blocked writing to it.
    payload = os.path.join(tmp, "payload.pkl")
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_entry, args=(r, world, backend, devices[r], os.path.join(tmp, "store"), timeout_s,
                                                payload, outs[r]), daemon=True)
             for r in range(world)]
    try:
        with _main_without_a_missing_file():
            for p in procs:
                p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > deadline:
                late = [r for r, p in enumerate(procs) if p.exitcode is None]
                raise TimeoutError(f"ranks {late} of {world} still running after {timeout_s:.0f} s")
            time.sleep(0.05)
        if failed:
            r = failed[0]
            detail = f"exit code {procs[r].exitcode}"
            if os.path.exists(outs[r]):
                with open(outs[r], "rb") as f:
                    detail = pickle.load(f)[1]
            raise RuntimeError(f"rank {r} of {world} failed:\n{detail}")
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f)[1])
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
