"""Rank groups and host-staged collectives on ``torch.distributed`` (the
port's stand-in for the JAX package's device-mesh runtime).

``run_ranks(fn, world, *args, device=...)`` spawns ``world`` ranks with the
``spawn`` start method (CUDA cannot be forked after it is initialized),
joins them to one gloo group through a ``file://`` rendezvous in a fresh
temporary folder (no TCP port, so concurrent groups cannot collide), runs
``fn(device, *args)`` on each and returns the ranks' results in rank
order. Every rank gets the same explicit ``device``: ``cuda:0`` on a
one-card machine, where the ranks share the card time-sliced, or ``cpu``.
Asking for CUDA with no card raises; nothing falls back to the CPU. With
CUDA the parent builds the kernel library first, so the ranks load it
instead of each running ``nvcc``. The group has a timeout
(``TIMEOUT_S``), and the parent joins the ranks with a deadline: past it,
or as soon as one rank fails, it kills the rest and raises with each
rank's traceback, so a hung rendezvous or collective fails fast.

Under ``torchrun`` (``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` in the
environment) ``init_from_env`` joins the group it describes instead, each
rank on its own card (``cuda:LOCAL_RANK``).

The collectives stage their tensor through the host: gloo moves CPU
tensors only, and NCCL refuses two ranks on one device. On a CPU tensor the
staging step is a no-op, so the CPU tests run the very same code. Each
helper adds its wall time to ``COLLECTIVE_S`` (the host-staged share of a
forward that the chip smoke reports).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import signal
import tempfile
import time
import traceback
import warnings

import torch
import torch.distributed as dist

TIMEOUT_S = 60  # the process group's timeout: a rendezvous or collective that waits longer raises
RANK_THREADS = 1  # torch threads per CPU rank, so that ranks do not oversubscribe the cores
COLLECTIVE_S = [0.0]  # seconds spent in this process's collectives (host staging included)


def rank_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} needs a CUDA device and none is available; "
                               f"pass device='cpu' to run the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def under_torchrun() -> bool:
    """True when the environment describes a group (torchrun's variables)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def init_from_env(device, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the gloo group that torchrun's environment describes. A bare
    ``cuda`` means this rank's card, ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = rank_device(dev)
    dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def map_tensors(tree, fn):
    """``fn`` applied to every tensor leaf of nested dicts, lists, tuples,
    NamedTuples and dataclasses; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_tensors(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def _to_cpu(tree):
    return map_tensors(tree, lambda t: t.detach().cpu())


def _rank_main(r, world, rdzv, out_dir, device, threads, group_timeout_s):
    """One spawned rank: join the group, run the pickled ``fn(device,
    *args)``, leave its result (or its traceback) in ``out_dir``."""
    torch.set_num_threads(threads)
    try:
        with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=r, world_size=world,
                                timeout=datetime.timedelta(seconds=group_timeout_s))
        out = _to_cpu(fn(dev, *args))
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{r}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_ranks(fn, world: int, *args, device="cuda", timeout_s: float | None = 600.0,
              threads: int = RANK_THREADS, group_timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(device, *args)`` on ``world`` spawned ranks of one gloo group;
    returns their results (tensors moved to the CPU) in rank order.

    ``fn`` must be importable by name (a module-level function); ``fn`` and
    ``args`` go to the ranks through a pickle file (plain pickle: the
    caller's tensors are not moved to shared memory). Raises RuntimeError with every failed rank's
    traceback if any rank fails, and TimeoutError (after killing the ranks)
    if they are not all done within ``timeout_s`` (None: no deadline; a
    rank blocked in a collective still fails after ``group_timeout_s``). ``group_timeout_s``: the
    process group's timeout (how long a rank waits in a collective)."""
    import torch.multiprocessing as mp

    if world < 1:
        raise ValueError(f"run_ranks needs world >= 1, got {world}")
    dev = rank_device(device)
    if dev.type == "cuda":
        from ..ops import _lib

        _lib.library()  # one nvcc build here, not one per rank
    tmp = tempfile.mkdtemp(prefix="p2v_ranks_")
    try:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, _to_cpu(args)), f)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, os.path.join(tmp, "rdzv"), tmp, str(dev), threads, group_timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        failed_at = None
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = now  # the others may be blocked in a collective with the failed rank
            if (deadline is not None and now > deadline) or (failed_at is not None and now > failed_at + 5.0):
                break
            time.sleep(0.02)
        timed_out = any(p.is_alive() for p in procs) and failed_at is None
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGKILL)
            p.join()
        errs = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errs.append(f"rank {r}: exit code {p.exitcode}")
        if timed_out:
            raise TimeoutError(f"{world} ranks not done within {timeout_s} s; killed\n" + "\n".join(errs))
        if errs:
            raise RuntimeError(f"{len(errs)} of {world} ranks failed\n" + "\n".join(errs))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Host-staged collectives
# ---------------------------------------------------------------------------


class _Timed:
    def __enter__(self):
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        COLLECTIVE_S[0] += time.perf_counter() - self.t


def _host(t: torch.Tensor) -> torch.Tensor:
    """The staging copy: a contiguous CPU tensor (no copy for one)."""
    return t.detach().to("cpu").contiguous()


def all_reduce(t: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """Elementwise SUM, MIN or MAX over the group; returns a new tensor on
    ``t``'s device. Integer SUM is exact in any order."""
    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    with _Timed():
        h = _host(t).clone()
        dist.all_reduce(h, op=ops[op], group=group)
        return h.to(t.device)


def reduce_scatter_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """SUM over the group, then this rank's block of rows (the i-th of
    ``size`` equal blocks for group rank i): ``psum_scatter(tiled=True)``."""
    with _Timed():
        n = dist.get_world_size(group)
        h = _host(t)
        if h.shape[0] % n:
            raise ValueError(f"reduce_scatter_rows: {h.shape[0]} rows do not split into {n} blocks")
        out = torch.empty((h.shape[0] // n, *h.shape[1:]), dtype=h.dtype)
        with warnings.catch_warnings():  # newer torch renames it reduce_scatter_single
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, h, op=dist.ReduceOp.SUM, group=group)
        return out.to(t.device)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in group-rank order
    (``all_gather(tiled=True)``); equal shapes on every rank."""
    with _Timed():
        n = dist.get_world_size(group)
        h = _host(t)
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts, dim=0).to(t.device)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of the global rank ``src`` on every rank of the group (each
    passes a tensor of the same shape and dtype)."""
    with _Timed():
        h = _host(t).clone()
        dist.broadcast(h, src=src, group=group)
        return h.to(t.device)


def send(t: torch.Tensor, dst: int) -> None:
    with _Timed():
        dist.send(_host(t), dst=dst)


def recv(shape, dtype, src: int, device) -> torch.Tensor:
    with _Timed():
        h = torch.empty(shape, dtype=dtype)
        dist.recv(h, src=src)
        return h.to(device)


def broadcast_object(obj, src: int = 0, device=None):
    """A picklable object (tensor leaves staged through the host) from rank
    ``src`` to every rank; tensors land on ``device``."""
    with _Timed():
        box = [_to_cpu(obj) if dist.get_rank() == src else None]
        dist.broadcast_object_list(box, src=src)
    return box[0] if device is None else map_tensors(box[0], lambda t: t.to(device))
