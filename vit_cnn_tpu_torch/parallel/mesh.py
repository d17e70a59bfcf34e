"""Data parallelism over a ``torch.distributed`` process group.

Port of :mod:`vit_cnn_tpu.parallel.mesh`. The JAX package runs ONE
program over a 1-D ``data`` mesh: the patch batch (training) and the
band groups or window chunks (serving) are sharded over the devices, the
state is replicated, and XLA inserts the gradient psum. Because that one
program sees the global batch, train-mode BatchNorm statistics, the
losses' denominators and every random draw come out global.

The port runs ONE PROCESS PER DEVICE, and the calling process is rank 0:

* ``--n_devices`` keeps its JAX meaning: the mesh engages by itself when
  more than one device is visible, inside the process the user started;
* ``--serve`` keeps its stdin and stdout in that process (rank 0 reads
  each request and broadcasts it);
* torch's docs advise against ``DataParallel``'s single-process threads,
  which serialise the host.

:func:`make_mesh` starts ranks 1..n-1 with the ``spawn`` start method
(never ``fork``: the caller may hold threads, a test process JAX's) and
joins the group with them over TCP on 127.0.0.1 at a free port. Each
worker waits for tasks: :meth:`Mesh.run` hands ``fn`` and its arguments to
every worker and calls ``fn(mesh, ...)`` itself, so every rank runs the
same code; ``fn`` must be importable by name (a module-level function of
this package). Backend: NCCL when each rank has a card of its own, gloo
on the CPU and when the ranks share one card. Every collective is a sum
``all_reduce`` or a ``broadcast``, which gloo takes on CUDA tensors too,
so one code path serves all three.

The invariant: with world size n, a step is the world-size-1 step over
the global batch. Rank r's rows of every batch-leading tensor are rows
``[r*B/n, (r+1)*B/n)`` of the global one (:func:`shard_rows`); a batch
that n does not divide raises. What the step needs global is taken
inside :func:`engaged`: BatchNorm's sums (nn/layers.py), the losses'
denominators (:func:`global_sum`), the draws, made at the global shape
from the replicated generator and cut to the rank's rows (nn/noise.py,
pipeline/patches.py), and MoCo's keys (:func:`gather_rows`). Gradients
are then summed, never averaged (:func:`all_reduce_grads`).

A failure on any rank ends every rank: a worker reports its exception
to rank 0 and exits, which breaks the collective rank 0 waits in; rank 0
terminates the workers on its own failure, and re-raises the first
worker's exception (its type kept) where one failed. The group timeout
bounds every wait in a collective. Importing this module starts nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import multiprocessing
import os
import pickle
import queue
import socket
import sys
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

#: seconds any rank waits in one collective before it raises
GROUP_TIMEOUT_S = 300.0
#: seconds rank 0 waits for the workers' start (their imports included)
START_TIMEOUT_S = 120.0

# the mesh engaged by the running step, per thread and task
_engaged: contextvars.ContextVar = contextvars.ContextVar("mesh",
                                                          default=None)


class Mesh:
    """One rank's view of the group: ``rank``, ``world_size``, its
    ``device`` and the ``backend``. Rank 0's Mesh (from :func:`make_mesh`)
    also owns the workers: :meth:`run` runs a task on every rank,
    :meth:`close` (or leaving a ``with`` block) ends them. A world of 1
    has no group: every collective is the identity."""

    def __init__(self, rank: int, world_size: int, device: torch.device,
                 backend: Optional[str] = None):
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)
        self.backend = backend
        self._procs: List = []
        self._tasks: List = []
        self._reports = None
        self._closed = False

    # -- collectives -------------------------------------------------------
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place (not differentiable)."""
        if self.world_size > 1:
            dist.all_reduce(t)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        if self.world_size > 1:
            dist.broadcast(t, src)
        return t

    def broadcast_object(self, obj=None, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        if self.world_size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src)
        return box[0]

    # -- tasks (rank 0) ----------------------------------------------------
    def run(self, fn: Callable, *args, here: Optional[dict] = None,
            **kwargs):
        """Run ``fn(mesh, *args, **kwargs)`` on every rank and return rank
        0's result. ``here``: keyword arguments for rank 0's call only
        (streams, callbacks: what cannot go to another process). On any
        rank's failure the workers end and the exception is raised here:
        the first failed worker's, else rank 0's own."""
        if self.rank != 0:
            raise RuntimeError("Mesh.run is called on rank 0")
        if self._closed:
            raise RuntimeError("this mesh is closed")
        try:
            if self._tasks:
                task = pickle.dumps((fn, args, kwargs))
                for tasks in self._tasks:
                    tasks.put(task)
            return fn(self, *args, **dict(kwargs, **(here or {})))
        except BaseException as own:
            failed = self._worker_failure()
            self._abort()
            if failed is not None:
                raise failed from own
            raise

    def close(self) -> None:
        """End the workers and leave the group (rank 0); raises a
        worker's failure."""
        if self._closed or self.rank != 0:
            return
        self._closed = True
        for tasks in self._tasks:
            tasks.put(None)
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        failed = self._worker_failure()
        self._abort()
        if failed is not None:
            raise failed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._closed = True
            self._abort()
        return False

    def _worker_failure(self):
        """The exception the lowest failed worker reported, or a
        RuntimeError naming workers that ended without a report, or None.
        A worker reports before it exits, so its report is readable by
        the time its sockets close and rank 0's collective raises."""
        if self._reports is None:
            return None
        reports = []
        while not self._reports.empty():
            reports.append(self._reports.get())
        errors = [r for r in reports if r[0] == "error"]
        if errors:
            _, rank, exc, text = min(errors, key=lambda r: r[1])
            exc.add_note("raised on rank {} of {}:\n{}".format(
                rank, self.world_size, text))
            return exc
        lost = [(i + 1, p.exitcode) for i, p in enumerate(self._procs)
                if p.exitcode not in (None, 0)]
        if lost:
            return RuntimeError("mesh worker(s) ended without a report "
                                "(rank, exit code): {}".format(lost))
        return None

    def _abort(self) -> None:
        self._closed = True
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(10.0)
            if p.is_alive():
                p.kill()
                p.join(10.0)
        self._procs = []
        if dist.is_initialized():
            dist.destroy_process_group()


# -- the engaged mesh --------------------------------------------------------
@contextlib.contextmanager
def engaged(mesh: Optional[Mesh]):
    """Make ``mesh`` the current one inside the block (None: no mesh):
    BatchNorm's statistics, :func:`global_sum`, the draws and
    :func:`gather_rows` then span its ranks."""
    token = _engaged.set(mesh if mesh is not None and mesh.world_size > 1
                         else None)
    try:
        yield mesh
    finally:
        _engaged.reset(token)


def current() -> Optional[Mesh]:
    """The engaged mesh of more than one rank, or None."""
    return _engaged.get()


def world_size() -> int:
    m = current()
    return m.world_size if m is not None else 1


def shard_rows(x, mesh: Optional[Mesh] = None):
    """This rank's rows ``[r*B/n, (r+1)*B/n)`` of ``x``'s first axis (of
    ``mesh``, else the engaged one; ``x`` itself without either). Raises
    when n does not divide B."""
    mesh = mesh if mesh is not None else current()
    if mesh is None or mesh.world_size == 1:
        return x
    n, b = mesh.world_size, len(x)
    if b % n:
        raise ValueError("a batch of {} does not split over {} ranks".format(
            b, n))
    return x[mesh.rank * (b // n):(mesh.rank + 1) * (b // n)]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward is the same sum of the
    cotangents (each rank's loss is its share of the global one)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the engaged mesh's ranks (differentiable), or
    ``x`` without one."""
    if current() is None:
        return x
    return _AllReduceSum.apply(x)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The (n*b, ...) global batch of every rank's (b, ...) rows, in rank
    order: a zero-filled buffer holding this rank's rows, summed (not
    differentiable). ``x`` itself without an engaged mesh."""
    mesh = current()
    if mesh is None:
        return x
    b = x.shape[0]
    full = x.new_zeros((mesh.world_size * b,) + tuple(x.shape[1:]))
    full[mesh.rank * b:(mesh.rank + 1) * b] = x.detach()
    return mesh.sum_(full)


def _flat_groups(tensors):
    """{dtype: [tensors]} in order."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def all_reduce_grads(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Sum every parameter's gradient over the ranks, one flattened
    bucket a dtype."""
    if mesh is None or mesh.world_size == 1:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    for group in _flat_groups(grads):
        flat = mesh.sum_(torch.cat([g.reshape(-1) for g in group]))
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def broadcast_module(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Rank 0's parameters and buffers on every rank (JAX ``replicate``),
    one flattened bucket a dtype."""
    if mesh is None or mesh.world_size == 1:
        return
    tensors = list(model.parameters()) + list(model.buffers())
    with torch.no_grad():
        for group in _flat_groups(tensors):
            flat = mesh.broadcast_(torch.cat([t.reshape(-1) for t in group]))
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


# -- starting the group -------------------------------------------------------
def visible_devices(device="cuda") -> int:
    """The devices a mesh on ``device``'s type may span: the CUDA cards,
    or 1 on the CPU (where only an explicit size makes a mesh)."""
    device = torch.device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _settings() -> dict:
    """The caller's numerics settings, which the workers take on."""
    return {"threads": torch.get_num_threads(),
            "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32,
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "matmul_precision": torch.get_float32_matmul_precision()}


def _apply_settings(s: dict) -> None:
    torch.set_num_threads(s["threads"])
    torch.backends.cuda.matmul.allow_tf32 = s["tf32_matmul"]
    torch.backends.cudnn.allow_tf32 = s["tf32_cudnn"]
    torch.use_deterministic_algorithms(s["deterministic"])
    torch.set_float32_matmul_precision(s["matmul_precision"])


def _init_group(rank, world, device, backend, port) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="tcp://127.0.0.1:{}".format(port), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _report(reports, *item) -> None:
    try:
        reports.put(item)
    except Exception:                       # an exception that won't pickle
        reports.put(item[:2] + (RuntimeError(repr(item[2])),) + item[3:])


def _worker(rank, world, device, backend, port, settings, tasks, reports):
    """Rank ``rank``: join the group, run the tasks rank 0 hands over
    until None, then leave. On a failure: report it and exit at once, so
    that the sockets close and rank 0's collective raises."""
    parent = multiprocessing.parent_process()
    try:
        _apply_settings(settings)
        reports.put(("ready", rank, None, None))
        _init_group(rank, world, device, backend, port)
        mesh = Mesh(rank, world, device, backend)
        while True:
            try:
                task = tasks.get(timeout=1.0)
            except queue.Empty:
                if parent is not None and not parent.is_alive():
                    os._exit(1)
                continue
            if task is None:
                break
            fn, args, kwargs = pickle.loads(task)
            fn(mesh, *args, **kwargs)
        dist.destroy_process_group()
    except BaseException as e:              # noqa: B902 — every failure ends
        _report(reports, "error", rank, e,
                traceback.format_exc()[-20000:])
        sys.stderr.flush()
        os._exit(1)


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              share: bool = False) -> Mesh:
    """Rank 0 of a group of ``n_devices`` processes (all visible devices
    by default), this process included; ranks 1..n-1 start here.

    ``device`` 'cuda': rank r on card r over NCCL (more ranks than cards
    raises); with ``share``, every rank on ``device`` (card 0 unless it
    names one) over gloo. 'cpu': every rank on the CPU over gloo. A size
    of 1 starts nothing. The workers take this process's thread count,
    TF32 and determinism settings."""
    device = torch.device(device)
    visible = visible_devices(device)
    n = int(n_devices) if n_devices is not None else visible
    if n < 1:
        raise ValueError("n_devices {} < 1".format(n))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh without CUDA")
        if not share and n > visible:
            raise ValueError("n_devices {}: {} CUDA device(s) visible".format(
                n, visible))
        devices = ([torch.device("cuda", device.index or 0)] * n if share
                   else [torch.device("cuda", r) for r in range(n)])
        backend = "gloo" if share else "nccl"
    else:
        devices, backend = [device] * n, "gloo"
    if n == 1:
        return Mesh(0, 1, devices[0])
    if dist.is_initialized():
        raise RuntimeError("a process group is already active in this "
                           "process: close its mesh first")

    ctx = multiprocessing.get_context("spawn")
    port, settings = _free_port(), _settings()
    mesh = Mesh(0, n, devices[0], backend)
    mesh._reports = ctx.SimpleQueue()
    for r in range(1, n):
        tasks = ctx.Queue()
        p = ctx.Process(target=_worker, daemon=True, name="mesh-rank{}".format(
            r), args=(r, n, str(devices[r]), backend, port, settings, tasks,
                      mesh._reports))
        p.start()
        mesh._procs.append(p)
        mesh._tasks.append(tasks)
    try:
        ready, deadline = 0, time.monotonic() + START_TIMEOUT_S
        while ready < n - 1:
            if not mesh._reports.empty():
                report = mesh._reports.get()
                if report[0] != "ready":
                    mesh._reports.put(report)     # for _worker_failure
                    raise RuntimeError("a mesh worker failed to start")
                ready += 1
            elif (time.monotonic() > deadline
                  or any(not p.is_alive() for p in mesh._procs)):
                raise RuntimeError("a mesh worker failed to start")
            else:
                time.sleep(0.02)
        _init_group(0, n, devices[0], backend, port)
    except BaseException as own:
        failed = mesh._worker_failure()
        mesh._abort()
        if failed is not None:
            raise failed from own
        raise
    return mesh
