"""Ranks of a ``torch.distributed`` process group, and the port's one
collective layer.

``spawn(fn, world, ...)`` starts ``world`` rank processes, each joining a
group through a ``FileStore`` in a fresh directory (no fixed port, so
groups started side by side never meet), runs ``fn(rank, world, *args)``
in each and returns rank 0's result. A rank that raises, exits or
outlives ``timeout`` fails the whole call: the parent kills the others and
raises. ``init_rank`` is the same join for a process started by someone
else (``torchrun``'s environment).

The ranks' collectives go through gloo, on the CPU and on the card (the
ranks share one card there; NCCL refuses two ranks on one GPU). On the
card gloo does not reliably carry CUDA tensors (on an H100 with PyTorch
2.11 its send/recv of one fails and an all-gather inside DTensor crashes
the process: PERF.md), so there the group is a ``StagedGroup``:
every collective's tensors are staged through pinned host memory, the
bytes counted (``staged_bytes``). The ranks' compute stays on their
device: a rank that cannot get its device raises.
"""
from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

_STATE = {"device": torch.device("cpu")}
# how long the CLIs' spawned ranks may run before the run fails
CLI_TIMEOUT_S = 3600.0
STAGED_BYTES = {"bytes": 0, "calls": 0}


class StagedGroup(dist.ProcessGroup):
    """The ranks' process group on the card: a gloo group over host memory
    that every collective goes through, a CUDA tensor copied to pinned
    host memory first and its result copied back (``staged_bytes`` counts
    the bytes each way). Gloo crashes on some collectives of CUDA tensors
    when S processes share one card (PERF.md), and NCCL refuses
    two ranks on one GPU; host tensors go to gloo as they are. A Python
    process group: DTensor and ``torch.distributed`` reach it through
    PyTorch's ``ProcessGroup`` trampoline, under both the method names of
    PyTorch 2.13 and their older ones. Every call is synchronous: the
    returned work is done."""

    def __init__(self, store, rank: int, size: int, timeout, name: str):
        super().__init__(rank, size)
        # the group's registered name (DeviceMesh and DTensor's collectives
        # look groups up by it): this object replaces the one named
        self._name = name
        self._gloo = dist.ProcessGroupGloo(
            dist.PrefixStore("staged/", store), rank, size, timeout)
        self._rank, self._size = rank, size

    # -- staging --------------------------------------------------------
    def _in(self, t: torch.Tensor) -> torch.Tensor:
        if not t.is_cuda:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                        pin_memory=True)
        h.copy_(t)
        STAGED_BYTES["bytes"] += h.numel() * h.element_size()
        STAGED_BYTES["calls"] += 1
        return h

    def _buf(self, t: torch.Tensor) -> torch.Tensor:
        """Host memory for an output (nothing to copy in)."""
        if not t.is_cuda:
            return t
        return torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=True)

    def _out(self, t: torch.Tensor, h: torch.Tensor) -> None:
        if h is not t:
            t.copy_(h)
            STAGED_BYTES["bytes"] += h.numel() * h.element_size()

    @staticmethod
    def _done(result=None):
        from torch._C._distributed_c10d import _create_work_from_future
        from torch.futures import Future
        fut = Future()
        fut.set_result(result)
        return _create_work_from_future(fut)

    # -- collectives ----------------------------------------------------
    def allreduce(self, tensors, opts=None):
        hs = [self._in(t) for t in tensors]
        self._gloo.allreduce(hs, opts or dist.AllreduceOptions()).wait()
        for t, h in zip(tensors, hs):
            self._out(t, h)
        return self._done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        for t in tensors:
            o = dist.AllreduceOptions()
            if opts is not None:
                o.reduceOp = opts.reduceOp
            self.allreduce([t], o)
        return self._done(tensors)

    def broadcast(self, tensors, opts=None):
        hs = [self._in(t) for t in tensors]
        self._gloo.broadcast(hs, opts or dist.BroadcastOptions()).wait()
        for t, h in zip(tensors, hs):
            self._out(t, h)
        return self._done(tensors)

    def allgather(self, output_tensors, input_tensors, opts=None):
        hin = [self._in(t) for t in input_tensors]
        hout = [[self._buf(t) for t in outs] for outs in output_tensors]
        self._gloo.allgather(hout, hin, opts or dist.AllgatherOptions()
                             ).wait()
        for outs, hs in zip(output_tensors, hout):
            for t, h in zip(outs, hs):
                self._out(t, h)
        return self._done(output_tensors)

    def all_gather_single(self, output, input, opts=None):
        hin, hout = self._in(input), self._buf(output)
        self._gloo._allgather_base(hout, hin.contiguous(),
                                   opts or dist.AllgatherOptions()).wait()
        self._out(output, hout)
        return self._done(output)

    _allgather_base = all_gather_single

    def all_gather_single_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return self._done(outputs)

    allgather_into_tensor_coalesced = all_gather_single_coalesced

    def reduce_scatter(self, output_tensors, input_tensors, opts=None):
        for o, ins in zip(output_tensors, input_tensors):
            self.reduce_scatter_single(o, torch.cat(
                [t.reshape(-1) for t in ins]).reshape(
                    (len(ins),) + tuple(o.shape)), opts)
        return self._done(output_tensors)

    def reduce_scatter_single(self, output, input, opts=None):
        hin, hout = self._in(input), self._buf(output)
        self._gloo._reduce_scatter_base(
            hout, hin.contiguous(), opts or dist.ReduceScatterOptions()
        ).wait()
        self._out(output, hout)
        return self._done(output)

    _reduce_scatter_base = reduce_scatter_single

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return self._done(outputs)

    reduce_scatter_tensor_coalesced = reduce_scatter_single_coalesced

    def all_to_all_single(self, output, input, output_split_sizes,
                          input_split_sizes, opts=None):
        hin, hout = self._in(input), self._buf(output)
        self._gloo.alltoall_base(hout, hin.contiguous(),
                                 list(output_split_sizes),
                                 list(input_split_sizes),
                                 opts or dist.AllToAllOptions()).wait()
        self._out(output, hout)
        return self._done(output)

    alltoall_base = all_to_all_single

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return self._done()

    def send(self, tensors, dst: int, tag: int = 0):
        self._gloo.send([self._in(t) for t in tensors], dst, tag).wait()
        return self._done(tensors)

    def recv(self, tensors, src: int, tag: int = 0):
        hs = [self._buf(t) for t in tensors]
        self._gloo.recv(hs, src, tag).wait()
        for t, h in zip(tensors, hs):
            self._out(t, h)
        return self._done(tensors)

    def size(self):
        return self._size

    def getBackendName(self):
        return "staged"

    def getGroupName(self):
        return self._name

    @property
    def group_name(self):
        return self._name

    @property
    def pg_name(self):
        return self._name


def _create_staged(opts, backend_options):
    return StagedGroup(opts.store, opts.group_rank, opts.group_size,
                       opts.timeout, opts.group_id)


dist.Backend.register_backend("staged", _create_staged, extended_api=True,
                              devices=["cpu", "cuda"])


def rank_device() -> torch.device:
    """The device this rank computes on (``cpu`` outside a group)."""
    return _STATE["device"]


def staged_bytes() -> dict:
    """{"bytes", "calls"} staged through host memory by this process."""
    return dict(STAGED_BYTES)


def reset_staged() -> None:
    STAGED_BYTES.update(bytes=0, calls=0)


def init_rank(rank: int, world: int, store_dir: Optional[str] = None,
              device: str = "cuda", timeout_s: float = 300.0,
              staged: Optional[bool] = None) -> torch.device:
    """Join the group as ``rank`` of ``world`` through a ``FileStore`` in
    ``store_dir`` (None: ``torchrun``'s environment), computing on
    ``device`` ("cuda": the card ``LOCAL_RANK`` modulo the cards there;
    "cpu"). The group is a ``StagedGroup`` (``staged``, the default on a
    card) or gloo's own. Raises when a card is asked for and there is
    none."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        # ranks sharing a card: the allocator's segments grow in place
        # rather than fragment each rank's share
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _STATE["device"] = dev
    if staged is None:
        staged = dev.type == "cuda"
    kw = dict(backend="staged" if staged else "gloo", rank=rank,
              world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store_dir is not None:
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group(store=store, **kw)
    else:
        dist.init_process_group(**kw)
    return dev


def _rank_main(rank, world, store_dir, device, fn, args, q, timeout_s,
               staged):
    # a rank killed by a signal still prints where it was
    faulthandler.enable()
    code = 0
    try:
        init_rank(rank, world, store_dir, device, timeout_s, staged)
        with open(args, "rb") as f:
            out = fn(rank, world, *pickle.load(f))
        dist.barrier()
        if rank == 0:
            # pickled to a file: tensors travel by value, not as handles
            # to shared memory that dies with this process
            with open(os.path.join(store_dir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
        q.put((rank, "ok", None))
    except BaseException:
        code = 1
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        # the result reaches the pipe, then the rank ends without waiting
        # on threads its imports left behind
        q.close()
        q.join_thread()
        os._exit(code)


def spawn(fn: Callable, world: int, args: tuple = (), *, device: str = "cuda",
          timeout: float = 600.0, staged: Optional[bool] = None):
    """``fn(rank, world, *args)`` in ``world`` spawned rank processes
    joined into one group (``init_rank``'s; ``staged`` picks it) computing
    on ``device``; rank 0's return value (it must pickle). ``fn`` must be
    importable (a module-level function). Raises ``RuntimeError`` with the
    failing rank's traceback if any rank raises or dies, and
    ``TimeoutError`` if the group has not finished within ``timeout``
    seconds; either way no rank outlives the call."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="repro_ranks_")
    # the arguments go through a file: large ones handed to the process
    # start cost seconds a rank
    blob = os.path.join(store_dir, "args.pkl")
    with open(blob, "wb") as f:
        pickle.dump(tuple(args), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store_dir, device, fn, blob, q,
                               timeout, staged), daemon=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    results, error, result = {}, None, None
    try:
        for p in procs:
            p.start()
        while len(results) < world and error is None:
            try:
                rank, status, out = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    error = RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    error = TimeoutError(
                        f"{world} ranks did not finish in {timeout} s "
                        f"(done: {sorted(results)})")
                continue
            if status == "error":
                error = RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, min(30.0, deadline - time.monotonic())))
        if error is None:
            with open(os.path.join(store_dir, "result.pkl"), "rb") as f:
                result = pickle.load(f)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    if error is not None:
        raise error
    return result


# ---------------------------------------------------------------------------
# the collectives the port calls itself (DTensor calls the rest)
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with equal splits along dim 0 over ``group``:
    chunk j of rank i lands as chunk i of rank j. The map is its own
    inverse, so the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable equal-split all-to-all of ``_AllToAll``."""
    return _AllToAll.apply(x, group)
