"""The tensor-parallel serving mesh — the port's counterpart of the
reference's `serving_mesh` (`paddle_tpu/parallel/hybrid.py`), a 1-D "mp"
mesh of devices that one JAX process drives.

PyTorch drives one device a process, so a `ServingMesh` of degree mp is
rank 0, living in the caller's process, and ranks 1..mp-1 as worker
processes started with the `spawn` method.  All of them join one
`torch.distributed` process group (gloo or NCCL, built directly on a
`FileStore` in a fresh temporary directory, so several meshes can live in
one process and no fixed port is taken).  The group has an explicit
timeout, and so has every wait for a worker.

Rank 0 holds all host state; a worker holds only its shard of each
engine's weights and of its KV pool, and runs a loop over commands from
rank 0 on a pipe: make an engine (`attach`), declare a step program,
build it, stage its inputs and run it (the mirror of
`inference.graphs.StepProgram`), drop an engine, or call a function
(`run`, for tests and the smoke's kernel checks).  The staged inputs are
small int32 arrays and go by pickle on the pipe; weights go once, through
the pipe's shared-memory tensors (CPU) or CUDA IPC, and each worker copies
its shard to its own device.  Engines that share a mesh (a fleet's
replicas) share those shards: `attach(weights_of=)` points a worker's new
engine at another engine's.  A worker draws the sampled lane's Gumbel
noise itself, from a generator seeded like rank 0's.  Host copies of an
engine's pool go through its `HostSlabs`, shared host memory handed to
the workers once and reused.  `lock` orders the pipe: a request and its
reply, or a program's message and rank 0's own run of it, are one span
that no other thread's traffic enters.

The model functions see a rank through `mesh=`: `mp`, `rank`, `device`
and `all_reduce(t, op)` (SUM, MAX or MIN, in place).  All-reduce is the
only collective the serving model uses, so one path works under NCCL and
under gloo with CUDA tensors.

The same mesh carries training (`parallel.hybrid.HybridParallelTrainer`):
`group(name, ranks)` gives a `Group` over some of the ranks, its process
group built once per rank list on a `PrefixStore` of the mesh's store, and
the rank handle runs `all_reduce`, `broadcast`, `all_gather` and
`reduce_scatter` on it (gloo takes all four on CUDA tensors too, staging
them through host memory itself), the pipeline's `isend` and `recv`, the
ring's `exchange` (a send and a receive as one coalesced NCCL call, on a
group connected as it is made) and the ep exchange's tiled
`all_to_all`.  Gloo's send and recv do not take
CUDA tensors (they pass the device pointer to the socket), so those two go
through host memory in `MeshRank` (counted as "<group>.<op>_host").  Every call is counted with its bytes (`comm`), and
every wait has the mesh's timeout.  `first(n)` lends a trainer of n ranks
the first n of a larger mesh.

A worker dies with its parent: it polls the parent's pid, its pipe ends
when the parent's does, and it is a daemon process.  A failing worker
sends its traceback to rank 0 and exits; rank 0 raises it at its next
collective (whose peer is gone) or its next wait.  Nothing falls back:
NCCL with fewer cards than ranks raises, and so does a device list that
does not fit the backend.
"""
from __future__ import annotations

import datetime
import functools
import itertools
import multiprocessing
import os
import shutil
import tempfile
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing  # noqa: F401  (tensor reductions for pipes)

# seconds a collective or a worker reply may take before it raises
DEFAULT_TIMEOUT_S = 300.0
# a worker polls its parent this often
_PARENT_POLL_S = 1.0

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _process_group(backend: str, store, rank: int, size: int,
                   timeout_s: float):
    timeout = datetime.timedelta(seconds=timeout_s)
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._devices = [
            dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
        opts._timeout = timeout
        return dist.ProcessGroupGloo(store, rank, size, opts)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    return dist.ProcessGroupNCCL(store, rank, size, opts)


class MeshRank:
    """One rank's handle on the mesh: what the model functions read from
    `mesh=`."""

    mp: int
    rank: int
    device: torch.device
    backend: str

    def _setup(self, mp, rank, device, backend, store_path, timeout_s):
        self.mp, self.rank = mp, rank
        self.device, self.backend = device, backend
        self.timeout_s = timeout_s
        self._store = dist.FileStore(store_path, mp)
        self._pg = _process_group(backend, self._store, rank, mp, timeout_s)
        self._pgs: Dict[tuple, Any] = {tuple(range(mp)): self._pg}
        self.comm: Dict[str, List[int]] = {}    # "group.op" -> [calls, bytes]
        # what functions run on this rank (`ServingMesh.run`) keep between
        # calls, such as a trainer's rank state
        self.state: Dict[str, Any] = {}

    def group(self, name: str, ranks: Sequence[int], link: bool = False,
              connect: bool = False) -> "Group":
        """The group `name` over `ranks` (this rank among them).  Its
        process group is built at the first request for that rank set, on
        a prefix of the mesh's store; every member must ask for it in the
        same order.  A `link` (a pipeline's point-to-point link, or a
        ring's group) has a process group of its own, shared with no
        collective group over the same ranks.  `connect`: an NCCL
        communicator is built as the group is made, on every member at
        once (`eager_connect_single_device`), not at its first call (gloo
        always connects as it makes a group).  A group of one rank runs
        no collective."""
        ranks = tuple(ranks)
        if self.rank not in ranks:
            raise ValueError(f"rank {self.rank} is not in group {name} "
                             f"{ranks}")
        key = ("link",) + ranks if link else ranks
        pg = self._pgs.get(key)
        if pg is None and len(ranks) > 1:
            store = dist.PrefixStore(
                ("l" if link else "g") + "-".join(map(str, ranks)),
                self._store)
            pg = _process_group(self.backend, store, ranks.index(self.rank),
                                len(ranks), self.timeout_s)
            self._pgs[key] = pg
            self._new_pg(pg)
            if connect and self.backend == "nccl":
                pg.eager_connect_single_device(self.device)
        return Group(self, name, ranks, pg)

    def _new_pg(self, pg) -> None:
        """A process group this rank built for a `Group`."""

    def _count(self, group, op: str, t: torch.Tensor):
        """Count one call of `op` moving `t` under "<group>.<op>": `group`
        a Group, None (the world) or a name."""
        name = "world" if group is None else getattr(group, "name", group)
        c = self.comm.setdefault(f"{name}.{op}", [0, 0])
        c[0] += 1
        c[1] += t.numel() * t.element_size()

    def _wait(self, work) -> None:
        try:
            if self.backend == "gloo":
                # a gloo point-to-point wait has no timeout of its own
                work.wait(datetime.timedelta(seconds=self.timeout_s))
            else:
                work.wait()
        except RuntimeError as e:
            self._collective_failed(e)

    def _staged(self, op: str, group, t: torch.Tensor) -> bool:
        """Whether the send or recv `op` of `t` goes through host memory: a
        CUDA tensor under gloo, whose send and recv do not take one.
        Counted as "<group>.<op>_host" (`group` as in `_count`)."""
        if self.backend != "gloo" or t.device.type != "cuda":
            return False
        self._count(group, op + "_host", t)
        return True

    def exchange(self, t: torch.Tensor, dst: int, src: int,
                 group: "Group", labels=None) -> "Exchange":
        """Send `t` to the group's member `dst` and receive a tensor of
        `t`'s shape and dtype from member `src`, as one pair: under NCCL
        one coalesced call (`_start_coalescing` ... `_end_coalescing`, on
        the group's own communicator), so that NCCL starts the send and the
        receive together and a ring of such pairs cannot wait on itself;
        gloo, which coalesces nothing, posts both at once.  The returned
        handle's `wait()` gives the received tensor on the rank's device.
        `labels`: the (send, recv) names the two are counted under
        (default the group's), so a ring counts each direction apart."""
        send_as, recv_as = labels or (group, group)
        x = t.detach().contiguous()
        buf = torch.empty_like(x, device=self.device)
        self._count(send_as, "send", x)
        self._count(recv_as, "recv", buf)
        host = None
        if self._staged("send", send_as, x):
            x = x.cpu()
        if self._staged("recv", recv_as, buf):
            host = torch.empty(buf.shape, dtype=buf.dtype)
        pg = group.pg
        if pg.supports_coalescing:
            _coalescing(pg._start_coalescing, self.device)
            pg.send([x], dst, 0)
            pg.recv([buf if host is None else host], src, 0)
            works = [_coalescing(pg._end_coalescing, self.device)]
        else:
            works = [pg.recv([buf if host is None else host], src, 0),
                     pg.send([x], dst, 0)]
        return Exchange(self, works, x, buf, host)

    def isend(self, t: torch.Tensor, dst: int, group: "Group") -> "Sent":
        """Start sending `t` to the group's member `dst` (an index into
        `group.ranks`); the returned handle's `wait()` ends the send, and it
        keeps the data alive until then.  Sends and receives between two
        members are matched in the order they are made."""
        x = t.detach().contiguous()
        self._count(group, "send", x)
        if self._staged("send", group, x):
            x = x.cpu()
        return Sent(self, group.pg.send([x], dst, 0), x)

    def recv(self, shape, dtype: torch.dtype, src: int,
             group: "Group") -> torch.Tensor:
        """The next tensor member `src` sends this rank in `group`, of the
        `shape` and `dtype` both sides know, on the rank's device."""
        buf = torch.empty(shape, dtype=dtype, device=self.device)
        self._count(group, "recv", buf)
        if self._staged("recv", group, buf):
            host = torch.empty(shape, dtype=dtype)
            self._wait(group.pg.recv([host], src, 0))
            return buf.copy_(host)
        self._wait(group.pg.recv([buf], src, 0))
        return buf

    def all_to_all(self, t: torch.Tensor, split_axis: int, concat_axis: int,
                   group: "Group") -> torch.Tensor:
        """The tiled all-to-all (`jax.lax.all_to_all(tiled=True)`): `t` cut
        in `group.size` equal parts along `split_axis`, part j to member j;
        the parts received concatenated along `concat_axis` in member
        order."""
        n = group.size
        if n == 1:
            return t
        if t.shape[split_axis] % n:
            raise ValueError(f"all_to_all: {t.shape[split_axis]} over {n} "
                             f"ranks")
        x = torch.stack(t.chunk(n, split_axis)).contiguous()
        self._count(group, "all_to_all", x)
        out = torch.empty_like(x)
        self._wait(group.pg.alltoall_base(out, x, [], [],
                                          dist.AllToAllOptions()))
        return torch.cat(out.unbind(0), concat_axis)

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   group: Optional["Group"] = None) -> torch.Tensor:
        """Reduce `t` over the ranks (of `group`, default all) in place (a
        contiguous copy if it is not contiguous) and return it."""
        if group is not None and group.size == 1:
            return t
        if not t.is_contiguous():
            t = t.contiguous()
        self._count(group, "all_reduce", t)
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS[op]
        pg = self._pg if group is None else group.pg
        self._wait(pg.allreduce([t], opts))
        return t

    def broadcast(self, t: torch.Tensor, src: int,
                  group: "Group") -> torch.Tensor:
        """`t` of the group's rank `src` (an index into `group.ranks`)
        into `t` on every member, in place; `t` must be contiguous."""
        if group.size == 1:
            return t
        self._count(group, "broadcast", t)
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = src, 0
        self._wait(group.pg.broadcast([t], opts))
        return t

    def all_gather(self, t: torch.Tensor, dim: int,
                   group: "Group") -> torch.Tensor:
        """The members' `t` concatenated along `dim`, in member order."""
        if group.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        self._count(group, "all_gather", x)
        out = x.new_empty((group.size * x.shape[0],) + x.shape[1:])
        self._wait(group.pg._allgather_base(out, x))
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int,
                       group: "Group") -> torch.Tensor:
        """The sum of the members' `t`, cut in `group.size` equal parts
        along `dim`: this member's part."""
        if group.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        if x.shape[0] % group.size:
            raise ValueError(f"reduce_scatter: {x.shape[0]} rows over "
                             f"{group.size} ranks")
        self._count(group, "reduce_scatter", x)
        out = x.new_empty((x.shape[0] // group.size,) + x.shape[1:])
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self._wait(group.pg._reduce_scatter_base(out, x, opts))
        return out.movedim(0, dim)

    # the serving trunk's two tensor-parallel seams (`models.gpt`): a
    # column-parallel matmul's input as it is, a row-parallel output summed
    def column_in(self, h: torch.Tensor) -> torch.Tensor:
        return h

    def row_out(self, y: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(y, "sum")

    def _collective_failed(self, e: BaseException):
        raise e

    def vocab_slice(self, vocab: int) -> slice:
        """This rank's columns of a vocab axis split in mp equal parts."""
        n = vocab // self.mp
        return slice(self.rank * n, (self.rank + 1) * n)

    def warm(self) -> None:
        """One collective on the rank's device, so that an NCCL
        communicator exists before any CUDA-graph capture."""
        self.all_reduce(torch.zeros(1, device=self.device))


class Sent:
    """A send in flight (`MeshRank.isend`): `wait()` ends it, under the
    mesh's timeout."""

    def __init__(self, owner: MeshRank, work, data: torch.Tensor):
        self.owner, self.work, self.data = owner, work, data

    def wait(self) -> None:
        if self.work is not None:
            self.owner._wait(self.work)
            self.work = self.data = None


def _coalescing(fn, device):
    """A backend's `_start_coalescing` or `_end_coalescing`: without an
    argument on the builds whose backends take none, else with the
    device."""
    try:
        return fn()
    except TypeError:
        return fn(device)


class Exchange:
    """A send and a receive in flight (`MeshRank.exchange`): `wait()` ends
    both, under the mesh's timeout, and returns the received tensor."""

    def __init__(self, owner: MeshRank, works, data, buf, host):
        self.owner, self.works, self.data = owner, works, data
        self.buf, self.host = buf, host

    def wait(self) -> torch.Tensor:
        for w in self.works:
            self.owner._wait(w)
        self.works, self.data = [], None
        if self.host is not None:
            self.buf.copy_(self.host)
            self.host = None
        return self.buf


def _check_devices(mp: int, devices, backend: Optional[str]):
    if mp < 1:
        raise ValueError(f"mp must be >= 1, got {mp}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass devices=["
                               "'cpu', ...] to run the mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(mp)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < mp:
        raise ValueError(f"need {mp} devices for mp serving, have "
                         f"{len(devices)}")
    devices = devices[:mp]
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"a mesh is all CPU or all CUDA, got {devices}")
    cuda = "cuda" in kinds
    if cuda:
        devices = [torch.device("cuda", d.index if d.index is not None
                                else torch.cuda.current_device())
                   for d in devices]
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl":
        if not cuda:
            raise ValueError("NCCL needs CUDA devices")
        cards = torch.cuda.device_count()
        if len({d.index for d in devices}) < mp or cards < mp:
            raise ValueError(
                f"NCCL needs one card per rank: mp={mp} over {devices} "
                f"({cards} cards visible); pass backend='gloo' to put "
                f"several ranks on one card")
    return devices, backend


class Group:
    """Some of a mesh's ranks (`MeshRank.group`): `name`, `ranks` (mesh
    ranks, in member order), `size`, this rank's index `rank`, and the
    collectives, which run through the owning rank handle."""

    def __init__(self, owner: MeshRank, name: str, ranks: tuple, pg):
        self.owner, self.name, self.ranks, self.pg = owner, name, ranks, pg
        self.size = len(ranks)
        self.rank = ranks.index(owner.rank)

    def all_reduce(self, t, op="sum"):
        return self.owner.all_reduce(t, op, self)

    def broadcast(self, t, src):
        return self.owner.broadcast(t, src, self)

    def all_gather(self, t, dim=0):
        return self.owner.all_gather(t, dim, self)

    def reduce_scatter(self, t, dim=0):
        return self.owner.reduce_scatter(t, dim, self)

    def isend(self, t, dst):
        return self.owner.isend(t, dst, self)

    def recv(self, shape, dtype, src):
        return self.owner.recv(shape, dtype, src, self)

    def exchange(self, t, dst, src, labels=None):
        return self.owner.exchange(t, dst, src, self, labels)

    def all_to_all(self, t, split_axis, concat_axis):
        return self.owner.all_to_all(t, split_axis, concat_axis, self)


class ServingMesh(MeshRank):
    """Rank 0 of a serving mesh, and the owner of its workers.  Build it
    with `serving_mesh`; `close()` (or dropping it, or the end of the
    process) stops the workers."""

    def __init__(self, mp: int, devices=None, backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        devices, backend = _check_devices(mp, devices, backend)
        self.devices = devices
        self._dir = tempfile.mkdtemp(prefix="serving_mesh_")
        store_path = os.path.join(self._dir, "store")
        self._procs: List[multiprocessing.Process] = []
        self._conns: list = []
        self._eids = itertools.count(1)
        self._closed = False
        # held from a message to the workers through what rank 0 does
        # because of it: the collectives of a program run (so that every
        # rank meets them in one order, whichever engine's thread sends),
        # or the worker's reply
        self.lock = threading.RLock()
        self._groups: list = []         # rank 0's process group, to shut
        if devices[0].type == "cuda":
            # every kernel built once, here, before any worker loads them
            from ..incubate.kernels import _cuda
            _cuda.build_all()
        ctx = multiprocessing.get_context("spawn")
        try:
            for r in range(1, mp):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(
                    target=_worker_main, daemon=True,
                    name=f"serving-mesh-rank{r}",
                    args=(r, mp, str(devices[r]), backend, store_path,
                          timeout_s, theirs, os.getpid()))
                p.start()
                theirs.close()
                self._procs.append(p)
                self._conns.append(mine)
            self._setup(mp, 0, devices[0], backend, store_path, timeout_s)
            self._groups.append(self._pg)
            for r in range(1, mp):
                self._reply(r)                      # "ready"
            self.warm()
        except BaseException:
            self._shutdown()
            raise
        self._finalizer = weakref.finalize(
            self, _stop_workers, self._procs, self._conns, self._dir,
            self._groups)

    def _new_pg(self, pg) -> None:
        self._groups.append(pg)         # shut down with the mesh

    # ---- messages ---------------------------------------------------------
    def _send(self, rank: int, msg) -> None:
        self._check_open()
        self._conns[rank - 1].send(msg)

    def _broadcast(self, msg) -> None:
        for r in range(1, self.mp):
            self._send(r, msg)

    def _reply(self, rank: int):
        conn = self._conns[rank - 1]
        try:
            if not conn.poll(self.timeout_s):
                raise TimeoutError(f"serving mesh rank {rank}: no reply in "
                                   f"{self.timeout_s} s")
            kind, value = conn.recv()
        except (EOFError, OSError) as e:
            raise RuntimeError(f"serving mesh rank {rank} is gone "
                               f"(exit code {self._procs[rank - 1].exitcode})"
                               ) from e
        if kind == "err":
            raise RuntimeError(f"serving mesh rank {rank} failed:\n{value}")
        return value

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("the serving mesh is closed")

    def check_workers(self) -> None:
        """Raise a worker's error if one has reported (no wait)."""
        with self.lock:
            for r, conn in enumerate(self._conns, start=1):
                try:
                    pending = conn.poll()
                except (EOFError, OSError):
                    pending = True
                if pending or not self._procs[r - 1].is_alive():
                    self._reply(r)

    def _collective_failed(self, e: BaseException):
        # a worker that failed reported before it left the group
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            for r, conn in enumerate(self._conns, start=1):
                try:
                    if conn.poll():
                        self._reply(r)
                except (EOFError, OSError):
                    self._reply(r)
            time.sleep(0.05)
        raise e

    # ---- engines ----------------------------------------------------------
    def attach(self, shard_for: Optional[Callable[[int], Dict[str, Any]]],
               state: Dict[str, Any], weights_of: Optional[int] = None
               ) -> int:
        """Give each worker its engine state and its weight shard
        (`shard_for(r)` for rank r, made and sent one rank at a time), or,
        with `weights_of` (an engine id), point it at that engine's shard
        on the worker: replicas on one mesh hold one copy of the weights.
        Returns the engine id, which the workers key the engine's programs
        by."""
        with self.lock:
            eid = next(self._eids)
            for r in range(1, self.mp):
                shard = shard_for(r) if weights_of is None else None
                self._send(r, ("engine", eid, state, shard, weights_of))
                # the worker has copied its shard before it answers, so
                # the shard may go
                self._reply(r)
                del shard
        return eid

    def detach(self, eid: int) -> None:
        if not self._closed:
            try:
                with self.lock:
                    self._broadcast(("drop", eid))
            except (OSError, RuntimeError):
                pass

    def program(self, eid: int, role: str, spec: Dict[str, Any]) -> None:
        with self.lock:
            self._broadcast(("program", eid, role, spec))

    def build(self, eid: int, role: str) -> None:
        with self.lock:
            self.check_workers()
            self._broadcast(("build", eid, role))

    def dispatch(self, eid: int, role: str, values: Dict[str, Any],
                 payload: Optional[Dict[str, Any]] = None) -> None:
        with self.lock:
            self.check_workers()
            self._broadcast(("run", eid, role, values, payload))

    def slab(self, eid: int, sid: int, tensors: Dict[str, torch.Tensor]
             ) -> None:
        """Hand every worker engine `eid`'s shared host slab `sid` once
        (`HostSlabs`); a worker on the card pins it."""
        with self.lock:
            self._broadcast(("slab", eid, sid, tensors))

    def drain(self, eid: int) -> None:
        """Wait until every worker's queued host copies of engine `eid`
        (runs with an "into" payload) have landed, and every message sent
        before has been taken."""
        with self.lock:
            self._broadcast(("drain", eid))
            for r in range(1, self.mp):
                self._reply(r)

    def query(self, rank: int, what: str, *args):
        """A worker's answer to `what`: "counts" (its kernel launch counts),
        "reset_counts", "weight_bytes" (the bytes of the distinct weight
        tensors its engines hold), and of engine `eid`: ("pool_bytes",
        eid), its graph ("replays", eid), ("pool_digest", eid), its
        weights' addresses ("weights", eid)."""
        with self.lock:
            self._send(rank, ("query", what, args))
            return self._reply(rank)

    def rank_counts(self) -> List[Dict[str, Dict[str, int]]]:
        """Every rank's kernel counts: {"launches", "launches_int8",
        "composed_calls"} each."""
        return [_counts()] + [self.query(r, "counts")
                              for r in range(1, self.mp)]

    def reset_counts(self) -> None:
        """Zero the kernel counts on every rank."""
        from ..incubate import kernels as K
        K.reset_launches()
        for r in range(1, self.mp):
            self.query(r, "reset_counts")

    def run(self, fn: Callable, per_rank: Sequence[tuple]) -> List[Any]:
        """Call `fn(*args, mesh=<rank>, **kwargs)` on ranks 0..n-1 at once,
        `per_rank[r] = (args, kwargs)` for n = len(per_rank) (every rank by
        default); returns the results in rank order (the workers' pickled
        back).  `fn` must be importable by name."""
        n = len(per_rank)
        with self.lock:
            for r in range(1, n):
                args, kwargs = per_rank[r]
                self._send(r, ("call", fn, args, kwargs))
            args, kwargs = per_rank[0]
            out = [fn(*args, mesh=self, **kwargs)]
            return out + [self._reply(r) for r in range(1, n)]

    def first(self, n: int) -> "SubMesh":
        """Ranks 0..n-1 of this mesh, as a mesh of n ranks for a trainer
        (which then runs on those ranks only)."""
        if not 1 <= n <= self.mp:
            raise ValueError(f"a mesh of {self.mp} ranks has no first {n}")
        return SubMesh(self, n)

    # ---- lifetime ---------------------------------------------------------
    def close(self) -> None:
        """Stop the workers (each gets "exit", then is joined with a timeout
        and killed past it) and free the group."""
        if self._closed:
            return
        self._closed = True
        self._finalizer()
        self._pg = None

    def _shutdown(self) -> None:
        self._closed = True
        _stop_workers(self._procs, self._conns, self._dir, self._groups)

    def __enter__(self) -> "ServingMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"ServingMesh(mp={self.mp}, backend={self.backend!r}, "
                f"devices={[str(d) for d in self.devices]})")


class SubMesh:
    """The first `mp` ranks of a `ServingMesh` (`ServingMesh.first`): `run`,
    the counts and the per-rank `state` reach those ranks only; `close()`
    leaves the mesh open."""

    def __init__(self, mesh: ServingMesh, mp: int):
        self.parent, self.mp = mesh, mp
        self.rank, self.device, self.backend = 0, mesh.device, mesh.backend
        self.state, self.comm = mesh.state, mesh.comm

    def run(self, fn: Callable, per_rank: Sequence[tuple]) -> List[Any]:
        if len(per_rank) != self.mp:
            raise ValueError(f"{len(per_rank)} calls for {self.mp} ranks")
        return self.parent.run(fn, per_rank)

    def rank_counts(self) -> List[Dict[str, Dict[str, int]]]:
        return self.parent.rank_counts()[:self.mp]

    def reset_counts(self) -> None:
        self.parent.reset_counts()

    def close(self) -> None:
        """The parent mesh stays open."""

    def __repr__(self) -> str:
        return f"SubMesh(first {self.mp} of {self.parent!r})"


def _stop_workers(procs, conns, dirname, groups) -> None:
    """Stop the workers, then shut rank 0's process group down (an NCCL
    group's monitor threads read the store: before its directory goes)."""
    for c in conns:
        try:
            c.send(("exit",))
        except (OSError, ValueError):
            pass
    deadline = time.monotonic() + 10.0
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(5.0)
    for c in conns:
        c.close()
    for pg in groups:
        stop = getattr(pg, "shutdown", None) or getattr(pg, "abort", None)
        if stop is not None:
            try:
                stop()
            except RuntimeError:
                pass
    groups.clear()
    shutil.rmtree(dirname, ignore_errors=True)


def serving_mesh(mp: int, devices=None, backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> ServingMesh:
    """A tensor-parallel serving mesh of `mp` ranks (reference
    `parallel.hybrid.serving_mesh`).  `devices`: one a rank (default: CUDA
    cards 0..mp-1); `backend`: "nccl" (default on CUDA; one card a rank) or
    "gloo" (default on the CPU; on CUDA it may put several ranks on one
    card, and CUDA graphs cannot capture it)."""
    return ServingMesh(mp, devices, backend, timeout_s)


def all_reduce(t: torch.Tensor, op: str = "sum", *, mesh: MeshRank
               ) -> torch.Tensor:
    """`mesh.all_reduce` as a function of the tensor, for `ServingMesh.run`
    (which hands every rank its `mesh`)."""
    return mesh.all_reduce(t, op)


def pool_digest(pool: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """A sha256 of each pool leaf's pages 1 and up (two pools compared
    across processes).  The null page 0 is left out: inactive slots and
    padded rows write their garbage there, which differs between a graph
    engine and an eager one on the same traffic."""
    import hashlib
    return {n: hashlib.sha256(t[:, 1:].contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()
            for n, t in sorted(pool.items())}


def _counts() -> Dict[str, Dict[str, int]]:
    from ..incubate import kernels as K
    return {"launches": K.launches(), "launches_int8": K.launches_int8(),
            "composed_calls": K.composed_calls()}


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

def _watch_parent(ppid: int) -> None:
    while True:
        time.sleep(_PARENT_POLL_S)
        if os.getppid() != ppid:
            os._exit(3)


class _WorkerEngine:
    """A worker's part of one engine: its weight shard, its pool shard, its
    noise generator and its copies of the step programs."""

    def __init__(self, rank: MeshRank, state: Dict[str, Any],
                 params: Dict[str, Any]):
        from ..models import gpt as gpt_mod
        self.rank = rank
        self.config = state["config"]
        self.params = params
        self.sampling = state["sampling"]
        self.capture = state["capture"]
        self.pool = gpt_mod.init_paged_cache(
            self.config, state["num_pages"], state["page_size"],
            device=rank.device, kv_dtype=state["kv_dtype"], mp=rank.mp)
        self.generator = torch.Generator(device=rank.device)
        self.generator.manual_seed(state["seed"])
        self.specs: Dict[str, Dict[str, Any]] = {}
        self.programs: Dict[str, Any] = {}
        self.bucket_pool = None
        # the engine's shared host slabs (`HostSlabs`), and the events of
        # the host copies queued into them that `drain` waits for
        self.slabs: Dict[int, Dict[str, torch.Tensor]] = {}
        self.pending: List[Any] = []

    def program(self, role: str):
        from ..inference.engine import _BODIES, _capture_mode
        from ..inference.graphs import StepProgram
        prog = self.programs.get(role)
        if prog is None:
            spec = self.specs[role]
            mempool = None
            if spec["bucket_pool"] and self.capture and \
                    self.rank.device.type == "cuda":
                if self.bucket_pool is None:
                    self.bucket_pool = torch.cuda.graph_pool_handle()
                mempool = self.bucket_pool
            body = functools.partial(_BODIES[spec["kind"]], self.params,
                                     self.config, self.pool, self.sampling,
                                     self.rank)
            prog = StepProgram(role, body, spec["inputs"], self.rank.device,
                               capture=self.capture, device_fed=spec["fed"],
                               mempool=mempool, fetch=False,
                               capture_mode=_capture_mode(self.rank))
            self.programs[role] = prog
        return prog

    def run(self, role: str, values: Dict[str, Any],
            payload: Optional[Dict[str, Any]], conn) -> None:
        from ..inference.engine import draw_noise
        prog = self.program(role)
        values = dict(values)
        if "noise" in prog.inputs:
            values["noise"] = draw_noise(
                self.config, self.generator, self.rank.device,
                prog.inputs["noise"].shape[0], self.rank)
        if payload and "feed" in payload:
            # a private copy of this rank's part: the span may be reused
            # once a later message is answered
            sid, start, k = payload["feed"]
            values.update(slab_part(self.slabs[sid], self.rank.rank, start,
                                    k, copy=True))
        prog.stage(**values)
        out = prog.run()
        if payload and "into" in payload:
            sid, start, k = payload["into"]
            part = slab_part(self.slabs[sid], self.rank.rank, start, k)
            for n, t in part.items():
                t.copy_(out[n][:, :k].transpose(0, 1), non_blocking=True)
            if self.rank.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                self.pending.append(ev)

    def add_slab(self, sid: int, tensors: Dict[str, torch.Tensor]) -> None:
        if self.rank.device.type == "cuda":
            for t in tensors.values():
                _pin(t)
        self.slabs[sid] = tensors

    def drain(self) -> None:
        for ev in self.pending:
            ev.synchronize()
        self.pending.clear()

    def close(self) -> None:
        self.drain()
        if self.rank.device.type == "cuda":
            for tensors in self.slabs.values():
                for t in tensors.values():
                    _unpin(t)
        self.slabs.clear()

    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.pool.values())


def _tree_to(tree, device):
    """A private copy of every leaf on `device` (the sender may free its
    tensors once this returns)."""
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def _named_leaves(tree, prefix: str = ""):
    """(dotted name, tensor) of every leaf of a nested weight dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _weight_bytes(engines) -> int:
    """The bytes of the distinct weight storages a worker's engines hold."""
    seen = {}
    for e in engines.values():
        for _, t in _named_leaves(e.params):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _weights(params) -> Dict[str, tuple]:
    """Every weight leaf's (address, shape, dtype), by dotted name."""
    return {n: (t.data_ptr(), tuple(t.shape), str(t.dtype))
            for n, t in _named_leaves(params)}


def _pin(t: torch.Tensor) -> None:
    """Page-lock `t`'s host memory for this process's device copies (a
    shared slab, which `pin_memory()` would copy instead)."""
    # cudaHostRegisterPortable: pinned for every device of the process
    err = torch.cuda.cudart().cudaHostRegister(
        t.data_ptr(), t.numel() * t.element_size(), 1)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister failed ({err})")


def _unpin(t: torch.Tensor) -> None:
    torch.cuda.cudart().cudaHostUnregister(t.data_ptr())


def _worker_main(rank: int, mp: int, device: str, backend: str,
                 store_path: str, timeout_s: float, conn, ppid: int) -> None:
    threading.Thread(target=_watch_parent, args=(ppid,), daemon=True).start()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    try:
        me = MeshRank()
        me._setup(mp, rank, dev, backend, store_path, timeout_s)
        conn.send(("ok", "ready"))
        me.warm()
        engines: Dict[int, _WorkerEngine] = {}
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            op = msg[0]
            if op == "exit":
                break
            if op == "run":
                _, eid, role, values, payload = msg
                engines[eid].run(role, values, payload, conn)
            elif op == "build":
                _, eid, role = msg
                engines[eid].program(role).build()
            elif op == "program":
                _, eid, role, spec = msg
                engines[eid].specs[role] = spec
            elif op == "engine":
                _, eid, state, params, weights_of = msg
                params = engines[weights_of].params if params is None \
                    else _tree_to(params, dev)
                engines[eid] = _WorkerEngine(me, state, params)
                del params
                if stream is not None:
                    stream.synchronize()
                    torch.cuda.ipc_collect()
                conn.send(("ok", eid))
            elif op == "drop":
                gone = engines.pop(msg[1], None)
                if gone is not None:
                    gone.close()
            elif op == "slab":
                _, eid, sid, tensors = msg
                engines[eid].add_slab(sid, tensors)
            elif op == "drain":
                engines[msg[1]].drain()
                conn.send(("ok", None))
            elif op == "call":
                _, fn, args, kwargs = msg
                out = fn(*args, mesh=me, **kwargs)
                conn.send(("ok", _to_host(out)))
            elif op == "query":
                _, what, args = msg
                if what == "counts":
                    conn.send(("ok", _counts()))
                elif what == "reset_counts":
                    from ..incubate import kernels as K
                    K.reset_launches()
                    conn.send(("ok", None))
                elif what == "pool_bytes":
                    conn.send(("ok", engines[args[0]].pool_bytes()))
                elif what == "replays":
                    conn.send(("ok", sum(p.replays for p in
                                         engines[args[0]].programs.values())))
                elif what == "pool_digest":
                    conn.send(("ok", pool_digest(engines[args[0]].pool)))
                elif what == "weights":
                    conn.send(("ok", _weights(engines[args[0]].params)))
                elif what == "weight_bytes":
                    conn.send(("ok", _weight_bytes(engines)))
                else:
                    raise ValueError(f"unknown query {what!r}")
            else:
                raise ValueError(f"unknown mesh command {op!r}")
    except BaseException:
        try:
            conn.send(("err", traceback.format_exc()))
        except (OSError, ValueError):
            pass
        os._exit(1)
    os._exit(0)


def _to_host(out):
    """A call's result with its tensors on the CPU (a worker's CUDA memory
    does not outlive the reply)."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_host(o) for o in out)
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    return out


class EngineLink:
    """One engine's handle on its mesh: declares, builds and runs the
    workers' copies of its step programs (the `mirror` of
    `inference.graphs.StepProgram`).  `payload` rides the next run, naming
    a span of the engine's `HostSlabs` ((slab id, first slot, n)):
    {"feed": span} (each worker stages its part of the span's pages) or
    {"into": span} (each worker queues the copy of its part of the
    program's first n pages into the span; `drain` waits for it).
    `lock` is the mesh's: `StepProgram` holds it from the workers' message
    through rank 0's own run, so the ranks' collectives meet in one order
    whichever engine's thread dispatches."""

    def __init__(self, mesh: ServingMesh, eid: int):
        self.mesh = mesh
        self.eid = eid
        self.lock = mesh.lock
        self.payload: Optional[Dict[str, Any]] = None

    def declare(self, role: str, spec: Dict[str, Any]) -> None:
        self.mesh.program(self.eid, role, spec)

    def build(self, role: str) -> None:
        self.mesh.build(self.eid, role)

    def run(self, role: str, values: Dict[str, Any]) -> None:
        payload, self.payload = self.payload, None
        self.mesh.dispatch(self.eid, role, values, payload)

    def drain(self) -> None:
        self.mesh.drain(self.eid)

    def worker_query(self, what: str) -> List[Any]:
        """Every worker's answer to ("pool_bytes" | "replays" |
        "pool_digest" | "weights", this engine)."""
        return [self.mesh.query(r, what, self.eid)
                for r in range(1, self.mesh.mp)]

    def drop(self) -> None:
        self.mesh.detach(self.eid)


def slab_part(slab: Dict[str, torch.Tensor], rank: int, start: int, n: int,
              copy: bool = False) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s part of a slab's page slots start..start+n, each leaf
    [n, L, page, KVH/mp, ...] (contiguous; the slab is rank-major), or
    with `copy` a private copy in the pool's order [L, n, page, KVH/mp,
    ...]."""
    if copy:
        return {k: t[rank, start:start + n].transpose(0, 1).contiguous()
                for k, t in slab.items()}
    return {k: t[rank, start:start + n] for k, t in slab.items()}


class HostSlabs:
    """Shared host memory for one tensor-parallel engine's host copies of
    its pool (swaps, tier spills and restores), allocated once and
    reused.  A slab holds page slots of every leaf for every rank,
    rank-major (leaf [mp, slots, L, page, KVH/mp, ...]); a copy of n pages
    takes a span of n consecutive slots (`take`: (slab id, first slot,
    n), first fit), so each rank's part of it is one contiguous range its
    device copy fills or reads (`slab_part`).  A slab lives in shared
    memory, is handed to the workers once (`ServingMesh.slab`) and, on the
    card, is page-locked in every process (`cudaHostRegister`), so the
    copies are asynchronous and their waits come at the drain.
    Allocating and pinning takes far longer than a step, so `reserve`
    makes the first slab ahead, with room for what one step queues
    before its drain; a spill's span is held from its gather's dispatch
    to its drain, a restore's for its staging, a swapped victim's until
    its swap-in; a slab of `pages` slots (or n) is added only when no
    span fits.  `full` gives the host tier's layout,
    [L, n, page, KVH, ...] with every head, and `fill` writes that layout
    in.

    A span given back (`give`) is reused only after the workers answered
    a later drain, by when every message that named it has been taken and
    its copies have landed; `take` drains first when nothing else fits."""

    def __init__(self, link: EngineLink, pool: Dict[str, torch.Tensor],
                 mp: int, pages: int):
        self.link, self.mp, self.pages = link, mp, pages
        # one page of one rank: [L, page, KVH/mp, ...]
        self.leaves = {n: ((a.shape[0],) + tuple(a.shape[2:]), a.dtype)
                       for n, a in pool.items()}
        self.pin = next(iter(pool.values())).device.type == "cuda"
        self.slabs: Dict[int, Dict[str, torch.Tensor]] = {}
        self._free: Dict[int, List[tuple]] = {}     # sid -> [(start, n)]
        self._fenced: List[tuple] = []      # (span, rank 0's copy event)
        self._pinned: List[torch.Tensor] = []
        self._finalizer = weakref.finalize(self, _unpin_all, self._pinned)

    def reserve(self, slots: int) -> None:
        """Make the first slab now, of `slots` page slots (pinned, and
        handed to the workers), so the steps pay no allocation."""
        if not self.slabs:
            self._new(slots)

    def take(self, n: int) -> tuple:
        span = self._fit(n)
        if span is None and self._fenced:
            self.drain()
            span = self._fit(n)
        if span is None:
            self._new(max(n, self.pages))
            span = self._fit(n)
        return span

    def _fit(self, n: int) -> Optional[tuple]:
        for sid, free in self._free.items():
            for i, (start, m) in enumerate(free):
                if m >= n:
                    free[i:i + 1] = [(start + n, m - n)] if m > n else []
                    return sid, start, n
        return None

    def _new(self, slots: int) -> None:
        sid = len(self.slabs)
        tensors = {n: torch.empty((self.mp, slots) + shape,
                                  dtype=dtype).share_memory_()
                   for n, (shape, dtype) in self.leaves.items()}
        if self.pin:
            for t in tensors.values():
                _pin(t)
                self._pinned.append(t)
        self.slabs[sid] = tensors
        self._free[sid] = [(0, slots)]
        self.link.mesh.slab(self.link.eid, sid, tensors)

    @property
    def nbytes(self) -> int:
        """The host bytes of every slab (all ranks' parts)."""
        return sum(t.nbytes for slab in self.slabs.values()
                   for t in slab.values())

    def give(self, span: tuple, event=None) -> None:
        self._fenced.append((span, event))

    def drain(self) -> None:
        """`EngineLink.drain`, then the spans given back are free again."""
        fenced, self._fenced = self._fenced, []
        self.link.drain()
        for (sid, start, n), ev in fenced:
            if ev is not None:
                ev.synchronize()
            merged = []
            for s, m in sorted(self._free[sid] + [(start, n)]):
                if merged and sum(merged[-1]) == s:
                    merged[-1] = (merged[-1][0], merged[-1][1] + m)
                else:
                    merged.append((s, m))
            self._free[sid] = merged

    def part(self, span: tuple, rank: int, copy: bool = False):
        sid, start, n = span
        return slab_part(self.slabs[sid], rank, start, n, copy)

    def full(self, span: tuple, i: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        """The span's pages in the host tier's layout [L, n, page, KVH,
        ...] (a copy), or with `i` its page i alone, [L, page, KVH, ...]."""
        sid, start, n = span
        out = {}
        for k, t in self.slabs[sid].items():
            x = t[:, start + i:start + i + 1] if i is not None \
                else t[:, start:start + n]
            # [mp, n, L, page, h, ...] -> [L, n, page, mp * h, ...]
            x = x.movedim(0, 3).movedim(0, 1).flatten(3, 4).contiguous()
            out[k] = x[:, 0] if i is not None else x
        return out

    def fill(self, span: tuple, lanes: Dict[str, Sequence[torch.Tensor]]
             ) -> None:
        """Write the span's pages from the host tier's layout, {leaf: one
        [L, page, KVH, ...] tensor a page}."""
        sid, start, _ = span
        for k, t in self.slabs[sid].items():
            for i, lane in enumerate(lanes[k]):
                # [L, page, KVH, ...] -> [mp, L, page, h, ...]
                t[:, start + i].copy_(
                    lane.unflatten(2, (self.mp, -1)).movedim(2, 0))


def _unpin_all(tensors) -> None:
    for t in tensors:
        try:
            _unpin(t)
        except RuntimeError:
            pass
    tensors.clear()
