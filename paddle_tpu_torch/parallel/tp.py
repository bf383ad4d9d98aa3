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
its shard to its own device.  A worker draws the sampled lane's Gumbel
noise itself, from a generator seeded like rank 0's.

The model functions see a rank through `mesh=`: `mp`, `rank`, `device`
and `all_reduce(t, op)` (SUM, MAX or MIN, in place).  All-reduce is the
only collective the serving model uses, so one path works under NCCL and
under gloo with CUDA tensors.

The same mesh carries training (`parallel.hybrid.HybridParallelTrainer`):
`group(name, ranks)` gives a `Group` over some of the ranks, its process
group built once per rank list on a `PrefixStore` of the mesh's store, and
the rank handle runs `all_reduce`, `broadcast`, `all_gather` and
`reduce_scatter` on it (gloo takes all four on CUDA tensors too, staging
them through host memory itself), the pipeline's `isend` and `recv` and
the ep exchange's tiled `all_to_all`.  Gloo's send and recv do not take
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

    def group(self, name: str, ranks: Sequence[int],
              link: bool = False) -> "Group":
        """The group `name` over `ranks` (this rank among them).  Its
        process group is built at the first request for that rank set, on
        a prefix of the mesh's store; every member must ask for it in the
        same order.  A `link` (a pipeline's point-to-point link) has a
        process group of its own, shared with no collective group over the
        same ranks.  A group of one rank runs no collective."""
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
        return Group(self, name, ranks, pg)

    def _new_pg(self, pg) -> None:
        """A process group this rank built for a `Group`."""

    def _count(self, group: Optional["Group"], op: str, t: torch.Tensor):
        key = f"{'world' if group is None else group.name}.{op}"
        c = self.comm.setdefault(key, [0, 0])
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

    def _staged(self, op: str, group: "Group", t: torch.Tensor) -> bool:
        """Whether the send or recv `op` of `t` goes through host memory: a
        CUDA tensor under gloo, whose send and recv do not take one.
        Counted as "<group>.<op>_host"."""
        if self.backend != "gloo" or t.device.type != "cuda":
            return False
        self._count(group, op + "_host", t)
        return True

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
    def attach(self, shard_for: Callable[[int], Dict[str, Any]],
               state: Dict[str, Any]) -> int:
        """Give each worker its engine state and its weight shard
        (`shard_for(r)` for rank r, made and sent one rank at a time).
        Returns the engine id, which the workers key the engine's programs
        by."""
        eid = next(self._eids)
        for r in range(1, self.mp):
            shard = shard_for(r)
            self._send(r, ("engine", eid, state, shard))
            # the worker has copied its shard before it answers, so the
            # shard may go
            self._reply(r)
            del shard
        return eid

    def detach(self, eid: int) -> None:
        if not self._closed:
            try:
                self._broadcast(("drop", eid))
            except (OSError, RuntimeError):
                pass

    def program(self, eid: int, role: str, spec: Dict[str, Any]) -> None:
        self._broadcast(("program", eid, role, spec))

    def build(self, eid: int, role: str) -> None:
        self.check_workers()
        self._broadcast(("build", eid, role))

    def dispatch(self, eid: int, role: str, values: Dict[str, Any],
                 payload: Optional[Dict[str, Any]] = None) -> None:
        self.check_workers()
        self._broadcast(("run", eid, role, values, payload))

    def query(self, rank: int, what: str, *args):
        """A worker's answer to `what`: "counts" (its kernel launch counts),
        "reset_counts", and of engine `eid`: ("pool_bytes", eid), its
        graph ("replays", eid), ("pool_digest", eid)."""
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
        self.rank, self.device = 0, mesh.device
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
        self.params = _tree_to(params, rank.device)
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
        heads = head_slice(self.rank, self.config.kv_heads)
        for n, t in (payload or {}).get("feed", {}).items():
            values[n] = t[:, :, :, heads]
        prog.stage(**values)
        out = prog.run()
        if payload and "into" in payload:
            k = payload["n"]
            for n, t in payload["into"].items():
                t[:, :, :, heads].copy_(out[n][:, :k])
            conn.send(("ok", None))

    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.pool.values())


def _tree_to(tree, device):
    """A private copy of every leaf on `device` (the sender may free its
    tensors once this returns)."""
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


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
                _, eid, state, params = msg
                engines[eid] = _WorkerEngine(me, state, params)
                del params
                if stream is not None:
                    stream.synchronize()
                    torch.cuda.ipc_collect()
                conn.send(("ok", eid))
            elif op == "drop":
                engines.pop(msg[1], None)
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
    `inference.graphs.StepProgram`).  `payload` rides the next run: {"feed":
    {leaf: full-layout host tensor}} (each worker stages its kv heads of
    it) or {"into": {leaf: full-layout shared host tensor}, "n": pages}
    (each worker copies its kv heads of the program's first n pages into it
    and answers, which `collect` waits for)."""

    def __init__(self, mesh: ServingMesh, eid: int):
        self.mesh = mesh
        self.eid = eid
        self.payload: Optional[Dict[str, Any]] = None

    def declare(self, role: str, spec: Dict[str, Any]) -> None:
        self.mesh.program(self.eid, role, spec)

    def build(self, role: str) -> None:
        self.mesh.build(self.eid, role)

    def run(self, role: str, values: Dict[str, Any]) -> None:
        payload, self.payload = self.payload, None
        self.mesh.dispatch(self.eid, role, values, payload)

    def collect(self) -> None:
        for r in range(1, self.mesh.mp):
            self.mesh._reply(r)

    def worker_query(self, what: str) -> List[Any]:
        """Every worker's answer to ("pool_bytes" | "replays" |
        "pool_digest", this engine)."""
        return [self.mesh.query(r, what, self.eid)
                for r in range(1, self.mesh.mp)]

    def drop(self) -> None:
        self.mesh.detach(self.eid)


def head_slice(mesh: MeshRank, kv_heads: int) -> slice:
    """This rank's kv heads of the full pool layout (axis 3 of every pool
    leaf, k and v and the scale lanes)."""
    n = kv_heads // mesh.mp
    return slice(mesh.rank * n, (mesh.rank + 1) * n)
