"""A ('files', 'time') mesh over ``torch.distributed`` ranks (counterpart of
pyaudiorestoration_tpu/parallel/mesh.py).

Mesh axes:

* ``files``: data parallelism over a batch of recordings (or over the
  channels of one recording);
* ``time``: sequence parallelism along the recording.  Halos at shard edges
  go to the neighbours point to point.

The ranks are laid out as JAX lays out its devices, ``reshape(n_files,
n_time)``: rank r holds the block (r // n_time, r % n_time).  Every function
of the mesh tier runs on every rank at once (SPMD), each with its own block.

Collectives follow the semantics of the JAX primitives they replace:
``psum`` is an all-reduce, ``all_gather`` gathers along an axis, and the two
``ppermute`` directions receive zeros at the edge shards, as a partial
permutation does in ``jax.lax.ppermute``.

Backend: NCCL when every rank has a card of its own; gloo when ranks share a
card (NCCL refuses two ranks on one card) and on the CPU.  Under gloo, CUDA
tensors go through host buffers: only halos and carries travel, the compute
stays on the card.

:func:`launch` starts a world: ``torch.multiprocessing`` spawn with a
``FileStore`` rendezvous in a temporary directory (no port to fight over),
rank r on ``cuda:(r % device_count)``, every collective bounded by
``TIMEOUT_S`` and the whole world by the launcher's own limit, so that a rank
that raises fails the run instead of hanging it.
"""

from __future__ import annotations

import datetime
import inspect
import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import pin_fp32, resolve_device

__all__ = ["Mesh", "make_mesh", "shard_time_batch", "gather_time_batch", "launch",
           "run_in_world", "in_world", "world_ranks", "world_backend", "TIMEOUT_S"]

TIMEOUT_S = 60.0  # each collective and the rendezvous
WORLD_TIMEOUT_S = 1800.0  # the launcher's limit on a whole world


class Mesh:
    """The ('files', 'time') factorization of the current process group.

    Every rank must construct it, with the same shape and in the same order
    relative to other meshes: it creates one sub-group per time row and per
    files column, and ``dist.new_group`` is collective over the world.
    Without a process group the mesh is 1 x 1 and every collective is the
    identity (the edge zeros still apply).

    ``device``: where the rank's blocks live, "cuda" (this rank's current
    card; it raises without one, as every entry of the port does) or
    "cpu"."""

    def __init__(self, n_files: int = 1, n_time: int = 1, device="cuda"):
        self.grouped = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if self.grouped else 1
        if n_files * n_time != world:
            raise ValueError(f"{n_files}x{n_time} mesh over {world} ranks")
        self.rank = dist.get_rank() if self.grouped else 0
        self.shape = {"files": n_files, "time": n_time}
        self.coords = {"files": self.rank // n_time, "time": self.rank % n_time}
        self.stride = {"files": n_time, "time": 1}  # global rank step along an axis
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = dist.get_backend() if self.grouped else "none"
        self.groups = {"files": None, "time": None}
        if self.grouped and world > 1:
            rows = [("time", [f * n_time + t for t in range(n_time)])
                    for f in range(n_files)]
            rows += [("files", [f * n_time + t for f in range(n_files)])
                     for t in range(n_time)]
            for axis, ranks in rows:
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self.groups[axis] = g

    def __repr__(self):
        return (f"Mesh(files={self.shape['files']}, time={self.shape['time']}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[axis]

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host buffers (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _wire(self, t):
        t = t.contiguous()
        return t.cpu() if self.staged else t

    def psum(self, t, axis: str):
        """Sum of ``t`` over ``axis`` (``jax.lax.psum``)."""
        if self.shape[axis] == 1:
            return t
        buf = self._wire(t).clone()
        dist.all_reduce(buf, group=self.groups[axis])
        return buf.to(t.device)

    def pmax(self, t, axis: str):
        """Maximum of ``t`` over ``axis`` (``jax.lax.pmax``)."""
        if self.shape[axis] == 1:
            return t
        buf = self._wire(t).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.groups[axis])
        return buf.to(t.device)

    def all_gather(self, t, axis: str, tiled: bool = False):
        """``t`` of every rank along ``axis``, in axis order: stacked on a new
        leading axis, or concatenated on axis 0 with ``tiled``
        (``jax.lax.all_gather``)."""
        n = self.shape[axis]
        if n == 1:
            return t if tiled else t[None]
        src = self._wire(t)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.groups[axis])
        out = torch.cat(parts) if tiled else torch.stack(parts)
        return out.to(t.device)

    def exchange(self, axis: str, to_left=None, to_right=None):
        """Send ``to_left`` to the left neighbour and ``to_right`` to the
        right one along ``axis``, both in one ``batch_isend_irecv`` so that
        no rank waits on another's order.  Returns ``(from_left,
        from_right)``, shaped like ``to_right`` and ``to_left``: what the
        neighbours sent, zeros at the edge shards (and None where nothing
        was sent that way)."""
        n, i = self.shape[axis], self.coords[axis]
        step = self.stride[axis]
        ops, recv = [], {}
        for name, payload, peer_out, peer_in in (
                ("from_left", to_right, i + 1 < n, i > 0),
                ("from_right", to_left, i > 0, i + 1 < n)):
            if payload is None:
                recv[name] = None
                continue
            sign = 1 if name == "from_left" else -1
            wire = self._wire(payload)
            buf = torch.zeros_like(wire)
            recv[name] = buf
            if peer_out:
                ops.append(dist.P2POp(dist.isend, wire, self.rank + sign * step))
            if peer_in:
                ops.append(dist.P2POp(dist.irecv, buf, self.rank - sign * step))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        dev = (to_right if to_right is not None else to_left).device
        return tuple(None if recv[k] is None else recv[k].to(dev)
                     for k in ("from_left", "from_right"))

    def right_ppermute(self, t, axis: str = "time"):
        """Shard i receives ``t`` of shard i-1; the first shard receives zeros."""
        return self.exchange(axis, to_right=t)[0]

    def left_ppermute(self, t, axis: str = "time"):
        """Shard i receives ``t`` of shard i+1; the last shard receives zeros."""
        return self.exchange(axis, to_left=t)[1]

    def send_right(self, t, axis: str = "time"):
        """Blocking send of ``t`` to the right neighbour (none at the edge)."""
        if self.coords[axis] + 1 < self.shape[axis]:
            dist.send(self._wire(t), self.rank + self.stride[axis])

    def recv_left(self, like, axis: str = "time"):
        """Blocking receive, shaped like ``like``, from the left neighbour;
        the first shard gets ``like`` itself (the chain's initial carry)."""
        if self.coords[axis] == 0:
            return like
        buf = torch.empty_like(self._wire(like))
        dist.recv(buf, self.rank - self.stride[axis])
        return buf.to(like.device)

    def barrier(self):
        """Wait for every rank of the world (a no-op without a group)."""
        if self.grouped:
            dist.barrier()


def make_mesh(n_files: int = 1, n_time: int | None = None, device="cuda") -> Mesh:
    """A ('files', 'time') mesh over every rank of the current world;
    ``n_time`` defaults to the world size over ``n_files``.  ``device`` as
    for :class:`Mesh`: the rank's card by default, raising without one."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return Mesh(n_files, world // n_files if n_time is None else n_time, device)


def _block(mesh: Mesh, shape):
    """The (files, time) slices of this rank's block of a global ``shape``."""
    nf, nt = mesh.shape["files"], mesh.shape["time"]
    if shape[0] % nf or shape[1] % nt:
        raise ValueError(f"batch {tuple(shape)} does not divide over a {nf}x{nt} mesh")
    bf, bt = shape[0] // nf, shape[1] // nt
    f, t = mesh.coords["files"], mesh.coords["time"]
    return slice(f * bf, (f + 1) * bf), slice(t * bt, (t + 1) * bt)


def shard_time_batch(mesh: Mesh, batch, src: int | None = None):
    """This rank's (files, time) block of a global (files, time) batch, as a
    float32 tensor on ``mesh.device``.

    With ``src=None`` every rank holds ``batch`` and slices its block.  With
    ``src`` a rank, only that rank holds it (others pass None): it reads the
    batch once and sends each rank its block."""
    if src is None or not mesh.grouped:
        fs, ts = _block(mesh, np.shape(batch))
        return torch.as_tensor(np.ascontiguousarray(np.asarray(batch)[fs, ts]),
                               dtype=torch.float32, device=mesh.device)
    wire_dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    shape = torch.zeros(2, dtype=torch.int64, device=wire_dev)
    if mesh.rank == src:
        shape[:] = torch.as_tensor(np.shape(batch))
    dist.broadcast(shape, src)
    shape = tuple(int(v) for v in shape.cpu())
    _block(mesh, shape)  # the same check on every rank
    nf, nt = mesh.shape["files"], mesh.shape["time"]
    local = torch.empty((shape[0] // nf, shape[1] // nt), dtype=torch.float32,
                        device=wire_dev)
    parts = None
    if mesh.rank == src:
        arr = np.asarray(batch, np.float32)
        parts = []
        for r in range(nf * nt):
            f, t = divmod(r, nt)
            parts.append(torch.as_tensor(np.ascontiguousarray(
                arr[f * local.shape[0]:(f + 1) * local.shape[0],
                    t * local.shape[1]:(t + 1) * local.shape[1]]), device=wire_dev))
    dist.scatter(local, parts, src=src)
    return local.to(mesh.device)


def gather_time_batch(mesh: Mesh, local, dst: int = 0, time_axis: int = 1):
    """Inverse of :func:`shard_time_batch`: every rank's block of a (files,
    ...) array whose ``time_axis`` is sharded, reassembled on rank ``dst``
    as a numpy array (None on the other ranks)."""
    local = local.contiguous()
    if not mesh.grouped:
        return local.cpu().numpy()
    wire = local.cpu() if mesh.backend == "gloo" else local
    parts = ([torch.empty_like(wire) for _ in range(dist.get_world_size())]
             if mesh.rank == dst else None)
    dist.gather(wire, parts, dst=dst)
    if mesh.rank != dst:
        return None
    nt = mesh.shape["time"]
    rows = [torch.cat(parts[f * nt:(f + 1) * nt], dim=time_axis)
            for f in range(mesh.shape["files"])]
    return torch.cat(rows, dim=0).cpu().numpy()


# ------------------------------------------------------------------ worlds

def world_backend(n_ranks: int = 1, device="cuda") -> str:
    """The backend of a world of ``n_ranks`` on ``device``'s type: NCCL when
    every rank has a card of its own, gloo when they share one and on the
    CPU."""
    if torch.device(device).type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def world_ranks(device="cuda") -> int:
    """The ranks a plain run takes: one per visible card, one on the CPU
    (the counterpart of JAX's mesh over all of ``jax.devices()``)."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA card; "
                               "pass device='cpu' to run the plain PyTorch path")
        return torch.cuda.device_count()
    return 1


def _rank_device(rank: int, device) -> torch.device:
    """Rank ``rank``'s device (its card made current), with the port's
    float32 policy."""
    pin_fp32()
    if torch.device(device).type == "cuda":
        d = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(d)
        return d
    return torch.device("cpu")


def _group_kw(backend: str, dev: torch.device) -> dict:
    """NCCL binds its communicator to the rank's card where this PyTorch
    takes ``device_id`` (2.3 on)."""
    if backend == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        return {"device_id": dev}
    return {}


def _init(rank: int, n_ranks: int, store: str, backend: str, dev: torch.device):
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=n_ranks,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **_group_kw(backend, dev))


def _worker(rank, n_ranks, tmp, backend, device):
    """One spawned rank: load the function and its arguments, join the
    world, run ``fn(device, *args)``, leave, and pickle the result for the
    launcher (the traceback on failure)."""
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        if torch.device(device).type == "cpu":
            # one thread a rank: the CPU BLAS may split a product differently
            # with more threads (and with load), which moves a float32 peak by
            # an ulp and breaks the mesh's bit-equality with the dense tier
            torch.set_num_threads(1)
        dev = _rank_device(rank, device)
        _init(rank, n_ranks, os.path.join(tmp, "store"), backend, dev)
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(fn, n_ranks: int, args=(), device="cuda", backend: str | None = None,
           timeout_s: float = WORLD_TIMEOUT_S, spawn: bool | None = None):
    """Run ``fn(rank_device, *args)`` on each rank of a new world of
    ``n_ranks`` and return the list of their results, by rank.

    ``fn`` and ``args`` must pickle (``fn`` at a module's top level).  Rank r
    runs on ``cuda:(r % device_count)`` for ``device`` "cuda", on the CPU
    for "cpu".  ``backend`` defaults to :func:`world_backend`.  A world of
    one rank runs in this process (``spawn=True`` forces a child); more
    ranks are spawned processes, which import the caller's main module as
    spawned processes do: a script guards its entry under ``if __name__ ==
    "__main__"``.  A rank that raises, or a world that outlives
    ``timeout_s``, ends every rank and raises RuntimeError with the first
    failing rank's traceback."""
    backend = backend or world_backend(n_ranks, device)
    if torch.device(device).type == "cuda":
        world_ranks(device)  # raises without a card
    tmp = tempfile.mkdtemp(prefix="mesh_world_")
    try:
        if n_ranks == 1 and not spawn:
            dev = _rank_device(0, device)
            _init(0, 1, os.path.join(tmp, "store"), backend, dev)
            try:
                return [fn(dev, *args)]
            finally:
                dist.destroy_process_group()
        import torch.multiprocessing as mp

        # the call goes through a file: a large argument written to a spawned
        # child's pipe would hold the next start until the child has read it
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        ctx = mp.start_processes(_worker, args=(n_ranks, tmp, backend, str(device)),
                                 nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {n_ranks} ranks ran past {timeout_s} s")
        except Exception as e:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
            # the rank that failed first: the others may only have lost it
            errs = sorted((os.path.join(tmp, f) for f in os.listdir(tmp)
                           if f.startswith("error_")), key=os.path.getmtime)
            if errs:
                with open(errs[0]) as f:
                    detail = (f"rank {os.path.basename(errs[0])[6:-4]} failed first:\n"
                              f"{f.read()}")
            else:
                detail = str(e)
            raise RuntimeError(f"mesh world of {n_ranks} ranks ({backend}) failed: "
                               f"{detail}") from None
        results = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def in_world() -> bool:
    """Whether this process is a rank already: in a process group, or
    started by ``torchrun`` (``WORLD_SIZE`` and ``RANK`` set)."""
    return (dist.is_available() and dist.is_initialized()) or (
        "WORLD_SIZE" in os.environ and "RANK" in os.environ)


def run_in_world(fn, n_ranks: int | None, args=(), device="cuda"):
    """``fn(rank_device, *args)`` on a mesh world; returns rank 0's result.

    Inside a process group already (under ``torchrun``, or called from a
    rank) it runs on this rank directly, with the group as it is.  Under
    ``torchrun`` without a group yet (``WORLD_SIZE`` and ``RANK`` set), it
    joins torchrun's group first.  Otherwise it launches a world of
    ``n_ranks`` (default :func:`world_ranks`)."""
    if not (dist.is_available() and dist.is_initialized()) and \
            "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        dev = _rank_device(int(os.environ.get("LOCAL_RANK", rank)), device)
        backend = world_backend(world, device)
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=TIMEOUT_S),
                                **_group_kw(backend, dev))
    if dist.is_available() and dist.is_initialized():
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.device(device).type == "cuda" else torch.device("cpu"))
        return fn(dev, *args)
    return launch(fn, n_ranks or world_ranks(device), args, device)[0]
