"""Process groups for the multi-device layouts (port of ``boslam/parallel/mesh.py``).

The JAX package runs one program over a 1-D device mesh and names its
collectives by a mesh axis.  Here every rank is a process of a
``torch.distributed`` group, and ``Mesh`` holds that group with the
collectives the layouts use, each under its JAX name:

    psum          all_reduce SUM
    pmax          all_reduce MAX
    all_gather    all_gather_into_tensor (tiled along a dimension)
    psum_scatter  reduce_scatter_tensor SUM (tiled along dimension 0)
    axis_index    the rank
    axis_size     the world size

The backend follows the device the caller names: NCCL on ``cuda``, gloo
on ``cpu``.  At world size 1 every collective still goes through the
group.  Each collective adds the bytes of its result to ``Mesh.bytes``
under its JAX name (and one to ``Mesh.calls``): the port's count of what
the collectives move, in place of the JAX package's HLO reading
(``boslam/utils/hlo.py``, which counts result-shape bytes too).

``spawn`` runs functions on N spawned ranks and returns each rank's
results; the tests use it with gloo on the CPU.  A spawned rank imports
only what the functions it is handed import.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from boslam_torch.device import resolve_device

KINDS = ("psum", "pmax", "all_gather", "psum_scatter")
TIMEOUT = datetime.timedelta(seconds=300)  # a collective that waits longer fails
# the tensor forms of all_gather and reduce_scatter, under their newer names
# where this torch has them (the older ones warn there)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU: chosen, never tried."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Mesh:
    """One process group over the ranks of a solve, as a 1-D mesh."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    bytes: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    calls: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))

    @property
    def axis_index(self) -> int:
        return self.rank

    @property
    def axis_size(self) -> int:
        return self.size

    def reset_counts(self) -> None:
        self.bytes = dict.fromkeys(KINDS, 0)
        self.calls = dict.fromkeys(KINDS, 0)

    def _count(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] += nbytes
        self.calls[kind] += 1

    def _all_reduce(self, kind, op, xs):
        """One all_reduce per dtype over the flattened tensors ``xs``."""
        out = list(xs)
        by_dtype = {}
        for i, x in enumerate(xs):
            by_dtype.setdefault(x.dtype, []).append(i)
        for ix in by_dtype.values():
            buf = torch.cat([xs[i].reshape(-1) for i in ix])
            dist.all_reduce(buf, op=op, group=self.group)
            self._count(kind, _nbytes(buf))
            for i, part in zip(ix, torch.split(buf, [xs[i].numel() for i in ix])):
                out[i] = part.view(xs[i].shape)
        return out

    def psum(self, *xs: torch.Tensor):
        """Sum over the ranks; several tensors go in one call per dtype.
        Returns one tensor for one argument, else a list."""
        out = self._all_reduce("psum", dist.ReduceOp.SUM, xs)
        return out[0] if len(xs) == 1 else out

    def psum_dict(self, d: dict) -> dict:
        """``psum`` of a dict's values, one call per dtype."""
        return dict(zip(d, self._all_reduce("psum", dist.ReduceOp.SUM, tuple(d.values()))))

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum over the ranks (a bool goes through int32)."""
        y = x.to(torch.int32) if x.dtype == torch.bool else x
        (out,) = self._all_reduce("pmax", dist.ReduceOp.MAX, (y,))
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim``, rank 0 first."""
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((self.size * src.shape[0],) + tuple(src.shape[1:]))
        _ALL_GATHER(out, src, group=self.group)
        self._count("all_gather", _nbytes(out))
        return out.movedim(0, dim)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, each rank keeping its block of dim-0 rows."""
        n = x.shape[0] // self.size
        out = x.new_empty((n,) + tuple(x.shape[1:]))
        _REDUCE_SCATTER(out, x.contiguous(), group=self.group)
        self._count("psum_scatter", _nbytes(out))
        return out


def initialize_distributed(device="cuda") -> None:
    """Join the group that ``torchrun`` describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT; LOCAL_RANK): on ``cuda`` rank r takes
    ``cuda:LOCAL_RANK``.  Call once, before building graphs on the card."""
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)


def _start_single_rank(backend: str) -> None:
    """A one-rank group on a store at 127.0.0.1 and a port the system picks."""
    store = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=TIMEOUT)
    dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=TIMEOUT)


def make_mesh(device="cuda") -> Mesh:
    """The mesh over every rank of the default group, on ``device``.

    Starts a one-rank group when none exists.  A default group of another
    backend (gloo under a CUDA mesh) gets a group of the right one over
    the same ranks.  One collective runs here, so that NCCL sets up its
    communicator before any solve.
    """
    dev = resolve_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        _start_single_rank(backend)
    group = dist.group.WORLD
    if dist.get_backend() != backend:
        group = dist.new_group(backend=backend, timeout=TIMEOUT)
    mesh = Mesh(group, dist.get_rank(), dist.get_world_size(), dev, backend)
    dist.all_reduce(torch.zeros(1, device=dev), group=group)
    return mesh


def put_sharded(x, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` (numpy or tensor) along ``dim``, whose
    size the world size divides, on the rank's device."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    n = x.shape[dim] // mesh.size
    if n * mesh.size != x.shape[dim]:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over "
                         f"{mesh.size} ranks")
    return x.narrow(dim, mesh.rank * n, n).contiguous().to(mesh.device)


def _to_host(x):
    """Tensors (inside dicts, lists, tuples and dataclasses) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _to_host(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_host(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_to_host(v) for v in x)
    return x


def _rank_main(rank, world_size, store_path, device, jobs, queue):
    """A spawned rank: join the group on a FileStore, run ``jobs``, send
    (rank, results, error) to the parent."""
    results, error = None, None
    try:
        torch.set_num_threads(1)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend_for(device), store=store, rank=rank,
                                world_size=world_size, timeout=TIMEOUT)
        mesh = make_mesh(device)
        results = [_to_host(fn(*args, mesh=mesh, **kwargs)) for fn, args, kwargs in jobs]
    except Exception:
        error = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    queue.put((rank, results, error))


def spawn(jobs, world_size: int, store_path: str, device="cpu", timeout: float = 600.0):
    """Run ``jobs`` on ``world_size`` spawned ranks of one group; returns
    ``results[rank][job]``, each result through ``_to_host``.

    ``jobs`` is a list of (fn, args, kwargs); each rank calls
    ``fn(*args, mesh=mesh, **kwargs)`` in order.  ``fn`` and the arguments
    are pickled, so ``fn`` is a module-level function.  ``store_path`` is
    a file that does not exist yet (the group's FileStore).  A failure on
    any rank raises with that rank's traceback; ranks still running then
    are terminated.
    """
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, store_path, device, jobs, q),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    results, got = [None] * world_size, 0
    deadline = time.monotonic() + timeout
    try:
        while got < world_size:
            try:
                rank, res, error = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: a rank exited with code {dead[0]} before "
                                       "sending its result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: no result from every rank within {timeout} s")
                continue
            if error is not None:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{error}")
            results[rank] = res
            got += 1
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results
