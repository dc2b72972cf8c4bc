"""Process groups of the sharded pipeline, on ``torch.distributed``.

Port of ``buildingsegment_tpu/dist/mesh.py``.  The JAX package shards
the Morton-sorted points over a 1-D ``points`` mesh axis inside one
program (``shard_map``); here one process runs each shard, and a
:class:`ShardGroup` carries what ``lax.axis_size`` / ``lax.axis_index``
and the collectives gave the JAX code:

* ``ppermute`` ring steps → :meth:`ShardGroup.shift` (one
  ``batch_isend_irecv`` of both directions, so no pair can deadlock);
* ``psum`` / ``pmin`` of integer and bool tables → :meth:`ShardGroup.psum`
  / :meth:`ShardGroup.pmin` (``all_reduce``);
* ``psum`` of f32 tables → :meth:`ShardGroup.fold`: rank r continues the
  sums of ranks 0..r−1 with its own rows, in rank order, and the last
  rank's table is broadcast.  Every rank gets the same bits, run after
  run and on any backend, and the sums are the one-device sums: a rank
  holds consecutive rows, so "ranks in order, each its rows in order" is
  the one-device row order (for a blocked sum, when the shard is a
  whole number of blocks).

Several ranks can share one card only on gloo, whose point-to-point
and gather calls take CPU tensors: on gloo a CUDA tensor travels through
pinned host memory (chosen by the backend, not by catching an error).
NCCL takes the card's tensors directly and wants one card a rank.

:func:`make_mesh` refuses what it cannot give (more NCCL ranks than
cards, a world size other than the one asked for, a card that is not
there); it never shrinks the group and never moves to the CPU unless the
caller names ``device="cpu"``.  :func:`spawn` runs a function on every
rank of a new group of local processes (tests, ``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "POINTS_AXIS", "ShardGroup", "ShardStats", "make_mesh",
    "make_multihost_mesh", "shard_rows", "spawn", "fill_rows",
]

POINTS_AXIS = "points"
#: seconds a collective may wait for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class ShardStats:
    """What a group's collectives moved since the last :meth:`reset`."""

    halo_bytes: int = 0       # bytes this rank sent in ring steps
    halo_messages: int = 0    # messages this rank sent in ring steps
    ring_steps: int = 0       # shift calls (one a hop of a halo)
    reductions: int = 0       # all_reduce calls and folds
    gathers: int = 0          # all_gather calls
    host_stagings: int = 0    # card → host copies for gloo (each a sync)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class ShardGroup:
    """One rank's view of the sharded run: its process group, rank,
    world size, backend and device, and the collectives the sharded
    solvers call."""

    def __init__(self, pg, rank: int, world: int, backend: str,
                 device: torch.device, ranks: Optional[Sequence[int]] = None):
        self.pg = pg
        self.rank = rank
        self.world = world
        # ring position → rank in ``pg`` (make_multihost_mesh reorders)
        self.ranks = list(range(world)) if ranks is None else list(ranks)
        self.backend = backend
        self.device = torch.device(device)
        # gloo moves only host tensors point to point: stage card tensors
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.stats = ShardStats()

    def __repr__(self) -> str:
        return (f"ShardGroup(rank={self.rank}, world={self.world}, "
                f"backend={self.backend!r}, device={self.device})")

    # -- wire format ---------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor as the backend sends it: bool as uint8, contiguous,
        on the host (pinned) when staged."""
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        t = t.contiguous()
        if self.staged and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            self.stats.host_stagings += 1
            return host
        return t

    def _buffer(self, shape, dtype) -> torch.Tensor:
        """An empty receive buffer in the wire format."""
        wdt = torch.uint8 if dtype == torch.bool else dtype
        if self.staged:
            return torch.empty(shape, dtype=wdt, pin_memory=True)
        return torch.empty(shape, dtype=wdt, device=self.device)

    def _unwire(self, t: torch.Tensor, dtype) -> torch.Tensor:
        t = t.to(self.device, non_blocking=True)
        return t.to(dtype) if t.dtype != dtype else t

    # -- ring steps ----------------------------------------------------
    def shift(self, to_right: torch.Tensor, to_left: torch.Tensor, fill,
              tag: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """One ring step both ways (``lax.ppermute`` forward and back):
        sends ``to_right`` to rank + 1 and ``to_left`` to rank − 1, and
        returns (what rank − 1 sent right, what rank + 1 sent left).  A
        side past the global edge gets ``fill`` rows of the same shape."""
        from_left = fill_rows(to_right, fill)
        from_right = fill_rows(to_left, fill)
        if self.world == 1:
            return from_left, from_right
        r = self.rank
        ops, recv = [], []
        if r + 1 < self.world:
            peer = self.ranks[r + 1]
            ops.append(dist.P2POp(dist.isend, self._wire(to_right), peer,
                                  self.pg, tag))
            buf = self._buffer(to_left.shape, to_left.dtype)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.pg, tag))
            recv.append(("right", buf))
            self.stats.halo_bytes += to_right.numel() * to_right.element_size()
            self.stats.halo_messages += 1
        if r > 0:
            peer = self.ranks[r - 1]
            ops.append(dist.P2POp(dist.isend, self._wire(to_left), peer,
                                  self.pg, tag))
            buf = self._buffer(to_right.shape, to_right.dtype)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.pg, tag))
            recv.append(("left", buf))
            self.stats.halo_bytes += to_left.numel() * to_left.element_size()
            self.stats.halo_messages += 1
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self.stats.ring_steps += 1
        for side, buf in recv:
            if side == "right":
                from_right = self._unwire(buf, to_left.dtype)
            else:
                from_left = self._unwire(buf, to_right.dtype)
        return from_left, from_right

    def halo_pad(self, x: torch.Tensor, w: int, fill=0) -> torch.Tensor:
        """[S + 2w, ...]: the ring neighbours' w rows each side around
        this rank's rows (:func:`buildingsegment_tpu_torch.dist.halo.halo_pad`)."""
        from buildingsegment_tpu_torch.dist.halo import halo_pad

        return halo_pad(x, w, self, fill=fill)

    # -- reductions ------------------------------------------------------
    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if x.is_floating_point():
            raise TypeError(
                "an f32 all_reduce adds in the backend's order; use fold()")
        dtype = x.dtype
        if dtype == torch.bool:
            x = x.to(torch.int32)
        if self.world == 1:
            return x.to(dtype)
        buf = self._wire(x)
        if buf is x:
            buf = x.clone()
        dist.all_reduce(buf, op=op, group=self.pg)
        self.stats.reductions += 1
        out = self._unwire(buf, x.dtype)
        return out.bool() if dtype == torch.bool else out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks of an integer or bool tensor (bool: or)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """Minimum over the ranks of an integer or bool tensor."""
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated in rank order
        along dim 0."""
        if self.world == 1:
            return x
        bufs = [self._buffer(x.shape, x.dtype) for _ in range(self.world)]
        dist.all_gather(bufs, self._wire(x), group=self.pg)
        self.stats.gathers += 1
        ring = [bufs[g] for g in self.ranks]  # pg order → ring order
        return self._unwire(torch.cat(ring, 0), x.dtype)

    def fold(self, compute: Callable, shapes: Sequence[Tuple[int, ...]],
             dtype=torch.float32):
        """Sums over the ranks in a fixed order: rank 0 runs
        ``compute(None)``, rank r > 0 ``compute(init)`` with ``init`` the
        tables rank r − 1 computed (so ``compute`` continues those sums
        with its own rows), and the last rank's tables are broadcast.

        ``compute`` returns one tensor, or a tuple, of the given
        ``shapes``; ``init`` has the same form.  One device: ``compute
        (None)``."""
        single = len(shapes) > 0 and isinstance(shapes[0], int)
        shapes = [tuple(shapes)] if single else [tuple(s) for s in shapes]
        if self.world == 1:
            return compute(None)
        init = None
        if self.rank > 0:
            bufs = [self._buffer(s, dtype) for s in shapes]
            for b in bufs:
                dist.recv(b, self.ranks[self.rank - 1], group=self.pg)
            got = [self._unwire(b, dtype) for b in bufs]
            init = got[0] if single else tuple(got)
        out = compute(init)
        outs = [out] if single else list(out)
        for o, s in zip(outs, shapes):
            if tuple(o.shape) != s or o.dtype != dtype:
                raise ValueError(f"fold: compute gave {tuple(o.shape)} "
                                 f"{o.dtype}, expected {s} {dtype}")
        last = self.world - 1
        if self.rank < last:
            for o in outs:
                dist.send(self._wire(o), self.ranks[self.rank + 1],
                          group=self.pg)
        res = []
        for o, s in zip(outs, shapes):
            buf = self._wire(o) if self.rank == last else self._buffer(s,
                                                                       dtype)
            dist.broadcast(buf, self.ranks[last], group=self.pg)
            res.append(self._unwire(buf, dtype))
        self.stats.reductions += 1
        return res[0] if single else tuple(res)

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.pg)


def fill_rows(like: torch.Tensor, fill) -> torch.Tensor:
    """A tensor shaped as ``like`` holding ``fill``: a scalar, or for a
    2-D ``like`` a sequence of one value a column."""
    if isinstance(fill, (int, float, bool)):
        return torch.full_like(like, fill)
    row = torch.as_tensor(fill, dtype=like.dtype, device=like.device)
    return row.expand(like.shape).clone()


def shard_rows(n: int, group: Optional[ShardGroup]) -> slice:
    """This rank's contiguous row range of ``n`` rows (the port's form
    of ``point_sharding``); ``n`` must divide by the world size."""
    if group is None:
        return slice(0, n)
    if n % group.world:
        raise ValueError(f"N={n} does not divide by the world size "
                         f"{group.world}")
    s = n // group.world
    return slice(group.rank * s, (group.rank + 1) * s)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _pick_device(device, backend: str, world: int,
                 local_rank: int) -> torch.device:
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is not "
                               "available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the sharded pipeline runs on the card; pass "
            "device='cpu' to run it on the CPU")
    cards = torch.cuda.device_count()
    if backend == "nccl":
        if local_rank >= cards:
            raise RuntimeError(
                f"NCCL needs one card a rank: local rank {local_rank} of "
                f"{world} ranks, {cards} visible card(s); pass "
                "backend='gloo' to share one card")
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % cards)


def make_mesh(n_ranks: Optional[int] = None, *, backend: Optional[str] = None,
              device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> ShardGroup:
    """This process's :class:`ShardGroup` over the 1-D ``points`` axis.

    Uses the default process group when one exists; otherwise starts it
    from torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (and
    ``MASTER_ADDR`` / ``MASTER_PORT``), or as a group of one when those
    are unset.  ``n_ranks`` is the world size the caller needs: any
    other raises (a group is never shrunk).  ``backend`` defaults to
    NCCL on the card and gloo on the CPU; NCCL with more ranks than
    visible cards raises.  ``device`` None is ``cuda:LOCAL_RANK`` (gloo
    maps ranks past the card count onto the cards in turn) and raises
    without CUDA; ``"cpu"`` runs the shards on the CPU.  Collectives that
    find no peer within ``timeout_s`` raise.
    """
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        pg_backend = dist.get_backend()
        if backend is not None and backend != pg_backend:
            raise RuntimeError(f"the process group runs {pg_backend!r}, "
                               f"not {backend!r}")
        backend = pg_backend
    else:
        world = _env_int("WORLD_SIZE") or 1
        rank = _env_int("RANK") or 0
        if backend is None:
            wants_cpu = device is not None and torch.device(device).type == "cpu"
            backend = "gloo" if wants_cpu else "nccl"
    if n_ranks is not None and n_ranks != world:
        raise RuntimeError(
            f"requested a {n_ranks}-rank group but this process runs in a "
            f"world of {world}; start {n_ranks} processes (torchrun "
            f"--nproc_per_node {n_ranks}, or dist.spawn)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    dev = _pick_device(device, backend, world, local_rank)
    if backend == "nccl" and dev.type != "cuda":
        raise RuntimeError("NCCL runs on the card; use backend='gloo' for "
                           "device='cpu'")
    if not dist.is_initialized():
        timeout = datetime.timedelta(seconds=timeout_s)
        if _env_int("WORLD_SIZE") is None:
            # a group of one: an in-memory store, no rendezvous
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout)
        else:
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=world,
                                    timeout=timeout)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return ShardGroup(dist.group.WORLD, rank, world, backend, dev)


def make_multihost_mesh(n_ranks: Optional[int] = None, *,
                        backend: Optional[str] = None, device=None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> ShardGroup:
    """:func:`make_mesh` with the ranks ordered by (node, local rank).

    The sharded pipeline's only per-sweep point exchange is the ±w ring
    halo between adjacent ranks, so shard ranges that are contiguous
    per host cross the network only at the H − 1 host boundaries.  The
    group's rank r (its shard and ring position) is the r-th process in
    (node, local rank) order (node from ``GROUP_RANK``, torchrun's node
    rank, else the host name); on one host it is the plain group's
    order."""
    base = make_mesh(n_ranks, backend=backend, device=device,
                     timeout_s=timeout_s)
    if base.world == 1:
        return base
    node = _env_int("GROUP_RANK")
    key = (node if node is not None else -1, socket.gethostname(),
           _env_int("LOCAL_RANK") or 0, base.rank)
    keys = [None] * base.world
    dist.all_gather_object(keys, key, group=base.pg)
    order = sorted(range(base.world), key=lambda r: keys[r])
    return ShardGroup(base.pg, order.index(base.rank), base.world,
                      base.backend, base.device, ranks=order)


# -- a local launcher (tests, chip_smoke.py) -------------------------------

def _child(fn, args, rank, world, backend, device, store, timeout_s, out):
    """One spawned rank: join the group, run ``fn(group, *args)``, put
    (rank, ok, pickled result or the traceback) on ``out``."""
    try:
        if device is not None and torch.device(device).type == "cpu":
            # CPU ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        group = make_mesh(world, backend=backend, device=device,
                          timeout_s=timeout_s)
        res = fn(group, *args)
        out.put((rank, True, pickle.dumps(res)))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str = "gloo", device=None,
          timeout_s: float = 120.0, args: tuple = ()) -> list:
    """Run ``fn(group, *args)`` on ``world`` new local processes, one a
    rank; returns the ranks' results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable.  The ranks meet through a file store in a new
    temporary directory.  If a rank raises, the others are killed and
    the error (with the rank's traceback) is raised here; if the ranks
    have not all finished within ``timeout_s``, all are killed and
    ``TimeoutError`` is raised.  Collectives inside get the same timeout.
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="bst_dist_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(
            fn, args, r, world, backend, device, store, timeout_s, out),
            daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + timeout_s
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn: {world - len(results)} of {world} ranks "
                        f"did not finish within {timeout_s} s")
                try:
                    rank, ok, payload = out.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in
                            (None, 0)]
                    if dead:
                        # a rank that died without a word (killed, crashed)
                        try:
                            rank, ok, payload = out.get(timeout=1.0)
                        except queue_mod.Empty:
                            raise RuntimeError(
                                f"spawn: rank {dead[0]} exited with code "
                                f"{procs[dead[0]].exitcode}") from None
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n"
                                       f"{payload}")
                results[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                if p.is_alive() and len(results) < world:
                    p.kill()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            out.close()
    return [results[r] for r in range(world)]
