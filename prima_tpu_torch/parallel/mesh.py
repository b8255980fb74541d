"""The device mesh of the port: (dp, pp, sp, tp) over torch.distributed.

Counterpart of prima_tpu/parallel/mesh.py. The JAX package's mesh is one
array of devices behind shard_map; here every mesh position is a process
(a rank) that runs the per-device body itself, SPMD:

  dp - data parallel (server slots / batch rows)
  pp - pipeline parallel (layer windows, the piped ring)
  sp - sequence parallel (the KV cache's context axis)
  tp - tensor parallel (attention heads / FFN columns inside a window)

Ranks are numbered with tp innermost, as the JAX axis order puts it:
rank = ((dp * PP + pp) * SP + sp) * TP + tp. `psum` becomes an all-reduce
in the axis's process group, `pmax` an all-reduce MAX, `ppermute` a
point-to-point hop, all through the methods of `Mesh` and `Axis`.

The transport follows the placement. When every rank of a host has a card
of its own, the groups use NCCL on the cards. When ranks outnumber the
cards (several ranks on one card, which NCCL refuses) or run on the CPU,
they use gloo, and each collective and hop copies a CUDA tensor to the
host and back (explicit host staging: gloo's CUDA support is partial).
The choice is made from the device count and the local world size before
any group is built (`choose_transport`) and printed; it never depends on a
failed call. Commands of the control plane (parallel/engine.py) always go
over a gloo group of their own, with their own timeout.
"""

from __future__ import annotations

import datetime
import sys
import time
from dataclasses import dataclass, field
from itertools import product

import torch
import torch.distributed as dist

AXES = ("dp", "pp", "sp", "tp")


def mesh_rank(coords: dict, shape: dict) -> int:
    """The rank of mesh position `coords` (tp innermost)."""
    r = 0
    for a in AXES:
        r = r * shape[a] + coords[a]
    return r


def mesh_coords(rank: int, shape: dict) -> dict:
    """The (dp, pp, sp, tp) coordinates of `rank`."""
    out = {}
    for a in reversed(AXES):
        out[a] = rank % shape[a]
        rank //= shape[a]
    return {a: out[a] for a in AXES}


def choose_transport(device: torch.device, local_world: int) -> str:
    """NCCL when the ranks are on CUDA devices and a host has a card for
    each of its ranks, else gloo with host staging."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@dataclass(eq=False)
class Axis:
    """One mesh axis as seen from this rank: its size, this rank's index
    along it and the process group of its lane."""

    mesh: "Mesh"
    name: str
    size: int
    index: int
    group: object = None  # None when size == 1

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reduction of t over the lane (a new tensor in t's dtype and
        device). Half types are reduced in f32, on every transport."""
        if self.size == 1:
            return t
        return self.mesh._all_reduce(t, op, self.group)


@dataclass(eq=False)
class Mesh:
    """This rank's view of the mesh. `world` ranks are in it; `device` is
    the rank's torch device; `axes` the four Axis objects; `ctrl` the gloo
    group of the control plane (None at world 1)."""

    shape: dict
    rank: int
    device: torch.device
    transport: str = "gloo"
    axes: dict = field(default_factory=dict)
    ctrl: object = None
    # per data operation: [calls, seconds on the host clock (host staging
    # and the wait included), bytes this rank sent]
    stats: dict = field(default_factory=lambda: {k: [0, 0.0, 0] for k in
                                                 ("hop", "all_reduce", "broadcast", "gather")})

    @property
    def world(self) -> int:
        return self.shape["dp"] * self.shape["pp"] * self.shape["sp"] * self.shape["tp"]

    @property
    def coords(self) -> dict:
        return mesh_coords(self.rank, self.shape)

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def rank_of(self, **coords) -> int:
        """The rank at this rank's coordinates with `coords` replaced."""
        return mesh_rank({**self.coords, **coords}, self.shape)

    # -- transport ---------------------------------------------------------------

    def _buf(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of t where the transport reads it: the host
        under gloo (host staging), the card under NCCL."""
        where = "cpu" if self.transport == "gloo" else self.device
        return t.detach().to(where, copy=True).contiguous()

    def _count(self, name: str, t0: float, nbytes: int) -> None:
        st = self.stats[name]
        st[0] += 1
        st[1] += time.perf_counter() - t0
        st[2] += nbytes

    def _all_reduce(self, t: torch.Tensor, op: str, group) -> torch.Tensor:
        t0 = time.perf_counter()
        buf = self._buf(t.float() if t.dtype in (torch.bfloat16, torch.float16) else t)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=group)
        out = buf.to(device=t.device, dtype=t.dtype)
        self._count("all_reduce", t0, buf.numel() * buf.element_size())
        return out

    def hop(self, x: torch.Tensor | None, dst: int | None, src: int | None,
            like: tuple | None) -> torch.Tensor | None:
        """One step of the ring: send x to rank dst and receive from rank
        src a tensor of shape / dtype `like` (either side may be None),
        posted together so that no rank waits on another's send. The
        received tensor lands on this rank's device."""
        t0, sent = time.perf_counter(), 0
        ops, out = [], None
        if x is not None and dst is not None:
            ops.append(dist.P2POp(dist.isend, self._buf(x), dst))
            sent = x.numel() * x.element_size()
        if src is not None:
            shape, dtype = like
            where = "cpu" if self.transport == "gloo" else self.device
            out = torch.empty(shape, dtype=dtype, device=where)
            ops.append(dist.P2POp(dist.irecv, out, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = None if out is None else out.to(self.device)
        self._count("hop", t0, sent)
        return out

    def broadcast(self, t: torch.Tensor | None, src: int, shape, dtype) -> torch.Tensor:
        """t from rank src on every rank (t is ignored elsewhere)."""
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        where = "cpu" if self.transport == "gloo" else self.device
        buf = (self._buf(t) if self.rank == src
               else torch.empty(shape, dtype=dtype, device=where))
        dist.broadcast(buf, src)
        out = buf.to(self.device)
        self._count("broadcast", t0, buf.numel() * buf.element_size() if self.rank == src else 0)
        return out

    def gather0(self, t: torch.Tensor) -> list | None:
        """Every rank's t (same shape and dtype) on rank 0, in rank order;
        None elsewhere."""
        if self.world == 1:
            return [t]
        t0 = time.perf_counter()
        buf = self._buf(t)
        out = [torch.empty_like(buf) for _ in range(self.world)] if self.rank == 0 else None
        dist.gather(buf, out, dst=0)
        out = None if out is None else [o.to(self.device) for o in out]
        self._count("gather", t0, buf.numel() * buf.element_size())
        return out

    def bcast_cmd(self, cmd=None):
        """A control-plane object from rank 0 to every rank."""
        if self.world == 1:
            return cmd
        box = [cmd]
        dist.broadcast_object_list(box, src=0, group=self.ctrl)
        return box[0]

    def gather_obj0(self, obj) -> list | None:
        """Every rank's picklable obj on rank 0 (control group)."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.ctrl)
        return out

    def close(self) -> None:
        if self.world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(dp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1, *, rank: int = 0,
              device=None, init_method: str | None = None, local_world: int | None = None,
              timeout: float = 600.0, ctrl_timeout: float | None = None,
              verbose: bool = True) -> Mesh:
    """This rank's Mesh of dp * pp * sp * tp ranks, from an explicit rank,
    device and rendezvous address (`tcp://host:port`), never from globals.
    Joins the process group (unless one is already up, e.g. from
    launch.init_multihost) and builds one group per axis lane, every rank
    creating every group in the same order. `timeout` bounds each data
    collective; `ctrl_timeout` (default `timeout`) the control plane's
    waits, which a server sets long enough to sit idle between requests."""
    shape = {"dp": dp, "pp": pp, "sp": sp, "tp": tp}
    world = dp * pp * sp * tp
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a mesh of {world} (dp={dp} pp={pp} "
                         f"sp={sp} tp={tp})")
    device = torch.device("cuda" if device is None else device)
    transport = choose_transport(device, local_world or world)
    mesh = Mesh(shape, rank, device, transport)
    if world > 1:
        if verbose and rank == 0:
            print(f"mesh dp={dp} pp={pp} sp={sp} tp={tp}: {world} ranks, transport "
                  f"{transport}" + (" (host-staged)" if transport == "gloo"
                                    and device.type == "cuda" else ""),
                  file=sys.stderr, flush=True)
        td = datetime.timedelta(seconds=timeout)
        if not dist.is_initialized():
            if init_method is None:
                raise ValueError("a mesh of more than one rank needs init_method "
                                 "(tcp://host:port)")
            dist.init_process_group(transport, init_method=init_method, rank=rank,
                                    world_size=world, timeout=td)
        elif dist.get_world_size() != world or dist.get_rank() != rank:
            raise ValueError(f"process group has rank {dist.get_rank()} of "
                             f"{dist.get_world_size()}, the mesh wants {rank} of {world}")
        mesh.ctrl = dist.new_group(list(range(world)), backend="gloo",
                                   timeout=datetime.timedelta(
                                       seconds=ctrl_timeout or timeout))
    me = mesh_coords(rank, shape)
    for a in AXES:
        group = None
        # every lane of every axis, in one fixed order on every rank
        others = [x for x in AXES if x != a]
        for fixed in product(*(range(shape[x]) for x in others)):
            c = dict(zip(others, fixed))
            ranks = [mesh_rank({**c, a: i}, shape) for i in range(shape[a])]
            g = dist.new_group(ranks) if world > 1 and shape[a] > 1 else None
            if rank in ranks:
                group = g
        mesh.axes[a] = Axis(mesh, a, shape[a], me[a], group)
    return mesh


def auto_mesh_shape(n_devices: int, want_pp: int | None = None) -> dict:
    """The JAX package's default factorization of n devices into
    (dp, pp, tp): pp 2 when n is even, tp the largest power of two that
    divides the rest, dp what remains."""
    pp = want_pp if want_pp is not None else (2 if n_devices % 2 == 0 and n_devices >= 2
                                              else 1)
    rest = n_devices // pp
    tp = _largest_pow2_divisor(rest)
    return {"dp": rest // tp, "pp": pp, "tp": tp}


def auto_mesh(n_devices: int, want_pp: int | None = None, **kw) -> Mesh:
    """make_mesh over `auto_mesh_shape` (rank, device and rendezvous in kw)."""
    return make_mesh(**auto_mesh_shape(n_devices, want_pp), **kw)


def _largest_pow2_divisor(n: int) -> int:
    p = 1
    while n % (p * 2) == 0:
        p *= 2
    return p
