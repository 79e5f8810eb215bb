"""The (records, points) layout of a torch.distributed world.

The two parallel axes of the fit (the JAX package's parallel/mesh.py):

* records: data parallelism over time records (each record's fit is
  independent; the record loop at interpolate.py:511 of the reference);
* points: a row's ranks share out its solve: the chi2 and manual records,
  and the GCV objective's measurement points, summed with one all_reduce
  an evaluation (parallel/fit.py).

Rank k sits at row k // points, column k % points: the records axis varies
slowest, so with ranks numbered host by host (as torchrun numbers them) a
row, and its all_reduce traffic, stays inside one host.  Each row has its
own process group, its points group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


def world():
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class Mesh:
    """records x points ranks; ``group`` is this rank's points group, None
    without a process group (a plain one-process run, where the
    collectives are no-ops)."""

    records: int
    points: int
    rank: int
    group: object = None

    @property
    def size(self) -> int:
        return self.records * self.points

    @property
    def row(self) -> int:
        return self.rank // self.points

    @property
    def col(self) -> int:
        return self.rank % self.points

    def all_reduce(self, x, over="points"):
        """Sum x in place over this rank's points group (``over="points"``)
        or over the whole world (``over="world"``); returns x."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group if over == "points" else None)
        return x

    def gather(self, part, offset, total):
        """A [total, ...] tensor holding ``part`` at ``offset`` and every
        other rank's part at its own offset: each rank writes its part into
        zeros and the ranks sum.  Exact (x + 0 = x), and it needs only
        all_reduce, which every backend has for CUDA tensors (gloo's CUDA
        path has no all_gather)."""
        full = torch.zeros((total,) + tuple(part.shape[1:]), dtype=part.dtype,
                           device=part.device)
        full[offset:offset + part.shape[0]] = part
        return self.all_reduce(full, "world")


def make_mesh(mesh_records: int = 0, mesh_points: int = 1) -> Mesh:
    """The world's ranks as a mesh_records x mesh_points layout
    (mesh_records = 0: the world size over mesh_points).  Raises when the
    layout does not use exactly the world's ranks, so a layout that needs
    more ranks than the world has is never run on fewer.  Every rank must
    call it (each creates every row's group, in the same order)."""
    rank, n = world()
    p = max(int(mesh_points), 1)
    r = int(mesh_records) or max(n // p, 1)
    if r * p != n:
        raise ValueError(
            f"mesh {r}x{p} (MESH_RECORDS x MESH_POINTS) needs {r * p} "
            f"processes, the world has {n}")
    group = None
    if dist.is_available() and dist.is_initialized():
        for i in range(r):
            g = dist.new_group(ranks=list(range(i * p, (i + 1) * p)))
            if i == rank // p:
                group = g
    return Mesh(r, p, rank, group)
