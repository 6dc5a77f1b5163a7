"""The process mesh of the multi-device layer.

Counterpart of optimalcontrolmps_tpu/parallel/mesh.py. The JAX package
lays its devices on a 2D ("batch", "rows") mesh and annotates shardings:

  * axis "batch": data parallelism over multistart ramps;
  * axis "rows": the Hessian's time rows (sequence parallelism) and the
    bonds of a Vidal stage (tensor parallelism).

Here a mesh is a set of torch.distributed ranks laid out the same way, with
one process group for the whole mesh and one per line along "rows"
(`dist.new_group`; nothing reduces along "batch" alone), and a compute
device that is kept apart from the collective backend: NCCL
ranks compute on their own card; gloo ranks may all compute on one card
(NCCL refuses two ranks on one GPU, and `init_device_mesh("cuda", ...)`
would bind rank r to `cuda:{r % device_count}` under NCCL), or on the CPU.
A sharding is this rank's slice of a leading axis (`batch_shard`,
`row_shard`); the collectives are `comm.py`'s. A `Mesh` also says how work
splits along "rows" and how it is combined (`row_slice`, `bond_shares`,
`rows_sum`, `rows_gather`): the engines call these on the mesh they are
handed and import nothing of this package.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.trunc import shares
from .comm import all_gather_cat, all_reduce_sum

__all__ = ["Mesh", "init_distributed", "compute_device", "mesh_shape",
           "make_mesh", "batch_shard", "row_shard"]

_compute = {"device": None}


def _local_card(local_rank: int) -> torch.device:
    resolve_device(None)    # raises without a card
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(backend=None, init_method=None, world_size=None,
                     rank=None, device=None):
    """Join (or, for one rank, make) the default process group; returns
    (world_size, rank) and does nothing when a group exists already.

    device: where this rank computes. None means its card, cuda:(LOCAL_RANK
    mod the card count), and backend NCCL; "cpu" means backend gloo.
    backend="gloo" with a CUDA device gives gloo ranks that compute on the
    card (collectives staged through host memory, `comm.py`).
    init_method: "tcp://host:port" or "file://path"; None means env:// under
    torchrun (MASTER_ADDR set), an in-process store for a world of one, and
    an error otherwise. world_size / rank default to WORLD_SIZE / RANK, or
    1 / 0. A backend that cannot start raises: an NCCL group is created at
    once (device_id), so a card that NCCL cannot use fails here."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        dev = _local_card(local)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = _local_card(local)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_distributed: a world of several ranks "
                             "needs init_method (tcp://host:port or "
                             "file://path) or torchrun's environment")
        kw["store"] = dist.HashStore()
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    _compute["device"] = dev
    return world_size, rank


def compute_device() -> torch.device:
    """The device that init_distributed gave this rank (None: the card)."""
    dev = _compute["device"]
    return resolve_device(None) if dev is None else dev


def _factor(n: int) -> tuple[int, int]:
    """Factor n into (batch, rows) with rows the smaller power-like factor."""
    rows = 1
    for r in (2, 4, 8):
        if n % r == 0 and n // r >= r:
            rows = r
    return n // rows, rows


def mesh_shape(n: int, rows: int | None = None) -> tuple[int, int]:
    """(n_batch, n_rows) of a mesh of n ranks, as the JAX make_mesh lays
    its devices."""
    if rows is None:
        return _factor(n)
    if rows < 1 or n % rows:
        raise ValueError(f"rows={rows} does not divide the mesh size {n}")
    return n // rows, rows


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("batch", "rows") mesh of the first `size` ranks, row-major: mesh
    rank r sits at (r // n_rows, r % n_rows). `group` spans the mesh,
    `rows_group` this rank's line along "rows" (its group rank is
    `row_rank`). Mesh ranks are the global ranks 0..size-1."""
    shape: tuple
    rank: int
    device: torch.device
    group: object
    rows_group: object

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def n_rows(self) -> int:
        return self.shape[1]

    @property
    def row_rank(self) -> int:
        return self.rank % self.shape[1]

    def row_slice(self, n: int) -> slice:
        """This rank's rows of an axis of length n along "rows", cyclically:
        row i goes to row rank i mod n_rows, which balances the Hessian's
        triangular row loop."""
        return slice(self.row_rank, n, self.n_rows)

    def bond_shares(self, n: int) -> list:
        """[(lo, hi), ...]: each row rank's contiguous share of n bonds, in
        row-rank order (`ops.trunc.shares`: 10 -> 5/5, 9 -> 5/4); this
        rank's is at `row_rank`."""
        return shares(n, self.n_rows)

    def rows_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every row rank's `t` (`comm.all_reduce_sum`)."""
        return all_reduce_sum(t, self.rows_group)

    def rows_gather(self, t: torch.Tensor, sizes=None) -> torch.Tensor:
        """Every row rank's `t` concatenated along axis 0 in row-rank
        order; `sizes`: each rank's leading length when they differ
        (`comm.all_gather_cat`)."""
        return all_gather_cat(t, self.rows_group, sizes)


def make_mesh(n: int | None = None, rows: int | None = None
              ) -> Mesh | None:
    """A ("batch", "rows") mesh over the first n ranks of the default group
    (all of them for None), shaped as the JAX make_mesh (`mesh_shape`),
    computing on init_distributed's device. Every rank of the world must
    call it (it makes process groups); ranks outside the mesh get None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_distributed first")
    world, me = dist.get_world_size(), dist.get_rank()
    n = world if n is None else int(n)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    nb, nr = mesh_shape(n, rows)
    ranks = list(range(n))
    whole = dist.group.WORLD if n == world else dist.new_group(ranks)
    rows_groups = [dist.new_group(ranks[b * nr:(b + 1) * nr])
                   for b in range(nb)]
    if me >= n:
        return None
    return Mesh(shape=(nb, nr), rank=me, device=compute_device(),
                group=whole, rows_group=rows_groups[me // nr])


def batch_shard(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous slice of a leading batch axis of length n,
    sharded over the whole mesh (mesh rank order, as the JAX package's
    P(("batch", "rows"))). n must divide by the mesh size."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over a mesh of "
                         f"{mesh.size} ranks")
    c = n // mesh.size
    return slice(mesh.rank * c, (mesh.rank + 1) * c)


def row_shard(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a leading axis of length n along the "rows"
    axis (`Mesh.row_slice`)."""
    return mesh.row_slice(n)
