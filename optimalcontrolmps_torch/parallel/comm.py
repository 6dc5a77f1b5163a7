"""Collectives of the multi-device layer, over a torch.distributed group.

The JAX package annotates shardings and XLA inserts the collectives; here
they are explicit calls. Under NCCL the tensors stay on the card. Gloo's
collectives take CPU tensors only, so under gloo `_staged` copies a CUDA
tensor to the host and `_back` returns the result to its device: the one
place where a collective moves the port's tensors through host memory.
Complex tensors travel as real views, booleans as uint8.

`group=None` is the default (world) group. Every rank of the group calls
each function with tensors of the same dtype and trailing shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "all_reduce_sum", "broadcast_from", "argmin",
           "argmin_global", "Argmin"]


def _staged(t: torch.Tensor, group):
    """(what the group's backend takes, how to undo it): a real,
    contiguous tensor, on the host under gloo."""
    x = t.detach()
    kind = "bool" if x.dtype == torch.bool else (
        "complex" if x.is_complex() else "plain")
    if kind == "bool":
        x = x.to(torch.uint8)
    elif kind == "complex":
        x = torch.view_as_real(x.resolve_conj())
    if x.is_cuda and dist.get_backend(group) == "gloo":
        x = x.cpu()
    return x.contiguous(), (kind, t.device)


def _back(x: torch.Tensor, how) -> torch.Tensor:
    kind, device = how
    x = x.to(device)
    if kind == "bool":
        return x.to(torch.bool)
    if kind == "complex":
        return torch.view_as_complex(x.contiguous())
    return x


def all_gather_cat(t: torch.Tensor, group=None, sizes=None) -> torch.Tensor:
    """Every rank's `t` concatenated along axis 0, in group-rank order.
    `sizes`: each rank's leading length when they differ (known to every
    rank; shorter pieces are padded for the transfer and trimmed)."""
    x, how = _staged(t, group)
    n = dist.get_world_size(group)
    sizes = [x.shape[0]] * n if sizes is None else list(sizes)
    m = max(sizes)
    if x.shape[0] < m:
        pad = torch.zeros((m - x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        x = torch.cat([x, pad])
    bufs = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(bufs, x, group=group)
    return _back(torch.cat([b[:s] for b, s in zip(bufs, sizes)]), how)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's `t` (a new tensor; `t` is left as it is)."""
    x, how = _staged(t, group)
    x = x.clone() if x.data_ptr() == t.data_ptr() else x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return _back(x, how)


def broadcast_from(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank `src`'s (a group rank) `t` on every rank; the other ranks pass
    a tensor of the same shape and dtype, whose values are ignored."""
    x, how = _staged(t, group)
    x = x.clone() if x.data_ptr() == t.data_ptr() else x
    root = src if group in (None, dist.group.WORLD) else \
        dist.get_global_rank(group, src)
    dist.broadcast(x, src=root, group=group)
    return _back(x, how)


def argmin(x: torch.Tensor) -> int:
    """jnp.argmin of a 1-D tensor: the first index of the minimum, and a
    NaN counts as the minimum (its first occurrence)."""
    nan = torch.isnan(x)
    if bool(nan.any()):
        return int(torch.nonzero(nan)[0])
    return int(torch.nonzero(x == x.min())[0])


class Argmin(NamedTuple):
    """The global argmin: `index` into the concatenation of every rank's
    values (group-rank order), the group rank that holds it (`owner`), its
    index there (`local_index`) and the value."""
    index: int
    owner: int
    local_index: int
    value: float


def argmin_global(x: torch.Tensor, group=None) -> Argmin:
    """jnp.argmin over the concatenation of every rank's 1-D `x` without
    gathering it: each rank offers (value, index, length) of its own
    argmin, and every rank picks the same winner (NaN first, then the
    least value, ties to the lower rank)."""
    n_local = x.shape[0]
    if n_local:
        k = argmin(x)
        v = float(x[k])
    else:
        k, v = 0, float("nan")
    pack = torch.tensor([[v, k, n_local]], dtype=torch.float64,
                        device=x.device)
    offers = all_gather_cat(pack, group).cpu().tolist()
    offset, best = 0, None
    for r, (val, idx, cnt) in enumerate(offers):
        if cnt:
            key = (0, 0.0) if val != val else (1, val)
            if best is None or key < best[0]:
                best = (key, r, offset + int(idx), int(idx), val)
        offset += int(cnt)
    if best is None:
        raise ValueError("argmin_global of an empty sequence")
    _, owner, index, local, val = best
    return Argmin(index=index, owner=owner, local_index=local, value=val)
