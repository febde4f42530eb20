"""The port's one collective layer over ``torch.distributed``.

In the JAX package GSPMD inserts the collectives where a sharded axis is
contracted; here the step calls them by hand, SPMD, one process per rank
(:mod:`clrs_tpu_torch.solver.step`). Three kinds are enough:

- the all-gather of an nw-word tuple along one axis: raw words, so the
  movement is exact (clrs_tpu/parallel/bigcluster.py:70-73); the caller
  then runs the one-process reduction on the gathered terms, in its order;
- the min and max all-reduces of step lengths and error maxima, and the
  AND of the ok flags: exact in any order. They gather each rank's value
  and fold them in rank order with ``torch.minimum``/``torch.maximum``,
  which propagate a NaN from any rank as the one-process reduction does;
- a rank's slice of a replicated axis (``_local_rows``,
  clrs_tpu/parallel/bigcluster.py:75-78).

The transport follows the caller's process group: NCCL moves CUDA tensors
directly; gloo has no CUDA all-gather, so CUDA words are staged through
host memory there (a choice of the group's backend, not a fallback).
No other module of the port calls ``torch.distributed``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["Comm", "backend", "world_size", "device_mesh", "counts",
           "reset_counts"]

# collectives issued and words received by this process (the words of the
# other ranks' parts of every gather, and their values in the reductions),
# as dd/kernels.py counts kernel launches
_COUNTS = {"collectives": 0, "words": 0}


def counts():
    """{"collectives": n, "words": n} since the last reset_counts()."""
    return dict(_COUNTS)


def reset_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


def world_size():
    """The default process group's world size; 0 without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_world_size()


def backend():
    """The default process group's backend name ('nccl', 'gloo', ...)."""
    return str(dist.get_backend())


def device_mesh(n, axis):
    """A 1-D ``DeviceMesh`` of ``n`` ranks over the default process group:
    device type "cuda" on NCCL, "cpu" on any other backend (gloo moves
    host tensors; the solve's device is the caller's ``device=``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dt = "cuda" if backend() == "nccl" else "cpu"
    return init_device_mesh(dt, (n,), mesh_dim_names=(axis,))


class Comm:
    """The collectives of one 1-D mesh axis, for this rank (counted by
    :func:`counts`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.get_group()
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = str(dist.get_backend(self.group))

    def _gather0(self, t):
        """All ranks' ``t`` (same shape on each) concatenated on dim 0."""
        _COUNTS["collectives"] += 1
        _COUNTS["words"] += t.numel() * (self.size - 1)
        if self.backend == "nccl":
            out = torch.empty((self.size * t.shape[0],) + t.shape[1:],
                              dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t, group=self.group)
            return out
        src = t.cpu() if t.device.type != "cpu" else t
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, 0).to(t.device)

    def all_gather(self, x, dim=0):
        """An nw-word tuple's ``dim`` axis gathered from every rank, in rank
        order (one collective for all words; exact)."""
        st = torch.stack(x).movedim(dim + 1, 0).contiguous()
        out = self._gather0(st).movedim(0, dim + 1)
        return tuple(out[i].contiguous() for i in range(len(x)))

    def _fold(self, v, op):
        vals = self._gather0(v.reshape(1))
        out = vals[0]
        for i in range(1, self.size):
            out = op(out, vals[i])
        return out.reshape(v.shape)

    def all_min(self, v):
        """The minimum of a 0-dim tensor over the ranks (NaN if any is)."""
        return self._fold(v, torch.minimum)

    def all_max(self, v):
        """The maximum of a 0-dim tensor over the ranks (NaN if any is)."""
        return self._fold(v, torch.maximum)

    def all_and(self, flag):
        """The AND of a 0-dim bool tensor over the ranks."""
        return self._fold(flag.to(torch.uint8), torch.minimum).to(torch.bool)

    def local_range(self, n):
        """[lo, hi) of this rank's share of an axis of length n (n divides
        by the mesh)."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def local_rows(self, x, dim=0):
        """This rank's slice of a replicated axis of an nw-word tuple
        (clrs_tpu/parallel/bigcluster.py:75-78)."""
        lo, hi = self.local_range(x[0].shape[dim])
        return tuple(c.narrow(dim, lo, hi - lo) for c in x)
