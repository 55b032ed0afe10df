"""Rank mesh for the sharded PHY pipeline.

Port counterpart of ``srsran_4g_tpu/parallel/mesh.py``.  JAX builds one
``Mesh`` over the devices of one controller; here every rank is one OS
process driving one device, and the mesh is a (dp, sp) grid of
``torch.distributed`` ranks with a process group for each axis:

- axis ``dp``: data parallel over subframes / UEs / transport blocks;
- axis ``sp``: stream parallel over the time-sample axis of each subframe,
  with CP/filter-tail halos exchanged between ring neighbours
  (``parallel/stream.py``).

Ranks fill the grid in row-major order, as ``devs.reshape(dp, sp)`` does:
ranks {0, 1} form the first sp group of a (2, 2) mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as tdist

from srsran_4g_tpu_torch import resolve_device


def rank_grid(world: int, dp: int | None = None, sp: int = 1) -> np.ndarray:
    """The (dp, sp) grid of ranks 0..world-1 in row-major order; dp=None
    takes world // sp."""
    if dp is None:
        dp = world // sp
    if dp * sp != world:
        raise ValueError(f"dp*sp={dp * sp} != {world} ranks")
    return np.arange(world).reshape(dp, sp)


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the (dp, sp) mesh: the rank grid, the process
    group of this rank's line along each axis, and the rank's device."""

    ranks: np.ndarray  # (dp, sp) global ranks
    groups: dict[str, tdist.ProcessGroup]  # "dp", "sp"
    device: torch.device
    rank: int

    @property
    def shape(self) -> dict[str, int]:
        dp, sp = self.ranks.shape
        return {"dp": dp, "sp": sp}

    @property
    def coordinate(self) -> tuple[int, int]:
        """(dp index, sp index) of this rank."""
        dp_i, sp_i = np.argwhere(self.ranks == self.rank)[0]
        return int(dp_i), int(sp_i)

    def get_group(self, axis: str) -> tdist.ProcessGroup:
        return self.groups[axis]


def make_mesh(dp: int | None = None, sp: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """Build a (dp, sp) mesh over every rank of the initialised process group
    (``parallel.dist.init_distributed``).  Every rank must call it, with the
    same dp and sp: each axis line becomes a process group, and
    ``new_group`` is collective.  ``device`` is the rank's device (default
    the current CUDA device)."""
    if not tdist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.dist.init_distributed first")
    grid = rank_grid(tdist.get_world_size(), dp, sp)
    rank = tdist.get_rank()
    groups = {}
    for axis, lines in (("dp", grid.T), ("sp", grid)):
        for line in lines:
            group = tdist.new_group(line.tolist())
            if rank in line:
                groups[axis] = group
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(ranks=grid, groups=groups, device=dev, rank=rank)
