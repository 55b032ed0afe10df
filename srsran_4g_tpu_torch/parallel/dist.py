"""Multi-process distribution: process-group set-up, the rank's device, and
the collectives the sharded pipeline uses.

Port counterpart of ``srsran_4g_tpu/parallel/dist.py``.  The JAX package runs
one controller per host over all of that host's devices, so its
``init_distributed`` takes a ``local_device_count`` and a ``platform``.
Here every rank is one OS process that drives one device: those two have no
meaning and are left out, and the device is bound per rank instead.  NCCL
carries the collectives between CUDA devices, Gloo between CPU processes,
and Gloo also takes CUDA tensors (staged through the host), which is how
several ranks share one card: NCCL refuses two ranks of one communicator on
the same device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.parallel.mesh import Mesh, make_mesh


def check_backend(backend: str, num_processes: int, device: torch.device) -> None:
    """Raise if ``backend`` cannot carry ``num_processes`` ranks on
    ``device``'s kind: NCCL needs CUDA and one card a rank."""
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(f"NCCL runs between CUDA devices, not {device}; "
                         "pass backend='gloo' on the CPU")
    cards = torch.cuda.device_count()
    if num_processes > cards:
        raise ValueError(f"NCCL takes one card a rank: {num_processes} ranks on {cards} "
                         "card(s); pass backend='gloo' to put several ranks on one card")


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: torch.device | str | None = None,
                     backend: str | None = None) -> torch.device:
    """Join the process group (call once per process) and bind this rank's
    device; returns it.

    coordinator: "host:port" of the rank-0 store (``tcp://`` is prepended),
      or a full init URL such as ``file:///tmp/store``.
    device: "cuda" (the default) binds card ``process_id % device_count``;
      "cpu" runs the rank on the host.  There is no fallback.
    backend: "nccl" (the default on CUDA) or "gloo" (the default on the CPU,
      and the one that puts several ranks on one card).
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    check_backend(backend, num_processes, dev)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    tdist.init_process_group(backend, init_method=url, world_size=num_processes,
                             rank=process_id)
    return dev


def make_global_mesh(dp: int | None = None, sp: int = 1,
                     device: torch.device | str | None = None) -> Mesh:
    """(dp, sp) mesh over every process's rank."""
    return make_mesh(dp=dp, sp=sp, device=device)


def host_local_batch(mesh: Mesh, x: np.ndarray | torch.Tensor) -> torch.Tensor:
    """This rank's rows of a dp-sharded batch, on the rank's device.

    In torch every rank already holds only its own shard (the analog of
    each reference node reading its own sample stream), so this moves it to
    the device and checks that every rank of the mesh holds the same number
    of rows, as the global array's even dp sharding needs."""
    t = torch.as_tensor(x).to(mesh.device)
    if t.ndim == 0:
        raise ValueError("a batch needs a leading row axis")
    rows = torch.tensor([t.shape[0]], device=mesh.device)
    counts = torch.cat(all_gather(rows, None)).tolist()
    if len(set(counts)) != 1:
        raise ValueError(f"ranks hold unequal shards: {counts} rows")
    return t


def all_gather(x: torch.Tensor, group: tdist.ProcessGroup | None) -> list[torch.Tensor]:
    """Every rank's ``x`` (all of one shape) in group-rank order; a complex
    tensor travels as its real pairs."""
    real = (torch.view_as_real(x) if x.is_complex() else x).contiguous()
    parts = [torch.empty_like(real) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, real, group=group)
    return [torch.view_as_complex(p) for p in parts] if x.is_complex() else parts


def all_reduce_sum(x: torch.Tensor, group: tdist.ProcessGroup | None) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group (a new tensor); a complex
    tensor is summed as its real pairs."""
    out = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(torch.view_as_real(out) if out.is_complex() else out, group=group)
    return out
