"""Sharded sample-stream operators with a ring halo exchange.

Port counterpart of ``srsran_4g_tpu/parallel/stream.py``: each rank owns a
contiguous chunk of the IQ sample stream and takes only the block-boundary
samples (filter tails, CP- and symbol-spanning regions) from its ring
neighbour.  JAX moves them with ``ppermute`` over a mesh axis; here the axis
is a process group, and the exchange is one ``all_gather`` of the small
boundary slices, from which each rank picks its neighbour's: Gloo, which
puts several ranks on one card, has no point-to-point transfer of CUDA
tensors, and the same code then runs over NCCL and Gloo alike.  The ring
keeps JAX's semantics: shard 0's left halo is zeros (stream start), and the
right halo wraps from shard 0 to the last shard, which masks it out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as tdist

from srsran_4g_tpu_torch.ops import ofdm
from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig
from srsran_4g_tpu_torch.parallel import dist


def _ring(group: tdist.ProcessGroup) -> tuple[int, int]:
    """(this rank's index, ring size) in the group."""
    return tdist.get_rank(group), tdist.get_world_size(group)


def left_halo(x: torch.Tensor, n: int, group: tdist.ProcessGroup) -> torch.Tensor:
    """The last ``n`` samples of the left ring neighbour's chunk.

    x: (..., chunk) local shard.  Returns (..., n): zeros for shard 0.
    """
    idx, size = _ring(group)
    zeros = x.new_zeros(x.shape[:-1] + (n,))
    if size == 1:
        return zeros
    tails = dist.all_gather(x[..., -n:], group)  # collective: every rank joins
    return zeros if idx == 0 else tails[idx - 1]


def right_halo(x: torch.Tensor, n: int, group: tdist.ProcessGroup) -> torch.Tensor:
    """The first ``n`` samples of the right ring neighbour's chunk (the last
    shard gets shard 0's; a ring of one gets its own)."""
    idx, size = _ring(group)
    if size == 1:
        return x[..., :n]
    return dist.all_gather(x[..., :n], group)[(idx + 1) % size]


def fir_filter_sharded(x: torch.Tensor, taps: torch.Tensor,
                       group: tdist.ProcessGroup) -> torch.Tensor:
    """Causal FIR convolution of a time-block-sharded stream (overlap-save).

    Each shard holds (..., chunk) contiguous samples; the first len(taps)-1
    output samples of a chunk need the previous chunk's tail, which comes
    from the ring neighbour.
    """
    ntaps = taps.shape[-1]
    ext = torch.cat([left_halo(x, ntaps - 1, group), x], dim=-1)
    # dense small-tap convolution: sum_k taps[k] * ext[n + ntaps-1 - k]
    out = torch.zeros_like(x)
    for k in range(ntaps):
        out = out + taps[k] * ext[..., ntaps - 1 - k: ntaps - 1 - k + x.shape[-1]]
    return out


@functools.lru_cache(maxsize=32)
def _owner(cfg: OfdmConfig, chunk: int, size: int) -> np.ndarray:
    """(nsymb,) the shard in which each symbol's body starts."""
    starts = ofdm._gather_index(cfg)[:, 0]
    return np.minimum(starts // chunk, size - 1) if size > 1 else np.zeros_like(starts)


@functools.lru_cache(maxsize=32)
def _local_index(cfg: OfdmConfig, chunk: int, size: int) -> np.ndarray:
    """(nsymb, symbol_sz) each symbol body's offsets in its owner's chunk +
    right halo, clipped to that extent: rows out of range belong to other
    shards and are masked out."""
    h = min(cfg.symbol_sz + cfg.cp_len(0), chunk)
    gidx = ofdm._gather_index(cfg)
    return np.clip(gidx - _owner(cfg, chunk, size)[:, None] * chunk, 0, chunk + h - 1)


def ofdm_demodulate_sharded(cfg: OfdmConfig, samples_local: torch.Tensor,
                            group: tdist.ProcessGroup) -> torch.Tensor:
    """OFDM-demodulate a subframe whose sample axis is sharded over the
    group's ranks in equal contiguous chunks.

    Symbols whose body starts inside the local chunk are demodulated
    locally; bodies spanning the boundary use a right halo of
    symbol_sz + CP samples.  The per-shard grids (each symbol produced by
    exactly one shard) are summed over the group.

    Returns the full (..., nsymb, nre) grid on every rank of the group.
    """
    idx, size = _ring(group)
    chunk = samples_local.shape[-1]
    if size > 1 and chunk * size != cfg.sf_len:
        raise ValueError(f"{size} chunks of {chunk} samples for a subframe of {cfg.sf_len}")
    if size > 1 and chunk < cfg.symbol_sz:
        raise ValueError(f"stream shards must hold at least one FFT body: {chunk} "
                         f"samples < {cfg.symbol_sz}")

    h = min(cfg.symbol_sz + cfg.cp_len(0), chunk)
    ext = torch.cat([samples_local, right_halo(samples_local, h, group)], dim=-1)

    dev = samples_local.device
    local_idx = ofdm._on(dev, _local_index, cfg, chunk, size)
    grid = ofdm._fft_bins(cfg, ext[..., local_idx])
    if ofdm._window_phase(cfg) is not None:
        grid = grid * ofdm._on(dev, ofdm._window_phase, cfg)
    mine = (ofdm._on(dev, _owner, cfg, chunk, size) == idx)[:, None]
    grid = torch.where(mine, grid, torch.zeros_like(grid))
    return dist.all_reduce_sum(grid, group) if size > 1 else grid
