"""PHICH: hybrid-ARQ indicator channel, TS 36.211 §6.9.

Port counterpart of ``srsran_4g_tpu/models/phich.py`` (the reference's
`lib/src/phy/phch/phich.c`).  Each HARQ ACK/NACK bit is repeated three
times (BPSK), spread by a length-4 orthogonal sequence (8 per group: 4 codes
× I/Q), scrambled, and the 12 symbols go onto the group's 3 REGs in symbol
0.  Decoding despreads and correlates; many UEs' ACKs decode in one batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from srsran_4g_tpu_torch.models import equalizer, mimo, regs
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.ops.sequence import gold_sequence_np

# TS 36.211 Table 6.9.1-2: w for nseq 0..3 (normal CP); nseq 4..7 are j·w
_W = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]],
              dtype=np.complex64)


def _ref(cell: G.CellConfig, nseq: int, subframe: int) -> np.ndarray:
    """The 12 spread and scrambled symbols of an ACK = 1 (before 1/√2)."""
    cinit = (subframe + 1) * (2 * cell.cell_id + 1) * (1 << 9) + cell.cell_id
    c = gold_sequence_np(cinit, 12).astype(np.float32)
    w = _W[nseq % 4] * (1.0 if nseq < 4 else 1j)
    return (np.tile(w, 3) * (1.0 - 2.0 * c)).astype(np.complex64)


def encode(cell: G.CellConfig, ack: torch.Tensor, group: int, nseq: int,
           subframe: int, ng: float = 1.0) -> torch.Tensor:
    """Spread one UE's ACK (B,) 0/1 into its PHICH group symbols (B, 12),
    on ack's device."""
    del group, ng  # the group selects the REGs (put_into_grid)
    z = (2.0 * ack.to(torch.float32) - 1.0)[:, None]  # BPSK ±1, ACK = 1 → +1
    d = z * torch.as_tensor(_ref(cell, nseq, subframe), device=ack.device)[None, :]
    return d / torch.tensor(math.sqrt(2.0), dtype=torch.complex64, device=ack.device)


def put_into_grid(cell: G.CellConfig, grid_tx: torch.Tensor, phich_syms: torch.Tensor,
                  group: int, ng: float = 1.0) -> torch.Tensor:
    """Add the symbols onto the group's REs (groups share REs by code)."""
    idx = regs.phich_reg_indices(cell, ng)[group].reshape(-1)
    return mimo.scatter_ctrl_syms(grid_tx, idx, phich_syms, add=True)


def decode(cell: G.CellConfig, rx_grid: torch.Tensor, h: torch.Tensor, noise_var,
           group: int, nseq: int, subframe: int, ng: float = 1.0,
           h1: torch.Tensor | None = None) -> dict:
    """Despread one PHICH.  Returns dict(ack (B,) int8, metric (B,)).

    With ``h1`` (port-1 estimates) the group's 12 REs are SFBC-combined
    pairwise (2-port TX diversity, phich.c via predecoding_diversity)."""
    dev = rx_grid.device
    idx = torch.as_tensor(regs.phich_reg_indices(cell, ng)[group].reshape(-1), device=dev)
    b = rx_grid.shape[0]
    y = rx_grid.reshape(b, -1)[:, idx]
    h_re = h.reshape(b, -1)[:, idx]
    if h1 is not None:
        x, _ = equalizer.alamouti_decode_2x1(y, h_re, h1.reshape(b, -1)[:, idx], noise_var)
    else:
        x, _ = equalizer.equalize_single(y, h_re, noise_var)
    ref = torch.as_tensor(_ref(cell, nseq, subframe), device=dev)
    metric = torch.real((x * torch.conj(ref)).sum(dim=-1)) * math.sqrt(2.0)
    return dict(ack=(metric > 0).to(torch.int8), metric=metric)


def phich_alloc(cell_nof_prb: int, i_prb_ra: int, n_dmrs: int = 0,
                ng: float = 1.0) -> tuple[int, int]:
    """(group, sequence) of the PHICH acknowledging a PUSCH at lowest PRB
    index ``i_prb_ra`` (36.213 §9.1.2; phich.c srsran_phich_calc)."""
    n_group = int(np.ceil(ng * cell_nof_prb / 8))
    return (i_prb_ra + n_dmrs) % n_group, (i_prb_ra // n_group + n_dmrs) % 8
