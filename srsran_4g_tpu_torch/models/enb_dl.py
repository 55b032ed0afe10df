"""eNB DL subframe assembly: the TX counterpart of the UE receiver.

Port counterpart of ``srsran_4g_tpu/models/enb_dl.py`` (the reference's
`lib/src/phy/enb/enb_dl.c`: srsran_enb_dl_put_* of PSS/SSS, CRS, PBCH,
PCFICH, PDCCH and PDSCH into the RE grid, then the IFFT).  Everything is
batched over subframes.
"""

from __future__ import annotations

import numpy as np
import torch

from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.models import pbch as pbch_mod
from srsran_4g_tpu_torch.models import pcfich as pcfich_mod
from srsran_4g_tpu_torch.models import pdcch as pdcch_mod
from srsran_4g_tpu_torch.models import pdsch as pdsch_mod
from srsran_4g_tpu_torch.models import sync
from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, modulate
from srsran_4g_tpu_torch.ops.zadoff_chu import pss_sequence


def pss_sss_values(cell: G.CellConfig, subframe: int):
    """(sss (62,), pss (62,)) signals for subframes 0/5, else None."""
    if subframe not in (0, 5):
        return None
    n_id_2 = cell.cell_id % 3
    n_id_1 = cell.cell_id // 3
    pss = pss_sequence(n_id_2)
    _, c, _ = sync._sss_base()
    n = np.arange(31)
    d = sync.sss_sequences()[n_id_1, 0 if subframe == 0 else 1].copy()
    d[0::2] *= c[(n + n_id_2) % 31]
    d[1::2] *= c[(n + n_id_2 + 3) % 31]
    return d.astype(np.complex64), pss


def _put_row(g: torch.Tensor, cell: G.CellConfig, symbol: int, vals: np.ndarray) -> None:
    """The 62 centre subcarriers of one symbol (every port) := vals, in place."""
    mid = cell.nre // 2
    g[..., symbol, mid - 31:mid + 31] = torch.as_tensor(vals, device=g.device).to(g.dtype)


def put_sync_signals(cell: G.CellConfig, grid_tx: torch.Tensor,
                     subframe: int) -> torch.Tensor:
    """FDD: SSS and PSS in the last two symbols of slot 0 of subframes 0/5.
    Returns a new grid."""
    vals = pss_sss_values(cell, subframe)
    if vals is None:
        return grid_tx
    g = grid_tx.clone()
    nsy = cell.nsymb // 2
    _put_row(g, cell, nsy - 2, vals[0])
    _put_row(g, cell, nsy - 1, vals[1])
    return g


def put_sync_signals_tdd(cell: G.CellConfig, grid_tx: torch.Tensor,
                         subframe: int) -> torch.Tensor:
    """TDD (frame structure type 2, TS 36.211 §6.11): SSS in the last
    symbol of subframes 0/5, PSS in symbol 2 (third DwPTS symbol) of the
    special subframes 1/6.  Returns a new grid."""
    g = grid_tx.clone()
    if subframe in (0, 5):
        _put_row(g, cell, cell.nsymb - 1, pss_sss_values(cell, subframe)[0])
    elif subframe in (1, 6):
        _put_row(g, cell, 2, pss_sequence(cell.cell_id % 3).astype(np.complex64))
    return g


def assemble_subframe(
    pdsch_cfg: pdsch_mod.PdschConfig,
    tb_bits: torch.Tensor | np.ndarray,
    cfi_value: int | None = None,
    mib_bits=None,
    frame_idx: int = 0,
    dcis: list[tuple] | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Full DL subframe grid: PDSCH + CRS + sync + PCFICH (+ PBCH, + DCIs).

    ``mib_bits`` (B, 24): the PBCH of the 40 ms TTI's block ``frame_idx % 4``
    goes into subframe 0 (other subframes carry none).  ``dcis``: a list of
    (dci_bits (B, A), rnti, l_agg, cce_start), put on the PDCCH of
    ``cell.cfi``'s control region.  A tensor ``tb_bits`` stays on its
    device; other inputs go to the grid's device, ``device`` (default CUDA)
    when ``tb_bits`` is not a tensor.
    """
    cell = pdsch_cfg.cell
    sf = pdsch_cfg.subframe
    g = pdsch_mod.encode(pdsch_cfg, tb_bits, device=device)
    g = pdsch_mod.add_crs(pdsch_cfg, g)
    g = put_sync_signals(cell, g, sf)
    cfi = cfi_value if cfi_value is not None else cell.cfi
    cfi_arr = torch.full((g.shape[0],), cfi, dtype=torch.int32, device=g.device)
    g = pcfich_mod.put_into_grid(cell, g, pcfich_mod.encode(cell, cfi_arr, sf))
    if mib_bits is not None and sf == 0:
        syms = pbch_mod.encode(cell, torch.as_tensor(mib_bits, device=g.device))
        g = pbch_mod.put_into_grid(cell, g, syms[:, frame_idx % 4])
    for dci_bits, rnti, l_agg, cce_start in dcis or []:
        g = pdcch_mod.put_dci(cell, cell.cfi, sf, g, torch.as_tensor(dci_bits, device=g.device),
                              rnti, l_agg, cce_start)
    return g


def subframe_to_samples(cell: G.CellConfig, grid_tx: torch.Tensor) -> torch.Tensor:
    return modulate(OfdmConfig(nof_prb=cell.nof_prb), grid_tx)
