"""PDSCH physical channel: encode (eNB side) and decode (UE side).

Port counterpart of ``srsran_4g_tpu/models/pdsch.py``: single codeword, one
antenna port, or TM2 transmit diversity (SFBC for 2 ports, SFBC-FSTD for 4).

  encode:  TB bits → DL-SCH (CRC/segment/turbo/rate-match) → scramble →
           modulate → RE-map into the resource grid (+ CRS insertion)
  decode:  grid → chest → RE-gather → equalise → soft demod → descramble →
           DL-SCH decode (dematch/HARQ/turbo/CRC)

Batched over a leading subframe dimension; RE maps and scrambling sequences
are host-built once per static config and cached as device tensors.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed import ProcessGroup

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.models import chest as chest_mod
from srsran_4g_tpu_torch.models import equalizer
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.models import mimo, sch
from srsran_4g_tpu_torch.ops import modem, scrambling
from srsran_4g_tpu_torch.ops.sequence import gold_sequence_np
from srsran_4g_tpu_torch.utils.constants import BITS_PER_SYMBOL


@dataclass(frozen=True)
class PdschConfig:
    cell: G.CellConfig
    rnti: int
    subframe: int
    mod: str  # "qpsk" | "16qam" | "64qam" | "256qam"
    tbs: int
    rv: int = 0
    prb_alloc: tuple[int, ...] | None = None  # None = full band
    codeword: int = 0

    @functools.cached_property
    def re_indices(self) -> np.ndarray:
        return G.pdsch_re_indices(self.cell, self.subframe, self.prb_alloc)

    @property
    def nof_re(self) -> int:
        return int(self.re_indices.shape[0])

    @property
    def qm(self) -> int:
        return BITS_PER_SYMBOL[self.mod]

    @property
    def g_bits(self) -> int:
        return self.nof_re * self.qm

    @functools.cached_property
    def plan(self) -> sch.DlschPlan:
        return sch.dlsch_plan(self.tbs, self.g_bits, self.qm, self.rv)

    @functools.cached_property
    def scramble_seq(self) -> np.ndarray:
        cinit = scrambling.pdsch_cinit(self.rnti, self.codeword, self.subframe,
                                       self.cell.cell_id)
        return gold_sequence_np(cinit, self.g_bits)


@functools.lru_cache(maxsize=64)
def _tables(cfg: PdschConfig, device: torch.device) -> dict[str, torch.Tensor]:
    return dict(re_idx=torch.as_tensor(cfg.re_indices, device=device),
                seq=torch.as_tensor(cfg.scramble_seq, device=device))


def _on_device(x, device: torch.device | str | None) -> torch.Tensor:
    """A tensor stays on its device unless ``device`` is given; any other
    input goes to ``device`` (default CUDA)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def _diversity_ports(syms: torch.Tensor, n_ports: int) -> list[torch.Tensor]:
    """TM2 transmit-diversity mapping of (B, n) symbols onto 2 ports (SFBC:
    port0 [x0, x1], port1 [-x1*, x0*] per RE pair) or 4 ports (SFBC-FSTD:
    Alamouti pairs on ports (0, 2) over REs (4i, 4i+1) and on (1, 3) over
    (4i+2, 4i+3), reference precoding.c:1961), 1/sqrt(2) per active pair →
    a (B, n) tensor per port."""
    if n_ports == 2:
        return list(mimo.sfbc_encode_2(syms))
    if n_ports != 4:
        raise ValueError(f"PDSCH maps onto 1, 2 or 4 ports, not {n_ports}")
    b, n = syms.shape
    sp = torch.cat([syms, syms.new_zeros((b, (-n) % 4))], dim=-1)
    x0, x1, x2, x3 = (sp[:, i::4] for i in range(4))
    zero = torch.zeros_like(x0)
    pairs = ([x0, x1, zero, zero], [zero, zero, x2, x3],
             [-x1.conj(), x0.conj(), zero, zero], [zero, zero, -x3.conj(), x2.conj()])
    return [torch.stack(p, dim=-1).reshape(b, -1)[:, :n] / math.sqrt(2.0)
            for p in pairs]


def encode(cfg: PdschConfig, tb_bits: torch.Tensor | np.ndarray,
           device: torch.device | str | None = None) -> torch.Tensor:
    """TB bits (B, tbs) → resource grid with the PDSCH REs set, complex64:
    (B, nsymb, nre) for 1 port, (B, P, nsymb, nre) for 2/4 ports (TM2 SFBC /
    SFBC-FSTD, TS 36.211 §6.3.4.3).  A tensor input stays on its device;
    other inputs go to ``device`` (default CUDA)."""
    bits = _on_device(tb_bits, device)
    tab = _tables(cfg, bits.device)
    cw = sch.dlsch_encode(cfg.plan, bits)
    syms = modem.modulate(cfg.mod, scrambling.scramble_bits(cw, tab["seq"]))
    b = bits.shape[0]
    cell = cfg.cell
    if cell.nof_ports == 1:
        flat = torch.zeros((b, cell.nsymb * cell.nre), dtype=torch.complex64,
                           device=bits.device)
        flat[:, tab["re_idx"]] = syms
        return flat.reshape(b, cell.nsymb, cell.nre)
    ports = _diversity_ports(syms, cell.nof_ports)
    flat = torch.zeros((b, cell.nof_ports, cell.nsymb * cell.nre),
                       dtype=torch.complex64, device=bits.device)
    for p, vals in enumerate(ports):
        flat[:, p, tab["re_idx"]] = vals
    return flat.reshape(b, cell.nof_ports, cell.nsymb, cell.nre)


def add_crs(cfg: PdschConfig, grid_tx: torch.Tensor | np.ndarray, port: int = 0,
            device: torch.device | str | None = None) -> torch.Tensor:
    """Insert cell reference signals into a TX grid (..., nsymb, nre), or into
    every port of a multi-port grid (B, P, nsymb, nre) with P = nof_ports (the
    other ports' CRS REs stay zero: the PDSCH mapping reserves them).  A
    tensor input stays on its device and is not modified; other inputs go to
    ``device`` (default CUDA)."""
    g = _on_device(grid_tx, device).clone()
    cell = cfg.cell
    if g.ndim >= 3 and cell.nof_ports >= 2 and g.shape[-3] == cell.nof_ports:
        for p in range(cell.nof_ports):
            _put_crs(cfg, g[..., p, :, :], p)
    else:
        _put_crs(cfg, g, port)
    return g


def _put_crs(cfg: PdschConfig, g: torch.Tensor, port: int) -> None:
    """Write one port's CRS into the grid (..., nsymb, nre) in place."""
    syms, scs = G.crs_pattern(cfg.cell, port)
    vals = torch.as_tensor(G.crs_values(cfg.cell, port, cfg.subframe),
                           device=g.device)
    g[..., torch.as_tensor(syms, device=g.device)[:, None],
      torch.as_tensor(scs, device=g.device)] = vals


def decode(
    cfg: PdschConfig,
    rx_grid: torch.Tensor,
    h: torch.Tensor | None = None,
    noise_var: torch.Tensor | float | None = None,
    softbuffers: dict | None = None,
    n_iter: int = 5,
    chest_cfg: chest_mod.ChestConfig | None = None,
    cb_shard: tuple[ProcessGroup, int] | None = None,
) -> dict:
    """Decode PDSCH from a received resource grid (B, nsymb, nre), on the
    grid's device.

    If ``h``/``noise_var`` are not given, they are estimated from the CRS:
    h is (B, nsymb, nre) for 1 port and (B, P, nsymb, nre) for 2/4 ports,
    noise_var the mean of the per-port estimates.  ``cb_shard`` (a process
    group and its size) splits the turbo decode's code-block lanes over the
    group's ranks (``sch.dlsch_decode``).
    Returns dict(bits, crc_ok, softbuffers, h, noise_var, snr_db?).
    """
    out: dict = {}
    n_ports = cfg.cell.nof_ports
    if h is None or noise_var is None:
        ccfg = chest_cfg or chest_mod.ChestConfig(cell=cfg.cell)
        ests = [chest_mod.estimate(ccfg, rx_grid, cfg.subframe, port=p)
                for p in range(n_ports)]
        if h is None:
            h = (torch.stack([e["h"] for e in ests], dim=1) if n_ports > 1
                 else ests[0]["h"])
        if noise_var is None:
            noise_var = (sum(e["noise_var"] for e in ests) / n_ports
                         if n_ports > 1 else ests[0]["noise_var"])
        out["snr_db"] = ests[0]["snr_db"]

    tab = _tables(cfg, rx_grid.device)
    idx = tab["re_idx"]
    b = rx_grid.shape[0]
    y = rx_grid.reshape(b, -1)[:, idx]
    if n_ports == 2:
        x, eff_nv = equalizer.alamouti_decode_2x1(
            y, h[:, 0].reshape(b, -1)[:, idx], h[:, 1].reshape(b, -1)[:, idx],
            noise_var)
    elif n_ports == 4:
        h_re = h.reshape(b, 4, -1)[..., idx]
        pad = (-y.shape[-1]) % 4
        yp = torch.cat([y, y.new_zeros((b, pad))], dim=-1)
        hp = torch.cat([h_re, h_re.new_ones((b, 4, pad))], dim=-1)
        x, eff_nv = equalizer.sfbc_fstd_decode_4x1(yp, hp, noise_var)
        x, eff_nv = x[..., :y.shape[-1]], eff_nv[..., :y.shape[-1]]
    else:
        x, eff_nv = equalizer.equalize_single(y, h.reshape(b, -1)[:, idx],
                                              noise_var)

    # per-RE CSI-scaled LLRs: demod divides by the effective noise variance
    llr_scr = modem.demodulate_soft(cfg.mod, x, eff_nv)
    llr = scrambling.descramble_llrs(llr_scr.reshape(b, cfg.g_bits), tab["seq"])
    bits, ok, soft = sch.dlsch_decode(cfg.plan, llr, softbuffers=softbuffers,
                                      n_iter=n_iter, cb_shard=cb_shard)
    out.update(bits=bits, crc_ok=ok, softbuffers=soft, h=h, noise_var=noise_var)
    return out
