"""LTE air interface: scheduler-driven subframes over the port's PHY.

Port counterpart of ``srsran_4g_tpu/runtime/lte_air.py``: the glue the
reference implements in `srsenb/src/phy/lte/cc_worker.cc` (encode_pdsch:596
+ PDCCH put) and `srsue/src/phy/lte/cc_worker.cc` (work_dl_regular:214 →
decode_pdcch:259 → decode_pdsch:442, work_ul:600): every grant travels over
the air as a DCI on PDCCH, the UE blind-decodes its search space every TTI,
HARQ-ACK/SR/CQI ride PUCCH, and UL data rides PUSCH — nothing is handed
between the nodes out-of-band.

Subframes are composed on ``device`` (default CUDA) by summing disjoint-RE
grids (PDSCH allocations, PUCCH resources, PUSCH allocations never overlap
by scheduler construction), and the turbo-coded channels decode through
``models/sch.dlsch_decode`` and the port's Hopper kernels.  Where the JAX
package jits one function per (config, subframe), the port runs the model
functions eagerly and keeps the host tables it builds itself (search-space
candidates, the DwPTS masks, the fading times and frequencies, the 2×2 mix)
on the device, cached per (config, subframe, RNTI).  The noise comes from
one ``torch.Generator`` per air seeded with ``seed`` (its draws differ from
the JAX package's PRNG for the same seed).

PUCCH resource derivation follows 36.213 §10.1: the HARQ-ACK format-1a
index is the first CCE of the scheduling PDCCH; SR and CQI resources are
RRC-configured per UE (here: allocated at attach).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.channel import fading as fad
from srsran_4g_tpu_torch.channel.awgn import awgn, snr_to_noise_var
from srsran_4g_tpu_torch.models import chest as chest_mod
from srsran_4g_tpu_torch.models import dci as dci_mod
from srsran_4g_tpu_torch.models import enb_dl
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.models import mimo
from srsran_4g_tpu_torch.models import pbch as pbch_mod
from srsran_4g_tpu_torch.models import pcfich as pcfich_mod
from srsran_4g_tpu_torch.models import pdcch as pdcch_mod
from srsran_4g_tpu_torch.models import pdsch as pdsch_mod
from srsran_4g_tpu_torch.models import pdsch_mimo
from srsran_4g_tpu_torch.models import phich as phich_mod
from srsran_4g_tpu_torch.models import prach as prach_mod
from srsran_4g_tpu_torch.models import pucch as pucch_mod
from srsran_4g_tpu_torch.models import pusch as pusch_mod
from srsran_4g_tpu_torch.models import ra
from srsran_4g_tpu_torch.models import sync as sync_mod
from srsran_4g_tpu_torch.models import tdd as tdd_mod
from srsran_4g_tpu_torch.models import ue_dl as ue_dl_mod
from srsran_4g_tpu_torch.ops import ofdm as ofdm_ops
from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, demodulate, modulate
from srsran_4g_tpu_torch.utils import constants as C

DL_SF = 4   # default DL subframe index for single-subframe harnesses
UL_SF = 3   # default UL subframe index for single-subframe harnesses


class CchAllocator:
    """Per-TTI CCE allocation over the search spaces
    (sf_cch_allocator.cc): first non-colliding candidate wins."""

    def __init__(self, cell: G.CellConfig, cfi: int) -> None:
        self.cell = cell
        self.cfi = cfi
        self.n_cce = pdcch_mod.cce_re_indices(cell, cfi).shape[0]

    def alloc(self, rnti: int, used: set[int],
              min_l: int = 1, sf: int = DL_SF) -> tuple[int, int] | None:
        for l_agg, start in _candidates(self.cell, self.cfi, rnti, sf):
            if l_agg < min_l:
                continue
            cces = set(range(start, start + l_agg))
            if not (cces & used):
                used |= cces
                return l_agg, start
        return None


@functools.lru_cache(maxsize=1024)
def _candidates(cell: G.CellConfig, cfi: int, rnti: int, sf: int
                ) -> tuple[tuple[int, int], ...]:
    """The (L, cce_start) search-space candidates of an RNTI in a subframe."""
    return tuple(pdcch_mod.search_space_candidates(cell, cfi, rnti, sf))


def dci_to_pdsch_cfg(cell: G.CellConfig, rnti: int, d: dci_mod.Dci1A,
                     sf: int = DL_SF) -> pdsch_mod.PdschConfig:
    """Both sides derive the PDSCH parameters from the DCI alone
    (ra_dl.c: MCS→modulation/I_TBS→TBS)."""
    return pdsch_mod.PdschConfig(
        cell=cell, rnti=rnti, subframe=sf, mod=ra.dl_mcs_to_mod(d.mcs),
        tbs=ra.dl_tbs(d.mcs, d.l_crbs), rv=d.rv,
        prb_alloc=tuple(range(d.rb_start, d.rb_start + d.l_crbs)))


def dci_to_pdsch_mimo_cfg(cell: G.CellConfig, rnti: int, d, sf: int,
                          tm: int) -> pdsch_mimo.PdschMimoConfig:
    """Format 2/2A → dual-codeword PDSCH parameters (both sides derive
    everything from the DCI: RBG bitmap → PRBs, per-codeword MCS → TBS;
    TM4 pinfo 1..2 = rank-2 codebook index, ra_dl.c srsran_ra_dl_dci_to_grant
    + precoding info table 36.212 5.3.3.1.5-4)."""
    prbs = ra.type0_alloc_to_prbs(d.rbg_bitmap, cell.nof_prb)
    return pdsch_mimo.PdschMimoConfig(
        cell=cell, rnti=rnti, subframe=sf,
        mod0=ra.dl_mcs_to_mod(d.mcs0), tbs0=ra.dl_tbs(d.mcs0, len(prbs)),
        mod1=ra.dl_mcs_to_mod(d.mcs1), tbs1=ra.dl_tbs(d.mcs1, len(prbs)),
        tm="tm4" if tm == 4 else "tm3",
        pmi=d.pinfo if tm == 4 else 0,
        rv0=d.rv0, rv1=d.rv1, prb_alloc=prbs)


def _ul_cfg(cell: G.CellConfig, rnti: int, prb_start: int, prb_len: int,
            mcs: int, rv: int = 0, sf: int = UL_SF) -> pusch_mod.PuschConfig:
    return pusch_mod.PuschConfig(
        cell=cell, rnti=rnti, subframe=sf, mod=ra.ul_mcs_to_mod(mcs),
        tbs=ra.tbs_from_itbs(ra.ul_mcs_to_itbs(mcs), prb_len),
        prb_start=prb_start, nof_prb_alloc=prb_len, rv=rv)


def _pdu_bytes(bits: torch.Tensor) -> bytes:
    """A decoded TB's bits (tbs,) → its bytes."""
    return np.packbits(bits.to("cpu", torch.uint8).numpy()).tobytes()


class LteAirPhy:
    """The sample-domain channel both nodes share, on one device."""

    def __init__(self, nof_prb: int, cell_id: int = 1, cfi: int | None = None,
                 snr_db: float = 20.0, seed: int = 7,
                 fading=None, nof_ports: int = 1, nof_rx: int = 1,
                 frame_type: str = "fdd", ul_dl_config: int = 1,
                 ssf_config: int = 4,
                 device: torch.device | str | None = None) -> None:
        """`fading`: optional channel.fading.FadingConfig — applied (with
        independent DL/UL realisations) between the nodes, as the
        reference's channel emulator hooks into its rx/tx paths
        (srsue/src/phy/sync.cc:88-90).

        `nof_ports`/`nof_rx` = 2 selects the 2×2 MIMO air: the eNB
        assembles 2-port grids (SFBC control + CRS per port, TM3/TM4
        spatial-mux PDSCH), the DL channel is a fixed well-conditioned
        2×2 mix + AWGN, and the UE receives 2 antenna streams
        (enb.conf.example:17-31 `tm=3/4 nof_ports=2`).

        `frame_type="tdd"` selects frame structure type 2 with
        `ul_dl_config`/`ssf_config` (36.211 Table 4.2-2/-1): PSS moves
        to symbol 2 of the special subframes, SSS to the last symbol of
        sf 0/5, special subframes transmit only their DwPTS symbols, and
        the UL/PHICH/ACK timing helpers of models/tdd.py replace the FDD
        n+4 rule (phy_common.c:111 srsran_sfidx_tdd_type,
        harq_ack.c association sets).

        `device`: where every subframe is built, sent and received
        (default CUDA; raises without a card)."""
        self.device = resolve_device(device)
        self.fading = fading
        self.seed = seed
        self.nof_ports = nof_ports
        self.nof_rx = nof_rx
        if frame_type not in ("fdd", "tdd"):
            raise ValueError(f"frame_type is 'fdd' or 'tdd', not {frame_type!r}")
        if (nof_ports, nof_rx) not in ((1, 1), (2, 2)):
            raise ValueError("the air is 1x1 or 2x2")
        if fading is not None and nof_ports != 1:
            raise ValueError("fading emulation is single-port only")
        if frame_type == "tdd" and nof_ports != 1:
            raise ValueError("the TDD air is single-port")
        self.frame_type = frame_type
        self.ul_dl_config = ul_dl_config
        self.ssf_config = ssf_config
        if cfi is None:
            cfi = 3 if nof_prb <= 10 else 2
        self.cell = G.CellConfig(nof_prb=nof_prb, cell_id=cell_id, cfi=cfi,
                                 nof_ports=nof_ports, frame_type=frame_type)
        # fixed 2x2 DL mix (flat in frequency, constant over the run):
        # well-conditioned and with non-cancelling port sums so the
        # all-ports PSS/SSS transmission stays detectable on either antenna
        self.h_mix = np.array([[1.0 + 0.0j, 0.35 + 0.25j],
                               [-0.30 + 0.20j, 0.95 + 0.1j]], np.complex64)
        self.ofdm = OfdmConfig(nof_prb=nof_prb)
        self.cch = CchAllocator(self.cell, cfi)
        self.dci_len = dci_mod.format1a_len(nof_prb)
        self.nv = float(snr_to_noise_var(snr_db, device="cpu"))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.prach_cfg = prach_mod.PrachConfig(
            symbol_sz=C.symbol_sz(nof_prb), root_seq_index=0,
            zero_corr_zone=5)
        self._tabs: dict = {}

    # -- utilities -----------------------------------------------------------

    def sf_kind(self, tti: int) -> str:
        """'D'/'S'/'U' for TDD; always 'D' on the FDD air."""
        if self.frame_type == "fdd":
            return "D"
        return tdd_mod.sf_type(self.ul_dl_config, tti % 10)

    def ack_k(self, tti: int) -> int:
        """HARQ-ACK delay for a PDSCH at `tti` (FDD: 4; TDD: the
        association-set k)."""
        if self.frame_type == "fdd":
            return 4
        return tdd_mod.ack_delay(self.ul_dl_config, tti % 10)

    def ul_k(self, tti: int) -> int | None:
        """PUSCH delay for an UL grant/RAR at `tti` (FDD: 4; TDD:
        Table 8-2 — None when this subframe carries no UL grants)."""
        if self.frame_type == "fdd":
            return 4
        return tdd_mod.ul_grant_delay(self.ul_dl_config, tti % 10)

    def phich_k(self, tti: int) -> int:
        """PHICH delay for a PUSCH at `tti` (FDD: 4)."""
        if self.frame_type == "fdd":
            return 4
        return tdd_mod.phich_delay(self.ul_dl_config, tti % 10)

    def cqi_due(self, tti: int) -> bool:
        """Periodic CQI occasion: the report must land on an UL subframe
        (FDD keeps the historical tti%%20==5; TDD config1 uses sf 2)."""
        if self.frame_type == "fdd":
            return tti % 20 == 5
        return tti % 20 == 2

    def _tab(self, key, build):
        """A device table built once per key (the per-(config, subframe)
        host work that the JAX package leaves to its jit cache)."""
        t = self._tabs.get(key)
        if t is None:
            t = self._tabs[key] = build()
        return t

    def _bits(self, pdu: bytes, nbits: int) -> torch.Tensor:
        b = np.unpackbits(np.frombuffer(pdu, np.uint8))[:nbits]
        return torch.as_tensor(np.pad(b, (0, nbits - len(b))).astype(np.int8)[None],
                               device=self.device)

    # -- eNB TX --------------------------------------------------------------

    def enb_dl_tx(self, items: list[tuple[pdsch_mod.PdschConfig | None, bytes,
                                          np.ndarray, int, int, int]],
                  sf: int = DL_SF,
                  phich: list[tuple[int, int, int]] | None = None,
                  mib: tuple[np.ndarray, int] | None = None,
                  tti: int = 0) -> torch.Tensor:
        """items: (cfg, pdu, dci_bits, rnti, l_agg, cce_start) → samples.

        cfg None = DCI-only item (UL grant: PDCCH but no PDSCH).
        `sf` is the subframe index (tti % 10); at sf 0/5 the sync
        signals (PSS/SSS, and PBCH at sf 0) are added so a UE can
        acquire the cell over the air.  `phich`: (group, nseq, ack)
        UL-HARQ indications to carry (phich.c counterpart).
        Returns noisy time-domain samples (1, sf_len) — or
        (1, nof_rx, sf_len) on the 2×2 MIMO air.

        On a 2-port cell an item's cfg may be a `PdschMimoConfig` with
        pdu = (pdu0, pdu1): the dual-codeword TM3/TM4 spatial multiplex
        (srsenb cc_worker encode_pdsch at rank 2).
        """
        cell, dev = self.cell, self.device
        grid = None
        for cfg, pdu, _, _, _, _ in items:
            if cfg is None:
                continue
            if isinstance(cfg, pdsch_mimo.PdschMimoConfig):
                g = pdsch_mimo.encode(cfg, self._bits(pdu[0], cfg.tbs0),
                                      self._bits(pdu[1], cfg.tbs1))
            else:
                g = pdsch_mod.encode(cfg, self._bits(pdu, cfg.tbs))
            grid = g if grid is None else grid + g

        if grid is None:
            shape = ((1, cell.nsymb, cell.nre) if self.nof_ports == 1
                     else (1, self.nof_ports, cell.nsymb, cell.nre))
            grid = torch.zeros(shape, dtype=torch.complex64, device=dev)
        ref_cfg = pdsch_mod.PdschConfig(cell=cell, rnti=0, subframe=sf, mod="qpsk", tbs=16)
        grid = pdsch_mod.add_crs(ref_cfg, grid)
        cfi_arr = torch.full((grid.shape[0],), cell.cfi, dtype=torch.int32, device=dev)
        grid = pcfich_mod.put_into_grid(cell, grid, pcfich_mod.encode(cell, cfi_arr, sf))
        if self.frame_type == "fdd":
            if sf in (0, 5):
                grid = enb_dl.put_sync_signals(cell, grid, sf)
        elif sf in (0, 1, 5, 6):
            grid = enb_dl.put_sync_signals_tdd(cell, grid, sf)
        if mib is not None and sf == 0:
            mib_bits, block = mib
            syms = pbch_mod.encode(cell, torch.as_tensor(mib_bits[None], device=dev),
                                   n_ports=cell.nof_ports)
            grid = pbch_mod.put_into_grid(cell, grid, syms[:, block % 4])
        for group, nseq, ack in (phich or []):
            syms = phich_mod.encode(cell, torch.tensor([ack], dtype=torch.int8, device=dev),
                                    group, nseq, sf)
            grid = phich_mod.put_into_grid(cell, grid, syms, group)

        for cfg, _, dci_bits, rnti, l_agg, cce_start in items:
            grid = pdcch_mod.put_dci(cell, cell.cfi, sf, grid,
                                     torch.as_tensor(dci_bits[None], device=dev),
                                     rnti=rnti, l_agg=l_agg, cce_start=cce_start)

        if self.frame_type == "tdd" and self.sf_kind(tti) == "S":
            # special subframe: only the DwPTS symbols transmit
            # (36.211 Table 4.2-1 via tdd.dl_symbol_mask)
            mask = self._tab(("dwpts", sf), lambda: torch.as_tensor(
                tdd_mod.dl_symbol_mask(self.ul_dl_config, self.ssf_config, sf)
                .astype(np.float32), device=dev)[:, None])
            grid = grid * mask
        return self._channel(grid, tti, link=0)

    def _channel(self, grid: torch.Tensor, tti: int, link: int) -> torch.Tensor:
        """grid → (fading) → OFDM → AWGN → samples; `link` decorrelates
        the DL (0) and UL (1) fading realisations.  On the 2×2 MIMO DL
        (link 0, nof_ports=2) the per-port sample streams pass through the
        fixed `h_mix` before per-antenna AWGN."""
        cfg, dev = self.ofdm, self.device
        if link == 0 and self.nof_ports == 2:
            h = self._tab("h_mix", lambda: torch.as_tensor(self.h_mix, device=dev))
            y = torch.einsum("rt,bts->brs", h, modulate(cfg, grid))
            return awgn(y, self.nv, generator=self.gen)
        if self.fading is None:
            return awgn(modulate(cfg, grid), self.nv, generator=self.gen)
        offs, sc_f = self._tab("fading_axes", self._fading_axes)
        t0 = torch.tensor(float(tti) * 1e-3, dtype=torch.float32, device=dev)
        h = fad.freq_response(self.fading, self.seed * 2 + link, t0 + offs, sc_f)
        return awgn(modulate(cfg, grid * h[None]), self.nv, generator=self.gen)

    def _fading_axes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-symbol start times (s) within the subframe, and each
        subcarrier's frequency in cycles/sample."""
        cfg, n = self.ofdm, self.ofdm.symbol_sz
        offs = ofdm_ops._symbol_offsets(cfg) / (cfg.sf_len / 1e-3) * 1e-3
        bins = ofdm_ops._sc_to_bin(cfg).astype(np.int64)
        signed = np.where(bins >= n // 2, bins - n, bins)
        return (torch.as_tensor(offs, dtype=torch.float32, device=self.device),
                torch.as_tensor((signed / n).astype(np.float32), device=self.device))

    # -- UE cell acquisition ---------------------------------------------------

    def ue_cell_search(self, samples: torch.Tensor) -> dict:
        """PSS/SSS blind search on one subframe of samples
        (srsue sync.cc FIND via ue_dl.cell_search).

        Returns dict(found, cell_id, phase (0: sf 0, 1: sf 5), peak)."""
        if self.nof_rx == 2:
            samples = samples[:, 0]    # search on antenna 0 (sync.cc)
        out = ue_dl_mod.cell_search(samples, nof_prb=self.cell.nof_prb)
        peak = float(out["pss_peak"][0])
        return dict(found=peak > 0.5, cell_id=int(out["cell_id"][0]),
                    phase=int(out["phase"][0]), peak=peak)

    def ue_cell_search_tdd(self, samples2: torch.Tensor) -> dict:
        """TDD cell search over a TWO-subframe buffer [sf_n-1 | sf_n]:
        the PSS sits in symbol 2 of the special subframe and the SSS in
        the last symbol of the PRECEDING subframe (sync.c frame-type
        detection; models/tdd.detect_frame_type).

        Returns dict(found, cell_id, phase, peak) where phase 0 means
        the buffer's first subframe is sf 0 (1 → sf 5)."""
        cfg = self.ofdm
        found = sync_mod.find_pss(samples2, cfg.symbol_sz)
        res = tdd_mod.detect_frame_type(samples2, found["offset"], found["n_id_2"], cfg)
        exp_off = tdd_mod.pss_to_sf_start(cfg, "tdd")
        off_v = int(found["offset"][0])
        peak = float(found["peak"][0])
        ok = peak > 0.5 and int(res.frame_type[0]) == 1 and abs(off_v - exp_off) < 4
        cell_id = 3 * int(res.n_id_1[0]) + int(found["n_id_2"][0])
        return dict(found=ok, cell_id=cell_id, phase=int(res.phase[0]), peak=peak)

    def ue_mib_rx(self, samples: torch.Tensor, cell_id: int) -> dict | None:
        """PBCH decode from a subframe-0 sample buffer (ue_mib.c): the
        central 6 PRB of the full-band grid carry the PBCH; the 40 ms
        segment index (sfn %% 4) is blind-tried.  Returns
        dict(mib (24,), n_ports, block) or None."""
        if self.nof_rx == 2:
            samples = samples[:, 0]    # MIB from antenna 0 (ue_mib.c)
        grid = demodulate(self.ofdm, samples)
        mid = self.cell.nre // 2
        g6 = grid[..., mid - 36:mid + 36]
        cell6 = G.CellConfig(nof_prb=6, cell_id=cell_id, cfi=self.cell.cfi,
                             nof_ports=self.nof_ports)
        ccfg = chest_mod.ChestConfig(cell=cell6)
        est = chest_mod.estimate(ccfg, g6, 0, port=0)
        h1 = (chest_mod.estimate(ccfg, g6, 0, port=1)["h"] if self.nof_ports == 2
              else None)
        for blk in range(4):
            r = pbch_mod.decode(cell6, g6, est["h"], est["noise_var"], frame_idx=blk, h1=h1)
            if bool(r["crc_ok"][0]):
                return dict(mib=r["mib"][0].cpu().numpy(), n_ports=int(r["n_ports"][0]),
                            block=blk)
        return None

    # -- PHICH -----------------------------------------------------------------

    def _ue_front(self, samples: torch.Tensor, sf: int):
        """OFDM demod + CRS estimation front-end
        (srsran_ue_dl_decode_fft_estimate, ue_dl.c:349).

        SISO: returns (grid (B,S,K), h, None, h_full=None, nv, snr_db).
        2×2:  returns (grids (B,2,S,K), h (rx0,port0), h1 (rx0,port1),
        h_full (B,2rx,2tx,S,K), nv, snr_db)."""
        ccfg = chest_mod.ChestConfig(cell=self.cell)
        grids = demodulate(self.ofdm, samples)
        if self.nof_rx == 1:
            est = chest_mod.estimate(ccfg, grids, subframe=sf)
            return grids, est["h"], None, None, est["noise_var"], est["snr_db"]
        ests = [[chest_mod.estimate(ccfg, grids[:, r], sf, port=p) for p in range(2)]
                for r in range(2)]
        h_full = torch.stack([torch.stack([ests[r][p]["h"] for p in range(2)], dim=1)
                              for r in range(2)], dim=1)  # (B, rx, tx, S, K)
        nv = sum(ests[r][p]["noise_var"] for r in range(2) for p in range(2)) / 4
        return grids, h_full[:, 0, 0], h_full[:, 0, 1], h_full, nv, ests[0][0]["snr_db"]

    def ue_phich_rx(self, samples: torch.Tensor, group: int, nseq: int,
                    sf: int = DL_SF) -> bool:
        """Decode one PHICH: True = ACK, False = NACK
        (srsue cc_worker decode_phich)."""
        grid, h, h1, _, nv, _ = self._ue_front(samples, sf)
        if self.nof_rx == 2:
            grid = grid[:, 0]
        r = phich_mod.decode(self.cell, grid, h, nv, group=group, nseq=nseq,
                             subframe=sf, h1=h1)
        return bool(r["ack"][0])

    # -- UE RX ----------------------------------------------------------------

    def ue_dl_rx_multi(self, samples: torch.Tensor, rnti: int, sf: int = DL_SF,
                       harq_bufs: dict | None = None,
                       mimo_fmt: str | None = None,
                       common_1c: bool = False) -> dict:
        """Blind-decode the UE's full search space for `rnti`.

        Returns dict(snr_db, hits=[{dci|ul_dci|dci2, cce_start, pdu?,
        pdu2?}, ...]) plus (2×2 air) ri/pmi/cqi from the CRS channel
        estimate (srsran_pmi_select feedback, precoding.c:307).
        Every CRC-passing candidate is taken, smallest aggregation level
        first, skipping candidates whose CCEs overlap an accepted one
        (overlapping "echo" detections of the same DCI at a larger L).
        pdu None on a DL hit = PDSCH KO (CRC fail).

        `harq_bufs` is the UE's per-process soft-buffer store
        ({pid: {"ndi", "tbs", "bufs"}}, the buffers device tensors):
        retransmissions of the same process (same NDI/TBS) chase-combine
        their LLRs before turbo decoding, as the reference's
        srsran_softbuffer_rx (ue_dl.c decode_tb softbuffer path).
        Dual-codeword (format 2/2A) transmissions re-decode each
        retransmission standalone.

        `mimo_fmt`: "2" (TM4) or "2A" (TM3) adds a second blind search
        at that format's payload length (ue_dl.c:543-548 searches the
        TM-specific format alongside 0/1A).

        `common_1c`: also search the format-1C payload length — the
        compact SI/RAR/paging format a real UE always monitors in the
        common search space (ra_dl.c:383 P/SI/RA-RNTI accept 1A/1C).
        """
        cell = self.cell
        grids, h, h1, h_full, nv, snr_db = self._ue_front(samples, sf)
        grid0 = grids[:, 0] if self.nof_rx == 2 else grids
        cands = _candidates(cell, cell.cfi, rnti, sf)

        def run_blind(dci_len):
            out = pdcch_mod.blind_decode(cell, cell.cfi, sf, grid0, h, nv, rnti=rnti,
                                         dci_len=dci_len, candidates=list(cands), h1=h1)
            return (out["ok_per_candidate"][0].cpu().numpy(),
                    out["payload_per_candidate"][0].cpu().numpy())

        res = dict(snr_db=float(snr_db[0]), hits=[])
        if self.nof_rx == 2:
            res.update(self._csi_report(h_full, nv))
        ok, payloads = run_blind(self.dci_len)
        ok2, payloads2 = np.zeros_like(ok), None
        if mimo_fmt is not None:
            len2 = (dci_mod.format2_len(cell.nof_prb, 2) if mimo_fmt == "2"
                    else dci_mod.format2a_len(cell.nof_prb, 2))
            ok2, payloads2 = run_blind(len2)
        ok1c, payloads1c = np.zeros_like(ok), None
        if common_1c:
            ok1c, payloads1c = run_blind(dci_mod.format1c_len(cell.nof_prb))
        if not ok.any() and not ok2.any() and not ok1c.any():
            return res
        used: set[int] = set()
        for i in sorted(range(len(cands)), key=lambda i: cands[i][0]):
            if not (ok[i] or ok2[i] or ok1c[i]):
                continue
            l_agg, start = cands[i]
            cces = set(range(start, start + l_agg))
            if cces & used:
                continue
            used |= cces
            if ok1c[i] and not ok[i] and not ok2[i]:
                d1c = dci_mod.unpack_1c(payloads1c[i], cell.nof_prb)
                cfg = pdsch_mod.PdschConfig(
                    cell=cell, rnti=rnti, subframe=sf, mod="qpsk",
                    tbs=ra.dl_tbs_1c(d1c.mcs),
                    prb_alloc=dci_mod.dci1c_prbs(d1c, cell.nof_prb))
                h_1c = h if h1 is None else torch.stack([h, h1], dim=1)
                r = pdsch_mod.decode(cfg, grid0, h=h_1c, noise_var=nv, n_iter=6)
                pdu = _pdu_bytes(r["bits"][0]) if bool(r["crc_ok"][0]) else None
                res["hits"].append(dict(dci_1c=d1c, cce_start=start, pdu=pdu))
                continue
            if ok2[i] and not ok[i]:
                d2 = (dci_mod.unpack_2(payloads2[i], cell.nof_prb) if mimo_fmt == "2"
                      else dci_mod.unpack_2a(payloads2[i], cell.nof_prb))
                res["hits"].append(self._rx_dual_cw(
                    grids, h_full, nv, rnti, sf, d2, start, 4 if mimo_fmt == "2" else 3))
                continue
            bits = payloads[i]
            if bits[0] == 0:       # format 0/1A flag: UL grant
                res["hits"].append(dict(ul_dci=dci_mod.unpack_0(bits, cell.nof_prb),
                                        cce_start=start))
                continue
            d = dci_mod.unpack_1a(bits, cell.nof_prb)
            cfg = dci_to_pdsch_cfg(cell, rnti, d, sf)
            sb = None
            if harq_bufs is not None:
                ent = harq_bufs.get(d.harq_pid)
                if (ent is not None and ent["ndi"] == d.ndi
                        and ent["tbs"] == cfg.tbs):
                    sb = ent["bufs"]
            h_sfbc = h if h1 is None else torch.stack([h, h1], dim=1)
            r = pdsch_mod.decode(cfg, grid0, h=h_sfbc, noise_var=nv, softbuffers=sb,
                                 n_iter=6)
            crc_ok = bool(r["crc_ok"][0])
            if harq_bufs is not None:
                harq_bufs[d.harq_pid] = dict(
                    ndi=d.ndi, tbs=cfg.tbs,
                    bufs=None if crc_ok else r.get("softbuffers"))
            pdu = _pdu_bytes(r["bits"][0]) if crc_ok else None
            res["hits"].append(dict(dci=d, cce_start=start, pdu=pdu))
        return res

    def _rx_dual_cw(self, grids: torch.Tensor, h_full: torch.Tensor, nv, rnti: int,
                    sf: int, d, start: int, tm: int) -> dict:
        """Decode a format 2/2A dual-codeword PDSCH from both RX antennas
        (pdsch_mimo.decode: effective channel H·W → batched 2×2 MMSE →
        per-codeword DL-SCH)."""
        cfg = dci_to_pdsch_mimo_cfg(self.cell, rnti, d, sf, tm)
        r = pdsch_mimo.decode(cfg, grids, h=h_full, noise_var=nv, n_iter=6)
        pdu = _pdu_bytes(r["bits0"][0]) if bool(r["crc_ok0"][0]) else None
        pdu2 = _pdu_bytes(r["bits1"][0]) if bool(r["crc_ok1"][0]) else None
        return dict(dci2=d, cce_start=start, pdu=pdu, pdu2=pdu2)

    def _csi_report(self, h_full: torch.Tensor, nv) -> dict:
        """RI/PMI selection from the full 2×2 CRS estimate: capacity
        argmax over the rank-1/rank-2 codebooks (mimo.pmi_select_2tx,
        reference srsran_pmi_select precoding.c:307)."""
        h = h_full.reshape(h_full.shape[:3] + (-1,))  # (B, rx, tx, S*K)
        _, m1 = mimo.pmi_select_2tx(h, nv, rank=1)
        pmi2, m2 = mimo.pmi_select_2tx(h, nv, rank=2)
        ri = 2 if float(m2.amax(dim=-1)[0]) > float(m1.amax(dim=-1)[0]) else 1
        return dict(ri=ri, pmi=int(pmi2[0]))

    # -- UE UL TX --------------------------------------------------------------

    def pucch_cfg(self, n_pucch: int, rnti: int = 0,
                  n_rb_2: int = 1, sf: int = UL_SF) -> pucch_mod.PucchConfig:
        return pucch_mod.PucchConfig(cell=self.cell, subframe=sf,
                                     n_pucch=n_pucch, n_rb_2=n_rb_2,
                                     rnti=rnti)

    def ue_ul_tx(self, pusch: tuple[pusch_mod.PuschConfig, bytes] | None,
                 ack: tuple[int, int] | None = None,
                 sr: int | None = None,
                 cqi: tuple[int, int, int] | None = None,
                 csi: tuple[int, int, int, int, int] | None = None,
                 sf: int = UL_SF) -> torch.Tensor | None:
        """One UE's UL grid: PUSCH + PUCCH contributions (or None).

        ack: (n_pucch, ack_bit); sr: n_pucch_sr; cqi: (n_pucch_2, rnti, cqi);
        csi: (n_pucch_2, rnti, cqi, ri, pmi) — the 7-bit CQI(4)+RI(1)+PMI(2)
        periodic report of the 2×2 air (36.213 §7.2.2 mode 1-1 condensed
        onto one format-2 occasion; format 2 carries up to 13 bits).
        """
        dev = self.device
        grid = None

        def add(g):
            return g if grid is None else grid + g

        if pusch is not None:
            cfg, pdu = pusch
            grid = pusch_mod.encode(cfg, self._bits(pdu, cfg.tbs))
        if ack is not None:
            n_pucch, bit = ack
            grid = add(pucch_mod.encode_format1(
                self.pucch_cfg(n_pucch, sf=sf),
                torch.tensor([[bit]], dtype=torch.int8, device=dev)))
        if sr is not None:
            grid = add(pucch_mod.encode_format1(self.pucch_cfg(sr, sf=sf), None, device=dev))
        if cqi is not None:
            n2, rnti, val = cqi
            bits = ((val >> np.arange(3, -1, -1)) & 1).astype(np.int8)
            grid = add(pucch_mod.encode_format2(self.pucch_cfg(n2, rnti=rnti, sf=sf),
                                                torch.as_tensor(bits[None], device=dev)))
        if csi is not None:
            n2, rnti, val, ri, pmi = csi
            word = (val << 3) | ((ri - 1) << 2) | (pmi & 3)
            bits = ((word >> np.arange(6, -1, -1)) & 1).astype(np.int8)
            grid = add(pucch_mod.encode_format2(self.pucch_cfg(n2, rnti=rnti, sf=sf),
                                                torch.as_tensor(bits[None], device=dev)))
        return grid

    def combine_ul(self, grids: list, tti: int = 0) -> torch.Tensor:
        """Sum per-UE UL grids and push through the channel → eNB samples."""
        total = None
        for g in grids:
            if g is not None:
                total = g if total is None else total + g
        if total is None:
            total = torch.zeros((1, self.cell.nsymb, self.cell.nre),
                                dtype=torch.complex64, device=self.device)
        return self._channel(total, tti, link=1)

    # -- eNB UL RX ---------------------------------------------------------------

    def enb_ul_grid(self, samples: torch.Tensor) -> torch.Tensor:
        return demodulate(self.ofdm, samples)

    def enb_pusch_rx(self, ul_grid: torch.Tensor, cfg: pusch_mod.PuschConfig
                     ) -> bytes | None:
        r = pusch_mod.decode(cfg, ul_grid, n_iter=6)
        if not bool(r["crc_ok"][0]):
            return None
        return _pdu_bytes(r["bits"][0])

    def enb_pucch_ack_rx(self, ul_grid: torch.Tensor, n_pucch: int,
                         sf: int = UL_SF) -> bool | None:
        """→ True (ACK) / False (NACK) / None (DTX)."""
        r = pucch_mod.decode_format1(self.pucch_cfg(n_pucch, sf=sf), ul_grid, 1,
                                     noise_var=self.nv)
        if not bool(r["detected"][0]):
            return None
        return int(r["bits"][0, 0]) == 0  # bit 0 ⇔ ACK

    def enb_sr_rx(self, ul_grid: torch.Tensor, n_pucch_sr: int, sf: int = UL_SF) -> bool:
        r = pucch_mod.decode_format1(self.pucch_cfg(n_pucch_sr, sf=sf), ul_grid, 1,
                                     noise_var=self.nv)
        return bool(r["detected"][0])

    def enb_cqi_rx(self, ul_grid: torch.Tensor, n_pucch_2: int, rnti: int,
                   sf: int = UL_SF) -> int:
        r = pucch_mod.decode_format2(self.pucch_cfg(n_pucch_2, rnti=rnti, sf=sf), ul_grid, 4)
        bits = r["bits"][0].cpu().numpy()
        return int(bits.dot(1 << np.arange(3, -1, -1)))

    def enb_csi_rx(self, ul_grid: torch.Tensor, n_pucch_2: int, rnti: int,
                   sf: int = UL_SF) -> tuple[int, int, int]:
        """→ (cqi, ri, pmi): the 7-bit CQI+RI+PMI periodic report of the
        2×2 air (counterpart of ue_ul_tx csi=...)."""
        r = pucch_mod.decode_format2(self.pucch_cfg(n_pucch_2, rnti=rnti, sf=sf), ul_grid, 7)
        bits = r["bits"][0].cpu().numpy()
        word = int(bits.dot(1 << np.arange(6, -1, -1)))
        return word >> 3, ((word >> 2) & 1) + 1, word & 3

    # -- PRACH ---------------------------------------------------------------------

    def _prach_noisy(self, preamble_idx: int) -> torch.Tensor:
        """The UE's preamble at unit power plus the air's noise (1, n)."""
        pre = prach_mod.generate(self.prach_cfg, preamble_idx, device=self.device)
        pre = pre / torch.sqrt(torch.mean(pre.abs() ** 2))
        return awgn(pre[None, :], self.nv, generator=self.gen)

    def prach_tx_samples(self, preamble_idx: int) -> torch.Tensor:
        """UE-side PRACH for the sample-stream (multi-process) deployment:
        normalised noisy preamble padded to one subframe of samples
        (the three-process analog of `prach`; prach.c preamble gen)."""
        noisy = self._prach_noisy(preamble_idx)
        out = torch.zeros((1, self.ofdm.sf_len), dtype=torch.complex64, device=self.device)
        n = min(noisy.shape[1], self.ofdm.sf_len)
        out[:, :n] = noisy[:, :n]
        return out

    def prach_rx(self, samples: torch.Tensor) -> int | None:
        """eNB-side PRACH correlation on one UL subframe of samples
        (prach_worker.cc FFT correlation off the fast path)."""
        cfg = self.prach_cfg
        sl = samples[:, :cfg.cp_len + cfg.seq_len_samples]
        # energy gate: an idle (zero/PUCCH-only) subframe must not reach
        # the correlator with pathological normalisation
        if float(torch.mean(sl.abs() ** 2)) < 1e-6:
            return None
        return self._prach_detect(sl)

    def _prach_detect(self, rx: torch.Tensor) -> int | None:
        det = prach_mod.detect(self.prach_cfg, rx)
        if not bool(det["detected"][0].any()):
            return None
        return int(det["power"][0].argmax())

    def prach(self, preamble_idx: int) -> int | None:
        """UE preamble TX → eNB detect; returns detected index or None."""
        return self._prach_detect(self._prach_noisy(preamble_idx))
