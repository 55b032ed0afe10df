"""Sharded end-to-end PHY pipeline over a (dp, sp) rank mesh.

Port counterpart of ``srsran_4g_tpu/parallel/pipeline.py``: a full
encode → channel → receive → decode round per subframe batch, one rank a
device, in the SPMD form of the JAX package's ``shard_map`` program:

- transport blocks are sharded over ``dp`` (subframe/UE data parallelism);
- the IQ sample stream of every subframe is sharded over ``sp`` in
  contiguous time blocks; the fading FIR's tail and symbol-spanning samples
  come from the ring neighbour (``parallel/stream.py``), the per-symbol grids
  are reassembled with an ``all_reduce``, and the turbo decode splits its
  code-block lanes over ``sp`` (``sch.dlsch_decode(cb_shard=…)``);
- BLER/bit counters are summed over the whole mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from srsran_4g_tpu_torch.models import pdsch as pdsch_mod
from srsran_4g_tpu_torch.ops import ofdm as ofdm_mod
from srsran_4g_tpu_torch.parallel import dist, stream
from srsran_4g_tpu_torch.parallel.mesh import Mesh


def channel_taps(fir_taps: int = 9) -> np.ndarray:
    """The static channel's unit-energy taps, drawn as the JAX package draws
    them (``np.random.default_rng(1234)``), so both packages fade alike."""
    rng = np.random.default_rng(1234)
    taps = rng.standard_normal(fir_taps) + 1j * rng.standard_normal(fir_taps)
    taps[0] += 3.0 * np.sqrt(fir_taps)  # strong LOS tap keeps it equalisable
    return (taps / np.linalg.norm(taps)).astype(np.complex64)


class PipelineStep:
    """One sharded pipeline step for this rank; see ``make_pipeline_step``."""

    def __init__(self, cfg: pdsch_mod.PdschConfig, mesh: Mesh, snr_db: float,
                 fir_taps: int, n_iter: int):
        self.cfg = cfg
        self.mesh = mesh
        self.n_iter = n_iter
        self.ofdm_cfg = ofdm_mod.OfdmConfig(nof_prb=cfg.cell.nof_prb)
        self.sp = mesh.shape["sp"]
        if self.ofdm_cfg.sf_len % self.sp:
            raise ValueError(f"a subframe of {self.ofdm_cfg.sf_len} samples does not split "
                             f"into {self.sp} chunks")
        self.chunk = self.ofdm_cfg.sf_len // self.sp
        # channel/awgn.py's scale: sqrt(noise_var / 2) in float32
        noise_var = np.float32(10.0 ** (-snr_db / 10.0))
        self.noise_std = float(np.sqrt(noise_var / 2, dtype=np.float32))
        self.taps = torch.as_tensor(channel_taps(fir_taps), device=mesh.device)

    def local_step(self, tb_bits: torch.Tensor, noise: torch.Tensor) -> tuple[dict, dict]:
        """This rank's body on its dp rows ``tb_bits`` (b, tbs) int8 and its
        chunk's unit complex normal noise ``noise`` (b, chunk) complex64.

        Returns (the mesh-summed metrics as floats: bit_errors, blocks_ok,
        blocks, bler; this rank's receive: rx_grid and ``pdsch.decode``'s
        output)."""
        cfg, sp = self.cfg, self.sp
        sp_group = self.mesh.get_group("sp")
        sp_idx = self.mesh.coordinate[1]
        # ---- TX (dp-sharded batch, replicated over sp) --------------------
        tx_grid = pdsch_mod.add_crs(cfg, pdsch_mod.encode(cfg, tb_bits))
        samples = ofdm_mod.modulate(self.ofdm_cfg, tx_grid)  # (b, sf_len)

        # ---- channel: sp-sharded time blocks with a ring halo exchange ----
        local = samples[..., sp_idx * self.chunk:(sp_idx + 1) * self.chunk]
        faded = stream.fir_filter_sharded(local, self.taps, sp_group)
        noisy = faded + self.noise_std * noise

        # ---- RX: sharded OFDM demod reassembles the grid over sp ----------
        rx_grid = stream.ofdm_demodulate_sharded(self.ofdm_cfg, noisy, sp_group)
        # the dominant turbo decode splits its code-block lanes over sp
        # (all-gathered back), so no rank decodes redundantly
        out = pdsch_mod.decode(cfg, rx_grid, n_iter=self.n_iter,
                               cb_shard=(sp_group, sp) if sp > 1 else None)

        bit_err = (out["bits"] != tb_bits).sum() / sp  # sp-replicated
        blocks_ok = out["crc_ok"].sum() / sp
        blocks = torch.tensor(tb_bits.shape[0] / sp, device=bit_err.device)
        stats = torch.stack([bit_err.float(), blocks_ok.float(), blocks.float()])
        bit_errors, ok, n = dist.all_reduce_sum(stats, None).tolist()
        metrics = {"bit_errors": bit_errors, "blocks_ok": ok, "blocks": n,
                   "bler": 1.0 - ok / n}
        return metrics, dict(out, rx_grid=rx_grid)

    def __call__(self, tb_bits: torch.Tensor, seed: int) -> dict:
        """The step on this rank's dp rows, noise drawn on the rank's device
        from (seed, sp index): ranks of one sp index draw the same noise, as
        JAX's ``fold_in(key, sp_idx)`` does.  Returns the summed metrics."""
        state = np.random.SeedSequence([seed, self.mesh.coordinate[1]]).generate_state(1)
        gen = torch.Generator(device=self.mesh.device).manual_seed(int(state[0]))
        shape = (tb_bits.shape[0], self.chunk)
        noise = torch.complex(
            torch.randn(shape, generator=gen, device=self.mesh.device),
            torch.randn(shape, generator=gen, device=self.mesh.device))
        return self.local_step(tb_bits, noise)[0]


def make_pipeline_step(cfg: pdsch_mod.PdschConfig, mesh: Mesh, snr_db: float = 20.0,
                       fir_taps: int = 9, n_iter: int = 4) -> PipelineStep:
    """Build this rank's sharded pipeline step.

    Returns step(tb_bits (b, tbs), seed) → the mesh-summed metrics, with
    ``step.local_step(tb_bits, noise)`` for given noise.  Every rank of the
    mesh calls it together: the collectives pair them.
    """
    return PipelineStep(cfg, mesh, snr_db, fir_taps, n_iter)


def shard_batch(mesh: Mesh, x: np.ndarray | torch.Tensor) -> torch.Tensor:
    """This rank's dp rows of a host batch (B, ...), on the rank's device."""
    dp = mesh.shape["dp"]
    rows = x.shape[0]
    if rows % dp:
        raise ValueError(f"a batch of {rows} does not split over dp={dp}")
    loc = rows // dp
    i = mesh.coordinate[0]
    return torch.as_tensor(x[i * loc:(i + 1) * loc]).to(mesh.device)
