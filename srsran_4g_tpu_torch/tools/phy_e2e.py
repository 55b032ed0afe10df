"""Two-process PHY end-to-end loopback over the native IQ bridge.

The framework's analog of the reference's ZMQ-based E2E system test
(test/run_lte.sh): an eNB process assembles DL subframes (CRS + sync +
PCFICH + PDSCH) and streams IQ samples over the native TCP bridge; a UE
process consumes the sample stream (sample count = clock), OFDM-demodulates,
estimates the channel from CRS and decodes the PDSCH, asserting zero block
errors on a shared pseudo-random payload.

Port counterpart of the repo's ``tools/phy_e2e.py``: the same roles, wire and
output lines, on ``--device`` (default CUDA; there is no CPU fallback:
``--device cpu`` asks for the CPU) and at ``--prb`` (default 6, where the
grant is the JAX tool's: QPSK, TBS 408; at any width, QPSK at I_TBS 4 over the
whole band).  On the card the UE also prints the turbo wrappers' launch
counts and the largest (B, K, L, T) each launched at.

Run standalone:
    python -m srsran_4g_tpu_torch.tools.phy_e2e enb --port 45111 --subframes 20 &
    python -m srsran_4g_tpu_torch.tools.phy_e2e ue  --port 45111 --subframes 20
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device

I_TBS = 4  # TBS 408 at 6 PRB, the JAX tool's grant


def make_cfg(nof_prb=6, cell_id=42, subframe=4):
    from srsran_4g_tpu_torch.models import grid as G, pdsch, ra

    cell = G.CellConfig(nof_prb=nof_prb, cell_id=cell_id, cfi=1)
    return pdsch.PdschConfig(
        cell=cell, rnti=0x46, subframe=subframe, mod="qpsk",
        tbs=ra.tbs_from_itbs(I_TBS, nof_prb)
    )


def payload(cfg, n_sf: int, seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n_sf, cfg.tbs)).astype(np.int8)


def run_enb(port: int, n_sf: int, nof_prb: int, device: torch.device) -> None:
    from srsran_4g_tpu_torch.models import enb_dl
    from srsran_4g_tpu_torch.runtime.native import IqBridgeTx

    # bind first: the UE may connect while the subframes are built
    tx = IqBridgeTx(port)
    cfg = make_cfg(nof_prb)
    bits = payload(cfg, n_sf)
    grid_tx = enb_dl.assemble_subframe(cfg, bits, device=device)
    samples = enb_dl.subframe_to_samples(cfg.cell, grid_tx).cpu().numpy()
    tx.accept()
    for i in range(n_sf):
        tx.send(samples[i])
    tx.close()
    print(f"enb: streamed {n_sf} subframes", flush=True)


def run_ue(port: int, n_sf: int, nof_prb: int, device: torch.device) -> int:
    from srsran_4g_tpu_torch.models import ue_dl
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig
    from srsran_4g_tpu_torch.runtime.native import IqBridgeRx

    cfg = make_cfg(nof_prb)
    ofdm = OfdmConfig(nof_prb=cfg.cell.nof_prb)
    rx = IqBridgeRx("127.0.0.1", port, timeout_ms=30000)
    frames = [rx.read(ofdm.sf_len) for _ in range(n_sf)]
    rx.close()
    rx_samples = torch.from_numpy(np.stack(frames)).to(device)
    out = ue_dl.receive_pdsch_subframe(cfg, rx_samples, n_iter=4)
    ok = out["crc_ok"].cpu().numpy()
    bits = out["bits"].cpu().numpy()
    expect = payload(cfg, n_sf)
    n_ok = int(ok.sum())
    match = bool((bits[ok] == expect[ok]).all()) if n_ok else False
    print(f"ue: {n_ok}/{n_sf} subframes CRC-OK, payload match={match}",
          flush=True)
    if device.type == "cuda":
        from srsran_4g_tpu_torch.apps.srsenb import turbo_result

        print("ue: turbo " + json.dumps(turbo_result()), flush=True)
    return 0 if n_ok == n_sf and match else 1


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("role", choices=["enb", "ue"])
    p.add_argument("--port", type=int, default=45111)
    p.add_argument("--subframes", type=int, default=10)
    p.add_argument("--prb", type=int, default=6)
    p.add_argument("--device", default="cuda",
                   help="torch device of the PHY (default cuda)")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as err:
        sys.exit(f"phy_e2e: {err}")
    if args.role == "enb":
        run_enb(args.port, args.subframes, args.prb, dev)
        return 0
    return run_ue(args.port, args.subframes, args.prb, dev)


if __name__ == "__main__":
    sys.exit(main())
