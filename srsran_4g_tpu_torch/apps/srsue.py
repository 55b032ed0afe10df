"""srsUE process: UE stack + the port's PHY behind the native IQ bridge.

The framework's counterpart of `srsue/src/main.cc:724` + `ue.cc:53`: a
standalone UE process that connects to the eNB's DL IQ stream, runs the
over-the-air acquisition FSM (PSS/SSS → PBCH MIB → SI; srsue
`sync.cc:684-709`), transmits PRACH/PUSCH/PUCCH back in its own UL
sample stream (sample count = clock, `rf_zmq_imp.c` model) and attaches
through NAS — then answers the EPC's DL ping train end-to-end.

Prints one final line `RESULT {json}`.

Port counterpart of ``srsran_4g_tpu/apps/srsue.py``: the same flags, wire
and RESULT fields over the port's ``UeNode``/``UePhy`` and ``LteAirPhy`` on
``--device`` (default CUDA; there is no CPU fallback: ``--device cpu`` asks
for the CPU).  Each TTI copies the DL samples to the device once and the UL
samples (PRACH, or the UL grid through the channel) to the host once.  On
the card the turbo kernels load before the bridges open and the RESULT line
adds ``turbo``, as in ``srsenb``; ``--tm``/``--cc`` fall back to the config
file the same way, and ``--tdd`` with TM 3/4 is a usage error.

Usage: python -m srsran_4g_tpu_torch.apps.srsue --dl-port 45201 --ul-port 45202
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="srsUE on the PyTorch port")
    ap.add_argument("--config", default=None, help="INI config (ue.conf)")
    ap.add_argument("--dl-addr", default="127.0.0.1")
    ap.add_argument("--dl-port", type=int, default=45201,
                    help="IQ bridge port the eNB serves DL samples on")
    ap.add_argument("--ul-port", type=int, default=45202,
                    help="IQ bridge port this UE serves UL samples on")
    ap.add_argument("--prb", type=int, default=None)
    ap.add_argument("--ue-idx", type=int, default=0,
                    help="UE index: offsets the IMSI, PUCCH resources "
                         "and RA occasion (multi-UE deployments)")
    ap.add_argument("--snr", type=float, default=30.0)
    ap.add_argument("--ttis", type=int, default=480)
    ap.add_argument("--tm", type=int, default=None,
                    help="transmission mode 1, 3 or 4 (3/4 = 2x2 cell: the "
                         "DL bridge carries 2 RX-antenna streams per TTI; "
                         "default: the config's [cell] tm)")
    ap.add_argument("--tdd", action="store_true",
                    help="frame structure type 2 (UL/DL config 1; TM 1 only)")
    ap.add_argument("--cc", type=int, default=None,
                    help="component carriers, 1 or 2 (2 = read the SCell DL "
                         "stream from dl_port+50+2*ue_idx; default: the "
                         "config's [rat.eutra] nof_carriers)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the PHY (default cuda)")
    ap.add_argument("-v", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from srsran_4g_tpu_torch import resolve_device
    from srsran_4g_tpu_torch.apps.nodes import UeNode, UePhy
    from srsran_4g_tpu_torch.apps.srsenb import cell_mode, load_turbo, turbo_result
    from srsran_4g_tpu_torch.config import load_config
    from srsran_4g_tpu_torch.runtime.lte_air import LteAirPhy
    from srsran_4g_tpu_torch.runtime.native import IqBridgeRx, IqBridgeTx

    cfg = load_config(args.config)
    nof_prb = args.prb if args.prb is not None else cfg.cell.nof_prb
    tm, nof_ports, cc = cell_mode(ap, args, cfg)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as err:
        sys.exit(f"srsue: {err}")
    log = (lambda *a: print(*a, flush=True)) if args.v else (lambda *a: None)

    stats = {"prach": 0, "pdsch_ko": 0, "pusch_ko": 0, "pdsch_tx": 0,
             "pusch_tx": 0, "dl_ping_rx": 0, "ul_ping_rx": 0,
             "dci_tx": 0, "phich_ack": 0, "phich_nack": 0}
    # UL noise is applied UE-side (the reference's channel emulator hooks
    # into the tx path, sync.cc:88-90); seed decorrelated from the eNB's DL
    air = LteAirPhy(nof_prb=nof_prb, snr_db=args.snr,
                    seed=13 + args.ue_idx, nof_ports=nof_ports,
                    nof_rx=nof_ports,
                    frame_type="tdd" if args.tdd else "fdd", device=dev)
    ue = UeNode(args.ue_idx, air, stats, log, tm=tm)
    air_s = (LteAirPhy(nof_prb=nof_prb, cell_id=2, snr_db=args.snr,
                       seed=11, device=dev)
             if cc == 2 else None)
    uephy = UePhy(ue, air, air_s)
    load_turbo(dev)

    # connect to the eNB's DL stream first, then serve our UL stream
    dl_rx = None
    for _ in range(300):
        try:
            dl_rx = IqBridgeRx(args.dl_addr, args.dl_port, timeout_ms=60000)
            break
        except OSError:
            time.sleep(0.1)
    if dl_rx is None:
        print("srsue: DL bridge connect failed", flush=True)
        return 1
    scell_rx = None
    if cc == 2:
        for _ in range(300):
            try:
                scell_rx = IqBridgeRx(
                    args.dl_addr, args.dl_port + 50, timeout_ms=60000)
                break
            except OSError:
                time.sleep(0.1)
        if scell_rx is None:
            print("srsue: SCell bridge connect failed", flush=True)
            return 1
    ul_tx = IqBridgeTx(args.ul_port)
    ul_tx.accept()
    print("srsue: IQ bridges up", flush=True)

    sf_len = air.ofdm.sf_len
    zeros = np.zeros(sf_len, np.complex64)
    attach_announced = False
    for tti in range(args.ttis):
        ue.tick()
        dl = torch.from_numpy(dl_rx.read(nof_ports * sf_len)).to(dev)
        dl = dl.reshape(2, sf_len)[None] if nof_ports == 2 else dl[None, :]
        # TDD: UL subframes carry zeros on the DL stream — the sample
        # clock still advances, but there is nothing to decode (the
        # in-process runner likewise skips rx_dl when step_dl yields
        # nothing); both loops run in sample lockstep, so tti numbering
        # agrees with the eNB's
        ul_sf = air.sf_kind(tti) == "U" or air.frame_type == "fdd"
        if air.frame_type == "fdd" or air.sf_kind(tti) != "U":
            uephy.rx_dl(tti, dl)
        if scell_rx is not None:
            s_dl = torch.from_numpy(scell_rx.read(sf_len)[None, :]).to(dev)
            uephy.rx_dl_scell(tti, s_dl)
        idx = uephy.prach_due(tti) if ul_sf else None
        if idx is not None:
            ul_samples = air.prach_tx_samples(idx)[0].cpu().numpy()
            stats["prach"] += 1
        else:
            g = (ue.ul_grid(tti, cqi_due=air.cqi_due(tti))
                 if ul_sf else None)
            ul_samples = (air.combine_ul([g], tti=tti)[0].cpu().numpy()
                          if g is not None else zeros)
        ul_tx.send(ul_samples)
        if ue.nas.is_registered() and not attach_announced:
            attach_announced = True
            print(f"srsue: ATTACHED ip="
                  f"{'.'.join(str(b) for b in ue.nas.ip_addr)}", flush=True)

    dl_rx.close()
    ul_tx.close()
    stats["registered"] = ue.nas.is_registered()
    stats["sync_state"] = ue.sync_state
    stats["cqi"] = ue.cqi_sent
    if dev.type == "cuda":
        stats["turbo"] = turbo_result()
    print("RESULT " + json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
