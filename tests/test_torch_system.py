"""The port's system path end to end: ``srsran_4g_tpu_torch.tools.run_lte``
(the counterpart of the JAX package's ``tools/run_lte.py``) on the CPU at 6
PRB with one UE, held to every criterion of ``tests/test_run_lte.py::_run``:
the UE camps on PCI 1 over the air (PSS/SSS → MIB → SI), sends exactly one
PRACH, attaches (AKA, SMC) through the EPC, loses no PDSCH or PUSCH, the
ciphered pings arrive both ways, every grant travelled on PDCCH, PHICH
carried the UL HARQ feedback and every CQI after the first is at target.

The same run at 100 PRB with two UEs is ``tests/test_torch_cuda.py``'s
``test_run_lte_100prb_on_card`` (card only).
"""

import torch

from srsran_4g_tpu_torch.tools import run_lte

torch.set_num_threads(2)


def test_run_lte_6prb_one_ue_on_cpu():
    ues_n, pings = 1, 2
    ok, stats, ues, mme = run_lte.run(n_ttis=360, n_pings=pings, snr_db=30.0, nof_prb=6,
                                      n_ues=ues_n, device="cpu")
    for u in ues:
        assert u.sync_state == "camped" and u.acq_pci == 1, (u.sync_state, u.acq_pci)
        assert u.acq_sfn >= 0
    assert stats["phich_ack"] > 0, stats
    assert stats["phich_ack"] + stats["phich_nack"] >= stats["pusch_tx"] - 4
    assert all(u.nas.is_registered() for u in ues), stats
    assert stats["prach"] == ues_n
    assert stats["pdsch_ko"] == 0 and stats["pusch_ko"] == 0, stats
    assert stats["dl_ping_rx"] == pings * ues_n, stats
    assert stats["ul_ping_rx"] >= pings * ues_n, stats
    assert stats["dci_tx"] >= stats["pdsch_tx"], stats
    for u in ues:
        assert all(c >= 13 for c in u.cqi_sent[1:]), u.cqi_sent
        assert u.rrc.idle.si_acquired(), u.rrc.idle.events
    assert mme.attached_ues() == [u.ucfg.imsi for u in ues]
    assert ok
