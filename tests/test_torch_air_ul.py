"""Port parity: the uplink of ``runtime/lte_air.LteAirPhy`` against the
JAX package's, built and compared as in ``tests/test_torch_air.py`` (6 PRB,
``snr_db=200``, both receivers fed the JAX air's samples).

- UL: a PUSCH with a PUCCH format-1a ACK from one UE, an SR and a format-2
  CQI from another, through ``combine_ul``; samples atol 1e-4, then the PUSCH
  bytes, ACK, SR and CQI decisions identical.
- PRACH: ``prach(idx)`` and the sample-stream pair ``prach_tx_samples`` /
  ``prach_rx`` give identical indices.
"""

import numpy as np
import pytest
import torch

from srsran_4g_tpu.runtime import lte_air as j_air
from srsran_4g_tpu_torch.runtime import lte_air as t_air
from test_torch_air import RNTI, RNTI_B, SAMPLE_TOL, _airs, _np, _pdu

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def airs():
    return _airs()


def test_ul_subframe_and_decisions_match_jax(airs):
    j, t = airs
    sf, tti = 7, 17
    n_sr = j.cch.n_cce + 2
    pdu = _pdu(j_air._ul_cfg(j.cell, RNTI, 2, 2, 10, sf=sf).tbs // 8, 3)
    grids = []
    for air, mod in ((j, j_air), (t, t_air)):
        cfg = mod._ul_cfg(air.cell, RNTI, 2, 2, 10, sf=sf)
        grids.append((air.ue_ul_tx((cfg, pdu), ack=(3, 0), sf=sf),
                      air.ue_ul_tx(None, sr=n_sr, cqi=(0, RNTI_B, 12), sf=sf), cfg))
    want = np.array(j.combine_ul(list(grids[0][:2]), tti=tti))
    got = _np(t.combine_ul(list(grids[1][:2]), tti=tti))
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    jg, tg = j.enb_ul_grid(want), t.enb_ul_grid(torch.as_tensor(want))
    assert t.enb_pusch_rx(tg, grids[1][2]) == j.enb_pusch_rx(jg, grids[0][2]) == pdu
    assert t.enb_pucch_ack_rx(tg, 3, sf=sf) == j.enb_pucch_ack_rx(jg, 3, sf=sf) is True
    assert t.enb_sr_rx(tg, n_sr, sf=sf) == j.enb_sr_rx(jg, n_sr, sf=sf) is True
    assert t.enb_cqi_rx(tg, 0, RNTI_B, sf=sf) == j.enb_cqi_rx(jg, 0, RNTI_B, sf=sf) == 12
    assert t.combine_ul([None], tti=tti).shape == (1, t.ofdm.sf_len)


def test_prach_matches_jax(airs):
    j, t = airs
    for idx in (5, 37):
        assert t.prach(idx) == j.prach(idx) == idx
    want = j.prach_tx_samples(21)
    got = t.prach_tx_samples(21)
    np.testing.assert_allclose(_np(got), want, **SAMPLE_TOL)
    assert t.prach_rx(torch.as_tensor(want)) == j.prach_rx(want) == 21
    assert t.prach_rx(torch.zeros_like(got)) is None
