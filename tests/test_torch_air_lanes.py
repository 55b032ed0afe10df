"""Port parity: the other airs of ``runtime/lte_air.LteAirPhy`` against the
JAX package's — a 2-port TM4 subframe (format 2, both codewords, RI/PMI), an
EPA-faded subframe at TTI 500, and the TDD air (timing helpers, a DwPTS-only
special subframe and the two-subframe cell search), and the blind cell
search at 15, 50 and 100 PRB — built and compared as in
``tests/test_torch_air.py`` (6 PRB and ``snr_db=200`` unless named, the
port's receivers fed the JAX air's samples; samples atol 1e-4, decisions
identical).
"""

import dataclasses

import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import dci as j_dci
from srsran_4g_tpu.runtime import lte_air as j_air
from srsran_4g_tpu_torch.models import dci as t_dci
from srsran_4g_tpu_torch.runtime import lte_air as t_air
from test_torch_air import RNTI, SAMPLE_TOL, _airs, _hits, _np, _pdu

torch.set_num_threads(2)


def test_tm4_subframe_matches_jax():
    j, t = _airs(nof_ports=2, nof_rx=2)
    sf = 4
    d = j_dci.Dci2(rbg_bitmap=0b111111, mcs0=10, mcs1=12, ndi0=1, ndi1=1, harq_pid=1,
                   pinfo=1)
    td = t_dci.Dci2(**dataclasses.asdict(d))
    bits = j_dci.pack_2(d, 6)
    np.testing.assert_array_equal(t_dci.pack_2(td, 6), bits)
    jc = j_air.dci_to_pdsch_mimo_cfg(j.cell, RNTI, d, sf, 4)
    tc = t_air.dci_to_pdsch_mimo_cfg(t.cell, RNTI, td, sf, 4)
    assert (tc.tbs0, tc.tbs1, tc.pmi, tc.prb_alloc) == (jc.tbs0, jc.tbs1, jc.pmi, jc.prb_alloc)
    alloc = j.cch.alloc(RNTI, set(), sf=sf)
    pdus = (_pdu(jc.tbs0 // 8, 1), _pdu(jc.tbs1 // 8, 2))
    want = np.array(j.enb_dl_tx([(jc, pdus, bits, RNTI) + alloc], sf=sf, tti=sf))
    got = _np(t.enb_dl_tx([(tc, pdus, bits, RNTI) + alloc], sf=sf, tti=sf))
    assert got.shape == want.shape == (1, 2, t.ofdm.sf_len)
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    jr = j.ue_dl_rx_multi(want, RNTI, sf=sf, mimo_fmt="2")
    tr = t.ue_dl_rx_multi(torch.as_tensor(want), RNTI, sf=sf, mimo_fmt="2")
    assert _hits(tr) == _hits(jr)
    assert (tr["ri"], tr["pmi"]) == (jr["ri"], jr["pmi"])
    assert (tr["hits"][0]["pdu"], tr["hits"][0]["pdu2"]) == pdus


def test_faded_subframe_matches_jax():
    j, t = _airs(fading=dict(profile="epa", doppler_hz=5.0, srate_hz=1.92e6))
    mib = (np.random.default_rng(8).integers(0, 2, 24).astype(np.int8), 2)
    want = np.array(j.enb_dl_tx([], sf=0, mib=mib, tti=500))
    got = _np(t.enb_dl_tx([], sf=0, mib=mib, tti=500))
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)
    flat = _np(_airs()[1].enb_dl_tx([], sf=0, mib=mib, tti=500))
    assert np.abs(got - flat).max() > 0.1  # the channel did fade


def test_tdd_air_matches_jax():
    j, t = _airs(frame_type="tdd", ul_dl_config=1, ssf_config=4)
    for tti in range(20):
        assert (t.sf_kind(tti), t.ack_k(tti) if t.sf_kind(tti) != "U" else None,
                t.ul_k(tti), t.phich_k(tti) if t.sf_kind(tti) == "U" else None,
                t.cqi_due(tti)) == \
            (j.sf_kind(tti), j.ack_k(tti) if j.sf_kind(tti) != "U" else None,
             j.ul_k(tti), j.phich_k(tti) if j.sf_kind(tti) == "U" else None, j.cqi_due(tti))
    bufs = []
    for sf in (0, 1):
        want = np.array(j.enb_dl_tx([], sf=sf, tti=10 + sf))
        got = _np(t.enb_dl_tx([], sf=sf, tti=10 + sf))
        np.testing.assert_allclose(got, want, **SAMPLE_TOL, err_msg=f"sf {sf}")
        bufs.append(want)
    buf = np.concatenate(bufs, axis=-1)
    jr, tr = j.ue_cell_search_tdd(buf), t.ue_cell_search_tdd(torch.as_tensor(buf))
    assert {k: tr[k] for k in ("found", "cell_id", "phase")} == \
        {k: jr[k] for k in ("found", "cell_id", "phase")} == dict(found=True, cell_id=1, phase=0)
    np.testing.assert_allclose(tr["peak"], jr["peak"], rtol=1e-4)


@pytest.mark.parametrize("nof_prb", [15, 50, 100])
def test_cell_search_wide_cells_matches_jax(nof_prb):
    """The air's blind search above 6 PRB, where the port's ``cell_search``
    takes its CFO from the CP and refines the timing: on the air's subframe 0
    at 30 dB (no CFO, no PDSCH) both packages find cell 1 at phase 0 with
    PSS peaks within 1e-4, both above the 0.5 threshold."""
    j, t = _airs(nof_prb=nof_prb, snr_db=30.0)
    x = np.array(j.enb_dl_tx([], sf=0, tti=0))
    jr, tr = j.ue_cell_search(x), t.ue_cell_search(torch.as_tensor(x))
    assert {k: tr[k] for k in ("found", "cell_id", "phase")} == \
        {k: jr[k] for k in ("found", "cell_id", "phase")} == dict(found=True, cell_id=1, phase=0)
    np.testing.assert_allclose(tr["peak"], jr["peak"], rtol=1e-4)
