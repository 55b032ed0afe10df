"""Port parity: the rest of the UE receiver around the downlink —
``ops/sequence.gold_sequence``, ``ops/resampling``, ``ops/agc``,
``ops/cfr``, ``models/tdd``, ``models/ue_sync``, ``models/meas`` and
``models/pmch`` — against the JAX package on the same inputs, with the
``convert`` functions that carry PMCH configs and the UE's loop states
across.

Inputs, noise and CFOs come from numpy with a seed and go to both packages as
arrays; the JAX side runs under ``jax.jit`` where its function allows (the
``UeSync`` FSM and ``find_neighbour_cells`` are host loops and run eagerly).
Sizes: 6 PRB for the FSM (state for state over a 12-subframe stream), TDD,
measurements and the MIB; 15 PRB QPSK for PMCH, as tests/test_mbms.py.
Tolerances: bits, CRC flags, cell ids, offsets, phases, frame types and FSM
states identical; float outputs within ``EST_TOL`` (rtol 1e-4, atol 1e-5;
tests/test_torch_pdsch.py) unless stated: resampled and CFR'd samples atol
1e-5 (two FFT libraries), the FSM's integrated CFO and measured CFOs atol
1e-4 subcarriers (or 2 Hz: the CRS phase drift is divided by 2π·0.5 ms),
dB values atol 1e-3 dB.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import grid as j_grid
from srsran_4g_tpu.models import meas as j_meas
from srsran_4g_tpu.models import pmch as j_pmch
from srsran_4g_tpu.models import tdd as j_tdd
from srsran_4g_tpu.models import ue_sync as j_ue_sync
from srsran_4g_tpu.ops import agc as j_agc
from srsran_4g_tpu.ops import cfr as j_cfr
from srsran_4g_tpu.ops import ofdm as j_ofdm
from srsran_4g_tpu.ops import resampling as j_rs
from srsran_4g_tpu.ops import sequence as j_seq
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import enb_dl, grid, meas, pdsch, pmch, sync, tdd, ue_sync
from srsran_4g_tpu_torch.ops import agc, cfr, ofdm, resampling, sequence

torch.set_num_threads(2)

EST_TOL = dict(rtol=1e-4, atol=1e-5)
SAMPLE_TOL = dict(rtol=0, atol=1e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _jit(fn, *args, **kw):
    """fn with its leading and keyword arguments fixed, under jax.jit."""
    return jax.jit(functools.partial(fn, *args, **kw))


def _noise(rng, shape, nv):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(nv / 2)).astype(np.complex64)


# --- ops ----------------------------------------------------------------------

def test_gold_sequence_matches_jax_and_host():
    # the seeds of tests/test_sequence.py:31,37, a 31-bit one and a batch shape
    c_inits = np.array([[0, 1, 9999, 2**28 + 3], [4321, 2**30 + 7, 2**31 - 1, 12345]],
                       dtype=np.int64)
    got = sequence.gold_sequence(torch.as_tensor(c_inits), 257)
    assert got.dtype == torch.uint8 and got.shape == (2, 4, 257)
    np.testing.assert_array_equal(
        _np(got), _np(j_seq.gold_sequence(jnp.asarray(c_inits, jnp.uint32), 257)))
    for ci, row in zip(c_inits.ravel(), _np(got).reshape(8, 257)):
        np.testing.assert_array_equal(row, sequence.gold_sequence_np(int(ci), 257))
    np.testing.assert_array_equal(_np(sequence.gold_sequence(4321, 100, device="cpu")),
                                  j_seq.gold_sequence_np(4321, 100))


@pytest.mark.parametrize("up,down", [(3, 4), (4, 3), (1, 2)])
def test_resample_fft_matches_jax(up, down):
    rng = np.random.default_rng(up * 10 + down)
    x = _noise(rng, (2, 1200), 1.0)
    np.testing.assert_allclose(_np(resampling.resample_fft(torch.as_tensor(x), up, down)),
                               _np(_jit(j_rs.resample_fft, up=up, down=down)(x)),
                               **SAMPLE_TOL)


@pytest.mark.parametrize("rate", [0.75, 4 / 3, 0.5])
def test_resample_polyphase_matches_jax(rate):
    rng = np.random.default_rng(int(rate * 100))
    x = _noise(rng, (2, 1000), 1.0)
    got = resampling.resample_polyphase(torch.as_tensor(x), rate)
    np.testing.assert_allclose(_np(got), _np(_jit(j_rs.resample_polyphase, rate=rate)(x)),
                               **SAMPLE_TOL)


def test_agc_and_cfr_match_jax():
    rng = np.random.default_rng(7)
    x = _noise(rng, (3, 512), 1e-2)
    gain = np.array([0.0, 20.0, 45.0], np.float32)
    acfg = agc.AgcConfig()
    y_t, g_t = agc.agc_step(acfg, torch.as_tensor(x), torch.as_tensor(gain))
    y_j, g_j = _jit(j_agc.agc_step, j_agc.AgcConfig())(x, gain)
    np.testing.assert_allclose(_np(y_t), _np(y_j), **EST_TOL)
    np.testing.assert_allclose(_np(g_t), _np(g_j), rtol=0, atol=1e-3)
    sym = _noise(rng, (4, 256), 1.0)
    ccfg, jccfg = cfr.CfrConfig(symbol_sz=256, nof_re=180), j_cfr.CfrConfig(256, 180)
    out = cfr.cfr_apply(ccfg, torch.as_tensor(sym))
    np.testing.assert_allclose(_np(out), _np(_jit(j_cfr.cfr_apply, jccfg)(sym)), **SAMPLE_TOL)
    np.testing.assert_allclose(_np(cfr.papr_db(out)), _np(_jit(j_cfr.papr_db)(_np(out))),
                               rtol=0, atol=1e-3)


# --- TDD --------------------------------------------------------------------------

def test_tdd_tables_and_acks_match_jax():
    assert tdd.UL_DL_CONFIGS == j_tdd.UL_DL_CONFIGS
    assert (tdd.DWPTS_SYMS, tdd.UPPTS_SYMS) == (j_tdd.DWPTS_SYMS, j_tdd.UPPTS_SYMS)
    assert tdd.DL_ASSOC_SETS == j_tdd.DL_ASSOC_SETS and tdd.UL_GRANT_K == j_tdd.UL_GRANT_K
    for c in range(7):
        for sf in range(10):
            assert tdd.sf_type(c, sf) == j_tdd.sf_type(c, sf)
            np.testing.assert_array_equal(tdd.dl_symbol_mask(c, 4, sf),
                                          j_tdd.dl_symbol_mask(c, 4, sf))
            assert tdd.ul_grant_delay(c, sf) == j_tdd.ul_grant_delay(c, sf)
            if tdd.sf_type(c, sf) != "U":
                assert tdd.ack_subframe_for_dl(c, sf) == j_tdd.ack_subframe_for_dl(c, sf)
                assert tdd.ack_delay(c, sf) == j_tdd.ack_delay(c, sf)
            else:
                assert tdd.phich_delay(c, sf) == j_tdd.phich_delay(c, sf)
    rng = np.random.default_rng(3)
    acks = rng.integers(0, 2, (16, 4)).astype(np.int8)
    valid = rng.integers(0, 2, (16, 4)).astype(np.int8)
    np.testing.assert_array_equal(
        _np(tdd.bundle_acks(torch.as_tensor(acks), torch.as_tensor(valid))),
        _np(j_tdd.bundle_acks(jnp.asarray(acks), jnp.asarray(valid))))
    np.testing.assert_array_equal(
        _np(tdd.multiplex_acks(torch.as_tensor(acks), torch.as_tensor(valid), 3)),
        _np(j_tdd.multiplex_acks(jnp.asarray(acks), jnp.asarray(valid), 3)))


CELL6 = grid.CellConfig(nof_prb=6, cell_id=151, cfi=1)


def _half_frame(frame_type):
    """Three subframes with only the sync signals, as
    tests/test_tdd.py::test_frame_type_detection builds them."""
    cfg = ofdm.OfdmConfig(nof_prb=6)
    put = enb_dl.put_sync_signals if frame_type == "fdd" else enb_dl.put_sync_signals_tdd
    return torch.cat([ofdm.modulate(cfg, put(CELL6, torch.zeros((1, 14, 72), dtype=torch.complex64),
                                             sf)) for sf in range(3)], dim=-1).numpy()


@pytest.mark.parametrize("frame_type", ["fdd", "tdd"])
def test_detect_frame_type_matches_jax(frame_type):
    rng = np.random.default_rng(11)
    x = _half_frame(frame_type) + _noise(rng, (1, 3 * 1920), 1e-3)
    cfg, jcfg = ofdm.OfdmConfig(nof_prb=6), j_ofdm.OfdmConfig(nof_prb=6)
    found = sync.find_pss(torch.as_tensor(x), cfg.symbol_sz)
    got = tdd.detect_frame_type(torch.as_tensor(x), found["offset"], found["n_id_2"], cfg)
    keys = ("frame_type", "n_id_1", "phase", "metric")
    want = dict(zip(keys, jax.jit(lambda *a: tuple(
        getattr(j_tdd.detect_frame_type(*a, cfg=jcfg), k) for k in keys))(
        x, jnp.asarray(_np(found["offset"])), jnp.asarray(_np(found["n_id_2"])))))
    for key in keys[:3]:
        np.testing.assert_array_equal(_np(getattr(got, key)), _np(want[key]), key)
    np.testing.assert_allclose(_np(got.metric), _np(want["metric"]), **EST_TOL)
    assert int(got.frame_type[0]) == (frame_type == "tdd")
    assert int(found["offset"][0]) == tdd.pss_to_sf_start(cfg, frame_type)
    for ft in ("fdd", "tdd"):
        assert tdd.pss_sss_distance(cfg, ft) == j_tdd.pss_sss_distance(jcfg, ft)
    np.testing.assert_allclose(
        _np(tdd.extract_center62(torch.as_tensor(x), found["offset"], cfg)),
        _np(j_tdd.extract_center62(jnp.asarray(x), jnp.asarray(_np(found["offset"])), jcfg)),
        **SAMPLE_TOL)


# --- UE sync FSM and the MIB -------------------------------------------------------

SYNC_CELL = grid.CellConfig(nof_prb=6, cell_id=123, cfi=1)
N_SF = 12


@functools.lru_cache(maxsize=None)
def _sync_stream():
    """A 6 PRB FDD stream: a lead of 700 samples, 12 subframes (PDSCH, CRS,
    PSS/SSS, PCFICH; the MIB in subframe 0), a CFO of 0.05 subcarrier, AWGN
    at 20 dB."""
    rng = np.random.default_rng(5)
    mib = rng.integers(0, 2, (1, 24)).astype(np.int8)
    sfs = []
    for sf in range(N_SF):
        cfg = pdsch.PdschConfig(cell=SYNC_CELL, rnti=0x46, subframe=sf % 10, mod="qpsk",
                                tbs=152)
        bits = rng.integers(0, 2, (1, cfg.tbs)).astype(np.int8)
        g = enb_dl.assemble_subframe(cfg, bits, mib_bits=mib, device="cpu")
        sfs.append(enb_dl.subframe_to_samples(SYNC_CELL, g)[0].numpy())
    lead = 700
    x = np.concatenate([np.zeros(lead, np.complex64)] + sfs + [np.zeros(1920, np.complex64)])
    x = x * np.exp(2j * np.pi * 0.05 * np.arange(x.size) / 128)
    return (x + _noise(rng, x.shape, 1e-2)).astype(np.complex64), lead, mib


def _state(us):
    return dataclasses.asdict(us.s)


def _same_state(a: dict, b: dict):
    assert {k: v for k, v in a.items() if k != "cfo_hz_acc"} == \
        {k: v for k, v in b.items() if k != "cfo_hz_acc"}
    assert abs(a["cfo_hz_acc"] - b["cfo_hz_acc"]) < 1e-4


def test_ue_sync_fsm_matches_jax_state_for_state():
    """FIND on two subframes, TRACK on the 12 aligned subframes (FIND's
    subframe again first), a radio error and FIND again; a second port FSM
    takes over the JAX FSM's state (``convert``) after 6 subframes."""
    x, lead, mib = _sync_stream()
    sf_len = 1920
    j_us, t_us = j_ue_sync.UeSync(nof_prb=6), ue_sync.UeSync(nof_prb=6)
    first = x[:2 * sf_len]
    out_j, out_t = j_us.zerocopy(jnp.asarray(first)), t_us.zerocopy(torch.as_tensor(first))
    assert out_t["in_sync"] and out_t["cell_id"] == SYNC_CELL.cell_id
    assert out_j["cell_id"] == out_t["cell_id"]
    np.testing.assert_allclose(_np(out_t["sf_samples"]), _np(out_j["sf_samples"]), atol=1e-4)
    _same_state(_state(j_us), _state(t_us))
    start = int(out_t["offset"]) - int(ofdm._symbol_offsets(t_us.cfg)[6])
    assert start == lead

    mib_t = ue_sync.decode_mib(out_t["cell_id"], out_t["sf_samples"][None])
    mib_j = j_ue_sync.decode_mib(out_j["cell_id"], out_j["sf_samples"][None])
    assert bool(mib_t["crc_ok"].all()) and bool(np.asarray(mib_j["crc_ok"]).all())
    np.testing.assert_array_equal(_np(mib_t["mib"]), mib)
    np.testing.assert_array_equal(_np(mib_t["mib"]), _np(mib_j["mib"]))

    taken = None
    for k in range(N_SF):
        chunk = x[start + k * sf_len:start + (k + 1) * sf_len]
        if k == 6:
            taken = ue_sync.UeSync(
                nof_prb=6, state=convert.ue_sync_state_from_dict(_state(j_us)))
        out_j, out_t = j_us.zerocopy(jnp.asarray(chunk)), t_us.zerocopy(torch.as_tensor(chunk))
        if taken is not None:
            taken.zerocopy(torch.as_tensor(chunk))
            _same_state(_state(taken), _state(t_us))
        assert out_t["in_sync"] == out_j["in_sync"] and out_t["in_sync"]
        assert out_t["state"] == out_j["state"] == ue_sync.TRACK
        _same_state(_state(j_us), _state(t_us))
        np.testing.assert_allclose(_np(out_t["sf_samples"]), _np(out_j["sf_samples"]), atol=1e-4)
    assert t_us.s.sfn == 1 and t_us.s.frames_tracked == 1
    for us in (j_us, t_us):
        us.radio_error()
    _same_state(_state(j_us), _state(t_us))
    again = x[start + 4 * sf_len:start + 6 * sf_len]
    out_j, out_t = j_us.zerocopy(jnp.asarray(again)), t_us.zerocopy(torch.as_tensor(again))
    assert out_t["state"] == out_j["state"] == ue_sync.TRACK and t_us.s.sf_idx == 5
    _same_state(_state(j_us), _state(t_us))


# --- measurements and power control ---------------------------------------------

def _cell_samples(cell_id, gain):
    """CRS and sync signals of one cell in subframes 0 and 5, as
    tests/test_meas.py builds them."""
    cell = grid.CellConfig(nof_prb=6, cell_id=cell_id, cfi=1)
    cfg = ofdm.OfdmConfig(nof_prb=6)
    out = []
    for sf in (0, 5):
        g = pdsch.add_crs(pdsch.PdschConfig(cell=cell, rnti=1, subframe=sf, mod="qpsk", tbs=16),
                          torch.zeros((1, 14, 72), dtype=torch.complex64))
        out.append(ofdm.modulate(cfg, enb_dl.put_sync_signals(cell, g, sf)).numpy())
    return gain * np.concatenate(out, axis=-1)


def test_find_neighbour_cells_matches_jax():
    rng = np.random.default_rng(9)
    sig = _cell_samples(150, 1.0)
    sig[..., 384:] += _cell_samples(259, 0.5)[..., :-384]
    rx = (sig + _noise(rng, sig.shape, 1e-4)).astype(np.complex64)
    for serving in (150, None):
        got = meas.find_neighbour_cells(torch.as_tensor(rx), 6, serving_cell_id=serving)
        want = j_meas.find_neighbour_cells(jnp.asarray(rx), 6, serving_cell_id=serving)
        assert [(c["cell_id"], c["n_id_2"], c["offset"], c["phase"]) for c in got] == \
            [(c["cell_id"], c["n_id_2"], c["offset"], c["phase"]) for c in want]
        for a, b in zip(got, want):
            assert abs(a["peak_ratio"] - b["peak_ratio"]) < 1e-3 * b["peak_ratio"]
            assert abs(a["cfo"] - b["cfo"]) < 1e-4
    assert [c["cell_id"] for c in got][:1] == [150] and 259 in [c["cell_id"] for c in got]


def test_measure_cell_matches_jax():
    rng = np.random.default_rng(13)
    cell = grid.CellConfig(nof_prb=6, cell_id=77, cfi=1)
    jcell = j_grid.CellConfig(nof_prb=6, cell_id=77, cfi=1)
    cfg = ofdm.OfdmConfig(nof_prb=6)
    g = pdsch.add_crs(pdsch.PdschConfig(cell=cell, rnti=1, subframe=0, mod="qpsk", tbs=16),
                      torch.zeros((2, 14, 72), dtype=torch.complex64))
    x = ofdm.modulate(cfg, g).numpy() * np.array([[0.5], [0.8]])
    x = x * np.exp(2j * np.pi * (300.0 / 15000.0) * np.arange(x.shape[-1]) / 128)
    rx_grid = ofdm.demodulate(cfg, torch.as_tensor((x + _noise(rng, x.shape, 1e-4))
                                                   .astype(np.complex64)))
    got = meas.measure_cell(rx_grid, cell, 0)
    want = _jit(j_meas.measure_cell, cell=jcell, subframe=0)(rx_grid.numpy())
    for key in ("rsrp", "rssi"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), **EST_TOL)
    for key in ("rsrp_dbfs", "rsrq_db", "snr_db"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(_np(got["cfo_hz"]), _np(want["cfo_hz"]), rtol=0, atol=2.0)
    assert np.all(np.abs(_np(got["cfo_hz"]) - 300.0) < 30.0)


def test_power_control_matches_jax():
    j_st, t_st = j_meas.PowerCtrlState(), meas.PowerCtrlState()
    for tpc in (3, 0, 2, 2, 1):
        j_st.apply_tpc_pusch(tpc), t_st.apply_tpc_pusch(tpc)
        j_st.apply_tpc_pucch(tpc), t_st.apply_tpc_pucch(tpc)
    moved = convert.power_ctrl_state_from_dict(dataclasses.asdict(j_st))
    assert dataclasses.asdict(moved) == dataclasses.asdict(t_st) == dataclasses.asdict(j_st)
    for st in (t_st, moved):
        for n_prb, pl in ((1, 60.0), (4, 100.0), (100, 150.0)):
            assert st.pusch_power(n_prb, pl) == j_st.pusch_power(n_prb, pl)
            assert st.pusch_power(n_prb, pl, p0_preamble=-90.0) == \
                j_st.pusch_power(n_prb, pl, p0_preamble=-90.0)
            assert st.srs_power(n_prb, pl) == j_st.srs_power(n_prb, pl)
        for fmt, n_cqi in (("1", 0), ("1b", 0), ("2", 8), ("2a", 2), ("2b", 11)):
            assert st.pucch_power(100.0, fmt=fmt, n_cqi=n_cqi) == \
                j_st.pucch_power(100.0, fmt=fmt, n_cqi=n_cqi)
    assert meas.PC_MAX_DBM == j_meas.PC_MAX_DBM


# --- PMCH ------------------------------------------------------------------------

def test_pmch_matches_jax():
    jcfg = j_pmch.PmchConfig(nof_prb=15, area_id=1, subframe=3, mod="qpsk", tbs=1608)
    cfg = convert.pmch_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg == pmch.PmchConfig(nof_prb=15, area_id=1, subframe=3, mod="qpsk", tbs=1608)
    np.testing.assert_array_equal(cfg.rs_indices, jcfg.rs_indices)
    np.testing.assert_array_equal(cfg.data_indices, jcfg.data_indices)
    np.testing.assert_array_equal(pmch.mbsfn_rs(1, 3, cfg.nre), j_pmch.mbsfn_rs(1, 3, cfg.nre))
    rng = np.random.default_rng(1608)
    bits = rng.integers(0, 2, (2, cfg.tbs)).astype(np.int8)
    tx = pmch.encode(cfg, bits, device="cpu")
    np.testing.assert_allclose(_np(tx), _np(_jit(j_pmch.encode, jcfg)(bits)), atol=1e-6, rtol=0)
    rx = (tx.numpy() + _noise(rng, tx.shape, 10 ** -1.2)).astype(np.complex64)
    got = pmch.decode(cfg, torch.as_tensor(rx), n_iter=6)
    want = _jit(j_pmch.decode, jcfg, n_iter=6)(rx)
    np.testing.assert_array_equal(_np(got["crc_ok"]), _np(want["crc_ok"]))
    np.testing.assert_array_equal(_np(got["bits"]), _np(want["bits"]))
    np.testing.assert_allclose(_np(got["noise_var"]), _np(want["noise_var"]), **EST_TOL)
    assert bool(got["crc_ok"].all())
    np.testing.assert_array_equal(_np(got["bits"]), bits)
