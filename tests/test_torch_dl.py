"""Port parity: the downlink from time-domain samples — ``ops/ofdm``,
``ops/zadoff_chu``, ``models/sync``, ``models/pcfich``, ``models/enb_dl`` and
``models/ue_dl`` — against the JAX package on the same inputs.

Inputs come from numpy with a seed; noise, CFO and offsets are passed in as
arrays so both packages see the same capture.  Tolerances: OFDM samples and
grids atol 1e-5 (two FFT libraries); assembled grids atol 1e-6; PSS/SSS ids,
offsets, phases, CFI, decoded bits and CRC flags identical; CFO atol 1e-4.
Sizes stay at 6 and 25 PRB (75 PRB for the 1536-point FFT only): the 20 MHz
path is chip_smoke.py's job.  The JAX side runs its functions under
``jax.jit`` (as its runtime does), which compiles each once instead of op by
op, and the transmitted subframes are built once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import enb_dl as j_enb
from srsran_4g_tpu.models import grid as j_grid
from srsran_4g_tpu.models import pcfich as j_pcfich
from srsran_4g_tpu.models import pdsch as j_pdsch
from srsran_4g_tpu.models import sync as j_sync
from srsran_4g_tpu.models import ue_dl as j_ue
from srsran_4g_tpu.ops import ofdm as j_ofdm
from srsran_4g_tpu.ops import zadoff_chu as j_zc
from srsran_4g_tpu_torch.models import enb_dl, grid, pcfich, pdsch, sync, ue_dl
from srsran_4g_tpu_torch.ops import ofdm, zadoff_chu
from srsran_4g_tpu_torch.utils import constants as C

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _jit(fn, *args, **kw):
    """The JAX function fn with its leading and keyword arguments fixed,
    under jax.jit; one compiled function per module and arguments."""
    # The JAX side runs once per shape, so compiling it is most of its cost:
    # compile it for speed of compiling (the same results, sooner).
    return jax.jit(functools.partial(fn, *args, **kw), compiler_options=dict(
        xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
        xla_cpu_parallel_codegen_split_count=1))


def _grid(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _noise(rng, shape, nv):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(nv / 2)).astype(np.complex64)


def test_tables_match():
    for prb in (6, 15, 25, 50, 75, 100, 8):
        n = C.symbol_sz(prb)
        assert n == j_ofdm.C.symbol_sz(prb)
        assert (C.cp_len_norm(0, n), C.cp_len_norm(1, n), C.cp_len_ext(n), C.slot_len(n),
                C.sf_len(n)) == (j_ofdm.C.cp_len_norm(0, n), j_ofdm.C.cp_len_norm(1, n),
                                 j_ofdm.C.cp_len_ext(n), j_ofdm.C.slot_len(n),
                                 j_ofdm.C.sf_len(n))
    for root, length, shift in ((25, 63, 0), (129, 839, 13)):
        np.testing.assert_array_equal(zadoff_chu.zadoff_chu(root, length, shift),
                                      j_zc.zadoff_chu(root, length, shift))
    for i in range(3):
        np.testing.assert_array_equal(zadoff_chu.pss_sequence(i), j_zc.pss_sequence(i))
    np.testing.assert_array_equal(sync.sss_sequences(), j_sync.sss_sequences())


# 6 PRB, 75 PRB (1536-point FFT), extended CP, a receive-window offset, and
# the NB-IoT half-subcarrier shift
OFDM_CFGS = [dict(nof_prb=6), dict(nof_prb=75), dict(nof_prb=6, normal_cp=False),
             dict(nof_prb=6, rx_window_offset=0.5), dict(nof_prb=6, half_sc_shift=True)]


@pytest.mark.parametrize("kw", OFDM_CFGS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_ofdm_matches_jax(kw):
    cfg, jcfg = ofdm.OfdmConfig(**kw), j_ofdm.OfdmConfig(**kw)
    rng = np.random.default_rng(cfg.nof_prb)
    g = _grid(rng, (2, cfg.nsymb_sf, cfg.nre))
    x = ofdm.modulate(cfg, torch.as_tensor(g))
    np.testing.assert_allclose(_np(x), _np(_jit(j_ofdm.modulate, jcfg)(jnp.asarray(g))),
                               atol=1e-5, rtol=0)
    y = x.numpy() + _noise(rng, x.shape, 1e-2)
    got = ofdm.demodulate(cfg, torch.as_tensor(y))
    np.testing.assert_allclose(_np(got), _np(_jit(j_ofdm.demodulate, jcfg)(jnp.asarray(y))),
                               atol=1e-5, rtol=0)
    if not cfg.normal_cp:
        np.testing.assert_allclose(
            _np(ofdm.demodulate_mbsfn(cfg, torch.as_tensor(y))),
            _np(_jit(j_ofdm.demodulate_mbsfn, jcfg)(jnp.asarray(y))), atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def _pss_capture(seed=3):
    """Two captures at 6 PRB: each PSS replica at an offset, CFO and noise."""
    rng = np.random.default_rng(seed)
    n, sz = 1920, 128
    cap = _noise(rng, (2, n), 0.02)
    offs, ids, cfos = (517, 1203), (1, 2), (0.21, -0.13)
    for b in range(2):
        cap[b, offs[b]:offs[b] + sz] += j_sync.pss_time_domain(ids[b], sz) * np.sqrt(sz)
        cap[b] *= np.exp(2j * np.pi * cfos[b] * np.arange(n) / sz).astype(np.complex64)
    return cap, offs, ids


def test_sync_functions_match_jax():
    cap, offs, ids = _pss_capture()
    sz = 128
    got = sync.find_pss(torch.as_tensor(cap), sz)
    want = _jit(j_sync.find_pss, symbol_sz=sz)(jnp.asarray(cap))
    for key in ("n_id_2", "offset"):
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]), err_msg=key)
    np.testing.assert_array_equal(_np(got["n_id_2"]), ids)
    np.testing.assert_allclose(_np(got["corr"]), _np(want["corr"]), atol=1e-4, rtol=1e-4)
    seg = np.stack([cap[b, o:o + sz] for b, o in enumerate(offs)])
    cfo_t = sync.pss_cfo_estimate(torch.as_tensor(seg), got["n_id_2"], sz)
    cfo_j = _jit(j_sync.pss_cfo_estimate, symbol_sz=sz)(jnp.asarray(seg), want["n_id_2"])
    np.testing.assert_allclose(_np(cfo_t), _np(cfo_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(sync.pss_cfo_estimate(torch.as_tensor(seg[:1]), 1, sz)),
                               _np(j_sync.pss_cfo_estimate(jnp.asarray(seg[:1]), 1, sz)),
                               atol=1e-4, rtol=0)
    fixed_t = sync.cfo_correct(torch.as_tensor(cap), cfo_t, sz)
    fixed_j = _jit(j_sync.cfo_correct, symbol_sz=sz)(jnp.asarray(cap), cfo_j)
    np.testing.assert_allclose(_np(fixed_t), _np(fixed_j), atol=1e-4, rtol=0)

    cfg, jcfg = ofdm.OfdmConfig(nof_prb=6), j_ofdm.OfdmConfig(nof_prb=6)
    x = _np(_jit(j_ofdm.modulate, jcfg)(jnp.asarray(_grid(np.random.default_rng(1), (2, 14, 72)))))
    x = x * np.exp(2j * np.pi * 0.21 * np.arange(x.shape[-1]) / 128).astype(np.complex64)
    np.testing.assert_allclose(_np(sync.cp_cfo_estimate(cfg, torch.as_tensor(x))),
                               _np(_jit(j_sync.cp_cfo_estimate, jcfg)(jnp.asarray(x))),
                               atol=1e-4, rtol=0)

    rng = np.random.default_rng(0)
    for n_id_2 in range(3):
        rx = (rng.standard_normal((4, 62)) + 1j * rng.standard_normal((4, 62))).astype(np.complex64)
        rx[:2] += 3 * j_sync.sss_sequences()[[5, 160], [0, 1]]
        got_s = sync.sss_detect(torch.as_tensor(rx), n_id_2)
        want_s = _jit(j_sync.sss_detect, n_id_2=n_id_2)(jnp.asarray(rx))
        for key in ("n_id_1", "phase"):
            np.testing.assert_array_equal(_np(got_s[key]), _np(want_s[key]), err_msg=key)
        np.testing.assert_allclose(_np(got_s["corr"]), _np(want_s["corr"]), atol=1e-4)

    tone = np.exp(2j * np.pi * 0.1234 * np.arange(256)).astype(np.complex64)[None]
    tone = tone + _noise(rng, tone.shape, 1e-3)
    np.testing.assert_allclose(_np(sync.cedron_freq_estimate(torch.as_tensor(tone))),
                               _np(j_sync.cedron_freq_estimate(jnp.asarray(tone))),
                               atol=1e-6, rtol=0)
    offsets = np.array([[10.0, 10.5, 11.2, 11.9, 12.4]], np.float32)
    np.testing.assert_allclose(_np(sync.sfo_estimate(torch.as_tensor(offsets))),
                               _np(j_sync.sfo_estimate(jnp.asarray(offsets))), rtol=1e-5)


def _cells(nof_prb, cell_id, cfi=1):
    return (grid.CellConfig(nof_prb=nof_prb, cell_id=cell_id, cfi=cfi),
            j_grid.CellConfig(nof_prb=nof_prb, cell_id=cell_id, cfi=cfi))


def _pdsch_cfgs(nof_prb, cell_id, subframe, mod, tbs, cfi=1, rnti=0x50):
    cell, jcell = _cells(nof_prb, cell_id, cfi)
    return (pdsch.PdschConfig(cell=cell, rnti=rnti, subframe=subframe, mod=mod, tbs=tbs),
            j_pdsch.PdschConfig(cell=jcell, rnti=rnti, subframe=subframe, mod=mod, tbs=tbs))


@functools.lru_cache(maxsize=None)
def _jax_tx(subframe):
    """25 PRB, 16QAM, TBS 1000: the configs, the sent bits and the JAX
    package's assembled grid."""
    cfg, jcfg = _pdsch_cfgs(25, 123, subframe, "16qam", 1000, cfi=2, rnti=0x1234)
    bits = np.random.default_rng(7 + subframe).integers(0, 2, size=(2, 1000)).astype(np.int8)
    return cfg, jcfg, bits, _np(_jit(j_enb.assemble_subframe, jcfg)(jnp.asarray(bits)))


@pytest.mark.parametrize("subframe", [0, 5])
def test_assemble_subframe_matches_jax(subframe):
    cfg, jcfg, bits, want = _jax_tx(subframe)
    got = enb_dl.assemble_subframe(cfg, bits, device="cpu")
    np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(enb_dl.subframe_to_samples(cfg.cell, got)),
                               _np(_jit(j_enb.subframe_to_samples, jcfg.cell)(jnp.asarray(want))),
                               atol=1e-5, rtol=0)
    g0 = torch.zeros((1, 14, 300), dtype=torch.complex64)
    for sf in (0, 1, 5, 6):
        np.testing.assert_array_equal(
            _np(enb_dl.put_sync_signals_tdd(cfg.cell, g0, sf)),
            _np(j_enb.put_sync_signals_tdd(jcfg.cell, jnp.asarray(g0.numpy()), sf)))


def test_pcfich_matches_jax():
    cell, jcell = _cells(25, 77)
    cfi = np.array([1, 2, 3, 2], np.int32)
    syms = pcfich.encode(cell, torch.as_tensor(cfi), 4)
    np.testing.assert_allclose(_np(syms), _np(_jit(j_pcfich.encode, jcell, subframe=4)(jnp.asarray(cfi))),
                               atol=1e-6)
    np.testing.assert_array_equal(pcfich.pcfich_re_indices(cell),
                                  j_pcfich.pcfich_re_indices(jcell))
    g = pcfich.put_into_grid(cell, torch.zeros((4, 14, 300), dtype=torch.complex64), syms)
    rng = np.random.default_rng(9)
    rx = g.numpy() + _noise(rng, g.shape, 0.3)
    h = np.ones(g.shape, np.complex64)
    got = pcfich.decode(cell, torch.as_tensor(rx), torch.as_tensor(h), 0.3, 4)
    want = _jit(j_pcfich.decode, jcell, subframe=4)(jnp.asarray(rx), jnp.asarray(h), 0.3)
    np.testing.assert_array_equal(_np(got["cfi"]), _np(want["cfi"]))
    np.testing.assert_array_equal(_np(got["cfi"]), cfi)
    np.testing.assert_allclose(_np(got["corr"]), _np(want["corr"]), atol=1e-3, rtol=1e-5)


def test_enb_dl_refuses_pbch_and_pdcch():
    # the control-channel slice lifted the refusal: a subframe 0 with a MIB
    # and a DCI now equals the JAX package's (tests/test_torch_control.py
    # holds the channels themselves); random TB, MIB and DCI bits, so that a
    # fault that maps zeros to zeros shows
    cfg, jcfg = _pdsch_cfgs(6, 1, 0, "qpsk", 120)
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, (2, 120)).astype(np.int8)
    mib = rng.integers(0, 2, (2, 24)).astype(np.int8)
    dci = rng.integers(0, 2, (2, 27)).astype(np.int8)
    got = enb_dl.assemble_subframe(cfg, bits, mib_bits=mib, dcis=[(dci, 0x50, 2, 0)],
                                   device="cpu")

    def assemble(bits, mib, dci):
        return j_enb.assemble_subframe(jcfg, bits, mib_bits=mib, dcis=[(dci, 0x50, 2, 0)])

    want = _jit(assemble)(jnp.asarray(bits), jnp.asarray(mib), jnp.asarray(dci))
    assert float(np.abs(_np(want)).mean()) > 0.1
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)


def _search_capture(cell_id):
    """The JAX package's cell-search test capture at 6 PRB: 333 samples of
    lead, the subframe, 400 of tail, CFO 0.12 subcarriers, noise."""
    cfg, jcfg = _pdsch_cfgs(6, cell_id, 0, "qpsk", 120)
    rng = np.random.default_rng(cell_id)
    bits = rng.integers(0, 2, size=(2, cfg.tbs)).astype(np.int8)
    sf = _np(_jit(j_enb.subframe_to_samples, jcfg.cell)(
        _jit(j_enb.assemble_subframe, jcfg)(jnp.asarray(bits))))
    cap = np.concatenate([np.zeros((2, 333), np.complex64), sf,
                          np.zeros((2, 400), np.complex64)], axis=-1)
    cap = cap * np.exp(2j * np.pi * 0.12 * np.arange(cap.shape[-1]) / 128).astype(np.complex64)
    return cap + _noise(rng, cap.shape, 10 ** (-1.5) * 0.05)


@pytest.mark.parametrize("cell_id", [0, 151, 503])
def test_cell_search_matches_jax(cell_id):
    cap = _search_capture(cell_id)
    got = ue_dl.cell_search(torch.as_tensor(cap), 6)
    want = _jit(j_ue.cell_search, nof_prb=6)(jnp.asarray(cap))
    for key in ("cell_id", "n_id_2", "n_id_1", "phase"):
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]), err_msg=key)
    np.testing.assert_array_equal(_np(got["cell_id"]), cell_id)
    np.testing.assert_allclose(_np(got["cfo"]), _np(want["cfo"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(got["grid"]), _np(want["grid"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(_np(got["sf_samples"]), _np(want["sf_samples"]), atol=1e-4)


def _capture_25(rng, lead, cfo):
    """Captures at 25 PRB of the JAX package's subframe 5 (PSS/SSS present):
    each after its lead, with a random phase, its CFO (subcarriers) and
    noise at 30 dB; 1,000 samples longer than the subframe."""
    _, jcfg, _, tx = _jax_tx(5)
    sf = _np(_jit(j_enb.subframe_to_samples, jcfg.cell)(jnp.asarray(tx)))
    n = sf.shape[-1] + 1000
    cap = np.zeros((len(lead), n), np.complex64)
    for i, start in enumerate(lead):
        cap[i, start:start + sf.shape[-1]] = sf[i % 2] * np.exp(2j * np.pi * rng.random())
    cap = cap * np.exp(2j * np.pi * np.asarray(cfo)[:, None] * np.arange(n) / 512)
    return (cap + _noise(rng, cap.shape, 1e-3)).astype(np.complex64)


def test_cell_search_above_6_prb_matches_jax_functions():
    # above 6 PRB the port takes the CFO from the CP and refines the timing:
    # held against the same steps composed from the JAX package's functions
    # (the refinement moves nothing here: the PSS peak is already exact)
    cap = _capture_25(np.random.default_rng(5), (333, 20), (0.12, -0.3))
    got = ue_dl.cell_search(torch.as_tensor(cap), 25)
    jcfg = j_ofdm.OfdmConfig(nof_prb=25)
    found = _jit(j_sync.find_pss, symbol_sz=512)(jnp.asarray(cap))
    sf = _jit(j_ue.align_subframe, cfg=jcfg)(jnp.asarray(cap), found["offset"])
    cfo = _jit(j_sync.cp_cfo_estimate, jcfg)(sf)
    sf = _jit(j_sync.cfo_correct, symbol_sz=512)(sf, cfo)
    body = int(j_ofdm._symbol_offsets(jcfg)[6])
    np.testing.assert_array_equal(_np(got["offset"]), _np(found["offset"]))
    np.testing.assert_array_equal(_np(got["offset"]), np.array([333, 20]) + body)
    np.testing.assert_array_equal(_np(got["cell_id"]), 123)
    np.testing.assert_array_equal(_np(got["phase"]), 1)
    np.testing.assert_allclose(_np(got["cfo"]), _np(cfo), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(got["cfo"]), (0.12, -0.3), atol=0.02)
    np.testing.assert_allclose(_np(got["grid"]), _np(_jit(j_ofdm.demodulate, jcfg)(sf)),
                               atol=1e-3)


@pytest.mark.parametrize("shift", [-1, 0, 1, 2, 7])
def test_pss_timing_error_measures_window_shift(shift):
    # a port addition: the FFT window of the PSS symbol started `shift`
    # samples early (inside the CP; -1 reaches one sample into the next
    # symbol), 25 PRB, 30 dB
    cfg, jcfg, _, tx = _jax_tx(5)
    sf = _np(_jit(j_enb.subframe_to_samples, jcfg.cell)(jnp.asarray(tx)))
    cap = np.concatenate([np.zeros((2, 40), np.complex64), sf,
                          np.zeros((2, 40), np.complex64)], axis=-1)
    cap = cap + _noise(np.random.default_rng(shift + 10), cap.shape, 1e-3)
    ocfg = ofdm.OfdmConfig(nof_prb=25)
    body = 40 + int(ofdm._symbol_offsets(ocfg)[6])
    g = ofdm.demodulate(ocfg, ue_dl.align_subframe(torch.as_tensor(cap),
                                                    torch.full((2,), body - shift), ocfg))
    mid = ocfg.nre // 2
    err = sync.pss_timing_error(g[:, 6, mid - 31:mid + 31], torch.tensor([0, 0]), 512)
    np.testing.assert_allclose(_np(err), shift, atol=0.2)


def test_cell_search_finds_exact_timing_at_25_prb():
    # leads 0..600, CFO within ±0.1, 30 dB: the offset is exact on every
    # capture, the CFO within 0.02
    rng = np.random.default_rng(11)
    lead, cfo = rng.integers(0, 601, size=8), rng.uniform(-0.1, 0.1, size=8)
    got = ue_dl.cell_search(torch.as_tensor(_capture_25(rng, lead, cfo)), 25)
    np.testing.assert_array_equal(_np(got["cell_id"]), 123)
    np.testing.assert_array_equal(_np(got["phase"]), 1)
    ocfg = ofdm.OfdmConfig(nof_prb=25)
    np.testing.assert_array_equal(_np(got["offset"]), lead + int(ofdm._symbol_offsets(ocfg)[6]))
    np.testing.assert_allclose(_np(got["cfo"]), cfo, atol=0.02, rtol=0)


def test_receive_pdsch_subframe_matches_jax():
    cfg, jcfg, bits, tx = _jax_tx(0)
    rng = np.random.default_rng(7)
    sf = _np(_jit(j_enb.subframe_to_samples, jcfg.cell)(jnp.asarray(tx)))
    rx = sf * np.complex64(0.95 * np.exp(1j * 0.2)) + _noise(rng, sf.shape, 10 ** (-1.8) * 0.05)
    got = ue_dl.receive_pdsch_subframe(cfg, torch.as_tensor(rx))
    want = _jit(j_ue.receive_pdsch_subframe, jcfg)(jnp.asarray(rx))
    np.testing.assert_array_equal(_np(got["crc_ok"]), _np(want["crc_ok"]))
    np.testing.assert_array_equal(_np(got["bits"]), _np(want["bits"]))
    assert _np(got["crc_ok"]).all()
    np.testing.assert_array_equal(_np(got["bits"]), bits)
