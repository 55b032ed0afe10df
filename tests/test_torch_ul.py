"""Port parity: the LTE uplink receiver — ``models/refsignal_ul``,
``ops/block_code``, ``models/cqi``, ``models/uci``, ``models/pusch``,
``models/pucch``, ``models/prach`` and ``models/srs`` — against the JAX
package on the same inputs, with the ``convert`` functions that carry their
configs across.

Inputs, noise and channels come from numpy with a seed and go to both
packages as arrays; the JAX side runs under ``jax.jit``.  Sizes: a 6 PRB
cell with a 4 PRB PUSCH (QPSK without UCI, 16QAM with 1 ACK, 1 RI and 4
CQI bits (short), 64QAM with 2 ACK and 20 CQI bits (long: CRC8 +
tail-biting Viterbi)), every PUCCH format, PRACH at symbol_sz 128, SRS over
16 PRB.  Tolerances: bits, CRC flags, ACK/RI/CQI bits, detected preambles
and codebooks identical; grids atol 1e-5 (the PUSCH's DFT precoding and the
PUCCH format 3's DFT-12 in two FFT libraries); channel estimates and noise
variances ``EST_TOL`` (rtol 1e-4, atol 1e-5; tests/test_torch_pdsch.py);
block-code metrics and PUCCH metrics rtol 1e-4, atol 1e-3 (``LLR_TOL``);
PRACH powers rtol 1e-4 and delays identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import cqi as j_cqi
from srsran_4g_tpu.models import grid as j_grid
from srsran_4g_tpu.models import prach as j_prach
from srsran_4g_tpu.models import pucch as j_pucch
from srsran_4g_tpu.models import pusch as j_pusch
from srsran_4g_tpu.models import refsignal_ul as j_ref
from srsran_4g_tpu.models import srs as j_srs
from srsran_4g_tpu.models import uci as j_uci
from srsran_4g_tpu.ops import block_code as j_bc
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import cqi, prach, pucch, pusch, refsignal_ul, srs, uci
from srsran_4g_tpu_torch.ops import block_code

torch.set_num_threads(2)

EST_TOL = dict(rtol=1e-4, atol=1e-5)
LLR_TOL = dict(rtol=1e-4, atol=1e-3)
GRID_TOL = dict(rtol=0, atol=1e-5)

JCELL = j_grid.CellConfig(nof_prb=6, cell_id=42, cfi=1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _jit(fn, *args, **kw):
    """fn with its leading and keyword arguments fixed, under jax.jit."""
    # The JAX side runs once per shape, so compiling it is most of its cost:
    # compile it for speed of compiling (the same results, sooner).
    return jax.jit(functools.partial(fn, *args, **kw), compiler_options=dict(
        xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
        xla_cpu_parallel_codegen_split_count=1))


def _noise(rng, shape, nv):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(nv / 2)).astype(np.complex64)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# --- tables, block code, CQI --------------------------------------------------------

def test_refsignal_and_cqi_match_jax():
    for m_sc in (12, 24, 36, 48, 96, 1152):
        for u in (0, 7, 29):
            np.testing.assert_array_equal(refsignal_ul.base_sequence(u, 0, m_sc),
                                          j_ref.base_sequence(u, 0, m_sc))
    np.testing.assert_array_equal(refsignal_ul.base_sequence(3, 1, 72),
                                  j_ref.base_sequence(3, 1, 72))
    for enabled in (False, True):
        np.testing.assert_array_equal(refsignal_ul.group_hopping_pattern(301, 3, enabled),
                                      j_ref.group_hopping_pattern(301, 3, enabled))
    np.testing.assert_array_equal(refsignal_ul.pusch_dmrs(301, 96, 5, 3),
                                  j_ref.pusch_dmrs(301, 96, 5, 3))
    snr = np.linspace(-5, 35, 81)
    np.testing.assert_array_equal(cqi.cqi_from_snr(snr), j_cqi.cqi_from_snr(snr))
    assert cqi.CQI_TO_MOD_RATE == j_cqi.CQI_TO_MOD_RATE
    for c in range(16):
        for pmi_present in (False, True):
            rep = cqi.CqiReport(wideband_cqi=c)
            bits = cqi.pack_wideband(rep, pmi_present, pmi=c % 4, n_tx=4)
            np.testing.assert_array_equal(
                bits, j_cqi.pack_wideband(j_cqi.CqiReport(wideband_cqi=c), pmi_present,
                                          pmi=c % 4, n_tx=4))
            assert cqi.unpack_wideband(bits, pmi_present, 4) == \
                j_cqi.unpack_wideband(bits, pmi_present, 4)


@pytest.mark.parametrize("n,a", [(20, 13), (20, 5), (32, 11), (32, 3)])
def test_block_code_matches_jax(n, a):
    rng = np.random.default_rng(n * 100 + a)
    bits = rng.integers(0, 2, (64, a)).astype(np.int8)
    np.testing.assert_array_equal(block_code.codebook(n, a), j_bc.codebook(n, a))
    cw = block_code.encode(_t(bits), n)
    np.testing.assert_array_equal(_np(cw), _np(j_bc.encode(jnp.asarray(bits), n)))
    # noisy LLRs (positive ⇒ 1): no tie can hide a wrong sign
    llr = ((2.0 * _np(cw) - 1.0) * 2.0 + rng.standard_normal(cw.shape) * 1.5).astype(np.float32)
    got_b, got_m = block_code.decode(_t(llr), n, a)
    want_b, want_m = _jit(j_bc.decode, n=n, a=a)(llr)
    np.testing.assert_array_equal(_np(got_b), _np(want_b))
    np.testing.assert_allclose(_np(got_m), _np(want_m), **LLR_TOL)


# --- UCI ------------------------------------------------------------------------

UCI_CFGS = [dict(o_ack=1, o_ri=1, o_cqi=4), dict(o_ack=2, o_cqi=20), dict(o_ri=2, o_cqi=11),
            dict(o_ack=2, o_ri=1, o_cqi=16, beta_ack=6.25)]


@pytest.mark.parametrize("kw", UCI_CFGS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_uci_plan_and_codes_match_jax(kw):
    shapes = [(600, 48, 2), (1000, 48, 4)]
    if kw == dict(o_ack=2, o_cqi=20):  # chip_smoke.py's PUSCH at 96 PRB
        shapes.append((71112, 1152, 6))
    for tbs, m_sc, qm in shapes:
        got = uci.uci_plan(tbs, m_sc, qm, uci.UciCfg(**kw))
        want = j_uci.uci_plan(tbs, m_sc, qm, j_uci.UciCfg(**kw))
        assert (got.q_prime_cqi, got.q_prime_ack, got.q_prime_ri, got.g_data) == \
            (want.q_prime_cqi, want.q_prime_ack, want.q_prime_ri, want.g_data)
        np.testing.assert_array_equal(got.perm, want.perm)
        np.testing.assert_array_equal(got.ack_pos, want.ack_pos)
    rng = np.random.default_rng(int(sum(kw.values())))
    for o, q in ((kw.get("o_ack", 0), 12), (kw.get("o_ri", 0), 18)):
        if o:
            bits = rng.integers(0, 2, (32, o)).astype(np.int8)
            cw = uci.encode_ack_ri(_t(bits), q)
            np.testing.assert_array_equal(_np(cw), _np(j_uci.encode_ack_ri(jnp.asarray(bits), q)))
            llr = ((2.0 * _np(cw) - 1) + rng.standard_normal(cw.shape)).astype(np.float32)
            np.testing.assert_array_equal(_np(uci.decode_ack_ri(_t(llr), o)),
                                          _np(_jit(j_uci.decode_ack_ri, o=o)(llr)))
    o = kw["o_cqi"]
    bits = rng.integers(0, 2, (32, o)).astype(np.int8)
    cw = uci.encode_cqi(_t(bits), 96)
    np.testing.assert_array_equal(_np(cw), _np(j_uci.encode_cqi(jnp.asarray(bits), 96)))
    llr = ((2.0 * _np(cw) - 1) * 2 + rng.standard_normal(cw.shape) * 1.2).astype(np.float32)
    got_b, got_ok = uci.decode_cqi(_t(llr), o)
    want_b, want_ok = _jit(j_uci.decode_cqi, o=o)(llr)
    np.testing.assert_array_equal(_np(got_b), _np(want_b))
    np.testing.assert_array_equal(_np(got_ok), _np(want_ok))


# --- PUSCH ------------------------------------------------------------------------

PUSCH_CASES = {"qpsk": ("qpsk", 600, None, 12.0),
               "16qam-uci-short": ("16qam", 1000, dict(o_ack=1, o_ri=1, o_cqi=4), 20.0),
               "64qam-uci-long": ("64qam", 1800, dict(o_ack=2, o_cqi=20), 26.0)}


def test_transform_precode_matches_jax():
    rng = np.random.default_rng(0)
    x = _noise(rng, (2, 12, 48), 1.0)
    y = pusch.transform_precode(_t(x))
    np.testing.assert_allclose(_np(y), _np(_jit(j_pusch.transform_precode)(x)), **GRID_TOL)
    np.testing.assert_allclose(_np(pusch.transform_deprecode(y)),
                               _np(_jit(j_pusch.transform_deprecode)(_np(y))), **GRID_TOL)


@pytest.mark.parametrize("name", list(PUSCH_CASES))
def test_pusch_matches_jax(name):
    mod, tbs, uci_kw, snr_db = PUSCH_CASES[name]
    jcfg = j_pusch.PuschConfig(cell=JCELL, rnti=0x777, subframe=2, mod=mod, tbs=tbs,
                               prb_start=1, nof_prb_alloc=4, cyclic_shift=2,
                               uci=None if uci_kw is None else j_uci.UciCfg(**uci_kw))
    cfg = convert.pusch_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.uci == (None if uci_kw is None else uci.UciCfg(**uci_kw))
    rng = np.random.default_rng(tbs)
    b = 2
    bits = rng.integers(0, 2, (b, tbs)).astype(np.int8)
    ucis = {f"{k}_bits": rng.integers(0, 2, (b, (uci_kw or {}).get(f"o_{k}", 0))).astype(np.int8)
            for k in ("cqi", "ack", "ri")}
    ucis = {k: v for k, v in ucis.items() if v.shape[-1]}
    tx = pusch.encode(cfg, bits, **{k: _t(v) for k, v in ucis.items()}, device="cpu")
    tx_j = _jit(j_pusch.encode, jcfg)(bits, **{k: jnp.asarray(v) for k, v in ucis.items()})
    np.testing.assert_allclose(_np(tx), _np(tx_j), **GRID_TOL)
    h = 0.9 * np.exp(1j * 0.6)
    rx = (_np(tx) * h + _noise(rng, tx.shape, 10 ** (-snr_db / 10) * cfg.m_sc / cfg.cell.nre)
          ).astype(np.complex64)
    got = pusch.decode(cfg, _t(rx), n_iter=5)
    want = _jit(j_pusch.decode, jcfg, n_iter=5)(rx)
    for key in ("bits", "crc_ok") + tuple(k for k in ("ack_bits", "ri_bits", "cqi_bits", "cqi_ok")
                                         if k in want):
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]), key)
    assert set(got) == set(want) - {"softbuffers"} | {"softbuffers"}
    for key in ("h", "noise_var"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), **EST_TOL)
    assert bool(got["crc_ok"].all())
    np.testing.assert_array_equal(_np(got["bits"]), bits)
    for k, v in ucis.items():
        np.testing.assert_array_equal(_np(got[k]), v, k)


# --- PUCCH ----------------------------------------------------------------------

PUCCH_CASES = [("1", None), ("1a", 1), ("1b", 2), ("2", 11), ("2a", 1), ("2b", 2), ("3-4", 4),
               ("3-11", 11)]


@pytest.mark.parametrize("fmt,nbits", PUCCH_CASES, ids=[c[0] for c in PUCCH_CASES])
def test_pucch_matches_jax(fmt, nbits):
    jcfg = j_pucch.PucchConfig(cell=JCELL, subframe=3, n_pucch=11, rnti=0x4601)
    cfg = convert.pucch_config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(len(fmt) * 10 + (nbits or 0))
    b = 6
    for ns in (6, 7):
        assert pucch.pucch_prb(cfg, ns) == j_pucch.pucch_prb(jcfg, ns)
        assert pucch.pucch3_prb(cfg, ns) == j_pucch.pucch3_prb(jcfg, ns)
    if fmt.startswith("1"):
        bits = None if nbits is None else rng.integers(0, 2, (b, nbits)).astype(np.int8)
        tx = pucch.encode_format1(cfg, None if bits is None else _t(bits), device="cpu")
        tx_j = j_pucch.encode_format1(jcfg, None if bits is None else jnp.asarray(bits))
        dec = functools.partial(pucch.decode_format1, cfg, nof_bits=nbits or 1)
        dec_j = _jit(j_pucch.decode_format1, jcfg, nof_bits=nbits or 1)
    elif fmt.startswith("2"):
        n_cqi = 11 if fmt == "2" else 8
        cqi_bits = rng.integers(0, 2, (b, n_cqi)).astype(np.int8)
        ack = None if fmt == "2" else rng.integers(0, 2, (b, nbits)).astype(np.int8)
        tx = pucch.encode_format2(cfg, _t(cqi_bits), None if ack is None else _t(ack))
        tx_j = _jit(j_pucch.encode_format2, jcfg)(cqi_bits, ack)
        nof_ack = 0 if fmt == "2" else nbits
        dec = functools.partial(pucch.decode_format2, cfg, nof_bits=n_cqi, nof_ack=nof_ack)
        dec_j = _jit(j_pucch.decode_format2, jcfg, nof_bits=n_cqi, nof_ack=nof_ack)
    else:
        bits = rng.integers(0, 2, (b, nbits)).astype(np.int8)
        tx = pucch.encode_format3(cfg, _t(bits))
        tx_j = _jit(j_pucch.encode_format3, jcfg)(bits)
        dec = functools.partial(pucch.decode_format3, cfg, nof_bits=nbits)
        dec_j = _jit(j_pucch.decode_format3, jcfg, nof_bits=nbits)
    np.testing.assert_allclose(_np(tx), _np(tx_j), **GRID_TOL)
    rx = (_np(tx) * (0.8 * np.exp(-0.4j)) + _noise(rng, tx.shape, 0.02)).astype(np.complex64)
    got, want = dec(_t(rx)), dec_j(rx)
    assert set(got) == set(want)
    for key in got:
        if got[key].dtype in (torch.int8, torch.bool):
            np.testing.assert_array_equal(_np(got[key]), _np(want[key]), key)
        else:
            np.testing.assert_allclose(_np(got[key]), _np(want[key]), **LLR_TOL)
    sent = {"1": None, "1a": bits if fmt[0] == "1" else None}.get(fmt)
    if fmt in ("1a", "1b"):
        np.testing.assert_array_equal(_np(got["bits"]), bits)
    elif fmt.startswith("2"):
        np.testing.assert_array_equal(_np(got["bits"]), cqi_bits)
        if ack is not None:
            np.testing.assert_array_equal(_np(got["ack_bits"]), ack)
    elif fmt.startswith("3"):
        np.testing.assert_array_equal(_np(got["bits"]), bits)
    del sent


# --- PRACH ------------------------------------------------------------------------

def test_prach_matches_jax():
    jcfg = j_prach.PrachConfig(symbol_sz=128, root_seq_index=22, zero_corr_zone=5)
    cfg = convert.prach_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.preamble_plan() == jcfg.preamble_plan()
    for idx in (0, 17, 63):
        np.testing.assert_allclose(_np(prach.generate(cfg, idx, device="cpu")),
                                   _np(j_prach.generate(jcfg, idx)), rtol=0, atol=1e-6)
    for paired, table in ((True, prach.PRACH_NR_FR1_PAIRED), (False, prach.PRACH_NR_FR1_UNPAIRED)):
        j_table = j_prach.PRACH_NR_FR1_PAIRED if paired else j_prach.PRACH_NR_FR1_UNPAIRED
        assert [dataclasses.astuple(c) for c in table] == [dataclasses.astuple(c) for c in j_table]
        for ci in range(len(table)):
            assert prach.prach_nr_start_symbol(ci, paired) == j_prach.prach_nr_start_symbol(ci, paired)
            for tti in range(0, 320, 7):
                assert prach.prach_nr_tti_opportunity(ci, tti, paired) == \
                    j_prach.prach_nr_tti_opportunity(ci, tti, paired)
    rng = np.random.default_rng(4)
    n = cfg.cp_len + cfg.seq_len_samples
    caps = _noise(rng, (4, n), 1e-3 / cfg.seq_len_samples)
    # delays inside the zero-correlation zone (N_cs = 26 ZC units = 47.6 samples)
    for row, (idx, delay) in enumerate(((5, 0), (40, 12), (63, 36))):
        p = j_prach.generate(jcfg, idx)
        caps[row, delay:] += np.asarray(p)[:n - delay]
    got = prach.detect(cfg, _t(caps))
    want = _jit(j_prach.detect, jcfg)(caps)
    np.testing.assert_array_equal(_np(got["detected"]), _np(want["detected"]))
    np.testing.assert_array_equal(_np(got["delay_samples"]), _np(want["delay_samples"]))
    np.testing.assert_allclose(_np(got["power"]), _np(want["power"]), rtol=1e-4, atol=1e-6)
    det = _np(got["detected"])
    assert [np.flatnonzero(r).tolist() for r in det] == [[5], [40], [63], []]
    np.testing.assert_array_equal(_np(got["delay_samples"])[[0, 1, 2], [5, 40, 63]], [0, 12, 36])


# --- SRS ------------------------------------------------------------------------

def test_srs_matches_jax():
    jcell = j_grid.CellConfig(nof_prb=25, cell_id=42, cfi=1)
    jcfg = j_srs.SrsConfig(cell=jcell, n_prb_srs=16, prb_offset=2, k_tc=1, cyclic_shift=3)
    cfg = convert.srs_config_from_dict(dataclasses.asdict(jcfg))
    np.testing.assert_array_equal(srs.srs_sequence(cfg, 4), j_srs.srs_sequence(jcfg, 4))
    np.testing.assert_array_equal(srs.srs_subcarriers(cfg), j_srs.srs_subcarriers(jcfg))
    rng = np.random.default_rng(16)
    g0 = _noise(rng, (3, 14, 300), 1.0)
    tx = srs.put_srs(cfg, _t(g0), 4)
    np.testing.assert_array_equal(_np(tx), _np(j_srs.put_srs(jcfg, g0, 4)))
    k = np.arange(300)
    chan = (0.9 * np.exp(0.3j) + 0.3 * np.exp(-2j * np.pi * k * 3 / 512)).astype(np.complex64)
    rx = (_np(tx) * chan + _noise(rng, tx.shape, 1e-3)).astype(np.complex64)
    got = srs.estimate_srs(cfg, _t(rx), 4)
    want = _jit(j_srs.estimate_srs, jcfg, subframe=4)(rx)
    for key in ("h", "noise_var"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), **EST_TOL)
    np.testing.assert_allclose(_np(got["snr_db"]), _np(want["snr_db"]), rtol=0, atol=1e-3)
