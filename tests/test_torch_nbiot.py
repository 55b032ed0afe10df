"""Port parity: NB-IoT — ``models/nbiot``, ``models/nbiot_data`` and
``stack/rrc_nbiot`` (a copy) — against the JAX package on the same numpy
inputs, at the shapes of tests/test_nbiot_data.py, test_aux_components.py
and test_rrc_nbiot.py.

Noise is a numpy array added to the same grid on both sides.  The JAX side
runs under ``jax.jit`` with the fast-compile options (its Viterbi jitted
alone where a function runs several).  Tolerances: bits, CRC flags, cell
ids, port counts and DCI fields identical; grids, channel estimates and
metrics within rtol 1e-4 / atol 1e-3.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import nbiot as j_nb
from srsran_4g_tpu.models import nbiot_data as j_nd
from srsran_4g_tpu.stack import rrc_nbiot as j_rrc
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import nbiot, nbiot_data as nd
from srsran_4g_tpu_torch.stack import rrc_nbiot

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-3)
FAST = dict(xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
            xla_cpu_parallel_codegen_split_count=1)
NCELL, RNTI = 17, 0x4604


@functools.lru_cache(maxsize=None)
def _jit(fn, *static, **kw):
    """fn with its leading and keyword arguments fixed, under jax.jit (fast
    compile)."""
    return jax.jit(functools.partial(fn, *static, **kw), compiler_options=FAST)


def _noise(rng, shape, nv):
    return (np.sqrt(nv / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _t(x):
    return torch.as_tensor(np.array(x))


def _channel(rng, x, nv):
    """A complex gain a capture and AWGN."""
    g = (0.5 + rng.random(x.shape[0])) * np.exp(2j * np.pi * rng.random(x.shape[0]))
    g = g.reshape((-1,) + (1,) * (x.ndim - 1)).astype(np.complex64)
    return (np.asarray(x) * g + _noise(rng, x.shape, nv)).astype(np.complex64)


def test_tables_and_dci_codecs():
    for name in ("TBS_NPDSCH", "TBS_SIB1", "TBS_NPUSCH"):
        np.testing.assert_array_equal(getattr(nd, name), getattr(j_nd, name))
    assert nd.I_SF_TO_NOF_SF == j_nd.I_SF_TO_NOF_SF
    for i_tbs in range(13):
        for i_sf in range(8):
            if j_nd.TBS_NPDSCH[i_tbs, i_sf]:
                assert nd.npdsch_tbs(i_tbs, i_sf) == j_nd.npdsch_tbs(i_tbs, i_sf)
    with pytest.raises(ValueError):
        nd.npdsch_tbs(12, 7)
    d1 = dict(i_delay=3, i_sf=2, mcs=7, i_rep=1, ndi=1, harq_ack=5)
    d0 = dict(sc_indication=18, i_ru=4, i_delay=1, mcs=5, rv=1, i_rep=2, ndi=1, dci_sf_rep=1)
    d2 = dict(is_paging=1, i_sf=3, mcs=9, i_rep=4)
    for cls, d in ((nd.DciN1, d1), (nd.DciN0, d0), (nd.DciN2, d2)):
        bits = cls(**d).pack()
        np.testing.assert_array_equal(bits, getattr(j_nd, cls.__name__)(**d).pack())
    assert dataclasses.asdict(nd.unpack_dci_n1(nd.DciN1(**d1).pack())) == d1
    assert dataclasses.asdict(nd.unpack_dci_n0(nd.DciN0(**d0).pack())) == d0
    assert nd.DciN1(**d1).nof_sf == 3 and nd.DciN1(**d1).tbs == 328


def test_rrc_nbiot_copy_and_mib_nb_over_npbch():
    """The copy equals its source; tests/test_rrc_nbiot.py's MIB-NB through
    both packages' NPBCH."""
    jax_src = (REPO / "srsran_4g_tpu" / "stack" / "rrc_nbiot.py").read_text()
    port_src = (REPO / "srsran_4g_tpu_torch" / "stack" / "rrc_nbiot.py").read_text()
    assert port_src == re.sub(r"\bsrsran_4g_tpu\.", "srsran_4g_tpu_torch.", jax_src)
    mib = rrc_nbiot.MibNb(sfn_msb=5, scheduling_info_sib1=3, system_info_value_tag=9)
    assert mib.pack() == j_rrc.MibNb(sfn_msb=5, scheduling_info_sib1=3,
                                     system_info_value_tag=9).pack()
    bits = np.unpackbits(np.frombuffer(mib.pack(), np.uint8))[:34][None].astype(np.int8)
    want = np.asarray(_jit(j_nb.npbch_encode, 0, frame_idx=0)(jnp.asarray(bits)))
    grid = nbiot.npbch_encode(0, _t(bits), frame_idx=0)
    np.testing.assert_allclose(grid.numpy(), want, **TOL)
    jout = _jit(j_nb.npbch_decode, 0, block_idx=0)(jnp.asarray(want))
    out = nbiot.npbch_decode(0, _t(want), block_idx=0)
    for k in ("mib", "crc_ok", "n_ports"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    assert bool(out["crc_ok"][0])
    rx = rrc_nbiot.MibNb.unpack(np.packbits(out["mib"][0].numpy().astype(np.uint8)).tobytes())
    assert rx == mib
    assert nbiot.mib_nb_unpack(out["mib"][0]) == j_nb.mib_nb_unpack(np.asarray(jout["mib"][0]))


def test_npss_and_nsss():
    """The NPSS metric on signal and on noise; the NSSS search over all 504
    ids at cell ids 0, 257 and 503 (tests/test_aux_components.py)."""
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(nbiot.npss_sequence(), j_nb.npss_sequence())
    zeros = np.zeros((2, 14, 12), np.complex64)
    g = nbiot.put_npss(_t(zeros)).numpy()
    np.testing.assert_allclose(g, np.asarray(j_nb.put_npss(jnp.asarray(zeros))), **TOL)
    for x in (_channel(rng, g, 0.3), _noise(rng, zeros.shape, 1.0)):
        np.testing.assert_allclose(nbiot.npss_metric(_t(x)).numpy(),
                                   np.asarray(_jit(j_nb.npss_metric)(jnp.asarray(x))), **TOL)
    assert (nbiot.npss_metric(_t(_channel(rng, g, 0.3))) > 0.5).all()
    cells = (0, 257, 503)
    for c in cells:
        np.testing.assert_array_equal(nbiot.nsss_sequence(c, 1), j_nb.nsss_sequence(c, 1))
    g = np.concatenate([nbiot.put_nsss(_t(zeros[:1]), c).numpy() for c in cells])
    rx = _channel(rng, g, 0.25)
    got, want = nbiot.nsss_detect(_t(rx)), _jit(j_nb.nsss_detect)(jnp.asarray(rx))
    np.testing.assert_array_equal(got["cell_id"].numpy(), cells)
    np.testing.assert_array_equal(got["cell_id"].numpy(), np.asarray(want["cell_id"]))
    np.testing.assert_allclose(got["metric"].numpy(), np.asarray(want["metric"]), **TOL)


@pytest.mark.parametrize("frame_idx,r14", [(0, False), (12, False), (35, True)])
def test_npbch(frame_idx, r14):
    """tests/test_aux_components.py's NPBCH points: cell 257, 8 dB, the 1-
    and 2-port hypotheses; a wrong cell id fails."""
    rng = np.random.default_rng(frame_idx)
    mib = rng.integers(0, 2, (3, nbiot.MIB_NB_LEN)).astype(np.int8)
    want = np.asarray(_jit(j_nb.npbch_encode, 257, frame_idx=frame_idx, is_r14=r14)(
        jnp.asarray(mib)))
    got = nbiot.npbch_encode(257, _t(mib), frame_idx=frame_idx, is_r14=r14)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    rx = want + _noise(rng, want.shape, 10 ** -0.8)
    block = (frame_idx // nbiot.NPBCH_REP) % nbiot.NPBCH_BLOCKS
    jout = _jit(j_nb.npbch_decode, 257, block_idx=block, nf=frame_idx, is_r14=r14)(
        jnp.asarray(rx))
    out = nbiot.npbch_decode(257, _t(rx), block_idx=block, nf=frame_idx, is_r14=r14)
    for k in ("mib", "crc_ok", "n_ports"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    assert bool(out["crc_ok"].all()) and np.array_equal(out["mib"].numpy(), mib)
    assert not bool(nbiot.npbch_decode(11, _t(rx), block_idx=block, nf=frame_idx,
                                       is_r14=r14)["crc_ok"].any())
    for port in (0, 1):
        c, jc = nbiot.chest_nbiot(257, _t(rx), port), j_nb.chest_nbiot(257, jnp.asarray(rx), port)
        for k in ("h", "noise_var"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), **TOL)


def test_nrs_pattern_values_and_estimate():
    rng = np.random.default_rng(4)
    for cell in (0, 17, 503):
        for a, b in zip(nd.nrs_pattern(cell), j_nd.nrs_pattern(cell)):
            np.testing.assert_array_equal(a, b)
        for sf in (1, 3, 8):
            np.testing.assert_array_equal(nd.nrs_values(cell, sf), j_nd.nrs_values(cell, sf))
        np.testing.assert_array_equal(nd.npdsch_re_indices(cell),
                                      j_nd.npdsch_re_indices(cell))
        for ncce in (0, 1):
            np.testing.assert_array_equal(nd.ncce_re_indices(cell, ncce),
                                          j_nd.ncce_re_indices(cell, ncce))
    g = nd.put_nrs(torch.zeros((2, 14, 12), dtype=torch.complex64), NCELL, 3).numpy()
    np.testing.assert_allclose(g, np.asarray(j_nd.put_nrs(jnp.zeros((2, 14, 12), jnp.complex64),
                                                          NCELL, 3)), **TOL)
    rx = _channel(rng, g, 0.05)
    h, nv = nd.nrs_estimate(_t(rx), NCELL, 3)
    jh, jnv = _jit(j_nd.nrs_estimate, n_id_ncell=NCELL, subframe=3)(jnp.asarray(rx))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jnv), **TOL)


def test_npdcch_search():
    """DCI N1 on each of the three candidates (one capture each) at 8 dB and
    a wrong RNTI (tests/test_nbiot_data.py), the candidates of a capture in
    one Viterbi batch."""
    rng = np.random.default_rng(1)
    dci = nd.DciN1(i_delay=0, i_sf=1, mcs=4, i_rep=0, ndi=1, harq_ack=2)
    bits = dci.pack()[None]
    tx = []
    for ncce, l_agg in nd.CANDIDATES:
        want = np.asarray(_jit(j_nd.npdcch_encode, rnti=RNTI, n_id_ncell=NCELL, subframe=1,
                               ncce=ncce, l_agg=l_agg)(jnp.asarray(bits)))
        got = nd.npdcch_encode(_t(bits), RNTI, NCELL, subframe=1, ncce=ncce, l_agg=l_agg)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        tx.append(want)
    rx = _channel(rng, np.concatenate(tx), 10 ** -0.8)
    for rnti in (RNTI, RNTI + 1):
        jout = _jit(j_nd.npdcch_blind_decode, rnti=rnti, n_id_ncell=NCELL, subframe=1)(
            jnp.asarray(rx))
        out = nd.npdcch_blind_decode(_t(rx), rnti, NCELL, subframe=1)
        for k in ("bits", "crc_ok"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
        if rnti == RNTI:
            assert out["crc_ok"].diagonal().all()
            for c in range(3):
                assert nd.unpack_dci_n1(out["bits"][c, c].numpy()) == dci
        else:
            assert not bool(out["crc_ok"].any())


@pytest.mark.parametrize("i_tbs,i_sf,snr_db", [(1, 0, 6.0), (4, 3, 6.0), (12, 2, 16.0)])
def test_npdsch(i_tbs, i_sf, snr_db):
    """tests/test_nbiot_data.py's NPDSCH points: the subframes as a batch
    axis on the port."""
    rng = np.random.default_rng(i_tbs)
    kw = dict(n_id_ncell=NCELL, rnti=RNTI, i_tbs=i_tbs, i_sf=i_sf, sfn=8, start_sf=4)
    jcfg = j_nd.NpdschConfig(**kw)
    cfg = convert.npdsch_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg == nd.NpdschConfig(**kw)
    assert cfg.sf_list() == jcfg.sf_list() and cfg.tbs == jcfg.tbs
    bits = rng.integers(0, 2, size=(3, cfg.tbs)).astype(np.int8)
    want = np.asarray(_jit(j_nd.npdsch_encode, jcfg)(jnp.asarray(bits)))
    got = nd.npdsch_encode(cfg, _t(bits))
    assert got.shape == (3, cfg.nof_sf, 14, 12)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    rx = _channel(rng, want, 10 ** (-snr_db / 10))
    jout = _jit(j_nd.npdsch_decode, jcfg)(jnp.asarray(rx))
    out = nd.npdsch_decode(cfg, _t(rx))
    for k in ("bits", "crc_ok"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    assert bool(out["crc_ok"].all()) and np.array_equal(out["bits"].numpy(), bits)


def test_npdsch_bcch_scrambling_and_sf_list():
    kw = dict(n_id_ncell=NCELL, rnti=0xFFFF, i_tbs=3, i_sf=0)
    bits = np.zeros((1, 328), np.int8)
    for bcch in (True, False):
        cfg, jcfg = nd.NpdschConfig(is_bcch=bcch, **kw), j_nd.NpdschConfig(is_bcch=bcch, **kw)
        np.testing.assert_allclose(nd.npdsch_encode(cfg, _t(bits[:, :cfg.tbs])).numpy(),
                                   np.asarray(j_nd.npdsch_encode(jcfg, jnp.asarray(
                                       bits[:, :cfg.tbs]))), **TOL)
    a = nd.npdsch_encode(nd.NpdschConfig(is_bcch=True, **kw), _t(bits))
    b = nd.npdsch_encode(nd.NpdschConfig(is_bcch=False, **kw), _t(bits))
    assert not torch.allclose(a, b)
    for start in range(10):
        for i_sf in (4, 7):
            kw2 = dict(n_id_ncell=NCELL, rnti=RNTI, i_tbs=1, i_sf=i_sf, sfn=3, start_sf=start)
            sfs = nd.NpdschConfig(**kw2).sf_list()
            assert sfs == j_nd.NpdschConfig(**kw2).sf_list()
            assert all(sf not in (0, 5, 9) for _, sf in sfs)
