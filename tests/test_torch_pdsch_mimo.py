"""Port parity: 2x2 spatial multiplexing (TM3/TM4, ``models/mimo.py`` and
``models/pdsch_mimo.py``) and 2/4-port transmit diversity (TM2,
``models/pdsch.py`` with the SFBC decoders of ``models/equalizer.py``)
against the JAX package, at the flagship shape (25 PRB, 16QAM, TBS 2000 on
each codeword) with 2 antenna ports.

Inputs, channels and noise are numpy arrays from a seed, given to both
packages.  Tolerances: the ``mimo`` functions and the equalisers within
rtol 1e-4 / atol 1e-5 (complex64 element-wise arithmetic, rounded in another
order); grids within atol 1e-6; decoded bits and CRC flags identical, and
equal to the sent bits.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import equalizer as jeq
from srsran_4g_tpu.models import grid as jgrid
from srsran_4g_tpu.models import mimo as jmimo
from srsran_4g_tpu.models import pdsch as jpdsch
from srsran_4g_tpu.models import pdsch_mimo as jpm
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import equalizer, mimo, pdsch, pdsch_mimo

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
CELL2 = jgrid.CellConfig(nof_prb=25, cell_id=123, cfi=1, nof_ports=2)
CELL4 = jgrid.CellConfig(nof_prb=25, cell_id=123, cfi=1, nof_ports=4)
TBS, MOD = 2000, "16qam"
# the 2x2 channel of the JAX package's own MIMO gate (tools/tpu_smoke.py)
HMAT = np.array([[1.0 + 0.1j, 0.3 - 0.4j], [0.2 + 0.4j, -0.9 + 0.2j]], np.complex64)
CASES = [("tm3", 0), ("tm4", 0), ("tm4", 1), ("tm4", 2)]


def _c(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def _noisy(rng, grid, nv):
    return (grid + _c(rng, *grid.shape) * np.sqrt(nv / 2)).astype(np.complex64)


# --- models/mimo.py ----------------------------------------------------------


@pytest.mark.parametrize("n_cw", [1, 2])
def test_layer_map_and_demap(n_cw):
    rng = np.random.default_rng(n_cw)
    cws = [_c(rng, 3, 40) for _ in range(n_cw)]
    want = jmimo.layer_map([jnp.asarray(c) for c in cws], 2)
    got = mimo.layer_map([_t(c) for c in cws], 2)
    _close(got, want)
    for g, w in zip(mimo.layer_demap(got, n_cw), jmimo.layer_demap(want, n_cw)):
        _close(g, w)


@pytest.mark.parametrize("pmi", [0, 1, 2])
def test_precode_2x2(pmi):
    x = _c(np.random.default_rng(pmi), 3, 2, 50)
    _close(mimo.precode_2x2(_t(x), pmi), jmimo.precode_2x2(jnp.asarray(x), pmi))


def test_cdd_precode_2x2():
    # a long symbol axis: the CDD phase pi*i is rounded to float32 as in JAX
    x = _c(np.random.default_rng(7), 2, 2, 7000)
    _close(mimo.cdd_precode_2x2(_t(x)), jmimo.cdd_precode_2x2(jnp.asarray(x)))


def test_sfbc_encode_2():
    x = _c(np.random.default_rng(8), 3, 60)
    for g, w in zip(mimo.sfbc_encode_2(_t(x)), jmimo.sfbc_encode_2(jnp.asarray(x))):
        _close(g, w)


@pytest.mark.parametrize("two_port", [False, True])
@pytest.mark.parametrize("add", [False, True])
def test_scatter_ctrl_syms(two_port, add):
    rng = np.random.default_rng(9)
    grid = _c(rng, 2, *((2,) if two_port else ()), 14, 72)
    idx = rng.choice(14 * 72, size=48, replace=False)
    syms = _c(rng, 2, 48)
    want = jmimo.scatter_ctrl_syms(jnp.asarray(grid), idx, jnp.asarray(syms), add=add)
    got = mimo.scatter_ctrl_syms(_t(grid), idx, _t(syms), add=add)
    _close(got, want)


def test_mmse_detect_2x2():
    rng = np.random.default_rng(10)
    y, h = _c(rng, 3, 2, 80), _c(rng, 3, 2, 2, 80)
    nv = (rng.random((3, 1)) * 0.2 + 0.01).astype(np.float32)
    want = jmimo.mmse_detect_2x2(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv))
    got = mimo.mmse_detect_2x2(_t(y), _t(h), _t(nv))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("rank", [1, 2])
def test_pmi_select_2tx(rank):
    h = _c(np.random.default_rng(11 + rank), 5, 2, 2, 64)
    pmi_w, m_w = jmimo.pmi_select_2tx(jnp.asarray(h), 0.1, rank=rank)
    pmi_g, m_g = mimo.pmi_select_2tx(_t(h), 0.1, rank=rank)
    np.testing.assert_array_equal(pmi_g.numpy(), np.asarray(pmi_w))
    assert pmi_g.dtype == torch.int32
    _close(m_g, m_w)


# --- models/pdsch_mimo.py ----------------------------------------------------


def _mimo_cfg(tm, pmi):
    return jpm.PdschMimoConfig(cell=CELL2, rnti=0x1234, subframe=4, mod0=MOD, tbs0=TBS,
                               mod1=MOD, tbs1=TBS, tm=tm, pmi=pmi)


@functools.lru_cache(maxsize=None)
def _mimo_case(tm, pmi):
    """Both packages' TX grid (CRS included), and the grid through HMAT with
    noise at 20 dB."""
    jcfg = _mimo_cfg(tm, pmi)
    rng = np.random.default_rng(100 + 3 * pmi + (tm == "tm3"))
    tb0, tb1 = (rng.integers(0, 2, (2, TBS)).astype(np.int8) for _ in range(2))
    grid_j = np.asarray(jpdsch.add_crs(jcfg.cw[0], jpm.encode(
        jcfg, jnp.asarray(tb0), jnp.asarray(tb1))))
    rx = _noisy(rng, np.einsum("rt,btsk->brsk", HMAT, grid_j), 0.01)
    cfg = convert.pdsch_config_from_dict(dataclasses.asdict(jcfg))
    return dict(jcfg=jcfg, cfg=cfg, tb0=tb0, tb1=tb1, grid_j=grid_j, rx=rx)


@pytest.mark.parametrize("tm,pmi", CASES)
def test_mimo_encode_grid_matches(tm, pmi):
    case = _mimo_case(tm, pmi)
    cfg = case["cfg"]
    grid = pdsch.add_crs(cfg.cw[0], pdsch_mimo.encode(cfg, case["tb0"], case["tb1"],
                                                      device="cpu"))
    assert grid.shape == (2, 2, 14, 300) and grid.dtype == torch.complex64
    np.testing.assert_allclose(grid.numpy(), case["grid_j"], atol=1e-6, rtol=0)


def _assert_same_decode(out_t, out_j, case):
    for q in (0, 1):
        bits_t, ok_t = out_t[f"bits{q}"].numpy(), out_t[f"crc_ok{q}"].numpy()
        np.testing.assert_array_equal(bits_t, np.asarray(out_j[f"bits{q}"]))
        np.testing.assert_array_equal(ok_t, np.asarray(out_j[f"crc_ok{q}"]))
        assert ok_t.all()
        np.testing.assert_array_equal(bits_t, case[f"tb{q}"])


@pytest.mark.parametrize("tm,pmi", CASES)
def test_mimo_decode_known_channel_matches(tm, pmi):
    case = _mimo_case(tm, pmi)
    h = np.broadcast_to(HMAT[None, :, :, None, None], (2, 2, 2, 14, 300)).astype(np.complex64)
    out_j = jpm.decode(case["jcfg"], jnp.asarray(case["rx"]), h=jnp.asarray(h),
                       noise_var=0.01, n_iter=4)
    out_t = pdsch_mimo.decode(case["cfg"], _t(case["rx"]), h=_t(h), noise_var=0.01,
                              n_iter=4)
    _assert_same_decode(out_t, out_j, case)


@pytest.mark.parametrize("tm,pmi", [("tm3", 0), ("tm4", 2)])
def test_mimo_decode_with_chest_matches(tm, pmi):
    case = _mimo_case(tm, pmi)
    out_j = jpm.decode(case["jcfg"], jnp.asarray(case["rx"]), n_iter=4)
    out_t = pdsch_mimo.decode(case["cfg"], _t(case["rx"]), n_iter=4)
    _assert_same_decode(out_t, out_j, case)
    _close(out_t["h"], out_j["h"])
    _close(out_t["noise_var"], out_j["noise_var"])


def test_mimo_config_conversion():
    jcfg = _mimo_cfg("tm3", 0)
    cfg = convert.pdsch_config_from_dict(dataclasses.asdict(jcfg))
    assert isinstance(cfg, pdsch_mimo.PdschMimoConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for c, jc in zip(cfg.cw, jcfg.cw):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        np.testing.assert_array_equal(c.scramble_seq, jc.scramble_seq)
    assert cfg.cw[0].plan == cfg.cw[1].plan  # the decode folds both codewords


# --- 2/4-port transmit diversity (TM2) ----------------------------------------


def test_alamouti_decode_2x1():
    rng = np.random.default_rng(12)
    y, h0, h1 = (_c(rng, 3, 80) for _ in range(3))
    nv = np.float32(0.05)
    want = jeq.alamouti_decode_2x1(*map(jnp.asarray, (y, h0, h1)), nv)
    got = equalizer.alamouti_decode_2x1(_t(y), _t(h0), _t(h1), float(nv))
    for g, w in zip(got, want):
        _close(g, w)


def test_sfbc_fstd_decode_4x1():
    rng = np.random.default_rng(13)
    y, h = _c(rng, 3, 80), _c(rng, 3, 4, 80)
    nv = (rng.random(3) * 0.1 + 0.01).astype(np.float32)
    want = jeq.sfbc_fstd_decode_4x1(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv))
    got = equalizer.sfbc_fstd_decode_4x1(_t(y), _t(h), _t(nv))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("cell", [CELL2, CELL4], ids=["2port", "4port"])
def test_tm2_encode_decode_matches(cell):
    jcfg = jpdsch.PdschConfig(cell=cell, rnti=0x1234, subframe=4, mod=MOD, tbs=TBS)
    cfg = convert.pdsch_config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(cell.nof_ports)
    bits = rng.integers(0, 2, (2, TBS)).astype(np.int8)
    grid_j = np.asarray(jpdsch.add_crs(jcfg, jpdsch.encode(jcfg, jnp.asarray(bits))))
    grid_t = pdsch.add_crs(cfg, pdsch.encode(cfg, bits, device="cpu"))
    assert grid_t.shape == (2, cell.nof_ports, 14, 300)
    np.testing.assert_allclose(grid_t.numpy(), grid_j, atol=1e-6, rtol=0)
    gains = _c(rng, cell.nof_ports) / 2
    rx = _noisy(rng, np.einsum("p,bpsk->bsk", gains, grid_j), 0.02)
    out_j = jpdsch.decode(jcfg, jnp.asarray(rx), n_iter=4)
    out_t = pdsch.decode(cfg, _t(rx), n_iter=4)
    np.testing.assert_array_equal(out_t["bits"].numpy(), np.asarray(out_j["bits"]))
    np.testing.assert_array_equal(out_t["crc_ok"].numpy(), np.asarray(out_j["crc_ok"]))
    assert out_t["crc_ok"].all()
    np.testing.assert_array_equal(out_t["bits"].numpy(), bits)
    _close(out_t["h"], out_j["h"])
    _close(out_t["noise_var"], out_j["noise_var"])


def test_mimo_encode_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    cfg = convert.pdsch_config_from_dict(dataclasses.asdict(_mimo_cfg("tm4", 2)))
    tb = np.zeros((1, TBS), np.int8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdsch_mimo.encode(cfg, tb, tb)
