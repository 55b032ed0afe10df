"""Port parity: ``models/pusch_nr`` (the NR PUSCH and UCI on PUSCH) and its
``convert`` functions against the JAX package on the same numpy inputs, on
the 24 PRB carrier and the points of tests/test_nr_phy.py.

Noise is a numpy array added to the same transmitted grid on both sides.
Tolerances: coded grids within rtol 1e-4 / atol 1e-3; the UCI plan, decoded
data bits, CRC flags, ACK and CSI bits identical.  The JAX LDPC encoder
costs ~3 CPU-s to compile a shape, so the JAX encoders run at three points
(QPSK, 64QAM, and UCI at o_ack 2 / o_csi 8) and the other points decode the
port's grid, held equal to JAX's at those three; the JAX decoders run at
every point.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import grid_nr as j_grid
from srsran_4g_tpu.models import pusch_nr as j_pusch
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import pusch_nr

torch.set_num_threads(2)

_FAST = dict(xla_cpu_use_fusion_emitters=False, xla_cpu_parallel_codegen_split_count=1)
_jit_enc = functools.partial(jax.jit, compiler_options=dict(_FAST,
                                                            xla_backend_optimization_level=0))
_jit_dec = functools.partial(jax.jit, compiler_options=_FAST)
TOL = dict(rtol=1e-4, atol=1e-3)
CAR = j_grid.NrCarrierConfig(nof_prb=24, pci=1)


def _noise(rng, shape, snr_db):
    nv = 10 ** (-snr_db / 10)
    return (np.sqrt(nv / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _cfgs(uci=None, **kw):
    """The same config in both packages, the port's through ``convert``."""
    if uci is None:
        j = j_pusch.PuschNrConfig(carrier=CAR, rnti=0x4601, slot=5, **kw)
    else:
        j = j_pusch.PuschNrUciConfig(carrier=CAR, rnti=0x4601, slot=5,
                                     uci=j_pusch.NrUciCfg(**uci), **kw)
    t = convert.pusch_nr_config_from_dict(dataclasses.asdict(j))
    assert type(t).__name__ == type(j).__name__
    return j, t


@pytest.mark.parametrize("mod,tbs,snr_db", [("qpsk", 1800, 8.0), ("64qam", 8456, 20.0)])
def test_pusch_nr_encode_decode(mod, tbs, snr_db):
    jcfg, cfg = _cfgs(mod=mod, tbs=tbs, rb_start=2, nof_rb=20)
    assert (cfg.nof_re, cfg.g_bits, dataclasses.asdict(cfg.seg)) == (
        jcfg.nof_re, jcfg.g_bits, dataclasses.asdict(jcfg.seg))
    rng = np.random.default_rng(tbs)
    bits = rng.integers(0, 2, (2, tbs)).astype(np.int8)
    tx = np.asarray(_jit_enc(functools.partial(j_pusch.encode, jcfg))(bits))
    np.testing.assert_allclose(pusch_nr.encode(cfg, torch.as_tensor(bits)).numpy(), tx, **TOL)
    rx = tx + _noise(rng, tx.shape, snr_db)
    want = _jit_dec(functools.partial(j_pusch.decode, jcfg, n_iter=8))(rx)
    got = pusch_nr.decode(cfg, torch.as_tensor(rx), n_iter=8)
    np.testing.assert_array_equal(got["bits"].numpy(), np.asarray(want["bits"]))
    np.testing.assert_array_equal(got["crc_ok"].numpy(), np.asarray(want["crc_ok"]))
    np.testing.assert_allclose(got["noise_var"].numpy(), np.asarray(want["noise_var"]), **TOL)
    assert got["crc_ok"].all() and (got["bits"].numpy() == bits).all()


def test_uci_plan_matches():
    for mod, tbs in (("16qam", 4224), ("qpsk", 2088), ("256qam", 20000)):
        for o_ack, o_csi in ((1, 0), (2, 8), (4, 16), (0, 11), (2, 20), (13, 40)):
            jcfg, cfg = _cfgs(mod=mod, tbs=tbs, uci=dict(o_ack=o_ack, o_csi=o_csi))
            for got, want in zip(pusch_nr._uci_plan(cfg), j_pusch._uci_plan(jcfg)):
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("o_ack,o_csi", [(1, 0), (2, 8), (4, 16), (0, 11)])
def test_uci_on_pusch_nr(o_ack, o_csi):
    """ACK (punctured) + CSI (rate-matched) on PUSCH at 14 dB, 16QAM."""
    jcfg, cfg = _cfgs(mod="16qam", tbs=4224, uci=dict(o_ack=o_ack, o_csi=o_csi))
    rng = np.random.default_rng(o_ack * 31 + o_csi)
    tb = rng.integers(0, 2, (3, cfg.tbs)).astype(np.int8)
    ack = rng.integers(0, 2, (3, o_ack)).astype(np.int8) if o_ack else None
    csi = rng.integers(0, 2, (3, o_csi)).astype(np.int8) if o_csi else None
    tx = pusch_nr.encode_uci(cfg, torch.as_tensor(tb), ack, csi).numpy()
    if (o_ack, o_csi) == (2, 8):
        want_tx = _jit_enc(functools.partial(j_pusch.encode_uci, jcfg))(tb, ack, csi)
        np.testing.assert_allclose(tx, np.asarray(want_tx), **TOL)
    rx = tx + _noise(rng, tx.shape, 14.0)
    want = _jit_dec(functools.partial(j_pusch.decode_uci, jcfg, n_iter=8))(rx)
    got = pusch_nr.decode_uci(cfg, torch.as_tensor(rx), n_iter=8)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["crc_ok"].all() and (got["bits"].numpy() == tb).all()
    if o_ack:
        np.testing.assert_array_equal(got["ack_bits"].numpy(), ack)
    if o_csi:
        np.testing.assert_array_equal(got["csi_bits"].numpy(), csi)


def test_uci_on_pusch_data_survives_unknown_ack():
    """A receiver that does not expect the ACK decodes the data all the same
    (ACK punctures, 38.212): the plain decoders of both packages on the
    port's UCI grid."""
    _, cfg_tx = _cfgs(mod="qpsk", tbs=2088, uci=dict(o_ack=2, o_csi=0))
    jcfg, cfg = _cfgs(mod="qpsk", tbs=2088)
    rng = np.random.default_rng(3)
    tb = rng.integers(0, 2, (2, 2088)).astype(np.int8)
    ack = rng.integers(0, 2, (2, 2)).astype(np.int8)
    tx = pusch_nr.encode_uci(cfg_tx, torch.as_tensor(tb), ack).numpy()
    rx = tx + _noise(rng, tx.shape, 10.0)
    want = _jit_dec(functools.partial(j_pusch.decode, jcfg, n_iter=8))(rx)
    got = pusch_nr.decode(cfg, torch.as_tensor(rx), n_iter=8)
    np.testing.assert_array_equal(got["bits"].numpy(), np.asarray(want["bits"]))
    np.testing.assert_array_equal(got["crc_ok"].numpy(), np.asarray(want["crc_ok"]))
    assert got["crc_ok"].all()
