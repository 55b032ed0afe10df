"""Port parity: NR CORESET#0 / SIB1 and CSI-RS — ``models/coreset0`` and
``models/csi_nr`` — against the JAX package on the same numpy inputs.

The slots come from ``chip_smoke.nr_sib_captures`` (the SI-RNTI DCI 1_0 on a
Type0 candidate and the SIB1 PDSCH it grants, from the port's encoders) on a
52 PRB carrier at 15 kHz: CORESET#0 index 6 (48 PRB x 1 symbol, the
reference capture's geometry) and index 1 (24 PRB x 2 symbols).  The JAX
side runs its host loops eagerly with its polar DCI decode and its LDPC
decode jitted, the rest under ``jax.jit`` with the fast-compile options.
Tolerances: bits, CRC flags, candidates, TBS and CQIs identical; grids and
metrics within rtol 1e-4 / atol 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from srsran_4g_tpu.models import coreset0 as j_c0
from srsran_4g_tpu.models import csi_nr as j_csi
from srsran_4g_tpu.models import grid_nr as j_grid
from srsran_4g_tpu.models import sch_nr as j_sch_nr
from srsran_4g_tpu.ops import polar_3gpp as j_polar
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import coreset0 as C0, csi_nr, dci_nr, grid_nr

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-3)
CPU = torch.device("cpu")
FAST = dict(xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
            xla_cpu_parallel_codegen_split_count=1)
PRB, SYMBOL_SZ, PCI, FC = 52, 1024, 500, 368500 * 5e3
SSB_HZ = 368410 * 5e3 - (FC - PRB * 6 * 15e3)   # the reference capture's ARFCNs


def _jit_when_eager(fn, options=FAST, **static):
    """fn under jax.jit when called eagerly; inside another jit, fn itself."""
    jitted = jax.jit(fn, compiler_options=options, **static)

    def call(*args, **kw):
        traced = any(isinstance(a, jax.core.Tracer) for a in args)
        return (fn if traced else jitted)(*args, **kw)
    return call


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_decoders():
    """The JAX receivers' polar DCI decode and LDPC decode under jax.jit (the
    LDPC at the default options but fusion emitters, as
    tests/test_torch_nr_pdsch.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_polar, "dci_decode", _jit_when_eager(j_polar.dci_decode,
                                                          static_argnums=(1, 2)))
        mp.setattr(j_sch_nr, "decode", _jit_when_eager(
            j_sch_nr.decode, dict(xla_cpu_use_fusion_emitters=False), static_argnums=(0,),
            static_argnames=("n_iter",)))
        yield


@functools.lru_cache(maxsize=None)
def _captures(idx: int):
    """Two slots (slot 0) of CORESET#0 ``idx`` + SIB1 at 10 dB: the DCI at L =
    4 and 8."""
    cs = C0.coreset_zero(PCI, SSB_HZ, idx)
    a = dci_nr.DciNr10(n_rb=cs.nof_prb).nof_bits
    x, payload, sent, sib1 = chip_smoke.nr_sib_captures(
        CPU, torch.Generator().manual_seed(idx), np.random.default_rng(idx), cs, a, nof_prb=PRB,
        symbol_sz=SYMBOL_SZ, pci=PCI, batch=2, snr_db=10.0, mcs=4, fc_hz=FC, levels=(4, 8))
    return cs, a, x, payload, sent, sib1


def test_coreset_zero_and_candidates():
    for idx in (0, 1, 6, 8, 13, 14):
        for off in (0.0, SSB_HZ, 9.54e6, 20e6):
            got = C0.coreset_zero(PCI, off, idx)
            assert got == convert.coreset0_from_dict(vars(j_c0.coreset_zero(PCI, off, idx)))
    with pytest.raises(ValueError):
        C0.coreset_zero(PCI, SSB_HZ, 15)
    assert C0.coreset_zero(PCI, SSB_HZ, 6) == C0.Coreset0(48, 1, 1, PCI)
    for nof_prb, dur, shift, inter in ((48, 1, 500, True), (24, 2, 7, True), (96, 2, 3, True),
                                       (48, 3, 0, False)):
        cs = C0.Coreset0(nof_prb, dur, 1, shift, inter)
        jcs = j_c0.Coreset0(nof_prb, dur, 1, shift, inter)
        n_cce = nof_prb * dur // 6
        for l_agg, ncce in C0.css_candidates(n_cce):
            assert C0.interleaved_candidate_rbs(cs, ncce, l_agg) == \
                j_c0.interleaved_candidate_rbs(jcs, ncce, l_agg)
    for n in range(1, 49):
        assert C0.type0_candidates(n) == j_c0.type0_candidates(n)
        assert C0.css_candidates(n) == j_c0.css_candidates(n)
    for ld in range(3, 15):
        for add in (0, 1, 2, 3):
            assert C0.dmrs_positions_type_a(ld, add) == j_c0.dmrs_positions_type_a(ld, add)


@pytest.mark.parametrize("fc_hz", [0.0, FC], ids=["no fc", "fc"])
def test_nr_slot_grid(fc_hz):
    rng = np.random.default_rng(7)
    slot_len = 14 * SYMBOL_SZ + 2 * 80 + 12 * 72
    x = (rng.standard_normal(slot_len) + 1j * rng.standard_normal(slot_len)).astype(np.complex64)
    for slot in (0, 5):
        want = np.asarray(j_c0.nr_slot_grid(x, PRB, SYMBOL_SZ, fc_hz=fc_hz, slot=slot))
        got = C0.nr_slot_grid(torch.as_tensor(x), PRB, SYMBOL_SZ, fc_hz=fc_hz, slot=slot)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    batch = C0.nr_slot_grid(torch.as_tensor(np.stack([x, x[::-1].copy()])), PRB, SYMBOL_SZ,
                            fc_hz=fc_hz)
    np.testing.assert_allclose(batch[1].numpy(), np.asarray(j_c0.nr_slot_grid(
        x[::-1].copy(), PRB, SYMBOL_SZ, fc_hz=fc_hz))[0], **TOL)


@pytest.mark.parametrize("idx", [6, 1])
def test_blind_decode_type0(idx):
    """CORESET#0 of 48 PRB x 1 symbol (index 6) and of 24 PRB x 2 symbols
    (index 1) from samples, each capture's DCI found at its candidate (the
    first passing in JAX's order) with its bits; an unsent RNTI finds
    nothing."""
    cs, a, x, payload, sent, _ = _captures(idx)
    jcs = j_c0.Coreset0(**vars(cs))
    grid = C0.nr_slot_grid(x, PRB, SYMBOL_SZ, fc_hz=FC)
    batch = C0.blind_decode_type0_batch(grid, PCI, 0, cs, 0xFFFF, a)
    assert bool(batch["found"].all()) and torch.equal(batch["bits"].to(torch.int8), payload)
    for i in range(2):
        jgrid = j_c0.nr_slot_grid(x[i].numpy(), PRB, SYMBOL_SZ, fc_hz=FC)
        np.testing.assert_allclose(grid[i:i + 1].numpy(), np.asarray(jgrid), **TOL)
        want = j_c0.blind_decode_type0(jgrid, PCI, 0, jcs, 0xFFFF, a)
        got = C0.blind_decode_type0(grid[i:i + 1], PCI, 0, cs, 0xFFFF, a)
        assert (got["l_agg"], got["ncce"]) == (want["l_agg"], want["ncce"]) == sent[i]
        np.testing.assert_array_equal(got["bits"], np.asarray(want["bits"]))
        assert batch["candidates"][int(batch["index"][i])] == sent[i]
    assert j_c0.blind_decode_type0(jgrid, PCI, 0, jcs, 0x1234, a) is None
    assert C0.blind_decode_type0(grid[1:], PCI, 0, cs, 0x1234, a) is None
    assert not bool(C0.blind_decode_type0_batch(grid, PCI, 0, cs, 0x1234, a)["found"].any())


def test_decode_pdsch_common():
    """The SIB1 PDSCH the DCI grants (all 48 PRB of CORESET#0 index 6, time
    row 0, MCS 4) from the first capture, the grant read from its DCI."""
    cs, _, x, payload, _, sib1 = _captures(6)
    bits = payload[0].numpy()
    rb = dci_nr._riv_bits(cs.nof_prb)
    riv, time_assign, mcs = (int("".join(map(str, bits[lo:lo + w])), 2)
                             for lo, w in ((0, rb), (rb, 4), (rb + 5, 5)))
    grid = C0.nr_slot_grid(x[:1], PRB, SYMBOL_SZ, fc_hz=FC)
    want = j_c0.decode_pdsch_common(jnp.asarray(grid.numpy()), PCI, 0, 0xFFFF, cs.offset_rb,
                                    riv, cs.nof_prb, time_assign, mcs)
    got = C0.decode_pdsch_common(grid, PCI, 0, 0xFFFF, cs.offset_rb, riv, cs.nof_prb,
                                 time_assign, mcs)
    for k in ("tbs", "rb", "syms", "mod"):
        assert got[k] == want[k]
    assert got["rb"] == (0, 48) and got["syms"] == (2, 12)
    assert bool(got["crc_ok"][0]) == want["crc_ok"] is True
    np.testing.assert_array_equal(got["bits"][0].numpy(), want["bits"])
    np.testing.assert_array_equal(got["bits"][0].numpy(), sib1[0].numpy())


def test_csi_rs_measure_and_report():
    """tests/test_nr_sa_sync_csi.py's shapes: 24 PRB, PCI 11, slot 2, 18 dB
    through a gain of 0.8, then a faded one at 0 dB; the config crosses with
    ``convert.csi_rs_config_from_dict``."""
    import dataclasses

    rng = np.random.default_rng(0)
    jcfg = j_csi.CsiRsConfig(carrier=j_grid.NrCarrierConfig(nof_prb=24, pci=11), slot=2)
    cfg = convert.csi_rs_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg == csi_nr.CsiRsConfig(carrier=grid_nr.NrCarrierConfig(nof_prb=24, pci=11), slot=2)
    np.testing.assert_array_equal(cfg.re_indices, jcfg.re_indices)
    g = csi_nr.put_csi_rs(cfg, torch.zeros((2, 14, 288), dtype=torch.complex64)).numpy()
    np.testing.assert_allclose(g, np.asarray(j_csi.put_csi_rs(
        jcfg, jnp.zeros((2, 14, 288), jnp.complex64))), **TOL)
    h = 0.8 * np.exp(1j * 0.3)
    for x in (g * h + _noise(rng, g.shape, 10 ** -1.8 * 0.64),
              g * 0.01 + _noise(rng, g.shape, 1.0)):
        want = jax.jit(functools.partial(j_csi.measure, jcfg), compiler_options=FAST)(
            jnp.asarray(x))
        got = csi_nr.measure(cfg, torch.as_tensor(x))
        for k in ("rsrp", "noise_var", "sinr_db"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
        rep, jrep = csi_nr.generate_report(got["sinr_db"]), j_csi.generate_report(want["sinr_db"])
        for k in ("cqi", "ri", "pmi"):
            np.testing.assert_array_equal(rep[k].numpy(), np.asarray(jrep[k]))
    assert (np.abs(got["sinr_db"].numpy()) < 40).all()


def _noise(rng, shape, nv):
    return (np.sqrt(nv / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)
