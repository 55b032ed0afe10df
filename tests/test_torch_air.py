"""Port parity: ``runtime/lte_air.LteAirPhy``, the PHY both nodes of the
system path share, against the JAX package's on the same inputs.

Both airs are built from one dict (``convert.lte_air_phy_from_dict``) at 6
PRB and ``snr_db=200``, where the noise (drawn by each package's own RNG) is
negligible; the JAX side runs through its own jitted ``_fn`` cache.  The
receivers of both packages are fed the same samples (the JAX air's), so
their decisions compare exactly.

- DL: subframe 0 with the MIB, two PHICHs, a PDSCH with its DCI 1A and a
  DCI 0 UL grant, and subframe 5; samples within atol 1e-4.  Cell search,
  the MIB, both PHICHs and the blind search give identical cell ids, MIB
  bits, ACKs, DCI fields, CCEs and PDU bytes; HARQ chase combining over a
  noisy transmission and its retransmission gives soft buffers within LLR
  tolerance and identical outcomes.

The uplink and PRACH are in ``tests/test_torch_air_ul.py``; the 2-port,
faded and TDD airs and the wider cell searches in
``tests/test_torch_air_lanes.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from srsran_4g_tpu.channel import fading as j_fad
from srsran_4g_tpu.models import dci as j_dci
from srsran_4g_tpu.runtime import lte_air as j_air
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import dci as t_dci
from srsran_4g_tpu_torch.runtime import lte_air as t_air

torch.set_num_threads(2)

SAMPLE_TOL = dict(rtol=0, atol=1e-4)
LLR_TOL = dict(rtol=1e-4, atol=1e-3)
RNTI, RNTI_B = 0x46, 0x47


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _airs(**kw):
    """(JAX air, port air) from one dict of constructor arguments.  The JAX
    air's per-call-shape functions are compiled for speed of compiling: each
    runs a few times, so compiling is most of its cost (the same results)."""
    d = {"nof_prb": 6, "snr_db": 200.0, **kw}
    jd = dict(d)
    if d.get("fading") is not None:
        jd["fading"] = j_fad.FadingConfig(**d["fading"])
    j = j_air.LteAirPhy(**jd)

    def fn(k, builder):  # LteAirPhy._fn with the compiler options
        if k not in j._fns:
            j._fns[k] = jax.jit(builder(), compiler_options=dict(
                xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
                xla_cpu_parallel_codegen_split_count=1))
        return j._fns[k]

    j._fn = fn
    return j, convert.lte_air_phy_from_dict(d, device="cpu")


def _fields(d) -> tuple:
    return type(d).__name__, dataclasses.asdict(d)


def _hits(res: dict) -> list:
    """A blind search's hits with every DCI as (format name, fields)."""
    return [{k: _fields(v) if dataclasses.is_dataclass(v) else v for k, v in hit.items()}
            for hit in res["hits"]]


def _pdu(n_bytes: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()


def _dl_items(j, t, sf: int, dci: j_dci.Dci1A, ul: j_dci.Dci0 | None):
    """The same DL items for both airs: a PDSCH + DCI 1A for RNTI (and a
    DCI 0 for it), CCEs from each air's allocator (which must agree)."""
    nof_prb = j.cell.nof_prb
    j_used, t_used = set(), set()
    items = ([], [])
    for d, pack in ((dci, "pack_1a"), (ul, "pack_0")):
        if d is None:
            continue
        alloc = j.cch.alloc(RNTI, j_used, sf=sf)
        assert t.cch.alloc(RNTI, t_used, sf=sf) == alloc and t_used == j_used
        bits = getattr(j_dci, pack)(d, nof_prb)
        np.testing.assert_array_equal(
            getattr(t_dci, pack)(getattr(t_dci, type(d).__name__)(**dataclasses.asdict(d)),
                                 nof_prb), bits)
        if pack == "pack_1a":
            jc = j_air.dci_to_pdsch_cfg(j.cell, RNTI, d, sf)
            tc = t_air.dci_to_pdsch_cfg(t.cell, RNTI, t_dci.Dci1A(**dataclasses.asdict(d)), sf)
            assert (tc.tbs, tc.mod, tc.prb_alloc, tc.rv) == (jc.tbs, jc.mod, jc.prb_alloc, jc.rv)
            pdu = _pdu(jc.tbs // 8, sf)
            items[0].append((jc, pdu, bits, RNTI) + alloc)
            items[1].append((tc, pdu, bits, RNTI) + alloc)
        else:
            items[0].append((None, None, bits, RNTI) + alloc)
            items[1].append((None, None, bits, RNTI) + alloc)
    return items


@pytest.fixture(scope="module")
def siso():
    j, t = _airs()
    assert t.cell == convert._with_cell(dict(cell=dataclasses.asdict(j.cell)))["cell"]
    assert (t.dci_len, t.cch.n_cce, t.nv) == (j.dci_len, j.cch.n_cce, j.nv)
    dci = j_dci.Dci1A(rb_start=1, l_crbs=4, mcs=2, harq_pid=2, ndi=1)
    ul = j_dci.Dci0(rb_start=2, l_crbs=2, mcs=10, ndi=1)
    mib = (np.random.default_rng(5).integers(0, 2, 24).astype(np.int8), 1)
    phich = [(0, 1, 1), (0, 5, 0)]  # 6 PRB: one group, two sequences
    sf0 = _dl_items(j, t, 0, dci, ul)
    sf5 = _dl_items(j, t, 5, dataclasses.replace(dci, rb_start=0, mcs=12, harq_pid=5), None)
    out = {}
    for key, sf, (jit, tit), kw in (("sf0", 0, sf0, dict(phich=phich, mib=mib)),
                                    ("sf5", 5, sf5, {})):
        out[key] = (np.array(j.enb_dl_tx(jit, sf=sf, tti=sf, **kw)),
                    _np(t.enb_dl_tx(tit, sf=sf, tti=sf, **kw)))
    return dict(j=j, t=t, dl=out, mib=mib, phich=phich, pdus={
        k: [it[1] for it in v[0] if it[0] is not None] for k, v in (("sf0", sf0), ("sf5", sf5))})


def test_dl_subframes_match_jax(siso):
    for key, (want, got) in siso["dl"].items():
        assert got.shape == want.shape == (1, siso["t"].ofdm.sf_len), key
        np.testing.assert_allclose(got, want, **SAMPLE_TOL, err_msg=key)
        assert np.abs(want).max() > 0.1


def test_cell_search_mib_phich_match_jax(siso):
    j, t = siso["j"], siso["t"]
    for key, phase in (("sf0", 0), ("sf5", 1)):
        x = siso["dl"][key][0]
        jr, tr = j.ue_cell_search(x), t.ue_cell_search(torch.as_tensor(x))
        assert {k: tr[k] for k in ("found", "cell_id", "phase")} == \
            {k: jr[k] for k in ("found", "cell_id", "phase")} == \
            dict(found=True, cell_id=1, phase=phase)
        np.testing.assert_allclose(tr["peak"], jr["peak"], rtol=1e-4)
    x = siso["dl"]["sf0"][0]
    jm, tm = j.ue_mib_rx(x, 1), t.ue_mib_rx(torch.as_tensor(x), 1)
    np.testing.assert_array_equal(tm["mib"], jm["mib"])
    np.testing.assert_array_equal(tm["mib"], siso["mib"][0])
    assert (tm["n_ports"], tm["block"]) == (jm["n_ports"], jm["block"]) == (1, 1)
    for group, nseq, ack in siso["phich"]:
        assert t.ue_phich_rx(torch.as_tensor(x), group, nseq, sf=0) == \
            j.ue_phich_rx(x, group, nseq, sf=0) == bool(ack)


def test_blind_rx_matches_jax(siso):
    j, t = siso["j"], siso["t"]
    for key, sf in (("sf0", 0), ("sf5", 5)):
        x = siso["dl"][key][0]
        jr = j.ue_dl_rx_multi(x, RNTI, sf=sf, harq_bufs={})
        t_bufs: dict = {}
        tr = t.ue_dl_rx_multi(torch.as_tensor(x), RNTI, sf=sf, harq_bufs=t_bufs)
        assert _hits(tr) == _hits(jr), key
        assert [h.get("pdu") for h in tr["hits"] if "dci" in h] == siso["pdus"][key]
        assert {"dci", "ul_dci"} <= {k for h in tr["hits"] for k in h} or key == "sf5"
        assert set(t_bufs) == {2 if key == "sf0" else 5}
        assert all(e["bufs"] is None for e in t_bufs.values())  # CRC passed


def test_harq_chase_combining_matches_jax(siso, monkeypatch):
    """A transmission and its retransmission (same process, NDI and TBS) at
    a low SNR, noise from numpy: the stored soft buffers agree within LLR
    tolerance and both packages reach the same CRC outcomes (the port on the
    f32 decoder the JAX package runs on the CPU): the first copy fails, the
    combined second passes, and the second alone (no stored buffer) fails."""
    monkeypatch.setenv("TURBO_KERNEL", "v4")
    j, t = siso["j"], siso["t"]
    x = siso["dl"]["sf5"][0]
    rng = np.random.default_rng(11)
    ys = [(x + (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)) * 0.35)
          .astype(np.complex64) for _ in range(2)]
    j_bufs, t_bufs, outcomes = {}, {}, []
    for y, keep in ((ys[0], True), (ys[1], True), (ys[1], False)):
        if not keep:
            j_bufs, t_bufs = {}, {}
        jr = j.ue_dl_rx_multi(y, RNTI, sf=5, harq_bufs=j_bufs)
        tr = t.ue_dl_rx_multi(torch.as_tensor(y), RNTI, sf=5, harq_bufs=t_bufs)
        assert _hits(tr) == _hits(jr)
        jb, tb = j_bufs[5]["bufs"], t_bufs[5]["bufs"]
        assert (jb is None) == (tb is None)
        if jb is not None:
            assert set(tb) == set(jb)
            for cb in jb:
                np.testing.assert_allclose(_np(tb[cb]), np.asarray(jb[cb]), **LLR_TOL)
        outcomes.append(tr["hits"][0]["pdu"] is not None)
    assert outcomes == [False, True, False]
