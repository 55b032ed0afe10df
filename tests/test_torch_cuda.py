"""The port on the card: each CUDA half-iteration kernel (sweep at radix 2
and 4, emit) against its plain torch version (atol 1e-3, f32 with the same
arithmetic), map_fused at radix 2 and 4 equal to its plain version,
map_windowed and map_v3 equal to their plain version and to each other, the
bf16 kernels (map_fused16, map_windowed16) equal to their plain versions,
turbo_decode at windows of 512 and 6144 under TURBO_KERNEL v9, bf16, v7 and
v8 equal to the CPU decode, map_fused16 in the turbo BER sweep's waterfall
(tools/ber_sweep at K = 6144, 0.5 dB) equal to its plain version, every probe
kernel
(ops/cuda/probes.py) against its plain version (f32 atol 1e-3, bf16 equal),
and the PDSCH, TM4 2x2, DL-from-samples, control-channel, PUSCH (with UCI)
and PMCH receivers, the NR PDSCH and the DCI polar decoder and the PRACH
detector on CUDA against the same on the CPU (identical ids, bits, flags,
delays and crc_ok), the NR PDSCH at 273 PRB / 256QAM, the fading channel's
100 PRB response against the CPU's (atol 1e-5), and the system path
(``tools.run_lte`` at 100 PRB with two UEs) held to the criteria of
``tests/test_run_lte.py::_run`` with the turbo kernels launched, and the
three-process deployment (``tools.three_process``) at 25 PRB held to the
criteria of ``tests/test_three_process_e2e.py``; the NR SA system path
(``tools.run_nr``) at 273 PRB held to the criteria of
``tests/test_run_nr.py`` with no turbo kernel launched, and the PDCCH-NR
blind search over a 273 PRB CORESET (one batched polar decode a level)
equal on the card and the CPU bit for bit; the 20 MHz V2X TM4 receiver
(``models/sl_rx``) over 8 data subframes, an NB-IoT batch of 64 and the
CORESET#0 + SIB1 receiver at 106 PRB on the card equal to the CPU (the
sidelink and SIB1 captures from ``chip_smoke.py``'s transmitters); the
measuring tools (``tools.profile_components``, ``turbo_kernel_bench``'s half
mode on three routes, ``trace_bench``, ``dp_evidence``, ``scaling_bench`` at
dp 1 and 2 over Gloo) at reduced batches.

Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test needs an NVIDIA GPU and skips without one.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from srsran_4g_tpu_torch.channel import awgn, fading
from srsran_4g_tpu_torch.models import (chest, dci_nr, enb_dl, grid, grid_nr, pbch, pcfich,
                                        pdcch, pdcch_nr, pdsch, pdsch_mimo, pdsch_nr, phich, pmch,
                                        prach, pusch, uci, ue_dl)
from srsran_4g_tpu_torch.ops import polar_3gpp, turbo
from srsran_4g_tpu_torch.ops.cuda import probes, turbo_map
from srsran_4g_tpu_torch.tools import (ber_sweep, dp_evidence, multichip, profile_components,
                                       run_lte, run_nr, scaling_bench, three_process,
                                       trace_bench, turbo_kernel_bench)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, b, k, l, t):
    gen = torch.Generator(device=device).manual_seed(k + t)
    lsa, lp = (torch.randn((b, k), generator=gen, device=device) * 3 for _ in range(2))
    ts, tp = (torch.randn((b, 3), generator=gen, device=device) for _ in range(2))
    return turbo._windowed_inputs(lsa, lp, ts, tp, l, t)[:4] + (t, l, b, k // l)


# also the default route's L ≡ 2 (mod 4) window at 100 PRB MCS 23 (K = 5696,
# L = 178), a window of 512, and the full recursion at K = 6144
WINDOWED_SHAPES = [(8, 5824, 208, 32), (8, 424, 106, 32), (4, 512, 64, 31), (2, 40, 40, 0),
                   (8, 5696, 178, 32), (4, 1024, 512, 32), (2, 6144, 6144, 0)]


@pytest.mark.parametrize("b,k,l,t", WINDOWED_SHAPES)
def test_kernel_matches_plain(cuda_device, b, k, l, t):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.launches["map_windowed"]
    got = turbo_map.map_windowed(*args)
    torch.cuda.synchronize()
    assert turbo_map.launches["map_windowed"] == before + 1
    want = turbo_map.map_windowed_ref(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


# also chip_smoke.py's shapes: a ragged last tile (N = 84), one window
# (W = 1), L/4 odd (L = 188), L = 512 and L = K = 6144 (8 lanes a block)
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (4, 512, 64, 16), (3, 5824, 208, 32),
                                     (3, 40, 40, 32), (2, 6016, 188, 32), (4, 1024, 512, 32),
                                     (2, 6144, 6144, 32)])
def test_map_fused_matches_plain(cuda_device, b, k, l, t, radix):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.launches["map_fused"]
    got = turbo_map.map_fused(*args, radix=radix)
    torch.cuda.synchronize()
    assert turbo_map.launches["map_fused"] == before + 1
    want = turbo_map.map_fused_ref(*args, radix=radix)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (8, 424, 106, 32), (4, 512, 64, 16)])
def test_sweep_and_emit_match_plain(cuda_device, b, k, l, t, radix):
    args = _inputs(cuda_device, b, k, l, t)
    before = (turbo_map.launches["sweep"], turbo_map.launches["emit"])
    stores = turbo_map.sweep(*args, radix=radix)
    n = args[0].shape[1]
    g2 = [x[t:t + l].view(l // 2, 2, n) for x in args[:2]]
    got = turbo_map.emit(*g2, *stores)
    torch.cuda.synchronize()
    assert (turbo_map.launches["sweep"], turbo_map.launches["emit"]) == (
        before[0] + 1, before[1] + 1)
    for g, w in zip(stores, turbo_map.sweep_ref(*args, radix=radix)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=1e-3, rtol=0)
    want = turbo_map.emit_ref(*g2, *stores)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=0)


# also the small shape of chip_smoke.py, five tiles (N = 160), a ragged last
# tile (N = 84), one window (W = 1), L/4 odd (L = 188), L = 512 (32 lanes a
# block, above 48 KB), L = K = 6144 (8 lanes a block), and the windows of the
# uplink's PUSCH (K = 5952, L = 192) and the PMCH (K = 5888, L = 184)
@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (4, 512, 64, 16), (64, 512, 64, 16),
                                     (5, 6144, 192, 32), (3, 5824, 208, 32), (3, 40, 40, 32),
                                     (2, 6016, 188, 32), (4, 1024, 512, 32),
                                     (2, 6144, 6144, 32), (12, 5952, 192, 32),
                                     (8, 5888, 184, 32)])
def test_map_fused16_equals_plain(cuda_device, b, k, l, t):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.launches["map_fused16"]
    got = turbo_map.map_fused16(*args)
    torch.cuda.synchronize()
    assert turbo_map.launches["map_fused16"] == before + 1
    want = turbo_map.map_fused16_ref(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


# also L = 178 (100 PRB MCS 23), 512, and the full recursion at K = 6144
@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (8, 424, 106, 32),
                                     (4, 512, 64, 31), (2, 40, 40, 0), (8, 5696, 178, 32),
                                     (4, 1024, 512, 32), (2, 6144, 6144, 0)])
def test_map_windowed16_equals_plain(cuda_device, b, k, l, t):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.launches["map_windowed16"]
    got = turbo_map.map_windowed16(*args)
    torch.cuda.synchronize()
    assert turbo_map.launches["map_windowed16"] == before + 1
    want = turbo_map.map_windowed16_ref(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (3, 424, 106, 31), (3, 40, 40, 0),
                                     (8, 5696, 178, 32), (4, 1024, 512, 32),
                                     (2, 6144, 6144, 0)])
def test_map_v3_matches_plain_and_turbo_map(cuda_device, b, k, l, t):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.launches["map_v3"]
    got = turbo_map.map_v3(*args)
    torch.cuda.synchronize()
    assert turbo_map.launches["map_v3"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), turbo_map.map_windowed(*args).cpu().numpy())
    want = turbo_map.map_v3_ref(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


# windows above 320: 512 (L = 512) and 6144 (L = K, the narrowest tiles),
# under the default route (v9, map_fused16) and the routes of the other
# shared-memory kernels (bf16: map_windowed16, v7 and v8: map_fused), against
# the same decode on the CPU (the plain version); each launches only its
# route's kernel, once a half-iteration
TURBO_KERNELS = {"v9": "map_fused16", "bf16": "map_windowed16", "v7": "map_fused",
                 "v8": "map_fused"}


@pytest.mark.parametrize("kernel", list(TURBO_KERNELS))
@pytest.mark.parametrize("window", [512, 6144])
def test_turbo_decode_wide_windows_match_cpu(cuda_device, window, kernel, monkeypatch):
    monkeypatch.setenv("TURBO_KERNEL", kernel)
    rng = np.random.default_rng(window)
    bits = rng.integers(0, 2, size=(2, 6144)).astype(np.int8)
    d = turbo.turbo_encode(torch.as_tensor(bits)).numpy().astype(np.float32)
    llr = (2 * d - 1) * 2 + rng.standard_normal(d.shape).astype(np.float32)
    turbo_map.launches.clear()
    h_g, a_g = turbo.turbo_decode(torch.as_tensor(llr, device=cuda_device), n_iter=2,
                                  window=window)
    torch.cuda.synchronize()
    assert dict(turbo_map.launches) == {TURBO_KERNELS[kernel]: 4}
    h_c, a_c = turbo.turbo_decode(torch.as_tensor(llr), n_iter=2, window=window)
    np.testing.assert_array_equal(a_g.cpu().numpy(), a_c.numpy())
    np.testing.assert_array_equal(h_g.cpu().numpy(), bits)


def test_ber_sweep_waterfall_kernel_matches_plain(cuda_device, monkeypatch):
    """tools/ber_sweep at K = 6144, 64 frames, 0.5 dB (in the waterfall,
    every half-iteration run): map_fused16 launched 2 x iters times, and the
    hard bits and APP LLRs identical to the same decode on the card with
    map_fused16_ref in its place."""
    monkeypatch.delenv("TURBO_KERNEL", raising=False)
    seen = []
    turbo_map.launches.clear()
    (row,) = ber_sweep.sweep(6144, 64, 5, [0.5], cuda_device,
                             on_point=lambda r, dt, llr, hard, app: seen.append((llr, hard, app)))
    assert dict(turbo_map.launches) == {"map_fused16": 10}
    assert 0 < row["fer"] < 1, row
    ((llr, hard, app),) = seen
    monkeypatch.setattr(turbo_map, "map_fused16", turbo_map.map_fused16_ref)
    h_p, a_p = ber_sweep.decode_point(llr, 5)
    assert torch.equal(h_p, hard) and torch.equal(a_p, app)


def test_dl_from_samples_on_card_matches_cpu(cuda_device):
    cell = grid.CellConfig(nof_prb=25, cell_id=124, cfi=1)
    cfg = pdsch.PdschConfig(cell=cell, rnti=0x1234, subframe=5, mod="16qam", tbs=2000)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, size=(3, cfg.tbs)).astype(np.int8)
    sf = enb_dl.subframe_to_samples(cell, enb_dl.assemble_subframe(cfg, bits)).cpu().numpy()
    n = sf.shape[-1] + 900
    cap = np.zeros((3, n), np.complex64)
    for i, lead in enumerate((17, 300, 499)):
        cap[i, lead:lead + sf.shape[-1]] = sf[i] * np.exp(1j * 0.7 * i)
    cap *= np.exp(2j * np.pi * 0.04 * np.arange(n) / 512).astype(np.complex64)
    cap += ((rng.standard_normal(cap.shape) + 1j * rng.standard_normal(cap.shape))
            * np.sqrt(5e-4)).astype(np.complex64)
    found = {d: ue_dl.cell_search(torch.as_tensor(cap, device=d), 25)
             for d in (cuda_device, torch.device("cpu"))}
    for key in ("cell_id", "phase", "offset"):
        np.testing.assert_array_equal(found[cuda_device][key].cpu().numpy(),
                                      found[torch.device("cpu")][key].numpy(), err_msg=key)
    np.testing.assert_array_equal(found[cuda_device]["cell_id"].cpu().numpy(), 124)
    np.testing.assert_array_equal(found[cuda_device]["offset"].cpu().numpy(),
                                  np.array([17, 300, 499]) + 3328)  # + symbol 6's body at 25 PRB
    out = pdsch.decode(cfg, found[cuda_device]["grid"], n_iter=4)
    assert bool(out["crc_ok"].all())
    np.testing.assert_array_equal(out["bits"].cpu().numpy(), bits)


def test_tm4_on_card_matches_cpu(cuda_device):
    cfg = pdsch_mimo.PdschMimoConfig(
        cell=grid.CellConfig(nof_prb=25, cell_id=123, cfi=1, nof_ports=2), rnti=0x1234,
        subframe=4, mod0="16qam", tbs0=2000, mod1="16qam", tbs1=2000, tm="tm4", pmi=2)
    rng = np.random.default_rng(2)
    tb0, tb1 = (rng.integers(0, 2, size=(4, 2000)).astype(np.int8) for _ in range(2))
    tx = pdsch.add_crs(cfg.cw[0], pdsch_mimo.encode(cfg, tb0, tb1))
    hmat = torch.tensor([[1.0 + 0.1j, 0.3 - 0.4j], [0.2 + 0.4j, -0.9 + 0.2j]],
                        dtype=torch.complex64, device=cuda_device)
    rx = awgn.awgn(torch.einsum("rt,btsk->brsk", hmat, tx), awgn.snr_to_noise_var(20.0),
                   torch.Generator(device=cuda_device).manual_seed(3))
    before = turbo_map.launches["map_fused16"]  # the default route, v9
    out_gpu = pdsch_mimo.decode(cfg, rx, n_iter=4)
    assert turbo_map.launches["map_fused16"] > before
    out_cpu = pdsch_mimo.decode(cfg, rx.cpu(), n_iter=4)
    for key in ("bits0", "bits1", "crc_ok0", "crc_ok1"):
        np.testing.assert_array_equal(out_gpu[key].cpu().numpy(), out_cpu[key].numpy(),
                                      err_msg=key)
    np.testing.assert_array_equal(out_gpu["bits0"].cpu().numpy(), tb0)
    np.testing.assert_array_equal(out_gpu["bits1"].cpu().numpy(), tb1)


def test_pdsch_on_card_matches_cpu(cuda_device):
    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=25, cell_id=123, cfi=1),
                            rnti=0x1234, subframe=4, mod="16qam", tbs=2000)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(4, cfg.tbs)).astype(np.int8)
    tx = pdsch.add_crs(cfg, pdsch.encode(cfg, bits))
    assert tx.device.type == "cuda"
    rx = awgn.awgn(tx, awgn.snr_to_noise_var(8.0),
                   torch.Generator(device=cuda_device).manual_seed(1))
    before = turbo_map.launches["map_fused16"]  # the default route, v9
    out_gpu = pdsch.decode(cfg, rx, n_iter=4)
    assert turbo_map.launches["map_fused16"] > before
    out_cpu = pdsch.decode(cfg, rx.cpu(), n_iter=4)
    np.testing.assert_array_equal(out_gpu["bits"].cpu().numpy(), out_cpu["bits"].numpy())
    np.testing.assert_array_equal(out_gpu["crc_ok"].cpu().numpy(), out_cpu["crc_ok"].numpy())
    np.testing.assert_array_equal(out_gpu["bits"].cpu().numpy(), bits)


NR_CAR = dict(nof_prb=273, pci=500, scs_khz=30)


def test_nr_pdsch_256qam_273prb_on_card(cuda_device):
    """100 MHz, 256QAM, TBS 213,176 (26 LDPC code blocks of K = 8448) at
    30 dB: every CRC passes and every bit is the sent one."""
    cfg = pdsch_nr.PdschNrConfig(carrier=grid_nr.NrCarrierConfig(**NR_CAR), rnti=0x4601,
                                 slot=7, mod="256qam", tbs=213176)
    assert (cfg.g_bits, cfg.seg.C, cfg.seg.K) == (288288, 26, 8448)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    bits = torch.randint(0, 2, (2, cfg.tbs), generator=gen, device=cuda_device,
                         dtype=torch.int8)
    rx = awgn.awgn(pdsch_nr.encode(cfg, bits), awgn.snr_to_noise_var(30.0), gen)
    out = pdsch_nr.decode(cfg, rx)
    assert out["bits"].device.type == "cuda" and bool(out["crc_ok"].all())
    assert torch.equal(out["bits"], bits)


def test_nr_pdsch_and_dci_on_card_match_cpu(cuda_device):
    """One 273 PRB slot near the 64QAM waterfall and a batch of noisy DCIs:
    the card and the CPU decide the same bits and CRC flags."""
    cfg = pdsch_nr.PdschNrConfig(carrier=grid_nr.NrCarrierConfig(**NR_CAR), rnti=0x4601,
                                 slot=7, mod="64qam", tbs=159880)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    bits = torch.randint(0, 2, (1, cfg.tbs), generator=gen, device=cuda_device,
                         dtype=torch.int8)
    rx = awgn.awgn(pdsch_nr.encode(cfg, bits), awgn.snr_to_noise_var(17.0), gen)
    out_gpu = pdsch_nr.decode(cfg, rx)
    out_cpu = pdsch_nr.decode(cfg, rx.cpu())
    assert torch.equal(out_gpu["bits"].cpu(), out_cpu["bits"])
    assert torch.equal(out_gpu["crc_ok"].cpu(), out_cpu["crc_ok"])
    payload = torch.randint(0, 2, (32, 44), generator=gen, device=cuda_device, dtype=torch.int8)
    coded = polar_3gpp.dci_encode(payload, 108, 0x4601).float()
    llr = (2 * coded - 1) * 2 + torch.randn(coded.shape, generator=gen, device=cuda_device) * 2
    dci_gpu = polar_3gpp.dci_decode(llr, 44, 0x4601)
    dci_cpu = polar_3gpp.dci_decode(llr.cpu(), 44, 0x4601)
    assert torch.equal(dci_gpu["bits"].cpu(), dci_cpu["bits"])
    assert torch.equal(dci_gpu["crc_ok"].cpu(), dci_cpu["crc_ok"])


def test_pusch_with_uci_on_card_matches_cpu(cuda_device):
    """chip_smoke.py's PUSCH: 100 PRB, PRB 2-97, 64QAM, TBS 71112, 2 ACK and
    20 CQI bits; two subframes at 20 dB."""
    cell = grid.CellConfig(nof_prb=100, cell_id=301, cfi=1)
    cfg = pusch.PuschConfig(cell=cell, rnti=0x46, subframe=2, mod="64qam", tbs=71112,
                            prb_start=2, nof_prb_alloc=96, uci=uci.UciCfg(o_ack=2, o_cqi=20))
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (2, cfg.tbs)).astype(np.int8)
    ack, cqi = (torch.as_tensor(rng.integers(0, 2, (2, o)).astype(np.int8), device=cuda_device)
                for o in (2, 20))
    tx = pusch.encode(cfg, bits, cqi_bits=cqi, ack_bits=ack)
    assert tx.device.type == "cuda"
    rx = awgn.awgn(tx, awgn.snr_to_noise_var(20.0), torch.Generator(device=cuda_device)
                   .manual_seed(3))
    before = turbo_map.launches["map_fused16"]
    out_gpu = pusch.decode(cfg, rx)
    assert turbo_map.launches["map_fused16"] > before
    out_cpu = pusch.decode(cfg, rx.cpu())
    for key in ("bits", "crc_ok", "ack_bits", "cqi_bits", "cqi_ok"):
        np.testing.assert_array_equal(out_gpu[key].cpu().numpy(), out_cpu[key].numpy(),
                                      err_msg=key)
    np.testing.assert_array_equal(out_gpu["bits"].cpu().numpy(), bits)
    np.testing.assert_array_equal(out_gpu["ack_bits"].cpu().numpy(), ack.cpu().numpy())
    np.testing.assert_array_equal(out_gpu["cqi_bits"].cpu().numpy(), cqi.cpu().numpy())


def test_pmch_on_card_matches_cpu(cuda_device):
    """chip_smoke.py's PMCH: 100 PRB, 64QAM, TBS 46888; two subframes at 20 dB."""
    cfg = pmch.PmchConfig(nof_prb=100, area_id=1, subframe=1, mod="64qam", tbs=46888)
    bits = np.random.default_rng(4).integers(0, 2, (2, cfg.tbs)).astype(np.int8)
    rx = awgn.awgn(pmch.encode(cfg, bits), awgn.snr_to_noise_var(20.0),
                   torch.Generator(device=cuda_device).manual_seed(5))
    before = turbo_map.launches["map_fused16"]
    out_gpu = pmch.decode(cfg, rx)
    assert turbo_map.launches["map_fused16"] > before
    out_cpu = pmch.decode(cfg, rx.cpu())
    np.testing.assert_array_equal(out_gpu["bits"].cpu().numpy(), out_cpu["bits"].numpy())
    np.testing.assert_array_equal(out_gpu["crc_ok"].cpu().numpy(), out_cpu["crc_ok"].numpy())
    np.testing.assert_array_equal(out_gpu["bits"].cpu().numpy(), bits)


def test_prach_detect_on_card_matches_cpu(cuda_device):
    cfg = prach.PrachConfig(symbol_sz=2048, root_seq_index=128, zero_corr_zone=5)
    rng = np.random.default_rng(6)
    n = cfg.cp_len + cfg.seq_len_samples
    caps = ((rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n)))
            * np.sqrt(1e-3 / cfg.seq_len_samples / 2)).astype(np.complex64)
    for row, (idx, delay) in enumerate(((3, 0), (33, 120), (63, 600))):
        caps[row, delay:] += prach.generate(cfg, idx, device="cpu").numpy()[:n - delay]
    out_gpu = prach.detect(cfg, torch.as_tensor(caps, device=cuda_device))
    out_cpu = prach.detect(cfg, torch.as_tensor(caps))
    np.testing.assert_array_equal(out_gpu["detected"].cpu().numpy(), out_cpu["detected"].numpy())
    np.testing.assert_array_equal(out_gpu["delay_samples"].cpu().numpy(),
                                  out_cpu["delay_samples"].numpy())
    np.testing.assert_allclose(out_gpu["power"].cpu().numpy(), out_cpu["power"].numpy(),
                               rtol=1e-4, atol=1e-6)
    assert [np.flatnonzero(r).tolist() for r in out_cpu["detected"].numpy()] == \
        [[3], [33], [63], []]


# --- the probe kernels ---------------------------------------------------------


def _rand(device, shape, seed, scale=4.0, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


# (variant, lanes, store rows): every body at 5,000 lanes and the probe's 56
# rows; full and astore also at one lane and at 20,001 (a ragged last tile;
# astore's 264 tiles of 76 lanes in 2 rounds of its 132 blocks on an H100),
# astore at rings of 1 and 72 rows (72 steps: no wrap)
PROBE2_CASES = ([(v, 5000, 56) for v in probes.PROBE2_VARIANTS]
                + [(v, n, 56) for v in ("full", "astore") for n in (1, 20001)]
                + [("astore", 5000, rows) for rows in (1, 72)])


@pytest.mark.parametrize("variant,n,store_rows", PROBE2_CASES, ids=[
    v if (n, rows) == (5000, 56) else f"{v}-n{n}-rows{rows}" for v, n, rows in PROBE2_CASES])
def test_probe2_kernels_match_plain(cuda_device, variant, n, store_rows):
    steps = 72
    g, a0 = _rand(cuda_device, (176, n), 1), _rand(cuda_device, (8, n), 2, 1.0)
    before = turbo_map.launches[f"probe2_{variant}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = probes.probe2(variant, g, g, a0, steps, 112, store_rows)
    torch.cuda.synchronize()
    assert turbo_map.launches[f"probe2_{variant}"] == before + 1
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if (variant, n) == ("astore", 20001) and sms <= 132:
        assert probes.probe2_launched[variant].rounds > 1
    # the output is the launch's one allocation: astore's ring is on chip
    assert torch.cuda.max_memory_allocated() - base <= 4 * got.numel() + 1024
    want = probes.probe2_ref(variant, g, g, a0, steps, 112, store_rows)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), atol=1e-3, rtol=0)
    if variant in ("full", "astore"):
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())


@pytest.mark.parametrize("threads,smem", [(128, 0), (1024, 0),
                                          (128, probes.ONE_BLOCK_PER_SM_SMEM)])
def test_probe_empty_matches_plain(cuda_device, threads, smem):
    x = _rand(cuda_device, (16, 86528), 3)
    got = probes.probe_empty([x, x], 8, threads=threads, smem=smem)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[0].cpu().numpy(), x[0].cpu().numpy())


# (f32 lanes, bf16 lanes a group, steps, bf16 arrays starting 2 bytes
# into their storage): the probes' step count, h even (two lanes a thread);
# then thousands of tiles, ragged, with a step count that is not a multiple
# of the gamma ring and odd (the middle step read by both chains at once), h
# odd (one lane a thread) and h even; last h even on contiguous views that
# are not 4-byte aligned (one lane a thread, 16-bit reads)
@pytest.mark.parametrize("n,h,steps,shifted", [(6000, 3000, 72, False),
                                               (70001, 35001, 11, False),
                                               (300, 70000, 11, False),
                                               (300, 3000, 72, True)])
def test_probe6_kernels_match_plain(cuda_device, n, h, steps, shifted):
    g2s, g2p = _rand(cuda_device, (steps, 2, n), 4), _rand(cuda_device, (steps, 2, n), 5)
    a0, b0 = _rand(cuda_device, (8, n), 6, 1.0), _rand(cuda_device, (8, n), 7, 1.0)
    for got, want in zip(probes.probe6_full(g2s, g2p, a0, b0),
                         probes.probe6_full_ref(g2s, g2p, a0, b0)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=0)
    for got, want in zip(probes.probe6_skel(a0, b0, steps),
                         probes.probe6_skel_ref(a0, b0, steps)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=0)
    g16 = [_rand(cuda_device, (steps, 2, 2, h), 8 + i, dtype=torch.bfloat16) for i in range(2)]
    m16 = [_rand(cuda_device, (16, h), 10 + i, 1.0, torch.bfloat16) for i in range(2)]
    if shifted:
        def shift(x):
            buf = x.new_empty(x.numel() + 1)
            buf[1:].copy_(x.flatten())
            return buf[1:].view(x.shape)

        g16, m16 = [shift(x) for x in g16], [shift(x) for x in m16]
        assert all(x.is_contiguous() and x.data_ptr() % 4 for x in g16 + m16)
    for got, want in zip(probes.probe6_bf16(*g16, *m16), probes.probe6_bf16_ref(*g16, *m16)):
        np.testing.assert_array_equal(got.float().cpu().numpy(), want.float().cpu().numpy())


# a lane count that is a multiple of the block, then one that is not, at
# iters 1 (the first step from all eight metrics, then one of the pairs) and
# 0 (the start metrics out as they came in)
@pytest.mark.parametrize("n,iters", [(4096, 256), (4100, 1), (4100, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe7_kernels_match_plain(cuda_device, dtype, n, iters):
    g = _rand(cuda_device, (2, n), 12, 0.5, dtype)
    a0 = _rand(cuda_device, (8, n), 13, 1.0, dtype)
    got, want = probes.probe7(g, a0, iters), probes.probe7_ref(g, a0, iters)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=0)
    else:
        np.testing.assert_array_equal(got.float().cpu().numpy(), want.float().cpu().numpy())


def test_control_channels_on_card_match_cpu(cuda_device):
    cell = grid.CellConfig(nof_prb=25, cell_id=301, cfi=2)
    cfg = pdsch.PdschConfig(cell=cell, rnti=0x3D, subframe=0, mod="16qam", tbs=1000)
    rng = np.random.default_rng(9)
    b, n_bits = 3, 25
    tb = rng.integers(0, 2, (b, cfg.tbs)).astype(np.int8)
    mib = rng.integers(0, 2, (b, 24)).astype(np.int8)
    d = rng.integers(0, 2, (b, n_bits)).astype(np.int8)
    ack = rng.integers(0, 2, b).astype(np.int8)
    g = enb_dl.assemble_subframe(cfg, tb, mib_bits=mib, dcis=[(d, 0x3D, 2, 4)])
    g = phich.put_into_grid(cell, g, phich.encode(cell, torch.as_tensor(ack, device=g.device),
                                                  1, 6, 0), 1)
    rx = awgn.awgn(g, awgn.snr_to_noise_var(20.0),
                   torch.Generator(device=cuda_device).manual_seed(5))
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        r = rx.to(dev)
        est = chest.estimate(chest.ChestConfig(cell=cell), r, 0)
        h, nv = est["h"], est["noise_var"]
        m = pbch.decode(cell, r, h, nv)
        bd = pdcch.blind_decode(cell, 2, 0, r, h, nv, rnti=0x3D, dci_len=n_bits)
        outs[dev.type] = dict(cfi=pcfich.decode(cell, r, h, nv, 0)["cfi"], mib=m["mib"],
                              mib_ok=m["crc_ok"], ack=phich.decode(cell, r, h, nv, 1, 6, 0)["ack"],
                              found=bd["found"], dci=bd["dci"], cand=bd["candidate"])
    for key, got in outs["cuda"].items():
        np.testing.assert_array_equal(got.cpu().numpy(), outs["cpu"][key].numpy(), err_msg=key)
    np.testing.assert_array_equal(outs["cuda"]["mib"].cpu().numpy(), mib)
    np.testing.assert_array_equal(outs["cuda"]["dci"].cpu().numpy(), d)
    np.testing.assert_array_equal(outs["cuda"]["ack"].cpu().numpy(), ack)


def test_fading_on_card_matches_cpu(cuda_device):
    cfg = fading.FadingConfig("etu", 300.0, 30.72e6)
    t = torch.linspace(0.5, 0.501, 14, dtype=torch.float32)
    f = torch.arange(-600, 600, dtype=torch.float32) / 2048
    want = fading.freq_response(cfg, 15, t, f)
    got = fading.freq_response(cfg, 15, t.to(cuda_device), f.to(cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_run_lte_100prb_on_card(cuda_device):
    """The system path at 20 MHz with two UEs, on the card: every criterion
    of tests/test_run_lte.py::_run, through the default turbo kernel."""
    turbo_map.launches.clear()
    n_ues, pings = 2, 2
    ok, stats, ues, mme = run_lte.run(n_ttis=360, n_pings=pings, snr_db=30.0, nof_prb=100,
                                      n_ues=n_ues, device=cuda_device)
    for u in ues:
        assert u.sync_state == "camped" and u.acq_pci == 1 and u.acq_sfn >= 0
        assert all(c >= 13 for c in u.cqi_sent[1:]), u.cqi_sent
        assert u.rrc.idle.si_acquired()
    assert len({u.crnti for u in ues}) == n_ues
    assert stats["prach"] == n_ues and stats["pdsch_ko"] == 0 and stats["pusch_ko"] == 0
    assert stats["dl_ping_rx"] == pings * n_ues and stats["ul_ping_rx"] >= pings * n_ues
    assert stats["dci_tx"] >= stats["pdsch_tx"] and stats["phich_ack"] > 0
    assert stats["phich_ack"] + stats["phich_nack"] >= stats["pusch_tx"] - 4
    assert ok, stats
    assert turbo_map.launches["map_fused16"] + turbo_map.launches["map_windowed"] > 0


def test_three_processes_25prb_on_card(cuda_device):
    """The three-process deployment (srsepc, srsenb and srsue as OS
    processes over the IQ bridge, S1AP and GTP-U) at the 25 PRB point of
    tests/test_three_process_e2e.py, on the card: every criterion of that
    test, and the default route's turbo kernels launched in the children."""
    run = three_process.run(three_process.Point(prb=25, ues=1, ttis=360), device="cuda",
                            timeout=600)
    checks = three_process.criteria(run)
    assert all(checks.values()), (checks, run.ue, run.enb, run.epc)
    launched = sum(st["turbo"]["launches"].get(w, 0) for st in (run.enb, *run.ue)
                   for w in ("map_fused16", "map_windowed"))
    assert launched > 0, (run.enb, run.ue)


def test_run_nr_273prb_on_card(cuda_device):
    """The NR SA system path at 100 MHz (273 PRB, 30 kHz) on the card: every
    criterion of tests/test_run_nr.py; NR launches no turbo kernel."""
    turbo_map.launches.clear()
    ok, stats, ue, amf = run_nr.run(n_slots=80, n_pings=2, snr_db=20.0, nof_prb=273,
                                    device=cuda_device)
    assert stats["ssb_found"] == 1 and stats["prach_detected"] == 1
    assert ue.nas.state == "REGISTERED"
    assert stats["pdsch_ko"] == 0 and stats["pusch_ko"] == 0
    assert stats["dl_ping_rx"] == 2 and stats["ul_ping_rx"] == 2
    assert stats["ack_rx"] >= 1
    assert ok, stats
    assert not any(turbo_map.launches.values())


def test_pdcch_nr_blind_search_on_card_matches_cpu(cuda_device):
    """A 273 PRB CORESET (45 CCEs) carrying one DCI at each of L = 1, 2 and 4
    in 16 captures at 5 dB: the batched search on the card equals the CPU's
    in found, bits and level, for the sent RNTI and one that was not sent
    (which finds nothing)."""
    cfg = pdcch_nr.CoresetConfig(nof_prb=273, pci=500, slot=2)
    a = dci_nr.DciNr10(n_rb=273).nof_bits
    gen = torch.Generator().manual_seed(13)
    dmrs_k = torch.as_tensor(pdcch_nr._re_maps(273)[1])
    rows = []
    for i in range(16):
        bits = torch.randint(0, 2, (a,), generator=gen, dtype=torch.int8)
        enc = [pdcch_nr.encode(cfg, bits, 0x4601, aggregation=agg, start_cce=start,
                               device="cpu") for agg, start in ((1, 3 + i), (2, 20), (4, 36))]
        row = sum(enc)
        row[:, dmrs_k] = enc[0][:, dmrs_k]   # one DMRS, not three
        rows.append(row)
    rx = awgn.awgn(torch.cat(rows), 10 ** -0.5, generator=gen)
    for rnti in (0x4601, 0x4602):
        want = pdcch_nr.blind_decode(cfg, rx, rnti=rnti, dci_len=a)
        got = pdcch_nr.blind_decode(cfg, rx.to(cuda_device), rnti=rnti, dci_len=a)
        for key in ("found", "bits", "agg"):
            assert torch.equal(got[key].cpu(), want[key]), key
        if rnti == 0x4601:
            assert bool(want["found"].all())
        else:
            assert not bool(want["found"].any())


def test_sidelink_tm4_100prb_on_card_matches_cpu(cuda_device):
    """chip_smoke.py's 20 MHz V2X TM4 stream cut to 8 data subframes (two
    48-PRB vehicles or one 96-PRB vehicle a subframe, MCS 22): the SLSS sync
    and ``decode_capture`` on the card equal the CPU's, every SCI and TB
    decoded, both default-route turbo kernels launched."""
    from srsran_4g_tpu_torch.models import sidelink as SL, sl_rx

    pool = sl_rx.SlPool.default(100, 4)
    mib = SL.MibSl(sl_bandwidth=100, direct_frame_number=517, in_coverage=False).pack(v2x=True)
    x, sent = chip_smoke.sl_tm4_stream(torch.device("cpu"), torch.Generator().manual_seed(14),
                                       np.random.default_rng(14), pool, 2048,
                                       chip_smoke.sl_schedule(8, 22), 335, mib, 1234, 30.0)
    sync = SL.psbch_sync_decode(x.to(cuda_device), 100, 2048, 335, tm=4)
    assert sync["crc_ok"] and np.array_equal(sync["mib"], mib) and sync["offset"] == 1234 - 8
    assert sync["offset"] == SL.psbch_sync_decode(x, 100, 2048, 335, tm=4)["offset"]
    turbo_map.launches.clear()
    got = sl_rx.decode_capture(x.to(cuda_device), 100, 4, 2048, pool, file_offset=sync["offset"],
                               max_subframes=9)
    assert turbo_map.launches["map_fused16"] > 0 and turbo_map.launches["map_windowed"] > 0
    want = sl_rx.decode_capture(x, 100, 4, 2048, pool, file_offset=sync["offset"],
                                max_subframes=9)
    assert got["events"] == want["events"]
    assert got["num_decoded_sci"] == got["num_decoded_tb"] == len(sent) == 14


def test_nbiot_batch_on_card_matches_cpu(cuda_device):
    """A batch of 64 NB-IoT grids on the card and the CPU: the NSSS search,
    the r14 NPBCH at frame 35, the NPDCCH search and the NPDSCH at i_tbs 12,
    i_sf 2 (16 dB) give identical cell ids, bits and CRC flags."""
    from srsran_4g_tpu_torch.models import nbiot, nbiot_data as nd

    gen = torch.Generator().manual_seed(64)
    cpu = torch.device("cpu")

    def channel(g, snr_db):
        return chip_smoke.nb_channel(cpu, gen, g, snr_db)

    zeros = torch.zeros((64, 14, 12), dtype=torch.complex64)
    mib = torch.randint(0, 2, (64, nbiot.MIB_NB_LEN), generator=gen, dtype=torch.int8)
    dci = torch.as_tensor(np.tile(nd.DciN1(i_sf=1, mcs=4, ndi=1).pack(), (64, 1)))
    cfg = nd.NpdschConfig(n_id_ncell=17, rnti=0x4604, i_tbs=12, i_sf=2, sfn=8)
    tb = torch.randint(0, 2, (64, cfg.tbs), generator=gen, dtype=torch.int8)
    rx = dict(nsss=channel(nbiot.put_nsss(zeros, 257), 6.0),
              npbch=channel(nbiot.npbch_encode(17, mib, frame_idx=35, is_r14=True), 8.0),
              npdcch=channel(nd.npdcch_encode(dci, 0x4604, 17, 1, ncce=1, l_agg=1), 8.0),
              npdsch=channel(nd.npdsch_encode(cfg, tb), 16.0))
    runs = dict(nsss=lambda x: nbiot.nsss_detect(x),
                npbch=lambda x: nbiot.npbch_decode(17, x, block_idx=4, nf=35, is_r14=True),
                npdcch=lambda x: nd.npdcch_blind_decode(x, 0x4604, 17, 1),
                npdsch=lambda x: nd.npdsch_decode(cfg, x))
    for name, run in runs.items():
        got, want = run(rx[name].to(cuda_device)), run(rx[name])
        for k, v in want.items():
            if v.dtype.is_floating_point:
                np.testing.assert_allclose(got[k].cpu().numpy(), v.numpy(), rtol=1e-4, atol=1e-3)
            else:
                assert torch.equal(got[k].cpu(), v), (name, k)
    assert bool(want["crc_ok"].all()) and torch.equal(want["bits"], tb)


def test_sib1_106prb_on_card_matches_cpu(cuda_device):
    """chip_smoke.py's CORESET#0 + SIB1 captures (106 PRB, index 13, 10 dB),
    three of them (L = 4, 8, 16): the slot grids, the Type0 search and the
    SIB1 decode on the card equal the CPU's."""
    from srsran_4g_tpu_torch.models import coreset0 as C0

    cs = C0.coreset_zero(chip_smoke.NR_SIB_PCI, chip_smoke.NR_SIB_SSB_HZ,
                         chip_smoke.NR_SIB_CORESET0)
    a = dci_nr.DciNr10(n_rb=cs.nof_prb).nof_bits
    x, payload, sent, sib1 = chip_smoke.nr_sib_captures(
        torch.device("cpu"), torch.Generator().manual_seed(106), np.random.default_rng(106), cs,
        a, batch=3)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        grid = C0.nr_slot_grid(x.to(dev), 106, 2048, fc_hz=chip_smoke.NR_SIB_FC_HZ)
        hit = C0.blind_decode_type0_batch(grid, chip_smoke.NR_SIB_PCI, 0, cs, 0xFFFF, a)
        riv_bits = dci_nr._riv_bits(cs.nof_prb)
        riv = int("".join(map(str, hit["bits"][0, :riv_bits].tolist())), 2)
        res = C0.decode_pdsch_common(grid, chip_smoke.NR_SIB_PCI, 0, 0xFFFF, cs.offset_rb, riv,
                                     cs.nof_prb, 0, chip_smoke.NR_SIB_MCS)
        out.append((grid.cpu(), hit, res))
    (g1, h1, r1), (g0, h0, r0) = out
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-4, atol=1e-3)
    for k in ("found", "index", "bits"):
        assert torch.equal(h1[k].cpu(), h0[k]), k
    assert [h0["candidates"][int(i)] for i in h0["index"]] == sent
    assert torch.equal(r1["bits"].cpu(), r0["bits"]) and torch.equal(r1["crc_ok"].cpu(),
                                                                     r0["crc_ok"])
    assert bool(r0["crc_ok"].all()) and torch.equal(r0["bits"], sib1)


def _multichip_checks(results):
    bad = multichip.check(results)
    for r in results:
        for name, c in r["configs"].items():
            if not c["launches"].get("map_fused16"):
                bad.append(f"rank {r['rank']} {name}: no map_fused16 launch")
    return bad


def test_multichip_nccl_one_rank_6prb(cuda_device):
    """tools/multichip at one rank over NCCL, mesh (1, 1), the tiny (6 PRB)
    configuration on the card: a finite BLER, map_fused16 launched."""
    res = multichip.launch(1, device="cuda", backend="nccl", configs="tiny", timeout=300)
    assert _multichip_checks(res) == []
    assert res[0]["backend"] == "nccl" and res[0]["mesh"] == {"dp": 1, "sp": 1}


def test_multichip_gloo_two_ranks_one_card(cuda_device):
    """Two ranks over Gloo on one card, mesh (1, 2): the bench configuration
    (100 PRB 64QAM TBS 75376) bit-exact with every CRC, each rank decoding
    half of the code-block lanes, and the sharded FIR and OFDM demod within
    atol 1e-4 of the dense ones."""
    res = multichip.launch(2, device="cuda", backend="gloo", configs="tiny,bench",
                           measure=True, timeout=300)
    assert _multichip_checks(res) == []
    for r in res:
        bench = r["configs"]["bench"]
        assert bench["metrics"]["bit_errors"] == 0 and bench["metrics"]["bler"] == 0
        assert bench["cb_lanes"] == 7  # 13 lanes padded to 14, over 2 ranks
        assert max(bench["stream_check"].values()) <= multichip.STREAM_ATOL


def test_profile_components_on_card(cuda_device, monkeypatch):
    """tools/profile_components at 16 subframes: the seven lines with host and
    device busy ms, the staged bits equal to pdsch.decode's."""
    monkeypatch.delenv("TURBO_KERNEL", raising=False)
    res = profile_components.run(16, "cuda", out=None)
    assert tuple(res["lines"]) == profile_components.NAMES
    assert all(v["device_busy_ms"] > 0 for v in res["lines"].values())
    assert set(res["stage_span_ms"]) == {"chest", "equalise_demod_descramble", "dlsch_decode"}


@pytest.mark.parametrize("kernel", ["v9", "v4", "v5"])
def test_turbo_kernel_bench_half_on_card(cuda_device, kernel, monkeypatch):
    """tools/turbo_kernel_bench half mode at 64 blocks of K = 5824: the
    half-iteration equal to _map_windowed's, the kernel alone against its
    plain version (max |diff| 0; sweep + emit within 1e-3), device times."""
    monkeypatch.setenv("TURBO_KERNEL", kernel)
    d = turbo_kernel_bench.make_llrs(64, 5824, "cuda")
    res = turbo_kernel_bench.half(d, 208, 32, iters=3)
    assert res["max_abs_err"] <= (0 if kernel != "v5" else chip_smoke.ATOL)
    assert res["kernel_device_ms"] > 0 and res["half_iter_device_ms"] > res["kernel_device_ms"]
    k = 5824
    t1_sys = torch.stack([d[:, 0, k], d[:, 2, k], d[:, 1, k + 1]], -1)
    t1_par = torch.stack([d[:, 1, k], d[:, 0, k + 1], d[:, 2, k + 1]], -1)
    assert torch.equal(res["llr"], turbo._map_windowed(d[:, 0, :k], d[:, 1, :k], t1_sys,
                                                       t1_par, 208, 32))


def test_trace_and_dp_evidence_on_card(cuda_device, tmp_path, monkeypatch):
    """tools/trace_bench (8 subframes, one decode: the trace written, device
    time seen) and tools/dp_evidence (batches 8 and 16, every CRC)."""
    monkeypatch.delenv("TURBO_KERNEL", raising=False)
    tr = trace_bench.run(8, 1, "cuda", str(tmp_path))
    assert (tmp_path / "trace.json").stat().st_size > 0 and tr["profile"]["device_ms"] > 0
    dp = dp_evidence.run([8, 16], 1, 4, 16, "cuda", out=None)
    assert all(r["crc_all_ok"] and r["device_busy_ms"] > 0 for r in dp["batch_sweep"])


def test_scaling_bench_two_ranks_on_card(cuda_device, tmp_path):
    """tools/scaling_bench at dp 1 and 2 over Gloo on one card: BLER 0."""
    res = scaling_bench.run([1, 2], per_dev=2, iters=1, device="cuda", backend="gloo",
                            out=str(tmp_path / "scaling.json"))
    assert [r["bler"] for r in res["rows"]] == [0.0, 0.0]
    assert all(r["step_device_busy_ms"] > 0 for r in res["rows"])
