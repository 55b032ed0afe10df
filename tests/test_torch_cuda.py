"""The port on the card: each CUDA half-iteration kernel (turbo_map,
map_fused at radix 2 and 4, sweep at radix 2 and 4, emit, map_v3) against
its plain torch version (atol 1e-3, f32 with the same arithmetic; map_v3
also equal to turbo_map's LLRs), the bf16 kernels (map_fused16,
map_windowed16) equal to their plain versions, and the PDSCH, TM4 2x2 and
DL-from-samples receivers on CUDA against the same receivers on the CPU
(identical ids, bits and crc_ok).

Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test needs an NVIDIA GPU and skips without one.
"""

import numpy as np
import pytest
import torch

from srsran_4g_tpu_torch.channel import awgn
from srsran_4g_tpu_torch.models import enb_dl, grid, pdsch, pdsch_mimo, ue_dl
from srsran_4g_tpu_torch.ops import turbo
from srsran_4g_tpu_torch.ops.cuda import turbo_map

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


@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (8, 424, 106, 32),
                                     (4, 512, 64, 31), (2, 40, 40, 0)])
def test_kernel_matches_plain(cuda_device, b, k, l, t):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.map_windowed.launches
    got = turbo_map.map_windowed(*args)
    torch.cuda.synchronize()
    assert turbo_map.map_windowed.launches == before + 1
    want = turbo_map.map_windowed_ref(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=0)


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (4, 512, 64, 16)])
def test_map_fused_matches_plain(cuda_device, b, k, l, t, radix):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.map_fused.launches
    got = turbo_map.map_fused(*args, radix=radix)
    torch.cuda.synchronize()
    assert turbo_map.map_fused.launches == before + 1
    want = turbo_map.map_fused_ref(*args, radix=radix)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=0)


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (8, 424, 106, 32), (4, 512, 64, 16)])
def test_sweep_and_emit_match_plain(cuda_device, b, k, l, t, radix):
    args = _inputs(cuda_device, b, k, l, t)
    before = (turbo_map.sweep.launches, turbo_map.emit.launches)
    stores = turbo_map.sweep(*args, radix=radix)
    n = args[0].shape[1]
    g2 = [x[t:t + l].view(l // 2, 2, n) for x in args[:2]]
    got = turbo_map.emit(*g2, *stores)
    torch.cuda.synchronize()
    assert (turbo_map.sweep.launches, turbo_map.emit.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(stores, turbo_map.sweep_ref(*args, radix=radix)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=1e-3, rtol=0)
    want = turbo_map.emit_ref(*g2, *stores)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=0)


@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (4, 512, 64, 16)])
def test_map_fused16_equals_plain(cuda_device, b, k, l, t):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.map_fused16.launches
    got = turbo_map.map_fused16(*args)
    torch.cuda.synchronize()
    assert turbo_map.map_fused16.launches == before + 1
    want = turbo_map.map_fused16_ref(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (8, 424, 106, 32),
                                     (4, 512, 64, 31), (2, 40, 40, 0)])
def test_map_windowed16_equals_plain(cuda_device, b, k, l, t):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.map_windowed16.launches
    got = turbo_map.map_windowed16(*args)
    torch.cuda.synchronize()
    assert turbo_map.map_windowed16.launches == before + 1
    want = turbo_map.map_windowed16_ref(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("b,k,l,t", [(8, 5824, 208, 32), (3, 424, 106, 31), (3, 40, 40, 0)])
def test_map_v3_matches_plain_and_turbo_map(cuda_device, b, k, l, t):
    args = _inputs(cuda_device, b, k, l, t)
    before = turbo_map.map_v3.launches
    got = turbo_map.map_v3(*args)
    torch.cuda.synchronize()
    assert turbo_map.map_v3.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), turbo_map.map_windowed(*args).cpu().numpy())
    want = turbo_map.map_v3_ref(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=0)


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
    before = turbo_map.map_fused16.launches  # the default route, v9
    out_gpu = pdsch_mimo.decode(cfg, rx, n_iter=4)
    assert turbo_map.map_fused16.launches > before
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
    before = turbo_map.map_fused16.launches  # the default route, v9
    out_gpu = pdsch.decode(cfg, rx, n_iter=4)
    assert turbo_map.map_fused16.launches > before
    out_cpu = pdsch.decode(cfg, rx.cpu(), n_iter=4)
    np.testing.assert_array_equal(out_gpu["bits"].cpu().numpy(), out_cpu["bits"].numpy())
    np.testing.assert_array_equal(out_gpu["crc_ok"].cpu().numpy(), out_cpu["crc_ok"].numpy())
    np.testing.assert_array_equal(out_gpu["bits"].cpu().numpy(), bits)
