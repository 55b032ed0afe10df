"""Port parity: the PDSCH encoder and receiver end to end against the JAX
package, at the flagship config (25 PRB, 16QAM, TBS 2000, one K=2048
block) and at a config with two code-block size groups (TBS 6202: one
K=3136 block with 62 fillers and one K=3200 block), plus a HARQ
retransmission that takes the JAX package's soft-buffers through
``srsran_4g_tpu_torch.convert``.

Tolerances: grids within atol 1e-6; bits and crc_ok identical; h within
rtol 1e-4 / atol 1e-5, noise_var and snr_db within rtol 1e-4 / atol 1e-5;
soft-buffers within rtol 1e-4 / atol 1e-3.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import grid as jgrid
from srsran_4g_tpu.models import pdsch as jpdsch
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import pdsch

torch.set_num_threads(2)

# The JAX side runs once per shape, so compiling it is most of its cost:
# compile it for speed of compiling (the same results, sooner).
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
    xla_cpu_parallel_codegen_split_count=1))

EST_TOL = dict(rtol=1e-4, atol=1e-5)
LLR_TOL = dict(rtol=1e-4, atol=1e-3)
CONFIGS = {"flagship": (2000, "16qam"), "two_groups": (6202, "64qam")}
N_ITER = 4


def _jax_cfg(tbs, mod, rv=0):
    return jpdsch.PdschConfig(cell=jgrid.CellConfig(nof_prb=25, cell_id=123, cfi=1),
                              rnti=0x1234, subframe=4, mod=mod, tbs=tbs, rv=rv)


def _noisy(rng, grid, snr_db):
    nv = 10 ** (-snr_db / 10)
    noise = rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape)
    return (grid + noise * np.sqrt(nv / 2)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _case(name):
    """The same TBs through both packages: JAX grid, noisy grid, JAX decode."""
    tbs, mod = CONFIGS[name]
    jcfg = _jax_cfg(tbs, mod)
    rng = np.random.default_rng(tbs)
    bits = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    grid_j = np.asarray(_jit(lambda b: jpdsch.add_crs(jcfg, jpdsch.encode(jcfg, b)))(bits))
    rx = _noisy(rng, grid_j, 15.0)
    out_j = _jit(lambda r: jpdsch.decode(jcfg, r, n_iter=N_ITER))(rx)
    return dict(name=name, jcfg=jcfg,
                cfg=convert.pdsch_config_from_dict(dataclasses.asdict(jcfg)),
                bits=bits, grid_j=grid_j, rx=rx, out_j=out_j)


@pytest.fixture(params=list(CONFIGS))
def case(request):
    return _case(request.param)


def test_encode_grid_matches(case):
    grid_t = pdsch.add_crs(case["cfg"], pdsch.encode(case["cfg"], case["bits"], device="cpu"))
    assert grid_t.dtype == torch.complex64
    np.testing.assert_allclose(grid_t.numpy(), case["grid_j"], atol=1e-6, rtol=0)


def test_decode_matches(case):
    if case["name"] == "two_groups":
        assert len(case["cfg"].plan.groups) == 2 and case["cfg"].plan.segm.F > 0
    out_t = pdsch.decode(case["cfg"], torch.as_tensor(case["rx"]), n_iter=N_ITER)
    out_j = case["out_j"]
    np.testing.assert_array_equal(out_t["bits"].numpy(), np.asarray(out_j["bits"]))
    np.testing.assert_array_equal(out_t["crc_ok"].numpy(), np.asarray(out_j["crc_ok"]))
    assert out_t["crc_ok"].all()
    np.testing.assert_array_equal(out_t["bits"].numpy(), case["bits"])
    for key in ("h", "noise_var", "snr_db"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   **EST_TOL, err_msg=key)
    soft_j = {k: np.asarray(v) for k, v in out_j["softbuffers"].items()}
    soft_t = convert.softbuffers_to_numpy(out_t["softbuffers"])
    assert soft_t.keys() == soft_j.keys()
    for k in soft_j:
        np.testing.assert_allclose(soft_t[k], soft_j[k], **LLR_TOL)


def test_harq_retransmission_from_jax_softbuffers():
    case = _case("flagship")
    tbs, mod = CONFIGS["flagship"]
    jcfg2 = _jax_cfg(tbs, mod, rv=2)
    cfg2 = convert.pdsch_config_from_dict(dataclasses.asdict(jcfg2))
    rng = np.random.default_rng(99)
    # the rv=2 transmission, made by the port's encoder (held to the JAX
    # one above) and fed to both receivers at a low SNR
    grid2 = pdsch.add_crs(cfg2, pdsch.encode(cfg2, case["bits"], device="cpu")).numpy()
    rx2 = _noisy(rng, grid2, 3.0)
    soft_j = case["out_j"]["softbuffers"]
    out_j = _jit(lambda r, sb: jpdsch.decode(jcfg2, r, softbuffers=sb, n_iter=N_ITER))(
        rx2, soft_j)
    soft_t = convert.softbuffers_from_numpy(
        {k: np.asarray(v) for k, v in soft_j.items()}, device="cpu")
    out_t = pdsch.decode(cfg2, torch.as_tensor(rx2), softbuffers=soft_t, n_iter=N_ITER)
    np.testing.assert_array_equal(out_t["bits"].numpy(), np.asarray(out_j["bits"]))
    np.testing.assert_array_equal(out_t["crc_ok"].numpy(), np.asarray(out_j["crc_ok"]))
    assert out_t["crc_ok"].all()
    combined_j = np.asarray(out_j["softbuffers"][0])
    np.testing.assert_allclose(out_t["softbuffers"][0].numpy(), combined_j, **LLR_TOL)


def test_config_conversion():
    jcfg = _jax_cfg(*CONFIGS["two_groups"])
    cfg = convert.pdsch_config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(cfg.re_indices, jcfg.re_indices)
    np.testing.assert_array_equal(cfg.scramble_seq, jcfg.scramble_seq)
    assert ([dataclasses.asdict(g) for g in cfg.plan.groups]
            == [dataclasses.asdict(g) for g in jcfg.plan.groups])
    from srsran_4g_tpu.models.chest import ChestConfig as JChest

    ccfg = convert.pdsch_config_from_dict(
        dataclasses.asdict(JChest(cell=jcfg.cell, smooth_len=5, wiener=True)))
    assert dataclasses.asdict(ccfg) == dataclasses.asdict(
        JChest(cell=jcfg.cell, smooth_len=5, wiener=True))


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    cfg = convert.pdsch_config_from_dict(dataclasses.asdict(_jax_cfg(*CONFIGS["flagship"])))
    bits = np.zeros((1, cfg.tbs), np.int8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdsch.encode(cfg, bits)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdsch.add_crs(cfg, np.zeros((1, 14, 300), np.complex64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.softbuffers_from_numpy({0: np.zeros((1, 3, 2052), np.float32)})

