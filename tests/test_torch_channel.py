"""Port parity: the channel emulator — ``channel/fading`` (EPA/EVA/ETU Jakes
taps, frequency response, per-symbol grid fading) and
``channel/impairments`` (delay sweep, high-speed-train Doppler, periodic
RLF) — against the JAX package on the same inputs, with the ``convert``
functions that carry their configs across.

Inputs come from numpy with a seed and go to both packages as arrays.  The
times include the system air's symbol times at TTI 500 (t = 0.5 s), where
the float32 phases are largest.  Tolerance: atol 1e-5 on every complex64
output (both packages evaluate the same float32 phases; the exponentials,
FFTs and cumulative sums of two libraries differ in the last bits).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.channel import fading as j_fad
from srsran_4g_tpu.channel import impairments as j_imp
from srsran_4g_tpu.ops import ofdm as j_ofdm
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.channel import fading, impairments

torch.set_num_threads(2)

TOL = dict(rtol=0, atol=1e-5)
PROFILES = (("epa", 5.0), ("eva", 70.0), ("etu", 300.0))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _axes(nof_prb: int, tti: int):
    """The system air's fading axes: symbol start times (s) of TTI ``tti``
    and each subcarrier's frequency in cycles/sample (lte_air.py)."""
    cfg = j_ofdm.OfdmConfig(nof_prb=nof_prb)
    n = cfg.symbol_sz
    offs = j_ofdm._symbol_offsets(cfg) / (cfg.sf_len / 1e-3) * 1e-3
    bins = j_ofdm._sc_to_bin(cfg).astype(np.int64)
    sc_f = (np.where(bins >= n // 2, bins - n, bins) / n).astype(np.float32)
    t = (np.float32(tti * 1e-3) + offs.astype(np.float32)).astype(np.float32)
    return t, sc_f


def _cfgs(profile: str, doppler: float, srate: float):
    d = dict(profile=profile, doppler_hz=doppler, srate_hz=srate)
    jc = j_fad.FadingConfig(**d)
    return jc, convert.fading_config_from_dict(dataclasses.asdict(jc))


@pytest.mark.parametrize("profile,doppler", PROFILES)
def test_fading_taps_and_response_match_jax(profile, doppler):
    jc, tc = _cfgs(profile, doppler, 15.36e6)  # 75 PRB's rate: every tap fractional
    assert tc == fading.FadingConfig(profile, doppler, 15.36e6)
    t = np.concatenate([np.linspace(0.0, 0.01, 7), _axes(75, 500)[0]]).astype(np.float32)
    for seed in (3, 14):
        want = _np(j_fad.tap_gains(jc, seed, jnp.asarray(t)))
        got = fading.tap_gains(tc, seed, torch.as_tensor(t))
        assert got.dtype == torch.complex64 and got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, **TOL)
    _, sc_f = _axes(75, 500)
    want = _np(j_fad.freq_response(jc, 14, jnp.asarray(t), jnp.asarray(sc_f)))
    got = fading.freq_response(tc, 14, torch.as_tensor(t), torch.as_tensor(sc_f))
    assert got.shape == (len(t), len(sc_f)) == want.shape
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("profile,doppler", PROFILES)
def test_fading_apply_grid_matches_jax(profile, doppler):
    """The air's per-subframe fading at 6 PRB, TTI 500, on a batch of two
    random grids: the faded grids and H."""
    jc, tc = _cfgs(profile, doppler, 1.92e6)
    t, sc_f = _axes(6, 500)
    rng = np.random.default_rng(9)
    grid = (rng.standard_normal((2, 14, 72))
            + 1j * rng.standard_normal((2, 14, 72))).astype(np.complex64)
    jg, jh = j_fad.apply_grid(jc, 15, jnp.asarray(grid), t, sc_f)
    tg, th = fading.apply_grid(tc, 15, torch.as_tensor(grid), t, sc_f)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    np.testing.assert_allclose(_np(tg), _np(jg), **TOL)


def test_delay_sweep_matches_jax():
    d = dict(min_samples=0.5, max_samples=6.25, period_s=0.2, srate_hz=1.92e6)
    jc = j_imp.DelayConfig(**d)
    tc = convert.delay_config_from_dict(dataclasses.asdict(jc))
    t = np.linspace(0.0, 0.5, 41).astype(np.float32)
    np.testing.assert_allclose(_np(impairments.delay_at(tc, torch.as_tensor(t))),
                               _np(j_imp.delay_at(jc, jnp.asarray(t))), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 1920)) + 1j * rng.standard_normal((3, 1920))).astype(np.complex64)
    delays = _np(j_imp.delay_at(jc, jnp.asarray([0.013, 0.101, 0.377], jnp.float32)))
    want = _np(j_imp.apply_delay(jnp.asarray(x), jnp.asarray(delays)))
    got = impairments.apply_delay(torch.as_tensor(x), torch.as_tensor(delays.copy()))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("fd,t0", [(750.0, 0.0), (750.0, 3.6), (1340.0, 0.5)])
def test_hst_doppler_matches_jax(fd, t0):
    jc = j_imp.HstConfig(fd_hz=fd)
    tc = convert.hst_config_from_dict(dataclasses.asdict(jc))
    t = np.linspace(0.0, 7.2, 97).astype(np.float32)
    np.testing.assert_allclose(_np(impairments.hst_doppler_at(tc, torch.as_tensor(t))),
                               _np(j_imp.hst_doppler_at(jc, jnp.asarray(t))),
                               rtol=1e-5, atol=1e-3)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 1920)) + 1j * rng.standard_normal((2, 1920))).astype(np.complex64)
    want = _np(j_imp.apply_hst(jc, jnp.asarray(x), t0, 1.92e6))
    got = impairments.apply_hst(tc, torch.as_tensor(x), t0, 1.92e6)
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_rlf_gate_matches_jax():
    jc = j_imp.RlfConfig(t_on_ms=1.0, t_off_ms=0.5)
    tc = convert.rlf_config_from_dict(dataclasses.asdict(jc))
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 5760)) + 1j * rng.standard_normal((2, 5760))).astype(np.complex64)
    for t0 in (0.0, 0.3, 7.25):
        want = _np(j_imp.apply_rlf(jc, jnp.asarray(x), t0, 1.92e6))
        got = _np(impairments.apply_rlf(tc, torch.as_tensor(x), t0, 1.92e6))
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, **TOL)
        assert 0 < (got[0] == 0).mean() < 1
