"""Port parity at the shapes that the JAX package sends to its v1 Pallas
kernel (``map_windowed_pallas``: training length T < 2): the port's one
half-iteration against that kernel in interpret mode, atol 1e-3.

At T = 0 the JAX XLA path ``_map_windowed`` is not a valid oracle: it
slices ``gs_winb[t - 1:]`` to one row and broadcasts a single beta over the
window (ROADMAP Queue 3), so the port is held to the Pallas kernel here.
"""

import jax
import numpy as np
import pytest
import torch

from srsran_4g_tpu.ops import turbo as jturbo
from srsran_4g_tpu_torch.ops import turbo

torch.set_num_threads(2)


@pytest.mark.parametrize("t", [0, 1])
def test_short_training_matches_pallas_v1_interpret(t):
    rng = np.random.default_rng(t)
    b, k, l = 2, 256, 64
    args = [(rng.standard_normal(s) * 3).astype(np.float32)
            for s in [(b, k), (b, k), (b, 3), (b, 3)]]
    # jitted and compiled for speed of compiling: it runs once
    want = np.asarray(jax.jit(
        lambda *a: jturbo._map_windowed_pl(*a, l, t, interpret=True), compiler_options=dict(
            xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
            xla_cpu_parallel_codegen_split_count=1))(*args))
    got = turbo._map_windowed(*map(torch.as_tensor, args), l, t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
