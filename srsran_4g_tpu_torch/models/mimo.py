"""MIMO layer mapping, precoding and detection, TS 36.211 §6.3.3/6.3.4.

Port counterpart of ``srsran_4g_tpu/models/mimo.py``: layer map/demap, TM3
(large-delay CDD) and TM4 (closed-loop) 2×2 spatial multiplexing with
codebook precoding, SFBC mapping, batched MMSE 2×2 detection and PMI
selection as a capacity argmax over the codebook.

Every 2×2 solve is closed form (adjugate and determinant), element-wise
complex torch arithmetic: no linear-algebra library call and no kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# TS 36.211 Table 6.3.4.2.3-1: 2-port codebook (identity excluded for TM4
# rank 2 per spec; index 0 used by TM3)
_CODEBOOK_2TX_R1 = np.array(
    [[1, 1], [1, -1], [1, 1j], [1, -1j]], dtype=np.complex64
) / np.sqrt(2)
_CODEBOOK_2TX_R2 = np.stack(
    [
        np.array([[1, 0], [0, 1]], dtype=np.complex64) / np.sqrt(2),
        np.array([[1, 1], [1, -1]], dtype=np.complex64) / 2.0,
        np.array([[1, 1], [1j, -1j]], dtype=np.complex64) / 2.0,
    ]
)


def _c64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.complex64), device=device)


def cdd_phase(s: int, device) -> torch.Tensor:
    """exp(-jπ i) for the RE counter i = 0..s-1, complex64, with the phase
    π·i rounded to float32 as the JAX package computes it."""
    theta = torch.tensor(-math.pi, dtype=torch.float32, device=device) \
        * torch.arange(s, dtype=torch.float32, device=device)
    return torch.complex(torch.cos(theta), torch.sin(theta))


def layer_map(codewords: list[torch.Tensor], n_layers: int) -> torch.Tensor:
    """Map codeword symbol streams to layers: (..., S) list → (..., L, S/L·cw)."""
    if len(codewords) == 1:
        d = codewords[0]
        s = d.shape[-1]
        if s % n_layers:
            raise ValueError(f"{s} symbols do not split into {n_layers} layers")
        return d.reshape(d.shape[:-1] + (s // n_layers, n_layers)).transpose(-1, -2)
    if len(codewords) != 2 or n_layers != 2:
        raise ValueError("two codewords map onto exactly two layers")
    return torch.stack(codewords, dim=-2)


def layer_demap(layers: torch.Tensor, n_codewords: int) -> list[torch.Tensor]:
    if n_codewords == 1:
        x = layers.transpose(-1, -2)
        return [x.reshape(x.shape[:-2] + (-1,))]
    return [layers[..., 0, :], layers[..., 1, :]]


def precode_2x2(x: torch.Tensor, pmi: int) -> torch.Tensor:
    """(..., 2, S) layers → (..., 2, S) antenna ports, rank-2 codebook."""
    w = _c64(_CODEBOOK_2TX_R2[pmi], x.device)
    return torch.einsum("ij,...js->...is", w, x)


def cdd_precode_2x2(x: torch.Tensor) -> torch.Tensor:
    """TM3 open-loop: codebook 0 + large-delay CDD (per-symbol-index cycling).

    y = W · D(i) · U · x with U the 2x2 DFT and D(i) = diag(1, e^{-jπi}).
    """
    u = _c64(np.array([[1, 1], [1, np.exp(-2j * np.pi / 2)]]) / np.sqrt(2), x.device)
    ux = torch.einsum("ij,...js->...is", u, x)
    ux = torch.stack([ux[..., 0, :], ux[..., 1, :] * cdd_phase(x.shape[-1], x.device)],
                     dim=-2)
    w = _c64(_CODEBOOK_2TX_R2[0], x.device)
    return torch.einsum("ij,...js->...is", w, ux)


def sfbc_encode_2(syms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """SFBC (TM2) transmit mapping for 2 ports, TS 36.211 §6.3.4.3: over each
    RE pair (even k, k+1) port0 = [x0, x1], port1 = [-x1*, x0*], each scaled
    1/sqrt(2).  syms (..., N), N even → (port0, port1), each (..., N)."""
    x0, x1 = syms[..., 0::2], syms[..., 1::2]
    s = math.sqrt(2.0)
    p0 = torch.stack([x0, x1], dim=-1).reshape(syms.shape) / s
    p1 = torch.stack([-x1.conj(), x0.conj()], dim=-1).reshape(syms.shape) / s
    return p0, p1


def scatter_ctrl_syms(grid_tx: torch.Tensor, idx, syms: torch.Tensor,
                      add: bool = False) -> torch.Tensor:
    """Scatter control-channel symbols onto their flat RE indices.

    On a single-port grid (..., nsymb, nre) the symbols go in as they are; on
    a 2-port grid (..., 2, nsymb, nre) they are SFBC-mapped first (the
    reference sends every control channel with TX diversity when
    nof_ports == 2).  Returns a new grid; ``grid_tx`` is not modified.
    """
    g = grid_tx.clone()
    idx = torch.as_tensor(idx, device=g.device)
    flat = g.reshape(g.shape[:-2] + (-1,))  # a view of g
    two_port = g.ndim == syms.ndim + 2 and g.shape[-3] == 2
    if not two_port:
        _scatter(flat, idx, syms, add)
        return g
    p0, p1 = sfbc_encode_2(syms)
    _scatter(flat[..., 0, :], idx, p0, add)
    _scatter(flat[..., 1, :], idx, p1, add)
    return g


def _scatter(flat: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             add: bool) -> None:
    """flat[..., idx] = vals (or += vals, repeated indices summed), in place."""
    if add:
        flat.index_add_(-1, idx, vals.to(flat.dtype))
    else:
        flat[..., idx] = vals.to(flat.dtype)


def mmse_detect_2x2(y: torch.Tensor, h: torch.Tensor, noise_var
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched 2×2 MMSE detection.

    Args:
      y: (..., 2, S) received (2 RX ports).
      h: (..., 2, 2, S) channel h[rx, layer] (already incl. precoding).
      noise_var: scalar or broadcastable.

    Returns:
      (x_hat (..., 2, S) complex64, eff_noise_var (..., 2, S) float32):
      per-layer symbol estimates with ZF-consistent scaling for the soft
      demapper.
    """
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=y.device)
    h00, h01 = h[..., 0, 0, :], h[..., 0, 1, :]
    h10, h11 = h[..., 1, 0, :], h[..., 1, 1, :]
    # G = H^H H + nv I (2x2 hermitian), rhs = H^H y
    g00 = h00.abs() ** 2 + h10.abs() ** 2
    g11 = h01.abs() ** 2 + h11.abs() ** 2
    a = g00 + nv
    d = g11 + nv
    b = h00.conj() * h01 + h10.conj() * h11  # G01
    r0 = h00.conj() * y[..., 0, :] + h10.conj() * y[..., 1, :]
    r1 = h01.conj() * y[..., 0, :] + h11.conj() * y[..., 1, :]
    bb = b.abs() ** 2
    det = torch.clamp(a * d - bb, min=1e-12)
    x0 = (d * r0 - b * r1) / det
    x1 = (a * r1 - b.conj() * r0) / det
    # unbiased scaling: mu = [G^-1 H^H H]_ii, effective noise (1 - mu) / mu
    mu0 = torch.clamp((d * g00 - bb) / det, 1e-6, 1.0 - 1e-6)
    mu1 = torch.clamp((a * g11 - bb) / det, 1e-6, 1.0 - 1e-6)
    xh = torch.stack([x0 / mu0, x1 / mu1], dim=-2).to(torch.complex64)
    env = torch.stack([(1.0 - mu0) / mu0, (1.0 - mu1) / mu1], dim=-2)
    return xh, env.to(torch.float32)


def pmi_select_2tx(h: torch.Tensor, noise_var, rank: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """PMI selection: argmax of post-precoding capacity over the codebook
    (reference precoding.c srsran_pmi_select).

    Args:
      h: (..., n_rx, 2, S) estimated channel (per RE).

    Returns: (pmi (...,) int32, metric (..., n_pmi) float32); rank 2 picks
    from TM4's codebook indices 1..2.
    """
    nv = torch.clamp(torch.as_tensor(noise_var, dtype=torch.float32, device=h.device),
                     min=1e-9)
    metrics = []
    if rank == 1:
        for w in _CODEBOOK_2TX_R1:
            hw = h[..., :, 0, :] * complex(w[0]) + h[..., :, 1, :] * complex(w[1])
            snr = (hw.abs() ** 2).sum(dim=-2) / nv
            metrics.append(torch.log2(1 + snr).mean(dim=-1))
        m = torch.stack(metrics, dim=-1)
        return m.argmax(dim=-1).to(torch.int32), m
    for wi in range(1, 3):  # rank-2 TM4 codebook indices 1..2
        hw = torch.einsum("...rls,lk->...rks", h, _c64(_CODEBOOK_2TX_R2[wi], h.device))
        g00 = (hw[..., :, 0, :].abs() ** 2).sum(dim=-2)
        g11 = (hw[..., :, 1, :].abs() ** 2).sum(dim=-2)
        metrics.append((torch.log2(1 + g00 / nv) + torch.log2(1 + g11 / nv)).mean(dim=-1))
    m = torch.stack(metrics, dim=-1)
    return (m.argmax(dim=-1) + 1).to(torch.int32), m
