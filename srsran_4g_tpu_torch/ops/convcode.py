"""Tail-biting convolutional code (K=7, rate 1/3) and a batched Viterbi
decoder, TS 36.212 §5.1.3.1 (generators 133, 171, 165 octal), for PBCH and
PDCCH.

Port counterpart of ``srsran_4g_tpu/ops/convcode.py`` (the reference's
`lib/src/phy/fec/convolutional/{convcoder.c,viterbi*.c}`).  The encoder is a
closed form: output bit k at step t is the parity of the generator's taps
over the last seven input bits, read circularly (tail-biting), so it needs
no recursion.  The Viterbi decoder keeps (batch, 64) path metrics and runs
a Python loop over the trellis steps, as JAX's ``lax.scan`` does; every
candidate of a PDCCH blind search decodes in one batch.  Tail-biting is
decoded on three concatenated copies of the LLRs, keeping the middle one.

Ties: the survivor decision is ``c1 > c0`` and the best final state the
first maximum, as in JAX, and the branch metric adds the three streams'
terms in JAX's order, so a rounding difference cannot flip a decision.
A hand-written kernel for the recursion is later work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# generator polynomials, current bit in the MSB (G0=133, G1=171, G2=165 oct)
_POLYS = (0o133, 0o171, 0o165)
_K = 7
_NSTATES = 64


@functools.lru_cache(maxsize=1)
def _tables() -> dict[str, np.ndarray]:
    """out (64, 2, 3): the code bits of input u from state s (bits 5..0 =
    the previous inputs, newest first); ns (64, 2); pred (64, 2): the two
    predecessors ((n << 1) | b) & 63 of state n, and pred_out (64, 2, 3)
    their code bits (the transition's input is n >> 5)."""
    out = np.zeros((_NSTATES, 2, 3), dtype=np.int64)
    ns = np.zeros((_NSTATES, 2), dtype=np.int64)
    for s in range(_NSTATES):
        for u in (0, 1):
            full = (u << 6) | s
            out[s, u] = [bin(full & g).count("1") & 1 for g in _POLYS]
            ns[s, u] = full >> 1
    pred = np.zeros((_NSTATES, 2), dtype=np.int64)
    pred_out = np.zeros((_NSTATES, 2, 3), dtype=np.int64)
    for nxt in range(_NSTATES):
        for b in (0, 1):
            pred[nxt, b] = ((nxt << 1) | b) & (_NSTATES - 1)
            pred_out[nxt, b] = out[pred[nxt, b], nxt >> 5]
    return dict(out=out, ns=ns, pred=pred, pred_out=pred_out)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Tail-biting encode: (B, N) bits → (B, 3, N) int8 streams d0, d1, d2."""
    b = bits.to(torch.int64)
    n = b.shape[-1]
    # window[..., t, c] = u_{t-6+c} (circularly): column c is bit c of the
    # register (u << 6) | state, column 6 the current input
    idx = (torch.arange(n, device=b.device)[:, None]
           - torch.arange(_K - 1, -1, -1, device=b.device)) % n
    window = b[..., idx]  # (B, N, 7)
    taps = torch.as_tensor([[(g >> c) & 1 for c in range(_K)] for g in _POLYS],
                           device=b.device)  # (3, 7)
    return ((window[..., None, :] * taps).sum(dim=-1) & 1).movedim(-1, -2).to(torch.int8)


@functools.lru_cache(maxsize=8)
def _tables_t(device: torch.device) -> dict[str, torch.Tensor]:
    t = _tables()
    return dict(pred0=torch.as_tensor(t["pred"][:, 0], device=device),
                pred1=torch.as_tensor(t["pred"][:, 1], device=device),
                po0=torch.as_tensor(t["pred_out"][:, 0], dtype=torch.float32, device=device),
                po1=torch.as_tensor(t["pred_out"][:, 1], dtype=torch.float32, device=device))


def _branch_metrics(lt: torch.Tensor, po: torch.Tensor) -> torch.Tensor:
    """sum_i l_i · po[s, i] for every step and state, i = 0, 1, 2 added left
    to right as JAX's einsum does: lt (S, B, 3), po (64, 3) → (S, B, 64)."""
    terms = lt[..., None, :] * po  # (S, B, 64, 3)
    return (terms[..., 0] + terms[..., 1]) + terms[..., 2]


def viterbi_decode(llrs: torch.Tensor, tail_biting: bool = True) -> torch.Tensor:
    """Max-log Viterbi decode.

    llrs: (B, 3, N) float32, positive ⇒ bit 1 (stream-major, as the encoder
    output); ``tail_biting``: circular decode on three copies.  Returns
    (B, N) int8 bits.
    """
    t = _tables_t(llrs.device)
    n = llrs.shape[-1]
    lt = llrs.to(torch.float32).movedim(-1, 0)  # (N, B, 3)
    if tail_biting:
        lt = torch.cat([lt, lt, lt], dim=0)
    bm0, bm1 = _branch_metrics(lt, t["po0"]), _branch_metrics(lt, t["po1"])
    nsteps, b = lt.shape[0], lt.shape[1]
    pm = torch.zeros((b, _NSTATES), dtype=torch.float32, device=llrs.device)
    decs = torch.empty((nsteps, b, _NSTATES), dtype=torch.bool, device=llrs.device)
    for s in range(nsteps):
        c0 = pm[:, t["pred0"]] + bm0[s]
        c1 = pm[:, t["pred1"]] + bm1[s]
        decs[s] = c1 > c0
        new = torch.maximum(c0, c1)
        pm = new - new.amax(dim=-1, keepdim=True)

    # traceback from the best final state (the first maximum)
    state = torch.argmax(pm, dim=-1)
    bits = torch.empty((b, nsteps), dtype=torch.int8, device=llrs.device)
    for s in range(nsteps - 1, -1, -1):
        d = decs[s].gather(-1, state[:, None])[:, 0].to(torch.int64)
        bits[:, s] = (state >> 5).to(torch.int8)
        state = ((state << 1) | d) & (_NSTATES - 1)
    return bits[:, n:2 * n] if tail_biting else bits
