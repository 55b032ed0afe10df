"""NR transport-channel chain (UL-SCH/DL-SCH), TS 38.212 §5.2.2/§6.2.

Port counterpart of ``srsran_4g_tpu/models/sch_nr.py``: TB CRC (16 or 24A),
LDPC base-graph selection, code-block segmentation with CRC24B and filler
bits, per-CB LDPC encode + rate matching with rv and the §5.4.2.2 bit
interleaver, concatenation, and the decode path with HARQ soft-buffers and
CRC checks.  All CBs of the batch decode together in one LDPC call.

The segmentation resolves on the host into static index tensors, cached
per (segmentation, device): one gather from the CBs' codewords to the G
transmitted bits (bit selection + interleaving of every CB at once), and
its inverse, one ``index_add`` into the CBs' soft-buffers per pass over the
circular buffer, so repeated positions accumulate in transmit order.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.ops import crc as crc_ops
from srsran_4g_tpu_torch.ops import ldpc

_FILLER_LLR = -64.0


@dataclass(frozen=True)
class NrSegm:
    tbs: int
    g: int
    qm: int
    rv: int
    bg: int
    z: int
    C: int
    K: int  # info bits per CB incl. fillers (Kb*Z)
    k_prime: int  # info bits per CB excl. fillers
    L_cb: int  # per-CB CRC length (0 when C == 1)
    L_tb: int  # TB CRC length (16 or 24)
    e_bits: tuple[int, ...]
    # per-CB payload (excl. CB CRC) lengths; NR TBS values make these equal,
    # arbitrary sizes put the remainder in the last CB
    data_lens: tuple[int, ...] = ()


@functools.lru_cache(maxsize=256)
def nr_segment(tbs: int, g: int, qm: int, rv: int = 0,
               n_layers: int = 1, target_rate: float | None = None) -> NrSegm:
    if rv not in (0, 1, 2, 3):
        raise ValueError(f"rv must be 0..3, got {rv}")
    a = tbs
    r = target_rate if target_rate is not None else a / max(g, 1)
    l_tb = 16 if a <= 3824 else 24
    b = a + l_tb
    bg = 2 if (a <= 292 or (a <= 3824 and r <= 0.67) or r <= 0.25) else 1
    kcb = 8448 if bg == 1 else 3840
    if b <= kcb:
        c, l_cb, bp = 1, 0, b
    else:
        l_cb = 24
        c = -(-b // (kcb - 24))
        bp = b + 24 * c
    kp = -(-bp // c)
    if bg == 1:
        kb = 22
    else:
        kb = 10 if b > 640 else (9 if b > 560 else (8 if b > 192 else 6))
    z = min(zz for s in ldpc.LIFT_SETS.values() for zz in s if kb * zz >= kp)
    k = (22 if bg == 1 else 10) * z

    gp = g // (n_layers * qm)
    e_list = []
    for j in range(c):
        if j <= c - 1 - (gp % c):
            e_list.append(n_layers * qm * (gp // c))
        else:
            e_list.append(n_layers * qm * (-(-gp // c)))
    assert sum(e_list) == g
    base = kp - l_cb
    lens = [base] * c
    lens[-1] = b - base * (c - 1)
    assert 0 < lens[-1] <= base
    return NrSegm(tbs=tbs, g=g, qm=qm, rv=rv, bg=bg, z=z, C=c, K=k,
                  k_prime=kp, L_cb=l_cb, L_tb=l_tb, e_bits=tuple(e_list),
                  data_lens=tuple(lens))


def _interleave_idx(e: int, qm: int) -> np.ndarray:
    """38.212 §5.4.2.2 bit interleaver: f[j·Qm+i] = e[i·E/Qm + j]
    (row-write, column-read over a Qm × E/Qm matrix)."""
    return np.arange(e).reshape(qm, e // qm).T.reshape(-1)


def _groups(seg: NrSegm) -> list[tuple[int, int, int]]:
    """Runs of consecutive CBs with equal payload: (first CB, count, length)."""
    out: list[tuple[int, int, int]] = []
    for ci, n in enumerate(seg.data_lens):
        if out and out[-1][2] == n:
            out[-1] = (out[-1][0], out[-1][1] + 1, n)
        else:
            out.append((ci, 1, n))
    return out


@functools.lru_cache(maxsize=64)
def _plan(seg: NrSegm, device: torch.device) -> dict:
    """Index tensors of the segmentation: ``tx`` (G,) into the CBs' flat
    (C*N) codewords; ``passes``, for each pass over the circular buffers,
    the (destination in C*N, source in G) pairs, each destination once;
    ``filler`` (C, N) bool; ``payload`` (tbs + L_tb,) into the (C*K) hard
    bits."""
    n = ldpc.bg_params(seg.bg)[2] * seg.z
    tx, rank = [], []
    filler = np.zeros((seg.C, n), bool)
    payload = []
    for ci, e in enumerate(seg.e_bits):
        used = seg.data_lens[ci] + seg.L_cb
        n_fill = seg.K - used
        idx = ldpc._rm_indices(seg.bg, seg.z, e, seg.rv, n_fill, used)
        ring = ldpc._rm_ring(seg.bg, seg.z, seg.rv, n_fill, used).size
        # transmitted position j·Qm+i carries bit perm[j·Qm+i] of the CB's
        # circular-buffer selection, in pass perm // ring
        perm = _interleave_idx(e, seg.qm)
        tx.append(ci * n + idx[perm])
        rank.append(perm // ring)
        filler[ci, used:seg.K] = True
        payload.append(ci * seg.K + np.arange(seg.data_lens[ci]))
    tx, rank = np.concatenate(tx), np.concatenate(rank)
    passes = [(torch.as_tensor(tx[rank == r], device=device),
               torch.as_tensor(np.nonzero(rank == r)[0], device=device))
              for r in range(int(rank.max()) + 1)]
    return dict(tx=torch.as_tensor(tx, device=device), passes=passes,
                filler=torch.as_tensor(filler, device=device),
                payload=torch.as_tensor(np.concatenate(payload), device=device), n=n)


def encode(seg: NrSegm, tb_bits: torch.Tensor) -> torch.Tensor:
    """(B, tbs) → (B, G) int8 rate-matched bits."""
    b = tb_bits.shape[0]
    p = _plan(seg, tb_bits.device)
    crc_key = "16" if seg.L_tb == 16 else "24A"
    bits = tb_bits.to(torch.int8)
    full = torch.cat([bits, crc_ops.crc_compute(bits, crc_key)], dim=-1)
    cbs, pos = [], 0
    for _, count, dlen in _groups(seg):
        cb = full[:, pos:pos + count * dlen].reshape(b, count, dlen)
        pos += count * dlen
        if seg.L_cb:
            cb = torch.cat([cb, crc_ops.crc_compute(cb, "24B")], dim=-1)
        cbs.append(torch.nn.functional.pad(cb, (0, seg.K - cb.shape[-1])))
    stacked = torch.cat(cbs, dim=1).reshape(b * seg.C, seg.K)
    cw = ldpc.encode(stacked, seg.bg, seg.z).reshape(b, -1)
    return cw[:, p["tx"]]


def decode(
    seg: NrSegm, llrs: torch.Tensor,
    softbuffers: dict[int, torch.Tensor] | None = None,
    n_iter: int = 15,
) -> tuple[torch.Tensor, torch.Tensor, dict[int, torch.Tensor]]:
    """(B, G) LLRs → (tb_bits (B, tbs) int8, crc_ok (B,), softbuffers: per CB
    (B, Nfull*Z) float32, the combined LLRs before the fillers are pinned)."""
    b = llrs.shape[0]
    if llrs.shape[-1] != seg.g:
        raise ValueError(f"llrs last dim {llrs.shape[-1]} != G={seg.g}")
    p = _plan(seg, llrs.device)
    n = p["n"]
    if softbuffers:
        buf = torch.stack([softbuffers[ci].to(torch.float32) if ci in softbuffers
                           else llrs.new_zeros((b, n), dtype=torch.float32)
                           for ci in range(seg.C)], dim=1).reshape(b, seg.C * n)
    else:
        buf = llrs.new_zeros((b, seg.C * n), dtype=torch.float32)
    vals = llrs.to(torch.float32)
    for dst, src in p["passes"]:
        buf.index_add_(1, dst, vals[:, src])
    buf = buf.reshape(b, seg.C, n)
    new_soft = {ci: buf[:, ci] for ci in range(seg.C)}
    dec_in = torch.where(p["filler"], _FILLER_LLR, buf).reshape(b * seg.C, n)
    hard = ldpc.decode(dec_in, seg.bg, seg.z, n_iter=n_iter).reshape(b, seg.C, seg.K)

    ok = torch.ones(b, dtype=torch.bool, device=llrs.device)
    if seg.L_cb:
        for first, count, dlen in _groups(seg):
            cbs = hard[:, first:first + count, :dlen + seg.L_cb]
            ok = ok & crc_ops.crc_check(cbs, "24B").all(dim=-1)
    full = hard.reshape(b, -1)[:, p["payload"]]
    ok = crc_ops.crc_check(full, "16" if seg.L_tb == 16 else "24A") & ok
    return full[:, :seg.tbs], ok, new_soft
