"""DL-SCH transport-channel encode/decode, TS 36.212 §5.3.2.

Port counterpart of ``srsran_4g_tpu/models/sch.py``: TB CRC24A, code-block
segmentation with per-CB CRC24B, turbo coding, rate matching with
redundancy versions and HARQ soft-buffers, and code-block (de)concatenation.

Segmentation resolves to a static plan on the host (one or two code-block
size groups); each group's CBs across the whole batch of TBs decode together
as one (B·C_g, ...) tensor, so the turbo kernel sees one wide batch.
Filler bits are encoded as 0, NULLed in rate matching, and pinned to a
strong bit-0 LLR before decoding.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed import ProcessGroup

from srsran_4g_tpu_torch.ops import crc as crc_ops
from srsran_4g_tpu_torch.ops import rate_match as rm
from srsran_4g_tpu_torch.ops import turbo
from srsran_4g_tpu_torch.ops.cbsegm import CbSegm, cbsegm
from srsran_4g_tpu_torch.parallel import dist

_FILLER_LLR = -64.0  # fillers are known 0-bits (negative ⇒ bit 0)


@dataclass(frozen=True)
class CbGroup:
    """A group of same-size code blocks within the TB (static plan)."""

    K: int
    count: int
    e_bits: tuple[int, ...]  # E per CB in this group
    n_filler: int  # filler bits in the first CB of this group
    first_cb_index: int


@dataclass(frozen=True)
class DlschPlan:
    tbs: int
    g: int  # total rate-matched bits for this codeword
    qm: int
    rv: int
    segm: CbSegm
    groups: tuple[CbGroup, ...]
    cb_data_len: tuple[int, ...]  # payload bits (excl. CB CRC) per CB


@functools.lru_cache(maxsize=256)
def dlsch_plan(tbs: int, g: int, qm: int, rv: int = 0, n_layers: int = 1) -> DlschPlan:
    s = cbsegm(tbs)
    # per-CB rate-matched length E (TS 36.212 §5.1.4.1.2)
    gp = g // (n_layers * qm)
    gamma = gp % s.C
    e_list = [n_layers * qm * (gp // s.C if r <= s.C - 1 - gamma else -(-gp // s.C))
              for r in range(s.C)]
    assert sum(e_list) == g, (sum(e_list), g)

    # CB ordering: the C2 smaller (K2) blocks first
    groups = []
    idx = 0
    if s.C2:
        groups.append(CbGroup(K=s.K2, count=s.C2, e_bits=tuple(e_list[:s.C2]),
                              n_filler=s.F, first_cb_index=0))
        idx = s.C2
    groups.append(CbGroup(K=s.K1, count=s.C1, e_bits=tuple(e_list[idx:]),
                          n_filler=s.F if not s.C2 else 0, first_cb_index=idx))
    data_len = [k - s.L_cb for k in [s.K2] * s.C2 + [s.K1] * s.C1]
    data_len[0] -= s.F
    return DlschPlan(tbs=tbs, g=g, qm=qm, rv=rv, segm=s, groups=tuple(groups),
                     cb_data_len=tuple(data_len))


def dlsch_encode(plan: DlschPlan, tb_bits: torch.Tensor) -> torch.Tensor:
    """Encode transport blocks (B, tbs) → (B, G) rate-matched codeword bits."""
    if tb_bits.shape[-1] != plan.tbs:
        raise ValueError(f"{tb_bits.shape[-1]} TB bits for a TBS of {plan.tbs}")
    s = plan.segm
    b = tb_bits.shape[0]
    full = torch.cat([tb_bits.to(torch.int8), crc_ops.crc_compute(tb_bits, "24A")],
                     dim=-1)

    outputs: list[torch.Tensor] = []
    pos = 0
    for grp in plan.groups:
        segs = []
        for i in range(grp.count):
            n_fill = grp.n_filler if i == 0 else 0
            dlen = grp.K - s.L_cb - n_fill
            seg = full[:, pos:pos + dlen]
            pos += dlen
            if n_fill:
                seg = torch.cat([seg.new_zeros((b, n_fill)), seg], dim=-1)
            if s.L_cb:
                seg = torch.cat([seg, crc_ops.crc_compute(seg, "24B")], dim=-1)
            segs.append(seg)
        # one turbo encode for the whole size group: (B*count, K)
        stacked = torch.stack(segs, dim=1).reshape(b * grp.count, grp.K)
        d = turbo.turbo_encode(stacked).reshape(b, grp.count, 3, grp.K + 4)
        for i in range(grp.count):
            outputs.append(rm.rate_match(d[:, i], grp.K, plan.rv, grp.e_bits[i],
                                         n_filler=grp.n_filler if i == 0 else 0))
    assert pos == plan.tbs + 24
    return torch.cat(outputs, dim=-1)


def dlsch_decode(
    plan: DlschPlan,
    llrs: torch.Tensor,
    softbuffers: dict[int, torch.Tensor] | None = None,
    n_iter: int = 5,
    window: int | None = 208,
    early_stop: bool = True,
    cb_shard: tuple[ProcessGroup, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict[int, torch.Tensor]]:
    """Decode transport blocks from codeword LLRs.

    Args:
      llrs: (B, G) float32, positive ⇒ bit 1.
      softbuffers: per-CB-index (B, 3, K+4) accumulated LLRs from earlier
        HARQ transmissions (as returned by this function), or None.
      cb_shard: optional (process_group, group_size) — split the stacked
        (B·C) code-block lanes of each turbo decode over the group's ranks
        (sp stream parallelism): the lanes are padded with zero LLRs to a
        multiple of the size, each rank decodes its contiguous share, and
        the hard bits are all-gathered back in rank order, so no rank
        decodes redundantly and every rank returns the whole result.  Each
        rank's early stop is its own; a block's bits do not depend on the
        split, since the decoder freezes each block that passes.

    Returns:
      (tb_bits (B, tbs) int8, crc_ok (B,) bool, softbuffers dict).
    """
    s = plan.segm
    b = llrs.shape[0]
    new_soft: dict[int, torch.Tensor] = {}

    e_offsets = np.cumsum([0] + [e for grp in plan.groups for e in grp.e_bits])
    cb_payloads: list[torch.Tensor] = []
    cb_crc_ok: list[torch.Tensor] = []
    cb_idx = 0
    early = ("24B" if s.L_cb else "24A") if early_stop else None
    for grp in plan.groups:
        d_group = []
        for i in range(grp.count):
            n_fill = grp.n_filler if i == 0 else 0
            lo, hi = e_offsets[cb_idx], e_offsets[cb_idx + 1]
            sb = softbuffers.get(cb_idx) if softbuffers else None
            d_llr = rm.rate_dematch(llrs[:, lo:hi], grp.K, plan.rv,
                                    softbuffer=sb, n_filler=n_fill)
            new_soft[cb_idx] = d_llr
            if n_fill:
                d_llr = d_llr.clone()
                d_llr[:, 0, :n_fill] = _FILLER_LLR
            d_group.append(d_llr)
            cb_idx += 1
        # one decoder call per size group over (B*count, 3, K+4)
        stacked = torch.stack(d_group, dim=1).reshape(b * grp.count, 3, grp.K + 4)
        if cb_shard is not None:
            hard = _decode_sharded(stacked, cb_shard, n_iter=n_iter, window=window,
                                   early_crc=early)
        else:
            hard, _ = turbo.turbo_decode(stacked, n_iter=n_iter, window=window,
                                         early_crc=early)
        hard = hard.reshape(b, grp.count, grp.K)
        for i in range(grp.count):
            bits = hard[:, i]
            if s.L_cb:
                cb_crc_ok.append(crc_ops.crc_check(bits, "24B"))
                bits = bits[:, :grp.K - s.L_cb]
            cb_payloads.append(bits[:, grp.n_filler if i == 0 else 0:])

    full = torch.cat(cb_payloads, dim=-1)  # (B, tbs + 24)
    tb_ok = crc_ops.crc_check(full, "24A")
    if cb_crc_ok:
        tb_ok = tb_ok & torch.stack(cb_crc_ok, dim=-1).all(dim=-1)
    return full[:, :plan.tbs], tb_ok, new_soft


def _decode_sharded(stacked: torch.Tensor, cb_shard: tuple[ProcessGroup, int],
                    **decode_args) -> torch.Tensor:
    """Turbo-decode this rank's contiguous share of the (N, 3, K+4) lanes,
    padded with zero LLRs to a multiple of the group size, and all-gather
    every rank's hard bits → (N, K) int8."""
    group, size = cb_shard
    if size != tdist.get_world_size(group):
        raise ValueError(f"cb_shard size {size} != {tdist.get_world_size(group)} ranks "
                         "in its group")
    n_lanes = stacked.shape[0]
    pad = (-n_lanes) % size
    if pad:
        stacked = torch.cat([stacked, stacked.new_zeros((pad,) + stacked.shape[1:])])
    loc = stacked.shape[0] // size
    i = tdist.get_rank(group)
    hard_loc, _ = turbo.turbo_decode(stacked[i * loc:(i + 1) * loc], **decode_args)
    return torch.cat(dist.all_gather(hard_loc, group))[:n_lanes]
