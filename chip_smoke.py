"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``srsran_4g_tpu_torch/csrc`` (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card at the shapes the main path gives it (and
at small shapes: odd L and T, L ≡ 2 mod 4, L = K with T = 0), then drives
the port's paths, each with the launch counters set to 0 just before it and
read just after:

- the main path — PDSCH encode → CRS → AWGN at 30 dB → decode at 20 MHz
  (100 PRB, 64QAM, TBS 75376, 13 code blocks of K=5824), turbo n_iter 4
  with the CRC early stop, 128 subframes a batch — under each value of
  ``TURBO_KERNEL`` (v9, the default, then bf16, v3, v4, v7, v8, v5, v6),
  each checked for every CRC passing, every decoded bit equal to the sent
  one, and the launch counters of its own kernels moving while the others
  stay at 0; v9 is also timed by stage, profiled, and swept over batch and
  SNR;
- the default route at a block size whose window is L ≡ 2 (mod 4): 100 PRB,
  64QAM, MCS 23 (TBS 51024, 9 code blocks of K=5696, L=178), which the
  default TURBO_KERNEL decodes through ``map_windowed``; exact, only
  ``map_windowed`` launched, its launches, kernel ms and the decode's device
  time logged;
- the TM4 2x2 dual-codeword lane (``models/pdsch_mimo``) at pmi 2, batch 64,
  30 dB through the fixed 2x2 channel of the JAX package's MIMO gate, both
  codewords checked the same way;
- the downlink from time-domain samples: 128 captures of a 100 PRB
  subframe 5 (``models/enb_dl``, ``ops/ofdm``) after a random lead, with a
  random phase, a CFO and AWGN at 30 dB, searched blind
  (``models/ue_dl.cell_search``: PSS, CFO, alignment, OFDM demod, SSS) and
  decoded from the grid the search returns, each capture checked for its
  cell id, frame phase, exact timing offset, CFO, CRCs and bits;
- the probes: every H100 micro-benchmark of ``srsran_4g_tpu_torch/tools``
  (the ports of the TPU probes tools/turbo_probe{2,3,6,7}.py) at the TPU
  probes' shapes, through their ``measure`` entry points, each kernel then
  held against its plain version;
- the downlink control path from samples: 128 captures of a 100 PRB
  subframe 0 (cell 301, CFI 1, Ng 1) carrying a MIB, two PHICH ACKs, a
  format-1A DCI for a C-RNTI granting the whole band at MCS 28 and one for
  SI-RNTI, and the granted PDSCH, after the same impairments; the receiver
  searches the cell, estimates the channel, decodes PCFICH, PBCH, PHICH,
  blind-searches the PDCCH for both RNTIs and one that was not sent,
  unpacks the grant and decodes the PDSCH it names, every field checked
  exactly on every capture;
- the eNB uplink receiver: 128 subframes of a 100 PRB cell (301, subframe
  2) at 30 dB carrying a PUSCH on PRB 2-97 (64QAM, TBS 71112, 12 code
  blocks of K=5952 at L=192, with 2 HARQ-ACK and 20 long-CQI bits) and four
  PUCCH UEs on PRB 0-1 and 98-99 (formats 1a, 2, 2b and 3), every data, ACK,
  CQI and PUCCH bit checked; SRS sounding over the 96 PRB through a two-tap
  channel, its estimate within a stated normalised MSE; PRACH at symbol_sz
  2048, 128 captures with one preamble each (the sent one detected and no
  other, its delay as the detector reads it) and 32 of noise alone (nothing
  detected); the PUSCH decode timed and each stage profiled;
- PMCH: 128 MBSFN subframes of 100 PRB, area 1, 64QAM, TBS 46888 (8 code
  blocks of K=5888 at L=184) at 30 dB, decoded exactly;
- the UE around the downlink: a 40-subframe FDD stream of cell 301 at 100
  PRB with a random lead, a CFO and a neighbour cell 6 dB weaker on its own
  timing; ``UeSync`` FIND then TRACK on every subframe, the MIB, CRS
  measurements (RSRP, SNR against the SINR put in, CFO), the neighbour
  search, FDD/TDD detection, resampling to 23.04 Msps (polyphase and FFT,
  in-band EVM, a search at symbol_sz 1536) and back, AGC from -20 dB and CFR
  (PAPR drop, in-band EVM), with the per-subframe tracking time;
- the system path (``srsran_4g_tpu_torch.tools.run_lte.run``, the counterpart
  of the JAX package's tools/run_lte.py): a 20 MHz FDD SISO cell (100 PRB)
  with two UEs for 360 TTIs at 30 dB — over-the-air acquisition, PRACH, RRC
  attach with AKA and security mode through the EPC, ciphered pings, every
  grant on PDCCH, HARQ-ACK/SR/CQI on PUCCH, PHICH — held to every criterion
  of tests/test_run_lte.py::_run, timed per TTI on the host clock, 20 TTIs
  after the attach profiled (device ms and kernels per TTI, idle share), the
  turbo kernels' launches and the (B, K, L) shapes they saw counted, and the
  kernels held against their plain versions at the largest shape launched;
  then the JAX test's other matrix points (EPA fading at 14 dB, TM4 at 15
  PRB, TDD, 2-CC carrier aggregation, SI on DCI 1C at 50 PRB), each with that
  test's own assertions, and the fading channel's 100 PRB response against
  the CPU's;
- the three-process deployment (``srsran_4g_tpu_torch.tools.three_process``:
  the port's ``apps.srsepc``, ``apps.srsenb`` and one ``apps.srsue`` a UE as
  OS processes over the native IQ bridge, S1AP over TCP and GTP-U over UDP,
  the counterpart of the JAX package's tests/test_three_process_e2e.py):
  the native runtime built here first, then 100 PRB with two UEs for 600
  TTIs, then that test's TM4, TDD and 2-CC CA points at 6 PRB, each held to
  that test's criteria on the children's RESULT lines and timed from the
  eNB's bridges up to the last RESULT line (the attach read off the UEs'
  ATTACHED lines), with each child's turbo launches; then
  ``tools.phy_e2e`` at 100 PRB (20 subframes, every CRC); then each turbo
  kernel the children launched against its plain version at the largest
  shape they reported;
- the NR PDSCH at 100 MHz (``models/pdsch_nr``: 273 PRB at 30 kHz, type-1
  DMRS, LDPC through ``models/sch_nr`` and ``ops/ldpc``), 8 slots a call:
  256QAM (TBS 213176, 26 code blocks of K=8448) and 64QAM (TBS 159880) at
  30 dB, QPSK (TBS 40000) at 10 dB, and HARQ IR at 16QAM (TBS 83976, rv 0
  alone failing at 8 dB, rv 2 combined onto its soft-buffers), every CRC and
  bit checked, timed, profiled (the LDPC decode also alone) and slot 0
  decoded again on the CPU with identical bits and CRC flags; the NR CRC
  polynomials at 213176 bits against the host's integer CRC (``crc_np``);
  DCI 1_0 through the 38.212 polar chain (``ops/polar_3gpp``) at
  aggregation levels 1-16, with an RNTI that was not sent failing every CRC.
  NR has no kernel of its own: no turbo kernel may launch there;
- the NR SA system path (``srsran_4g_tpu_torch.tools.run_nr.run``, the
  counterpart of the JAX package's tools/run_nr.py) at 100 MHz (273 PRB,
  30 kHz), 80 slots at 20 dB: SSB search, PRACH, RAR, RRC setup, 5G-AKA
  registration, PDU session and two ciphered pings, every grant on PDCCH-NR,
  the data on PDSCH-NR / PUSCH-NR, HARQ-ACKs on PUCCH-NR; held to every
  criterion of tests/test_run_nr.py with no turbo kernel launched, timed a
  slot on the host clock (each air call and the PDCCH-NR search apart), then
  run again under torch.profiler over the attach's slots and 10 slots after
  the registration; then its channels alone at full width, each against
  the CPU on the same inputs: PUSCH-NR at 64QAM (TBS 159880, 8 slots) with
  and without 2 ACK + 20 CSI bits, a PDCCH-NR search of a 273 PRB CORESET
  over 64 captures (one DCI each at L = 1, 2 or 4; an unsent RNTI finds
  nothing), PUCCH-NR F2 (20 bits, CRC11 + polar) and F1 over 1024, and the
  SSB search + PBCH over 128 captures at random delays (exact offsets);
- 20 MHz V2X sidelink, TM4 (``models/sidelink``, ``models/sl_rx``): a
  capture of a random lead, one SLSS + PSBCH subframe and 40 data subframes
  (two vehicles on 48 PRB or one on 96 PRB each, MCS 22, 70 in all) from
  this script's TM3/4 transmitter, synchronised (``psbch_sync_decode``) and
  blind-decoded (``decode_capture``): every SCI and TB exact, both
  default-route turbo kernels launched (``map_fused16`` at L = 192,
  ``map_windowed`` at L = 178) and held against their plain versions at the
  largest shape, one subframe decoded again on the CPU, host ms a subframe
  and 8 data subframes profiled;
- an NB-IoT cell from grids (``models/nbiot``, ``models/nbiot_data``), 1,024
  a batch with a random gain: NPSS, NSSS over 504 ids, the NPBCH with a
  MIB-NB (r13 and r14), DCI N1 on each NPDCCH candidate and an unsent RNTI,
  the NPDSCH at three points (one the BCCH with a SIB1-NB), each timed and
  profiled, no turbo launch;
- NR CORESET#0 + SIB1 at 20 MHz / 15 kHz from samples (``models/coreset0``):
  32 captures, an SI-RNTI DCI at L = 4, 8 or 16 found at its Type0
  candidate, the SIB1 it grants decoded, an unsent RNTI finding nothing, one
  capture again on the CPU; CSI-RS at 273 PRB over 64 slots at 0-25 dB
  (``models/csi_nr``), each SINR within 3 dB, the CQIs equal to the CPU's;
  no turbo launch;
- the multi-device pipeline (``parallel/``, through ``tools.multichip``, the
  counterpart of the JAX package's ``dryrun_multichip``), each rank a child
  process on this card: (a) one rank over NCCL, mesh (1, 1), and (b) two
  ranks over Gloo, mesh (1, 2) (NCCL refuses two ranks on one card), at the
  main path's configuration and batch, bits and CRCs exact, the step timed,
  the sharded FIR and OFDM demod held against the dense ones, at (b) each
  rank decoding half of the code-block lanes and the halo exchange, grid
  all_reduce and hard-bit all_gather timed alone; (c) four ranks over Gloo,
  mesh (2, 2), at the dry run's two configurations; every rank's
  ``map_fused16`` launches and peak memory; ``map_fused16`` then held against
  its plain version at a rank's shape of (b);
- the error-rate tools (``tools.ber_sweep``, ``tools.bler_sweep``, the
  counterparts of the JAX package's tools/ber_sweep.py and bler_sweep.py) at
  1,024 frames a point into a temporary directory: the turbo BER at K = 6144
  over 0-3 dB in steps of 0.25 (5 iterations, no early stop: ``map_fused16``
  launched 10 times a point at B = 1024, L = 128), the LDPC chain (TBS 4224,
  0.5-4 dB) and the 50 PRB PDSCH (QPSK, 16QAM, 64QAM, 5 points each); at
  every point in the waterfall (and the BER points on either side of it,
  each PDSCH case's lowest point with BLER < 1) the decode again with
  ``map_fused16``'s plain version, bits, flags and APP LLRs identical; no
  errors at the clean points, every curve non-increasing within three
  binomial standard errors; ``map_fused16`` timed at the sweep's shape.
  Each phase's seconds and the whole script's are logged.

``map_fused16`` (the default route's kernel), ``map_windowed``,
``map_windowed16``, ``map_v3`` and ``map_fused`` (radix 2 and 4) are held
exactly equal to their plain versions (max |diff| 0), also at five tiles, a
ragged last tile, one window, L/4 odd, L = 178, 512 and 6144 (the full
recursion at T = 0 for the single-chain kernels, T = 32 for the fused
ones), and ``map_fused16`` also at the uplink's and the PMCH's shapes
(L = 192 and 184, timed, their launches per decode in its entry of the
kernels line); each kernel's launch geometry is logged beside its build's
registers and spills, and given in the kernels line.  The decodes under ``bf16``,
``v7`` and ``v8`` are profiled for their device time.

Output (stdout): the card's name and power limit, the build and check
lines, per-path subframes/s (best of 3), a per-stage split, then one JSON
line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
Any failure raises and the script exits non-zero without the last line;
there is no CPU fallback.  Imports nothing of JAX or of srsran_4g_tpu.
"""

from __future__ import annotations

import contextlib
import importlib.metadata
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The rates the bounds below are computed against.  Bytes: the H100 SXM's
# HBM3 bandwidth (NVIDIA data sheet).  Operations: the CUDA cores, at 132 SMs
# and the 1.98 GHz boost clock.  Per SM and clock, for compute capability
# 9.0 (CUDA C++ Programming Guide, "Arithmetic Instructions", throughput
# table): 128 results of 32-bit float add/multiply (one f32 add or subtract
# an instruction), 256 of 16-bit float add/multiply (128 packed bf16x2
# instructions; a scalar bf16 add takes one instruction too), and 64 of
# compare/minimum/maximum (the guide has no packed 16-bit row: a bf16x2 max
# is taken as one such instruction giving two elements).  Each of the SM's
# four partitions dispatches one warp instruction a clock (NVIDIA H100
# Tensor Core GPU Architecture whitepaper), 128 thread instructions per SM
# and clock of any kind.  So n_add add and n_max max instructions take at
# least max(n_add / 128, n_max / 64, (n_add + n_max) / 128) SM clocks; in
# every kernel here n_add >= n_max, so dispatch binds, whatever pipe the
# maxes use.  The data sheet's 67 TFLOP/s f32 counts an FMA as two
# operations and its 989 TFLOP/s bf16 is the tensor cores', which no
# elementwise max can use.
PEAK_BYTES_PER_S = 3.35e12
SM_COUNT, CLOCK_HZ = 132, 1.98e9
ADD_PER_SM_CLOCK, MAX_PER_SM_CLOCK, DISPATCH_PER_SM_CLOCK = 128, 64, 128
ELEMENTS_PER_INSTR = {"f32": 1, "bf16": 1, "bf16x2": 2}
ATOL = 1e-3  # f32 kernel vs plain version: same arithmetic in the same order
# bf16 kernels vs plain version: the repo's 16-bit bars (hard bits identical,
# atol 2.5, mean |diff| < 0.5); the same bf16 ops in the same order, so 0 is
# expected
ATOL16, MEAN16 = 2.5, 0.5
SEED = 1234
BATCH = 128  # subframes per decode call
N_ITER = 4
SNR_DB = 30.0
DECODE_REPS = 5
SWEEP_BATCHES = (16, 32, 64, 256, 512)  # decode the 128 subframes cut or tiled
SWEEP_SNR_DB = (22.0, 20.0, 18.0)       # fresh noise on the same TX grids
PATH_REPS = 3  # best of 3 for each TURBO_KERNEL path and the MIMO lane
MIMO_BATCH = 64
MIMO_PMI = 2
# the fixed 2x2 channel of the JAX package's MIMO gate (tools/tpu_smoke.py)
MIMO_H = ((1.0 + 0.1j, 0.3 - 0.4j), (0.2 + 0.4j, -0.9 + 0.2j))
# TURBO_KERNEL -> the wrappers whose kernels that path launches
PATH_KERNELS = {"v9": ("map_fused16",), "bf16": ("map_windowed16",),
                "v3": ("map_v3",), "v4": ("map_windowed",),
                "v7": ("map_fused",), "v8": ("map_fused",),
                "v5": ("sweep", "emit"), "v6": ("sweep", "emit")}
WRAPPERS = ("map_windowed", "map_windowed16", "map_v3", "map_fused",
            "map_fused16", "sweep", "emit")
BF16_WRAPPERS = ("map_windowed16", "map_fused16")
# the downlink from samples: 100 PRB, subframe 5 (PSS/SSS present), a cell id
# that is not a multiple of 3; captures of a random lead of 0..DL_LEAD_MAX
# samples, the subframe, and a tail of at least DL_TAIL; CFO uniform in
# +-DL_CFO subcarriers (the largest of 0.1, 0.05, 0 at which the JAX package
# on the CPU searched, took the CFO from the CP and decoded a batch-2 capture
# exactly).  Above 6 PRB cell_search takes the CFO from the CP and refines
# the timing from the PSS's phase slope, so the offset must be exact.
DL_CELL_ID = 301
DL_SUBFRAME = 5
DL_LEAD_MAX, DL_TAIL = 2000, 400
DL_CFO = 0.1
DL_CFO_TOL = 0.02
# the probes: probe 7 also at a lane count that fills the card (132 SMs x
# 2,048 resident threads, one lane or lane pair a thread)
P7_FULL_TILE_C = 132 * 2048 // 8
# the control path: 100 PRB subframe 0 of cell 301, CFI 1, Ng 1, one port; a
# format-1A DCI for C-RNTI 0x003d at L=2, CCE 8 (candidate (2, 8) of its
# search space) granting all 100 PRB at MCS 28 (I_TBS 26, TBS 75376), one for
# SI-RNTI at L=4, CCE 0 (common space); one ACK on each of two PHICH groups,
# one of them with nseq >= 4; a third RNTI searched but not sent
CTRL_CELL_ID, CTRL_SUBFRAME = 301, 0
C_RNTI, SI_RNTI, UNSENT_RNTI = 0x003D, 0xFFFF, 0x1234
C_DCI_AT, SI_DCI_AT = (2, 8), (4, 0)
GRANT_MCS, GRANT_TBS = 28, 75376
PHICH_AT = ((3, 1), (7, 5))  # (group, nseq)
# kernel route -> (its wrapper and radix, its source under csrc/, the line of
# the TPU kernel it replaces in srsran_4g_tpu/ops/pallas/turbo_map.py, and the
# TURBO_KERNEL path whose decode gives its launches)
ROUTES = {
    "turbo_map": ("map_windowed", None, "turbo_windowed.cu", 272, "v4"),
    "map_windowed16": ("map_windowed16", None, "turbo_windowed.cu", 1323, "bf16"),
    "map_v3": ("map_v3", None, "turbo_windowed.cu", 1189, "v3"),
    "map_fused16": ("map_fused16", None, "turbo_fused16.cu", 942, "v9"),
    "map_fused_r2": ("map_fused", 2, "turbo_fused.cu", 872, "v7"),
    "map_fused_r4": ("map_fused", 4, "turbo_fused.cu", 872, "v8"),
    "sweep_r2": ("sweep", 2, "turbo_sweep.cu", 1022, "v6"),
    "sweep_r4": ("sweep", 4, "turbo_sweep.cu", 426, "v5"),
    "emit": ("emit", None, "turbo_emit.cu", 1150, "v5"),
}
# routes held to max |diff| 0: every route but sweep and emit
EXACT = ("turbo_map", "map_windowed16", "map_v3", "map_fused16", "map_fused_r2",
         "map_fused_r4")
# the default route at L ≡ 2 (mod 4): 100 PRB, MCS 23 (I_TBS 21, 64QAM), TBS
# 51024, 9 code blocks of K = 5696, window L = 178
MCS23_TBS, MCS23_K, MCS23_L = 51024, 5696, 178
# the eNB uplink receiver: 100 PRB, cell 301, subframe 2; the PUSCH on PRB
# 2-97 (96 PRB), 64QAM, I_TBS 26 (TBS 71112: 12 code blocks of K = 5952,
# window L = 192, map_fused16), UCI with 2 ACK bits and 20 CQI bits (long
# CQI: CRC8 + tail-biting Viterbi); four PUCCH UEs on PRB 0-1 and 98-99, each
# (PRB, slot) used once: format 1a (m = 2), 2 with 11 CQI bits (m = 0), 2b
# with 11 CQI and 2 ACK bits (m = 1), 3 with 11 ACK bits (n_pucch 15, m = 3)
UL_CELL_ID, UL_SUBFRAME = 301, 2
UL_PRB_START, UL_NOF_PRB = 2, 96
UL_TBS, UL_CBS, UL_K, UL_L = 71112, 12, 5952, 192
UL_UCI = dict(o_ack=2, o_cqi=20)
UL_PUCCH = {"1a": dict(n_pucch=0, n_rb_2=2), "2": dict(n_pucch=0, rnti=0x0047),
            "2b": dict(n_pucch=0, n_rb_2=1, rnti=0x0048), "3": dict(n_pucch=15, rnti=0x0049)}
# SRS over the 96 PRB through two taps (the second SRS_TAP_DELAY samples of
# 2048 later, -10 dB): the estimate's normalised MSE against the channel
# applied; at 30 dB the 3-tap smoother leaves 0.375 of the 1e-3 noise
# variance, ~4e-4
SRS_TAP_DELAY, SRS_NMSE_MAX = 5, 1e-3
# PRACH at symbol_sz 2048, root 128 and zero-correlation zone 5 (N_cs = 26,
# 32 shifts a root: two roots for the 64 preambles), delays of 0..12·60
# samples (the zone is 63 detector bins of 12 samples), PRACH_NOISE captures
# of noise alone
PRACH_ROOT, PRACH_ZCZ, PRACH_NOISE, PRACH_MAX_BIN = 128, 5, 32, 60
# PMCH: 100 PRB, area 1, subframe 1, 64QAM, I_TBS 20 (TBS 46888, code rate
# 0.77: 8 code blocks of K = 5888, window L = 184, map_fused16)
PMCH_TBS, PMCH_CBS, PMCH_K, PMCH_L = 46888, 8, 5888, 184
# the UE around the downlink: a 40-subframe FDD stream of cell 301 at 100
# PRB after a random lead, a neighbour (cell 152, another N_ID_2) 6 dB weaker
# with its own timing, a CFO inside +-DL_CFO; the bounds of its checks
SYNC_CELL_ID, SYNC_NBR_ID, SYNC_NBR_DB = 301, 152, 6.0
SYNC_SF, SYNC_LEAD_MAX = 40, 2000
# the system path (tools/run_lte.run): the full-width run, the TTIs after
# the last attach before the profiled window, and its length
SYS_RUN = dict(n_ttis=360, n_pings=2, snr_db=30.0, nof_prb=100, n_ues=2)
SYS_PROFILE_AFTER, SYS_PROFILE_TTIS = 20, 20
SYS_WRAPPERS = ("map_fused16", "map_windowed")  # the default route's two kernels
SYS_ROUTE = {"map_fused16": "map_fused16", "map_windowed": "turbo_map"}
# the stages timed in each TTI (host clock, the device synchronised around
# each call): the air's calls, and inside them the blind search, its
# Viterbi and the PDSCH/PUSCH decodes; what the air's calls leave of a TTI is
# the nodes' and the stack's Python
SYS_STAGES = ("LteAirPhy.enb_dl_tx", "LteAirPhy.ue_dl_rx_multi", "pdcch.blind_decode",
              "convcode.viterbi_decode", "pdsch.decode", "LteAirPhy.ue_phich_rx",
              "LteAirPhy.ue_ul_tx", "LteAirPhy.combine_ul", "LteAirPhy.enb_ul_grid",
              "LteAirPhy.enb_pusch_rx", "pusch.decode", "LteAirPhy.enb_pucch_ack_rx",
              "LteAirPhy.enb_sr_rx", "LteAirPhy.enb_cqi_rx", "LteAirPhy.prach")
# the three-process deployment (tools/three_process: srsepc, srsenb and one
# srsue a UE as OS processes over the IQ bridge, S1AP and GTP-U): the JAX
# test's 2-UE point (tests/test_three_process_e2e.py) at the widest PRB of the
# reference matrix, then that test's TM4, TDD and 2-CC CA points; phy_e2e at
# 100 PRB; the seconds a child may take
PROC_POINTS = (("2 UEs at 100 PRB", dict(prb=100, ues=2, ttis=600)),
               ("TM4 at 6 PRB", dict(prb=6, tm=4, ttis=480)),
               ("TDD at 6 PRB", dict(prb=6, tdd=True, ttis=600)),
               ("2-CC CA at 6 PRB", dict(prb=6, cc=2, ttis=600)))
PROC_PHY_E2E_PRB, PROC_PHY_E2E_SF = 100, 20
PROC_TIMEOUT = 300
SYNC_CFO_TOL = 0.005       # subcarriers, the tracked CFO against the one put in
SYNC_CFO_HZ_TOL = 50.0     # tracked CFO + measure_cell's residual, against the one put in
SYNC_RSRP_TOL_DB = 0.5     # the serving CRS is sent at 0 dB
SYNC_SNR_TOL_DB = 1.0    # measure_cell's SNR, against the SINR put in on the CRS REs
SYNC_EVM_POLY_DB, SYNC_EVM_FFT_DB = -20.0, -40.0
AGC_FRAMES, AGC_TOL_DB = 20, 1.5
CFR_DROP_DB, CFR_EVM_DB = 2.0, -15.0
# The NR PDSCH at 100 MHz (273 PRB, 30 kHz SCS), type-1 DMRS on symbols 2 and
# 11, NR_BATCH slots a call: (modulation, TBS, SNR dB, expected code
# blocks).  256QAM: G = 288,288, 26 CBs of K = 8448 (BG1, Z = 384), rate 0.74.
NR_CARRIER = dict(nof_prb=273, pci=500, scs_khz=30)
NR_RNTI, NR_SLOT, NR_BATCH, NR_REPS = 0x4601, 7, 8, 3
NR_POINTS = (("256qam", 213176, 30.0, 26), ("64qam", 159880, 30.0, 19), ("qpsk", 40000, 10.0, 5))
# HARQ IR: 16QAM at the TBS of MCS 16 on 273 PRB (38.214 table 1), code rate
# 0.58, 10 CBs; rv 0 alone fails at 8 dB, rv 0 + rv 2 combined decodes.
NR_HARQ = ("16qam", 83976, 8.0, 10)
NR_CRC_BITS = 213176  # the NR CRC polynomials at the 256QAM point's TB length
DCI_AGG = (1, 2, 4, 8, 16)  # E = 108 bits a CCE (PDCCH QPSK, 54 REs)
DCI_BATCH, DCI_SNR_DB = 64, 10.0
# The NR SA system path (tools/run_nr) at 100 MHz, held to tests/test_run_nr.py;
# a second run profiles the attach's slots and NR_SYS_PROFILE_SLOTS slots
# after the registration.  Then each of its channels alone at full width:
# PUSCH-NR at the 64QAM point (with and without UCI), PDCCH-NR searches of
# a 273 PRB CORESET, PUCCH-NR F2/F1 and SSB search + PBCH batches.
NR_SYS_RUN = dict(n_slots=80, n_pings=2, snr_db=20.0, nof_prb=273)
NR_SYS_PROFILE_SLOTS = 10
NR_SYS_STAGES = ("gnb_dl_tx", "ue_dl_rx", "ue_ul_tx", "ue_pucch_ack_tx", "gnb_pucch_ack_rx",
                 "gnb_ul_rx")
NR_UCI = dict(o_ack=2, o_csi=20)
NR_PDCCH_BATCH, NR_PDCCH_SNR_DB = 64, 5.0
NR_PDCCH_AT = ((1, 3), (2, 20), (4, 36))  # (level, first start CCE) of the DCI a row carries
NR_PUCCH_BATCH, NR_PUCCH_SNR_DB = 1024, 10.0
NR_PUCCH_F2 = dict(pci=500, rnti=NR_RNTI, nof_prb=4, nof_symb=2, nof_uci_bits=20)
NR_SSB_BATCH, NR_SSB_SNR_DB, NR_SSB_PCI = 128, 10.0, 500
# Sidelink V2X at 20 MHz (100 PRB, 30.72 Msps), TM4, the default pool (10
# subchannels of 10 PRB): a random lead of up to a subframe, one SLSS + PSBCH
# subframe of N_SL_ID 335 (root 37), then SL_DATA_SF data subframes at 30 dB,
# each with a random phase.  Three of every four carry two vehicles (PSCCH on
# subchannel 0 and 5, each PSSCH 48 PRB: TBS 22152 in 4 code blocks of K =
# 5568, window L = 192, map_fused16), every fourth one vehicle over all ten
# subchannels (98 PRB clipped to 96: TBS 45352, 8 code blocks of K = 5696, L =
# 178, map_windowed); every grant MCS 22 (64QAM), rv 0.  The receiver's
# first SL_PROFILE_SF data subframes are profiled.
SL_PRB, SL_SYMBOL_SZ, SL_N_SL_ID, SL_TM = 100, 2048, 335, 4
SL_DATA_SF, SL_MCS, SL_SNR_DB, SL_PROFILE_SF = 40, 22, 30.0, 8
SL_MIB = dict(sl_bandwidth=100, direct_frame_number=517, direct_subframe_number=0,
              in_coverage=False)
SL_SHAPES = {"map_fused16": (4, 5568, 192), "map_windowed": (8, 5696, 178)}  # (B, K, L) a TB
# NB-IoT, one standalone PRB at 15 kHz, NB_BATCH grids a batch, each with a
# random complex gain (amplitude 0.5-1.5) and AWGN: the NPSS at 5 dB, the NSSS
# of three cell ids at 6 dB, the NPBCH (an rrc_nbiot MIB-NB) at frames 0, 12
# and 35 (r14) at 8 dB, DCI N1 on each NPDCCH candidate at 8 dB, the NPDSCH at
# tests/test_nbiot_data.py's points and a SIB1-NB on the BCCH NPDSCH.
NB_BATCH, NB_CELL, NB_RNTI = 1024, 17, 0x4604
NB_NSSS_CELLS = (0, 257, 503)
NB_NPBCH_FRAMES = ((0, False), (12, False), (35, True))
# The NPDSCH's block errors are held to NB_NPDSCH_BLER of a batch (with every
# CRC-passing TB exact, and the CPU's decode identical on NB_CPU_RERUN captures
# and on every one whose CRC failed): the
# JAX receiver's NRS estimate (8 pilots a subframe) leaves block errors at the
# 6 dB point of tests/test_nbiot_data.py (2 of 4,096 on the CPU, the port's
# flags equal).
NB_NPDSCH_BLER, NB_CPU_RERUN = 0.01, 16
NB_NPDSCH = (("i_tbs 12, i_sf 2", dict(i_tbs=12, i_sf=2), 16.0),
             ("i_tbs 4, i_sf 3", dict(i_tbs=4, i_sf=3), 6.0),
             ("BCCH SIB1-NB", dict(i_tbs=0, i_sf=6, is_bcch=True, rnti=0xFFFF), 6.0))
# NR CORESET#0 + SIB1 on a 20 MHz carrier at 15 kHz (106 PRB, symbol_sz 2048,
# 30.72 Msps), PCI 500, slot 0, carrier at NR_SIB_FC_HZ: the SSB centre
# NR_SIB_SSB_HZ above pointA puts CORESET#0 index 13 (96 PRB x 2 symbols,
# Table 13-1 offset 38 RB) on RB 5-100; NR_SIB_BATCH one-slot captures at
# NR_SIB_SNR_DB, each an SI-RNTI DCI 1_0 at L = 4, 8 or 16 of the Type0 CSS
# and the SIB1 PDSCH it grants: all 96 PRB, time row 0, NR_SIB_MCS.  Then
# CSI-RS on PR 12's carrier (273 PRB, 30 kHz), NR_CSI_BATCH slots at SNRs
# spread over 0-25 dB.
NR_SIB_PRB, NR_SIB_SYMBOL_SZ, NR_SIB_PCI, NR_SIB_CORESET0 = 106, 2048, 500, 13
NR_SIB_SSB_HZ, NR_SIB_FC_HZ = 43 * 180e3 + 1.8e6, 2.1e9
NR_SIB_BATCH, NR_SIB_SNR_DB, NR_SIB_MCS, SI_RNTI_NR = 32, 10.0, 9, 0xFFFF
NR_CSI_BATCH = 64
# The multi-device pipeline (parallel/, tools/multichip): ranks as child
# processes on this one card, at the main path's batch and configuration.
# (a) one rank over NCCL, mesh (1, 1); (b) two ranks over Gloo, mesh (1, 2),
# each decoding half of the 128 x 13 code-block lanes (NCCL refuses two ranks
# on one card); (c) four ranks over Gloo, mesh (2, 2), at the JAX dry run's
# two configurations and batches.  MC_PER_RANK: map_fused16's shape on a
# rank of (b): B = 832 code blocks, K = 5824, L = 208, T = 32.
MC_RUNS = (("a", 1, "nccl", "bench", BATCH), ("b", 2, "gloo", "bench", BATCH),
           ("c", 4, "gloo", "tiny,bench", None))
MC_REPS = 3
MC_TIMEOUT = 240
MC_PER_RANK = (BATCH * 13 // 2, 5824, 208, 32)
# The error-rate tools (tools/ber_sweep, tools/bler_sweep) at their own
# grids and widths, with SWEEP_FRAMES frames (code blocks, TBs) a point: the
# turbo BER at K = 6144 (13 points, 5 iterations, no early stop, so 10
# map_fused16 launches a point at B = 1024, L = 128), the LDPC chain and the
# 50 PRB PDSCH.  Zero errors are required at and above SWEEP_TURBO_CLEAN dB
# (turbo BER and FER) and SWEEP_LDPC_CLEAN dB (LDPC BLER), and at the two
# highest points of each PDSCH case.
SWEEP_FRAMES = 1024
SWEEP_K, SWEEP_ITERS = 6144, 5
SWEEP_EBN0 = (0.0, 3.0, 0.25)  # the BER tool's default grid: min, max, step
SWEEP_TURBO_CLEAN, SWEEP_LDPC_CLEAN = 1.5, 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def pkg_version(name: str) -> str:
    try:
        return importlib.metadata.version(name)
    except importlib.metadata.PackageNotFoundError:
        return "not installed"


def op_ms(adds: int, maxes: int, kind: str) -> float:
    """Least time (ms) the CUDA cores take for ``adds`` adds and subtracts
    and ``maxes`` maxes of type ``kind`` ("f32", "bf16" or "bf16x2",
    counted in elements): the rates above."""
    per = ELEMENTS_PER_INSTR[kind]
    i_add, i_max = adds / per, maxes / per
    clocks = max(i_add / ADD_PER_SM_CLOCK, i_max / MAX_PER_SM_CLOCK,
                 (i_add + i_max) / DISPATCH_PER_SM_CLOCK) / SM_COUNT
    return clocks / CLOCK_HZ * 1e3


def bound(nbytes: int, adds: int, maxes: int, kind: str) -> tuple[float, str]:
    """Least time (ms) for work that moves ``nbytes`` and does ``adds`` adds
    and ``maxes`` maxes of type ``kind``, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, op_ms(adds, maxes, kind)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def work(wrapper: str, b: int, k: int, l: int, t: int) -> tuple[int, int, int]:
    """Bytes (each input read once, each output written once), adds
    (subtracts included) and maxes of one call of ``wrapper`` at these
    shapes.  The half-iteration (map_windowed, map_windowed16, map_v3,
    map_fused, map_fused16) reads the float32 gammas and initial metrics
    and writes L float32 LLRs per lane; sweep writes the L/2 even-position
    stores of both chains instead, and emit reads those stores and the body
    gammas.  Operations (bf16 for the 16-bit kernels, else f32), counting
    only lanes whose training is not frozen: per trellis step per chain 24
    adds (16 branch adds, 8 normalising subtracts) and 15 maxes (8 + 7);
    per LLR 26 adds (16 alpha + beta, 8 parity terms, the input term and
    the difference) and 14 maxes; for emit's two odd-position steps per
    pair 32 adds and 16 maxes."""
    w = k // l
    n = w * b
    gammas, inits, llrs = 2 * (l + 2 * t) * n, 2 * 8 * n, l * n
    stores = 2 * (l // 2) * 8 * n
    steps = (n - b) * t + (w - 1) * b * t + 2 * n * (l - 1)
    if wrapper == "sweep":
        return 4 * (gammas + inits + stores), 24 * steps, 15 * steps
    if wrapper == "emit":
        pairs = (l // 2) * n
        return (4 * (2 * l * n + stores + llrs), (26 * 2 + 32) * pairs,
                (14 * 2 + 16) * pairs)
    return 4 * (gammas + inits + llrs), 24 * steps + 26 * llrs, 15 * steps + 14 * llrs


def gamma_inputs(dev, gen, b, k, l, t):
    """Random half-iteration inputs laid out as the decoder lays them out."""
    from srsran_4g_tpu_torch.ops import turbo

    lsa = torch.randn((b, k), generator=gen, device=dev) * 3
    lp = torch.randn((b, k), generator=gen, device=dev) * 3
    ts = torch.randn((b, 3), generator=gen, device=dev)
    tp = torch.randn((b, 3), generator=gen, device=dev)
    gs, gp, a0, b0, w = turbo._windowed_inputs(lsa, lp, ts, tp, l, t)
    return gs, gp, a0, b0, t, l, b, w


def kernel_calls(args, route: str):
    """(kernel call, plain call) of one route on half-iteration inputs; emit
    takes the body gammas and the radix-4 sweep kernel's stores."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    wrapper, radix = ROUTES[route][:2]
    fn, ref = getattr(tm, wrapper), getattr(tm, wrapper + "_ref")
    if wrapper == "emit":
        gs, gp, _, _, t, l, b, w = args
        args = (gs[t:t + l].view(l // 2, 2, b * w), gp[t:t + l].view(l // 2, 2, b * w),
                *tm.sweep(*args, radix=4))
    kw = {} if radix is None else {"radix": radix}
    return lambda: fn(*args, **kw), lambda: ref(*args, **kw)


def check_kernel(route: str, args, time_it=False) -> dict:
    """One route's kernel vs its plain version on the card, same inputs: f32
    kernels to atol 1e-3, bf16 kernels to the 16-bit bars, and the routes of
    EXACT to max |diff| 0; map_v3 also equal to turbo_map's LLRs."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm
    from srsran_4g_tpu_torch.tools import event_ms, host_ms

    gs, _, _, _, t, l, b, w = args
    kernel, plain = kernel_calls(args, route)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max(float((g - p).abs().max()) for g, p in pairs)
    desc = f"B={b} L={l} T={t} N={w * b}"
    if not np.isfinite(err):
        raise AssertionError(f"{route} kernel vs plain at {desc}: not finite")
    if ROUTES[route][0] in BF16_WRAPPERS:
        mean = float((got - want).abs().mean())
        if err > ATOL16 or mean >= MEAN16 or not torch.equal(got > 0, want > 0):
            raise AssertionError(f"{route} kernel vs plain at {desc}: max |diff| {err}, "
                                 f"mean {mean}, or a hard decision differs")
    elif err > ATOL:
        raise AssertionError(f"{route} kernel vs plain at {desc}: max |diff| {err} > {ATOL}")
    if route in EXACT and err != 0:
        raise AssertionError(f"{route} kernel vs plain at {desc}: max |diff| {err}, not 0")
    res = dict(max_abs_err=err)
    if route == "map_v3":
        res["vs_turbo_map"] = float((got - tm.map_windowed(*args)).abs().max())
        torch.cuda.synchronize()
        if res["vs_turbo_map"] != 0:
            raise AssertionError(f"map_v3 vs turbo_map at {desc}: max |diff| "
                                 f"{res['vs_turbo_map']}, not 0")
    if time_it:
        res["ms"] = event_ms(kernel, iters=20, warmup=2)
        res["plain_ms"] = host_ms(plain, iters=2)
    log(f"check {route} {desc}: max|diff| {err:.3g}"
        + (f" (vs turbo_map {res['vs_turbo_map']:.3g})" if "vs_turbo_map" in res else "")
        + (f", kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.2f} ms" if time_it else ""))
    return res


def check_kernels(dev, gen, b, k) -> dict:
    """Every route at the bench shape (timed), the single-chain routes also
    at the MCS 23 path's shape (timed, under ``out["mcs23"]``), and every
    route at small shapes; the largest |diff| of each route over its
    checks."""
    bench = gamma_inputs(dev, gen, b, k, 208, 32)
    out = {r: check_kernel(r, bench, time_it=True) for r in ROUTES}
    any_shape = ("turbo_map", "map_windowed16", "map_v3")  # the v1 bodies
    mcs23 = gamma_inputs(dev, gen, BATCH * 9, MCS23_K, MCS23_L, 32)
    out["mcs23"] = {r: check_kernel(r, mcs23, time_it=True) for r in any_shape}
    del mcs23
    fused = ("map_fused16", "map_fused_r2", "map_fused_r4")
    small = [((64, 424, 106, 32), any_shape + ("sweep_r2", "sweep_r4", "emit")),  # L ≡ 2 (mod 4)
             ((32, 512, 64, 31), any_shape),                                      # odd T
             ((32, 504, 63, 16), any_shape),                                      # odd L
             ((33, 40, 40, 0), any_shape),                                        # L = K, T = 0, N odd
             ((64, 512, 64, 16), tuple(r for r in ROUTES if r not in any_shape)),  # L % 4 == 0
             ((5, 6144, 192, 32), ("map_fused16",)),  # N = 160, W = 32
             ((3, 5824, 208, 32), fused),             # N = 84: a ragged last tile
             ((3, 40, 40, 32), fused),                # W = 1
             ((2, 6016, 188, 32), fused),             # L/4 odd
             ((32, 1024, 512, 32), any_shape + fused),  # L = 512
             ((3, 6144, 6144, 0), any_shape),  # the full recursion at K = 6144
             ((3, 6144, 6144, 32), fused)]  # L = K = 6144, W = 1
    for shape, names in small:
        args = gamma_inputs(dev, gen, *shape)
        for r in names:
            res = check_kernel(r, args)
            for key in ("max_abs_err", "vs_turbo_map"):
                if key in res:
                    out[r][key] = max(out[r][key], res[key])
    for r, res in out["mcs23"].items():
        out[r]["max_abs_err"] = max(out[r]["max_abs_err"], res["max_abs_err"])
    # the default kernel at the uplink's and the PMCH's shapes (timed)
    for key, (cbs, k_cb, l_win) in (("ul_path", (UL_CBS, UL_K, UL_L)),
                                    ("mbsfn_path", (PMCH_CBS, PMCH_K, PMCH_L))):
        out[key] = check_kernel("map_fused16", gamma_inputs(dev, gen, BATCH * cbs, k_cb, l_win,
                                                            32), time_it=True)
        out["map_fused16"]["max_abs_err"] = max(out["map_fused16"]["max_abs_err"],
                                                out[key]["max_abs_err"])
    return out


def kernel_symbol(route: str, radix, geo) -> tuple[str, ...]:
    """Pieces of the mangled name of the kernel that ``route`` launches at
    the bench shape (``geo``: its geometry), to find it in the build log."""
    if route in ("turbo_map", "map_windowed16"):
        return f"windowed_kernelILi{geo.every}E", "F32" if route == "turbo_map" else "B16"
    if route == "map_v3":
        return (f"v3_kernelILi{geo.every}E",)
    if route == "map_fused16":
        return (f"fused16_kernelILi{geo.lanes}E",)
    if route in ("map_fused_r2", "map_fused_r4"):
        return (f"fused_kernelILi{geo.every}ELi{radix}E",)
    if route == "emit":
        return ("emit_kernel",)
    return (f"sweep_kernelILi{radix}E",)


def launch_counts(names=WRAPPERS) -> dict[str, int]:
    """The port's launch counts (``turbo_map.launches``) of these kernels."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    return {name: tm.launches[name] for name in names}


def reset_counts() -> None:
    """Every kernel's launch count to 0 (and the largest shapes noted)."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    tm.launches.clear()
    tm.largest.clear()


def timed_decodes(cfg, rx, reps: int, decode=None):
    """Decode `reps` times; host-clock seconds of each (ends in a sync), the
    turbo kernel launches of the last decode (all wrappers), and its
    output."""
    from srsran_4g_tpu_torch.models import pdsch

    decode = decode or pdsch.decode
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        before = sum(launch_counts().values())
        t0 = time.perf_counter()
        out = decode(cfg, rx, n_iter=N_ITER)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, sum(launch_counts().values()) - before, out


def sweeps(cfg, tx, rx, bits, gen, card) -> None:
    """Batch size and SNR against decode time (reported, not asserted on,
    except that every batch of the 30 dB sweep must decode exactly)."""
    from srsran_4g_tpu_torch.channel import awgn

    for b in SWEEP_BATCHES:
        tile = -(-b // BATCH)
        times, launches, out = timed_decodes(cfg, rx.repeat(tile, 1, 1)[:b], 3)
        if not (bool(out["crc_ok"].all())
                and torch.equal(out["bits"], bits.repeat(tile, 1)[:b])):
            raise AssertionError(f"batch {b}: decode is not exact")
        log(f"[{card}] batch sweep {SNR_DB} dB: batch {b}: best {min(times) * 1e3:.2f} ms "
            f"= {b / min(times):.1f} subframes/s, turbo launches {launches}")
    for snr in SWEEP_SNR_DB:
        rx_s = awgn.awgn(tx, awgn.snr_to_noise_var(snr), generator=gen)
        times, launches, out = timed_decodes(cfg, rx_s, 3)
        n_ok = int(out["crc_ok"].sum())
        n_exact = int((out["bits"] == bits).all(dim=1).sum())
        log(f"[{card}] SNR sweep batch {BATCH}: {snr} dB: best {min(times) * 1e3:.2f} ms "
            f"= {BATCH / min(times):.1f} subframes/s, turbo launches {launches}, "
            f"crc_ok {n_ok}/{BATCH}, exact {n_exact}/{BATCH}")


def staged_decode(cfg, rx):
    """pdsch.decode's stages run one by one, each timed with CUDA events."""
    from srsran_4g_tpu_torch.models import chest, equalizer, pdsch, sch
    from srsran_4g_tpu_torch.ops import modem, scrambling

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    tab = pdsch._tables(cfg, rx.device)
    b = rx.shape[0]
    ev[0].record()
    est = chest.estimate(chest.ChestConfig(cell=cfg.cell), rx, cfg.subframe)
    ev[1].record()
    y = rx.reshape(b, -1)[:, tab["re_idx"]]
    h = est["h"].reshape(b, -1)[:, tab["re_idx"]]
    x, eff_nv = equalizer.equalize_single(y, h, est["noise_var"])
    llr = scrambling.descramble_llrs(
        modem.demodulate_soft(cfg.mod, x, eff_nv).reshape(b, cfg.g_bits), tab["seq"])
    ev[2].record()
    sch.dlsch_decode(cfg.plan, llr, n_iter=N_ITER)
    ev[3].record()
    torch.cuda.synchronize()
    return dict(chest=ev[0].elapsed_time(ev[1]),
                          equalise_demod_descramble=ev[1].elapsed_time(ev[2]),
                          dlsch_decode=ev[2].elapsed_time(ev[3]))


def profile_decode(cfg, rx, decode_s: float, card: str, reps: int = 3,
                   decode=None, turbo: str = "fused") -> tuple[float, float] | None:
    """Device busy/idle share of the decode and its costliest kernels, from
    torch.profiler over `reps` decodes against the unprofiled best time, and
    the share of the turbo kernels (named *fused*, as the v9 route's is, or
    *<turbo>*).  Returns (device ms, turbo kernels' ms) per decode, None if
    the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from srsran_4g_tpu_torch.models import pdsch

    decode = decode or pdsch.decode
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            decode(cfg, rx, n_iter=N_ITER)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if busy_ms <= 0:
        log(f"[{card}] profiler saw no device time: idle share not measured")
        return None
    n_kernels = sum(e.count for e in kernels) / reps
    turbo_ms = sum(e.self_device_time_total for e in kernels if turbo in e.key) / 1e3 / reps
    log(f"[{card}] decode device time {busy_ms:.3f} ms in {n_kernels:.0f} kernels "
        f"per decode; idle share {1 - busy_ms / (decode_s * 1e3):.3f} of the "
        f"unprofiled {decode_s * 1e3:.2f} ms; kernels named *{turbo}* {turbo_ms:.4f} ms "
        f"({turbo_ms / busy_ms:.3f} of the device time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count // reps:<4d} "
            f"{e.key[:90]}")
    return busy_ms, turbo_ms


def check_exact(ok: torch.Tensor, got: torch.Tensor, sent: torch.Tensor, what: str) -> None:
    if not bool(ok.all()):
        raise AssertionError(f"{what}: crc_ok {int(ok.sum())}/{ok.numel()}")
    if not torch.equal(got, sent):
        raise AssertionError(f"{what}: decoded bits differ from the sent bits")


def drive_path(cfg, rx, bits, kernel: str) -> dict[str, int]:
    """Decode under TURBO_KERNEL=kernel with the counts at 0: the decode must
    be exact and only that path's kernels may launch.  Returns the counts."""
    from srsran_4g_tpu_torch.models import pdsch

    os.environ["TURBO_KERNEL"] = kernel
    reset_counts()
    out = pdsch.decode(cfg, rx, n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_exact(out["crc_ok"], out["bits"], bits, f"TURBO_KERNEL={kernel}")
    moved = {name for name, n in counts.items() if n}
    if moved != set(PATH_KERNELS[kernel]):
        raise AssertionError(f"TURBO_KERNEL={kernel} launched {counts}, expected only "
                             f"{PATH_KERNELS[kernel]}")
    log(f"TURBO_KERNEL={kernel}: crc_ok {int(out['crc_ok'].sum())}/{BATCH}, bits "
        f"equal, launches {counts}")
    return counts


def time_paths(cfg, rx, bits, card: str) -> dict[str, float]:
    """Best of PATH_REPS decodes under each TURBO_KERNEL, the paths taken in
    turn in every round so that host noise falls on all of them alike.
    Returns each path's best time in seconds."""
    times = {kernel: [] for kernel in PATH_KERNELS}
    for _ in range(PATH_REPS):
        for kernel in PATH_KERNELS:
            os.environ["TURBO_KERNEL"] = kernel
            t, _, out = timed_decodes(cfg, rx, 1)
            check_exact(out["crc_ok"], out["bits"], bits, f"TURBO_KERNEL={kernel} (timed)")
            times[kernel] += t
    for kernel, t in times.items():
        log(f"[{card}] TURBO_KERNEL={kernel}: decode of {BATCH} subframes best of "
            f"{PATH_REPS} {min(t) * 1e3:.2f} ms ({', '.join(f'{x * 1e3:.2f}' for x in t)})"
            f" = {BATCH / min(t):.1f} subframes/s")
    return {kernel: min(t) for kernel, t in times.items()}


def mimo_lane(dev, gen, card: str) -> dict[str, int]:
    """TM4 2x2, two codewords of 100 PRB / 64QAM / TBS 75376 at pmi 2,
    through the fixed channel at 30 dB, decoded with the default kernel."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch, pdsch_mimo

    os.environ["TURBO_KERNEL"] = "v9"
    mcfg = pdsch_mimo.PdschMimoConfig(
        cell=grid.CellConfig(nof_prb=100, cell_id=123, cfi=1, nof_ports=2),
        rnti=0x1234, subframe=4, mod0="64qam", tbs0=75376, mod1="64qam", tbs1=75376,
        tm="tm4", pmi=MIMO_PMI)
    tbs = [torch.randint(0, 2, (MIMO_BATCH, mcfg.tbs0), generator=gen, device=dev,
                         dtype=torch.int8) for _ in range(2)]
    tx = pdsch.add_crs(mcfg.cw[0], pdsch_mimo.encode(mcfg, *tbs))
    hmat = torch.tensor(MIMO_H, dtype=torch.complex64, device=dev)
    rx = awgn.awgn(torch.einsum("rt,btsk->brsk", hmat, tx), 10 ** (-SNR_DB / 10),
                   generator=gen)
    reset_counts()
    out = pdsch_mimo.decode(mcfg, rx, n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    for q in (0, 1):
        check_exact(out[f"crc_ok{q}"], out[f"bits{q}"], tbs[q], f"TM4 codeword {q}")
    if not counts["map_fused16"]:
        raise AssertionError(f"the TM4 lane launched no turbo kernel: {counts}")
    times, _, out = timed_decodes(mcfg, rx, PATH_REPS, decode=pdsch_mimo.decode)
    for q in (0, 1):
        check_exact(out[f"crc_ok{q}"], out[f"bits{q}"], tbs[q], f"TM4 codeword {q} (timed)")
    log(f"[{card}] TM4 2x2 pmi {MIMO_PMI}, batch {MIMO_BATCH} x 2 codewords, "
        f"{SNR_DB} dB: crc_ok and bits exact on both, launches {counts}, best of "
        f"{PATH_REPS} {min(times) * 1e3:.2f} ms "
        f"({', '.join(f'{t * 1e3:.2f}' for t in times)}) = "
        f"{MIMO_BATCH / min(times):.1f} subframes/s")
    profile_decode(mcfg, rx, min(times), card, decode=pdsch_mimo.decode)
    return counts


def mcs23_path(dev, gen, card: str, kern: dict) -> dict:
    """The default route at L ≡ 2 (mod 4): 100 PRB, 64QAM, MCS 23 (TBS 51024:
    9 code blocks of K = 5696, window L = 178), BATCH subframes at SNR_DB,
    decoded under the default TURBO_KERNEL, which turns v9 into v4 at this L
    and runs ``map_windowed``.  With the counts at 0: exact, and only
    ``map_windowed`` launched.  Logs its launches, kernel ms (``kern``, the
    MCS 23 shape timed in check_kernels) and the decode's host and device
    time.  Returns the default_route entry of turbo_map's kernels line."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch
    from srsran_4g_tpu_torch.ops import turbo

    os.environ.pop("TURBO_KERNEL", None)
    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=100, cell_id=123, cfi=1),
                            rnti=0x1234, subframe=4, mod="64qam", tbs=MCS23_TBS)
    grp = cfg.plan.groups[0]
    l_win = turbo.window_length(grp.K, 208, 32)
    if ((len(cfg.plan.groups), grp.count, grp.K, l_win) != (1, 9, MCS23_K, MCS23_L)
            or turbo.kernel_route("v9", l_win, 32) != "v4"):
        raise AssertionError(f"MCS 23: segmentation {cfg.plan}, window {l_win}: not 9 CBs "
                             f"of K={MCS23_K} at L={MCS23_L} on the v4 route")
    bits = torch.randint(0, 2, (BATCH, cfg.tbs), generator=gen, device=dev,
                         dtype=torch.int8)
    rx = awgn.awgn(pdsch.add_crs(cfg, pdsch.encode(cfg, bits)),
                   awgn.snr_to_noise_var(SNR_DB), generator=gen)
    torch.cuda.synchronize()
    reset_counts()
    out = pdsch.decode(cfg, rx, n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_exact(out["crc_ok"], out["bits"], bits, "MCS 23 default route")
    moved = {name for name, n in counts.items() if n}
    if moved != {"map_windowed"}:
        raise AssertionError(f"the MCS 23 default route launched {counts}, expected only "
                             f"map_windowed")
    times, _, out = timed_decodes(cfg, rx, PATH_REPS)
    check_exact(out["crc_ok"], out["bits"], bits, "MCS 23 default route (timed)")
    b = BATCH * grp.count
    nbytes, adds, maxes = work("map_windowed", b, MCS23_K, MCS23_L, 32)
    bound_ms, bound_by = bound(nbytes, adds, maxes, "f32")
    ms = kern["mcs23"]["turbo_map"]["ms"]
    log(f"MCS 23 default route: 100 PRB 64QAM TBS {cfg.tbs}, {grp.count} CBs of K={grp.K}, "
        f"L={l_win} (N={b * (grp.K // l_win)}), batch {BATCH}, {SNR_DB} dB: crc_ok "
        f"{int(out['crc_ok'].sum())}/{BATCH}, bits equal, launches {counts}")
    log(f"[{card}] MCS 23 default route: decode best of {PATH_REPS} "
        f"{min(times) * 1e3:.2f} ms ({', '.join(f'{t * 1e3:.2f}' for t in times)}) = "
        f"{BATCH / min(times):.1f} subframes/s; map_windowed {counts['map_windowed']} x "
        f"{ms:.4f} ms (map_v3 at this shape {kern['mcs23']['map_v3']['ms']:.4f} ms), bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    prof = profile_decode(cfg, rx, min(times), card, turbo="windowed_kernel")
    return dict(path="pdsch.decode, 100 PRB 64QAM MCS 23 (TBS 51024), default TURBO_KERNEL",
                shapes=dict(blocks=b, K=MCS23_K, L=MCS23_L, T=32,
                            lanes=b * (MCS23_K // MCS23_L)),
                launches=counts["map_windowed"], ms=ms,
                plain_ms=kern["mcs23"]["turbo_map"]["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, decode_ms=min(times) * 1e3,
                decode_device_ms=prof[0] if prof else None,
                map_windowed_device_ms=prof[1] if prof else None)


def impair(dev, gen, sf: torch.Tensor, cfo_max: float, symbol_sz: int):
    """Captures of the subframes ``sf`` (B, sf_len), each after a random lead
    of 0..DL_LEAD_MAX samples and before a tail of at least DL_TAIL, with a
    random phase, a CFO uniform in +-cfo_max subcarriers and AWGN at SNR_DB.
    Returns (captures (B, n) complex64, lead (B,), cfo (B,))."""
    from srsran_4g_tpu_torch.channel import awgn

    b, sf_len = sf.shape
    n = DL_LEAD_MAX + sf_len + DL_TAIL
    lead = torch.randint(0, DL_LEAD_MAX + 1, (b,), generator=gen, device=dev)
    gain = torch.polar(torch.ones(b, device=dev),
                       2 * np.pi * torch.rand(b, generator=gen, device=dev))
    cap = torch.zeros((b, n), dtype=torch.complex64, device=dev)
    cap.scatter_(1, lead[:, None] + torch.arange(sf_len, device=dev), sf * gain[:, None])
    cfo = (2 * torch.rand(b, generator=gen, device=dev) - 1) * cfo_max
    phase = 2 * np.pi * cfo.double()[:, None] * torch.arange(n, device=dev) / symbol_sz
    cap = cap * torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
    return (awgn.awgn(cap, awgn.snr_to_noise_var(SNR_DB, device=dev), generator=gen),
            lead, cfo)


def dl_captures(dev, gen, cfg, cfo_max: float):
    """DL-from-samples traffic: BATCH captures of one subframe of ``cfg``
    (``impair``).  Returns (captures (B, n) complex64, sent bits, lead (B,),
    cfo (B,))."""
    from srsran_4g_tpu_torch.models import enb_dl
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig

    bits = torch.randint(0, 2, (BATCH, cfg.tbs), generator=gen, device=dev,
                         dtype=torch.int8)
    sf = enb_dl.subframe_to_samples(cfg.cell, enb_dl.assemble_subframe(cfg, bits))
    cap, lead, cfo = impair(dev, gen, sf, cfo_max, OfdmConfig(nof_prb=cfg.cell.nof_prb).symbol_sz)
    return cap, bits, lead, cfo


def profile_search(search, card: str, reps: int = 3) -> None:
    """Device time of the cell search split into the FFTs (cuFFT kernels)
    and the rest, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            search()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if total <= 0:
        log(f"[{card}] profiler saw no device time: cell search split not measured")
        return
    fft = sum(e.self_device_time_total for e in kernels if "fft" in e.key.lower()) / 1e3 / reps
    log(f"[{card}] cell search device time {total:.3f} ms per search of {BATCH}: FFT "
        f"{fft:.3f} ms ({fft / total:.3f}), the rest {total - fft:.3f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count // reps:<4d} "
            f"{e.key[:90]}")


def dl_path(dev, gen, card: str) -> dict[str, int]:
    """The downlink from samples at 100 PRB, under the default TURBO_KERNEL:
    blind cell search of BATCH captures with the CFO from the CP (cell id,
    frame phase and timing offset exact, |CFO error| < DL_CFO_TOL on every
    capture), ``pdsch.decode`` of the grid it returns and
    ``receive_pdsch_subframe`` of the aligned samples, every CRC and bit
    checked.  Returns the launch counts of the search and decode."""
    from srsran_4g_tpu_torch.models import grid, pdsch, ue_dl
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, _symbol_offsets

    os.environ.pop("TURBO_KERNEL", None)
    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=100, cell_id=DL_CELL_ID, cfi=1),
                            rnti=0x1234, subframe=DL_SUBFRAME, mod="64qam", tbs=75376)
    plan = [(g.count, g.K) for g in cfg.plan.groups]
    if plan != [(13, 5824)]:
        log(f"DL path: segmentation {plan} (not 13 CBs of K=5824)")
    ocfg = OfdmConfig(nof_prb=100)
    t0 = time.perf_counter()
    cap, bits, lead, cfo = dl_captures(dev, gen, cfg, DL_CFO)
    torch.cuda.synchronize()
    log(f"DL path: {BATCH} captures of {cap.shape[-1]} samples (lead 0..{DL_LEAD_MAX}, "
        f"sf_len {ocfg.sf_len}, tail >= {DL_TAIL}), cell {DL_CELL_ID}, subframe "
        f"{DL_SUBFRAME}, CFO within +-{DL_CFO}, {SNR_DB} dB: made in "
        f"{time.perf_counter() - t0:.2f} s (first call)")

    def search():
        return ue_dl.cell_search(cap, 100)

    def search_decode():
        return pdsch.decode(cfg, search()["grid"], n_iter=N_ITER)

    reset_counts()
    found = search()
    out = pdsch.decode(cfg, found["grid"], n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    off_err = found["offset"] - (lead + int(_symbol_offsets(ocfg)[6]))
    cfo_err = float((found["cfo"] - cfo).abs().max())
    checks = {"cell_id": bool((found["cell_id"] == DL_CELL_ID).all()),
              "phase 1": bool((found["phase"] == 1).all()),
              "offset exact": bool((off_err == 0).all()),
              f"|CFO error| < {DL_CFO_TOL}": cfo_err < DL_CFO_TOL}
    if not all(checks.values()):
        raise AssertionError(f"DL cell search: {checks}; cell ids "
                             f"{found['cell_id'].unique().tolist()}, offset errors "
                             f"{off_err.unique().tolist()}, max |CFO error| {cfo_err}")
    check_exact(out["crc_ok"], out["bits"], bits, "DL from samples")
    moved = {name for name, n in counts.items() if n}
    if moved != set(PATH_KERNELS["v9"]):
        raise AssertionError(f"the DL path launched {counts}, expected only "
                             f"{PATH_KERNELS['v9']}")
    rx = ue_dl.receive_pdsch_subframe(cfg, found["sf_samples"], n_iter=N_ITER)
    check_exact(rx["crc_ok"], rx["bits"], bits, "receive_pdsch_subframe on the aligned samples")
    log(f"DL path: cell_id {DL_CELL_ID}, phase 1 and offset exact on "
        f"all {BATCH}, max |CFO error| {cfo_err:.6f}; decode of the "
        f"search grid: crc_ok {int(out['crc_ok'].sum())}/{BATCH}, bits equal; "
        f"receive_pdsch_subframe on the aligned samples exact; launches {counts}")

    t_search, t_all = [], []
    for _ in range(PATH_REPS):
        for fn, acc in ((search, t_search), (search_decode, t_all)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)
        check_exact(res["crc_ok"], res["bits"], bits, "DL from samples (timed)")
    log(f"[{card}] DL cell search of {BATCH} captures: best of {PATH_REPS} "
        f"{min(t_search) * 1e3:.2f} ms ({', '.join(f'{x * 1e3:.2f}' for x in t_search)})")
    log(f"[{card}] DL search + decode of {BATCH} captures: best of {PATH_REPS} "
        f"{min(t_all) * 1e3:.2f} ms ({', '.join(f'{x * 1e3:.2f}' for x in t_all)}) = "
        f"{BATCH / min(t_all):.1f} subframes/s")
    profile_search(search, card)
    return counts


def probes_phase(card: str) -> list[dict]:
    """The probes' path: every H100 micro-benchmark at its TPU probe's
    shapes through the tools' ``measure`` entry points (each kernel's ms from
    CUDA events), the launch counts of that run, then each kernel against
    its plain version on the same inputs (f32 atol 1e-3, bf16 the 16-bit
    bars).  Returns the probes' entries of the kernels line."""
    from srsran_4g_tpu_torch.ops.cuda import probes
    from srsran_4g_tpu_torch.tools import host_ms
    from srsran_4g_tpu_torch.tools import turbo_probe2 as p2
    from srsran_4g_tpu_torch.tools import turbo_probe3 as p3
    from srsran_4g_tpu_torch.tools import turbo_probe6 as p6
    from srsran_4g_tpu_torch.tools import turbo_probe7 as p7

    reset_counts()
    log(f"[{card}] probe 2 (N={p2.N} lanes, {p2.N_STEPS} radix-4 steps):")
    r2 = p2.measure(probes.PROBE2_VARIANTS)
    log(f"[{card}] probe 3 (N={p3.N} lanes):")
    r3 = p3.measure()
    log(f"[{card}] probe 6 (N={p6.N} lanes, {p6.STEPS} radix-4 steps):")
    r6 = p6.measure()
    log(f"[{card}] probe 7 at the TPU probe's default, then filling the card:")
    r7 = p7.measure()
    r7_full = p7.measure(tile_c=P7_FULL_TILE_C)
    torch.cuda.synchronize()
    counts = launch_counts(probes.KERNELS)
    if not all(counts.values()):
        raise AssertionError(f"the probes' run launched no kernel for "
                             f"{[k for k, n in counts.items() if not n]}")
    log(f"probe launches: {counts}")

    # ---- each kernel against its plain version (launches not counted) ----
    def check(name, kernel, plain, bf16=False):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        if name.startswith("probe2_") or name == "probe3_empty":
            pairs = [(g[0], w[0]) for g, w in pairs]  # row 0 is the output
        err = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
        if not np.isfinite(err):
            raise AssertionError(f"{name} kernel vs plain: not finite")
        # the outputs must be far from 0 for the tolerance to mean anything
        size = min(float(w.float().abs().mean()) for _, w in pairs)
        if size < 100 * ATOL:
            raise AssertionError(f"{name}: plain output's mean |value| {size} is within "
                                 f"100x of the tolerance {ATOL}")
        if bf16:
            # the 16-bit bars, and, since kernel and plain version round the
            # same bf16 ops in the same order, equality
            mean = max(float((g.float() - w.float()).abs().mean()) for g, w in pairs)
            if err > ATOL16 or mean >= MEAN16 or not all(
                    torch.equal(g > 0, w > 0) for g, w in pairs):
                raise AssertionError(f"{name} kernel vs plain: max |diff| {err}, "
                                     f"mean {mean}, or a sign differs")
            if err:
                raise AssertionError(f"{name} kernel vs plain: max |diff| {err}, not equal")
        elif err > ATOL:
            raise AssertionError(f"{name} kernel vs plain: max |diff| {err} > {ATOL}")
        log(f"check {name}: max |diff| {err:.3g}, plain mean |value| {size:.4g}")
        plain_ms = host_ms(plain)
        return err, plain_ms

    res = {}
    g, a0 = p2.inputs()
    for v in probes.PROBE2_VARIANTS:
        res[f"probe2_{v}"] = dict(ms=r2[v], n=p2.N, n_steps=p2.N_STEPS, checks=check(
            f"probe2_{v}", lambda: getattr(p2, v)(g, a0),
            lambda: probes.probe2_ref(v, g, g, a0, p2.N_STEPS, p2.WIN, p2.WIN // 2)))
    ins = p3.inputs()
    err3 = max(check("probe3_empty", lambda: p3.empty(ins, threads=t, scratch=sc),
                     lambda: probes.probe_empty_ref(ins, 112))[0]
               for t in p3.THREADS for sc in (False, True))
    res["probe3_empty"] = dict(ms=r3["empty threads=1024"], n=p3.N,
                               checks=(err3, host_ms(lambda: probes.probe_empty_ref(ins, 112))))
    x = p6.inputs()
    # random start metrics: from p6.inputs' zeros the skeleton's output is 0
    rng = np.random.default_rng(SEED)

    def metrics(rows, n, dtype):
        x = rng.normal(0, 1, (rows, n)).astype(np.float32)
        return torch.as_tensor(x, device="cuda").to(dtype)

    a6, b6 = metrics(8, p6.N, torch.float32), metrics(8, p6.N, torch.float32)
    a16, b16 = (metrics(16, p6.N // 2, torch.bfloat16), metrics(16, p6.N // 2, torch.bfloat16))
    res["probe6_full"] = dict(ms=r6["full"], n=p6.N, n_steps=p6.STEPS, checks=check(
        "probe6_full", lambda: p6.full(x["g2s"], x["g2p"], a6, b6),
        lambda: probes.probe6_full_ref(x["g2s"], x["g2p"], a6, b6)))
    res["probe6_skel"] = dict(ms=r6["skel"], n=p6.N, n_steps=p6.STEPS, checks=check(
        "probe6_skel", lambda: p6.skel(a6, b6),
        lambda: probes.probe6_skel_ref(a6, b6, p6.STEPS)))
    res["probe6_bf16"] = dict(ms=r6["bf16"], n=p6.N, n_steps=p6.STEPS, checks=check(
        "probe6_bf16", lambda: p6.bf16(x["g2s16"], x["g2p16"], a16, b16),
        lambda: probes.probe6_bf16_ref(x["g2s16"], x["g2p16"], a16, b16), bf16=True))
    for dt, rows, key in ((torch.float32, 8, "f32"), (torch.bfloat16, 16, "bf16")):
        errs = []
        for tc in (p7.TC, P7_FULL_TILE_C):
            g7, a7 = p7.check_inputs(dt, rows, tc)  # lanes differ, unlike p7.inputs
            errs.append(check(f"probe7_{key}", lambda: probes.probe7(g7, a7, p7.ITERS),
                              lambda: probes.probe7_ref(g7, a7, p7.ITERS), bf16=key == "bf16"))
        res[f"probe7_{key}"] = dict(
            ms=r7_full[f"{key}_ms"], n=rows * P7_FULL_TILE_C, iters=p7.ITERS,
            checks=(max(e for e, _ in errs), errs[-1][1]),
            gelem_s=r7_full[f"{key}_gelem_s"], ms_tpu_default=r7[f"{key}_ms"],
            gelem_s_tpu_default=r7[f"{key}_gelem_s"])
    log(f"[{card}] probe 7 bf16/f32 element-rate ratio: {r7['ratio']:.3f} at "
        f"{8 * p7.TC} f32 lanes, {r7_full['ratio']:.3f} at {8 * P7_FULL_TILE_C}")
    log(f"[{card}] probe 3: host {r3['host_ms_per_launch'] * 1e3:.2f} us per ctypes "
        f"launch against {r3['device_ms_per_launch'] * 1e3:.2f} us of device time")

    kernels = []
    for name in probes.KERNELS:
        r = res[name]
        nbytes, adds, maxes, kind = probes.work(name, r["n"], n_steps=r.get("n_steps", 0),
                                                iters=r.get("iters", 0))
        bound_ms, bound_by = bound(nbytes, adds, maxes, kind)
        err, plain_ms = r["checks"]
        log(f"[{card}] {name}: {r['ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes} B; {adds} adds + {maxes} maxes {kind}, {op_ms(adds, maxes, kind):.4f} "
            f"ms), {bound_ms / r['ms']:.3f} of the bound; plain "
            f"{plain_ms:.2f} ms, max |diff| {err:.3g}")
        source = "probe_launch.cu" if name == "probe3_empty" else "probe_acs.cu"
        extra = {k: r[k] for k in ("gelem_s", "ms_tpu_default", "gelem_s_tpu_default")
                 if k in r}
        if name == "probe3_empty":
            extra = dict(host_ms_per_launch=r3["host_ms_per_launch"],
                         configs={k: v for k, v in r3.items() if k.startswith("empty")})
        kernels.append(dict(
            name=name, route="cuda", source=f"srsran_4g_tpu_torch/csrc/{source}",
            replaces=probes.REPLACES[name], path="probes", shapes=dict(
                lanes=r["n"], **{k: r[k] for k in ("n_steps", "iters") if k in r}),
            launches=counts[name], max_abs_err=err, ms=r["ms"], plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, library_ms=None, **extra))
    return kernels


def ctrl_traffic(dev, gen):
    """The control path's transmitter: BATCH subframe-0 grids of 100 PRB with
    a MIB, the two DCIs, the granted PDSCH and the two PHICH ACKs, made into
    samples.  Returns (samples (B, sf_len), the PDSCH config, what was sent)."""
    from srsran_4g_tpu_torch.models import dci, enb_dl, grid, pdsch, phich

    cell = grid.CellConfig(nof_prb=100, cell_id=CTRL_CELL_ID, cfi=1)
    cfg = pdsch.PdschConfig(cell=cell, rnti=C_RNTI, subframe=CTRL_SUBFRAME, mod="64qam",
                            tbs=GRANT_TBS)
    rng = np.random.default_rng(SEED)
    sent = dict(mib=rng.integers(0, 2, (BATCH, 24)).astype(np.int8),
                si=rng.integers(0, 2, (BATCH, dci.format1a_len(100))).astype(np.int8),
                acks=[rng.integers(0, 2, BATCH).astype(np.int8) for _ in PHICH_AT])
    sent["c"] = np.stack([dci.pack_1a(dci.Dci1A(
        rb_start=0, l_crbs=100, mcs=GRANT_MCS, harq_pid=int(rng.integers(8)),
        ndi=int(rng.integers(2)), rv=0, tpc=int(rng.integers(4))), 100) for _ in range(BATCH)])
    sent["tb"] = torch.randint(0, 2, (BATCH, GRANT_TBS), generator=gen, device=dev,
                               dtype=torch.int8)
    g = enb_dl.assemble_subframe(cfg, sent["tb"], mib_bits=sent["mib"], frame_idx=0,
                                 dcis=[(sent["c"], C_RNTI, *C_DCI_AT),
                                       (sent["si"], SI_RNTI, *SI_DCI_AT)])
    for (group, nseq), ack in zip(PHICH_AT, sent["acks"]):
        g = phich.put_into_grid(cell, g, phich.encode(
            cell, torch.as_tensor(ack, device=dev), group, nseq, CTRL_SUBFRAME), group)
    return enb_dl.subframe_to_samples(cell, g), cfg, sent


def profile_window(fn, card: str, what: str, host_s: float, reps: int = 3,
                   cpu_ops: bool = True) -> tuple[float, float] | None:
    """Device time, kernel count and idle share of fn() from torch.profiler
    over ``reps`` calls, against the unprofiled host time ``host_s``; returns
    (device ms, kernels) a call, or None when the profiler saw no device
    time.  ``cpu_ops=False`` records the kernels alone: the host ops' events
    of a call of tens of thousands of kernels take the profiler seconds to
    aggregate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu_ops else [])
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if busy_ms <= 0:
        log(f"[{card}] profiler saw no device time: {what} idle share not measured")
        return None
    n_kernels = sum(e.count for e in kernels) / reps
    log(f"[{card}] {what}: device time {busy_ms:.3f} ms in {n_kernels:.0f} kernels; idle "
        f"share {1 - busy_ms / (host_s * 1e3):.3f} of the unprofiled {host_s * 1e3:.2f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count // reps:<5d} "
            f"{e.key[:90]}")
    return busy_ms, n_kernels


def control_path(dev, gen, card: str) -> dict[str, int]:
    """The DL control path from samples at 100 PRB under the default
    TURBO_KERNEL, every field checked on every capture: cell search, channel
    estimate, PCFICH, PBCH, PHICH, PDCCH blind search for both RNTIs and an
    unsent one, the 1A grant through ``ra``, then the PDSCH it grants.
    Returns the launch counts of the checked run."""
    from srsran_4g_tpu_torch.models import (chest, dci, pbch, pcfich, pdcch, pdsch, phich, ra,
                                            ue_dl)
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, _symbol_offsets

    os.environ.pop("TURBO_KERNEL", None)
    t0 = time.perf_counter()
    sf, cfg, sent = ctrl_traffic(dev, gen)
    cap, lead, cfo = impair(dev, gen, sf, DL_CFO, OfdmConfig(nof_prb=100).symbol_sz)
    torch.cuda.synchronize()
    cell, n_bits = cfg.cell, dci.format1a_len(100)
    cands = {r: pdcch.search_space_candidates(cell, 1, r, CTRL_SUBFRAME)
             for r in (C_RNTI, SI_RNTI)}
    log(f"control path: {BATCH} captures of 100 PRB subframe {CTRL_SUBFRAME}, cell "
        f"{CTRL_CELL_ID}, CFI 1, {pdcch.cce_re_indices(cell, 1).shape[0]} CCEs, "
        f"format 1A {n_bits} bits; C-RNTI {C_RNTI:#06x} at {C_DCI_AT} (candidate "
        f"{cands[C_RNTI].index(C_DCI_AT)} of {len(cands[C_RNTI])}), SI-RNTI at {SI_DCI_AT} "
        f"(candidate {cands[SI_RNTI].index(SI_DCI_AT)} of {len(cands[SI_RNTI])}); PHICH "
        f"{PHICH_AT}; made in {time.perf_counter() - t0:.2f} s (first call)")

    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.setdefault(name, []).append(time.perf_counter() - t)
        return out

    def receive():
        found = stage("cell_search", lambda: ue_dl.cell_search(cap, 100))
        grid_rx = found["grid"]
        est = stage("chest", lambda: chest.estimate(chest.ChestConfig(cell=cell), grid_rx,
                                                    CTRL_SUBFRAME))
        h, nv = est["h"], est["noise_var"]
        out = dict(found=found)
        out["cfi"] = stage("pcfich", lambda: pcfich.decode(cell, grid_rx, h, nv,
                                                           CTRL_SUBFRAME)["cfi"])
        out["mib"] = stage("pbch", lambda: pbch.decode(cell, grid_rx, h, nv, frame_idx=0))
        out["phich"] = stage("phich", lambda: [phich.decode(
            cell, grid_rx, h, nv, group, nseq, CTRL_SUBFRAME) for group, nseq in PHICH_AT])
        out["pdcch"] = stage("pdcch", lambda: {r: pdcch.blind_decode(
            cell, 1, CTRL_SUBFRAME, grid_rx, h, nv, rnti=r, dci_len=n_bits)
            for r in (C_RNTI, SI_RNTI, UNSENT_RNTI)})

        def grant():
            grants = [dci.unpack_1a(p, 100) for p in out["pdcch"][C_RNTI]["dci"].cpu().numpy()]
            g = grants[0]
            return grants, pdsch.PdschConfig(
                cell=cell, rnti=C_RNTI, subframe=CTRL_SUBFRAME, mod=ra.dl_mcs_to_mod(g.mcs),
                tbs=ra.dl_tbs(g.mcs, g.l_crbs), rv=g.rv,
                prb_alloc=tuple(range(g.rb_start, g.rb_start + g.l_crbs)))
        out["grants"], out["cfg"] = stage("dci_ra", grant)
        out["pdsch"] = stage("pdsch", lambda: pdsch.decode(out["cfg"], grid_rx, h=h,
                                                           noise_var=nv, n_iter=N_ITER))
        return out

    reset_counts()
    out = receive()
    counts = launch_counts()
    found = out["found"]
    off_err = found["offset"] - (lead + int(_symbol_offsets(OfdmConfig(nof_prb=100))[6]))
    cfo_err = float((found["cfo"] - cfo).abs().max())
    pd = out["pdcch"]
    c_idx, si_idx = cands[C_RNTI].index(C_DCI_AT), cands[SI_RNTI].index(SI_DCI_AT)
    grant = out["grants"][0]
    checks = {
        "cell_id": bool((found["cell_id"] == CTRL_CELL_ID).all()),
        "phase 0": bool((found["phase"] == 0).all()),
        "offset exact": bool((off_err == 0).all()),
        f"|CFO error| < {DL_CFO_TOL}": cfo_err < DL_CFO_TOL,
        "CFI 1": bool((out["cfi"] == 1).all()),
        "MIB crc_ok": bool(out["mib"]["crc_ok"].all()),
        "MIB n_ports 1": bool((out["mib"]["n_ports"] == 1).all()),
        "MIB bits": np.array_equal(out["mib"]["mib"].cpu().numpy(), sent["mib"]),
        "PHICH ACKs": all(np.array_equal(r["ack"].cpu().numpy(), a)
                          for r, a in zip(out["phich"], sent["acks"])),
        "C-RNTI DCI found": bool(pd[C_RNTI]["found"].all()),
        "C-RNTI DCI at its candidate": bool(pd[C_RNTI]["ok_per_candidate"][:, c_idx].all()),
        "C-RNTI DCI bits": np.array_equal(pd[C_RNTI]["dci"].cpu().numpy(), sent["c"]),
        "SI-RNTI DCI found": bool(pd[SI_RNTI]["found"].all()),
        "SI-RNTI DCI at its candidate": bool(pd[SI_RNTI]["ok_per_candidate"][:, si_idx].all()),
        "SI-RNTI DCI bits": np.array_equal(pd[SI_RNTI]["dci"].cpu().numpy(), sent["si"]),
        "unsent RNTI not found": not bool(pd[UNSENT_RNTI]["found"].any()),
        "grant 100 PRB / 64QAM / TBS 75376": (
            len({(g.rb_start, g.l_crbs, g.mcs, g.rv) for g in out["grants"]}) == 1
            and (grant.rb_start, grant.l_crbs) == (0, 100)
            and out["cfg"].mod == "64qam" and out["cfg"].tbs == GRANT_TBS),
    }
    if not all(checks.values()):
        raise AssertionError(f"control path: {checks}; offset errors "
                             f"{off_err.unique().tolist()}, max |CFO error| {cfo_err}")
    check_exact(out["pdsch"]["crc_ok"], out["pdsch"]["bits"], sent["tb"],
                "control path: the granted PDSCH")
    moved = {name for name, n in counts.items() if n}
    if moved != set(PATH_KERNELS["v9"]):
        raise AssertionError(f"the control path launched {counts}, expected only "
                             f"{PATH_KERNELS['v9']}")
    reported = {r: sorted(set(pd[r]["candidate"].tolist())) for r in (C_RNTI, SI_RNTI)}
    echoes = {r: int(pd[r]["ok_per_candidate"].sum(dim=1).max()) for r in (C_RNTI, SI_RNTI)}
    log(f"control path: every check exact on {BATCH}/{BATCH} ({', '.join(checks)}, PDSCH "
        f"crc_ok and bits); first-match candidates {reported} (sent at {c_idx} and "
        f"{si_idx}), at most {echoes} candidates pass per capture; launches {counts}")

    stages.clear()
    t_all = []
    for _ in range(PATH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = receive()
        torch.cuda.synchronize()
        t_all.append(time.perf_counter() - t0)
        check_exact(res["pdsch"]["crc_ok"], res["pdsch"]["bits"], sent["tb"],
                    "control path (timed)")
    log(f"[{card}] control path stages, host clock, best of {PATH_REPS} (ms): " + ", ".join(
        f"{k} {min(v) * 1e3:.2f}" for k, v in stages.items()))
    log(f"[{card}] control path, search to PDSCH bits, {BATCH} captures: best of "
        f"{PATH_REPS} {min(t_all) * 1e3:.2f} ms "
        f"({', '.join(f'{x * 1e3:.2f}' for x in t_all)}) = {BATCH / min(t_all):.1f} "
        f"decoded subframes/s")
    grid_rx = res["found"]["grid"]
    est = chest.estimate(chest.ChestConfig(cell=cell), grid_rx, CTRL_SUBFRAME)
    h, nv = est["h"], est["noise_var"]

    def control_stages():
        pcfich.decode(cell, grid_rx, h, nv, CTRL_SUBFRAME)
        pbch.decode(cell, grid_rx, h, nv, frame_idx=0)
        for group, nseq in PHICH_AT:
            phich.decode(cell, grid_rx, h, nv, group, nseq, CTRL_SUBFRAME)
        for r in (C_RNTI, SI_RNTI, UNSENT_RNTI):
            pdcch.blind_decode(cell, 1, CTRL_SUBFRAME, grid_rx, h, nv, rnti=r, dci_len=n_bits)

    ctrl_s = sum(min(stages[k]) for k in ("pcfich", "pbch", "phich", "pdcch"))
    profile_window(control_stages, card, "control stages (PCFICH, PBCH, PHICH, 3 blind "
                   "searches)", ctrl_s)
    return counts


# ---- the eNB uplink receiver, PMCH and the UE around the downlink ---------------


def ul_cfgs():
    """The uplink phase's configs: the 100 PRB cell, the PUSCH of 96 PRB with
    UCI, the four PUCCH UEs at the band edges and the SRS."""
    from srsran_4g_tpu_torch.models import grid, pucch, pusch, srs, uci

    cell = grid.CellConfig(nof_prb=100, cell_id=UL_CELL_ID, cfi=1)
    pcfg = pusch.PuschConfig(cell=cell, rnti=0x0046, subframe=UL_SUBFRAME, mod="64qam",
                             tbs=UL_TBS, prb_start=UL_PRB_START, nof_prb_alloc=UL_NOF_PRB,
                             uci=uci.UciCfg(**UL_UCI))
    pucchs = {name: pucch.PucchConfig(cell=cell, subframe=UL_SUBFRAME, **kw)
              for name, kw in UL_PUCCH.items()}
    scfg = srs.SrsConfig(cell=cell, n_prb_srs=UL_NOF_PRB, prb_offset=UL_PRB_START)
    return pcfg, pucchs, scfg


def pucch_prbs(cfg, name: str) -> tuple[int, int]:
    from srsran_4g_tpu_torch.models import pucch

    prb = pucch.pucch3_prb if name == "3" else pucch.pucch_prb
    return tuple(prb(cfg, 2 * cfg.subframe + s) for s in (0, 1))


def ul_traffic(dev, gen, batch: int):
    """``batch`` UL subframes of the 100 PRB cell: the PUSCH (random TBs,
    ACK and CQI bits) and the four PUCCH UEs (format 1a, 2 with 11 CQI bits,
    2b with 11 CQI and 2 ACK bits, 3 with 11 ACK bits), summed into one grid
    each, then AWGN at SNR_DB.  Returns (rx grid, what was sent)."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import pucch, pusch

    pcfg, pucchs, _ = ul_cfgs()

    def bits(n):
        return torch.randint(0, 2, (batch, n), generator=gen, device=dev, dtype=torch.int8)

    sent = dict(tb=bits(UL_TBS), ack=bits(UL_UCI["o_ack"]), cqi=bits(UL_UCI["o_cqi"]),
                f1a=bits(1), f2_cqi=bits(11), f2b_cqi=bits(11), f2b_ack=bits(2), f3=bits(11))
    g = pusch.encode(pcfg, sent["tb"], cqi_bits=sent["cqi"], ack_bits=sent["ack"])
    g = g + pucch.encode_format1(pucchs["1a"], sent["f1a"])
    g = g + pucch.encode_format2(pucchs["2"], sent["f2_cqi"])
    g = g + pucch.encode_format2(pucchs["2b"], sent["f2b_cqi"], sent["f2b_ack"])
    g = g + pucch.encode_format3(pucchs["3"], sent["f3"])
    return awgn.awgn(g, awgn.snr_to_noise_var(SNR_DB, device=dev), generator=gen), sent


def ul_receive(rx):
    """The eNB's uplink receive of one batch: the PUSCH with its UCI, then
    the four PUCCH UEs."""
    from srsran_4g_tpu_torch.models import pucch, pusch

    pcfg, pucchs, _ = ul_cfgs()
    return dict(pusch=pusch.decode(pcfg, rx, n_iter=N_ITER),
                f1a=pucch.decode_format1(pucchs["1a"], rx, 1),
                f2=pucch.decode_format2(pucchs["2"], rx, 11),
                f2b=pucch.decode_format2(pucchs["2b"], rx, 11, nof_ack=2),
                f3=pucch.decode_format3(pucchs["3"], rx, 11))


def check_ul(out, sent, what: str) -> dict[str, bool]:
    p = out["pusch"]
    checks = {"PUSCH crc_ok": bool(p["crc_ok"].all()),
              "PUSCH bits": torch.equal(p["bits"], sent["tb"]),
              "ACK bits": torch.equal(p["ack_bits"], sent["ack"]),
              "CQI crc_ok": bool(p["cqi_ok"].all()),
              "CQI bits": torch.equal(p["cqi_bits"], sent["cqi"]),
              "PUCCH 1a bits": torch.equal(out["f1a"]["bits"], sent["f1a"]),
              "PUCCH 1a detected": bool(out["f1a"]["detected"].all()),
              "PUCCH 2 CQI bits": torch.equal(out["f2"]["bits"], sent["f2_cqi"]),
              "PUCCH 2b CQI bits": torch.equal(out["f2b"]["bits"], sent["f2b_cqi"]),
              "PUCCH 2b ACK bits": torch.equal(out["f2b"]["ack_bits"], sent["f2b_ack"]),
              "PUCCH 3 bits": torch.equal(out["f3"]["bits"], sent["f3"])}
    if not all(checks.values()):
        raise AssertionError(f"{what}: {checks}")
    return checks


def srs_sounding(dev, gen, batch: int) -> tuple[float, object]:
    """``batch`` SRS grids over UL_NOF_PRB PRB through a two-tap channel of
    random complex gains per capture (a second tap SRS_TAP_DELAY samples of
    2048 later, -10 dB) and AWGN at SNR_DB; the estimate against the channel
    applied on the sounded subcarriers.  Returns (normalised MSE, the
    estimate call)."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import srs

    _, _, scfg = ul_cfgs()
    cell = scfg.cell
    g = srs.put_srs(scfg, torch.zeros((batch, cell.nsymb, cell.nre), dtype=torch.complex64,
                                      device=dev), UL_SUBFRAME)
    taps = torch.randn((batch, 2), generator=gen, device=dev, dtype=torch.complex64)
    taps[:, 1] *= 10 ** (-10 / 20)
    k = torch.arange(cell.nre, device=dev)
    ramp = torch.polar(torch.ones(cell.nre, device=dev), -2 * np.pi * SRS_TAP_DELAY * k / 2048)
    chan = taps[:, :1] + taps[:, 1:] * ramp  # (B, nre)
    rx = awgn.awgn(g * chan[:, None, :], awgn.snr_to_noise_var(SNR_DB, device=dev),
                   generator=gen)

    def estimate():
        return srs.estimate_srs(scfg, rx, UL_SUBFRAME)

    est = estimate()
    ks = torch.as_tensor(srs.srs_subcarriers(scfg), device=dev)
    want = chan[:, ks]
    nmse = float(((est["h"] - want).abs() ** 2).mean() / (want.abs() ** 2).mean())
    if not (est["h"].shape == want.shape and torch.isfinite(est["h"]).all()):
        raise AssertionError("SRS estimate: not finite or of the wrong shape")
    return nmse, estimate


def prach_captures(dev, gen, cfg, n_sent: int, n_noise: int):
    """``n_sent`` PRACH captures of cp+seq samples, each with one preamble at
    a seeded index and a seeded integer delay of 0..12·PRACH_MAX_BIN samples
    (inside its zero-correlation zone), then ``n_noise`` captures of noise
    alone; AWGN at SNR_DB against the preamble's mean sample power.  Returns
    (captures, indices, delays)."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import prach

    n = cfg.cp_len + cfg.seq_len_samples
    pre = torch.stack([prach.generate(cfg, i, device=dev) for i in range(64)])  # (64, n)
    idx = torch.randint(0, 64, (n_sent,), generator=gen, device=dev)
    delay = torch.randint(0, 12 * PRACH_MAX_BIN + 1, (n_sent,), generator=gen, device=dev)
    t = torch.arange(n, device=dev) - delay[:, None]
    cap = torch.where(t >= 0, pre[idx[:, None], t.clamp(min=0)], 0)
    cap = torch.cat([cap, cap.new_zeros((n_noise, n))])
    power = float((pre.abs() ** 2).mean())
    return (awgn.awgn(cap, awgn.snr_to_noise_var(SNR_DB, signal_power=power, device=dev),
                      generator=gen), idx, delay)


def prach_expected_delay(cfg, idx: torch.Tensor, delay: torch.Tensor):
    """The delay the detector reads for a noise-free capture: its windows
    start at rounded IFFT bins, and a delay moves the peak by delay·2048/seq
    bins, so the reading is seq/2048·(the nearest bin to the peak − the
    window's start).  Returns (expected reading, whether the peak sits
    within 0.1 bin of the midpoint of two bins, where noise picks either)."""
    from srsran_4g_tpu_torch.models import prach

    scale = prach.NFFT_DETECT / prach.N_ZC
    step = cfg.seq_len_samples / prach.NFFT_DETECT
    start = torch.as_tensor([((prach.N_ZC - s) % prach.N_ZC) * scale
                             for _, s in cfg.preamble_plan()], dtype=torch.float64,
                            device=idx.device)[idx]
    peak = start + delay.double() / step
    near_half = ((peak - peak.floor()) - 0.5).abs() < 0.1
    return (torch.round(peak) - torch.round(start)) * step, near_half


def ul_path(dev, gen, card: str) -> dict:
    """The eNB uplink receiver at 100 PRB, under the default TURBO_KERNEL:
    BATCH subframes of the PUSCH (96 PRB, 64QAM, TBS 71112, 2 ACK and 20
    long-CQI bits) and the four PUCCH UEs, every bit checked; SRS sounding
    within SRS_NMSE_MAX; PRACH at symbol_sz 2048 (BATCH captures with one
    preamble, PRACH_NOISE captures of noise alone).  Returns map_fused16's
    ul_path entry for the kernels line."""
    from srsran_4g_tpu_torch.models import prach, pucch, pusch
    from srsran_4g_tpu_torch.ops import turbo

    os.environ.pop("TURBO_KERNEL", None)
    pcfg, pucchs, _ = ul_cfgs()
    grp = pcfg.plan.groups[0]
    l_win = turbo.window_length(grp.K, 208, 32)
    if ((len(pcfg.plan.groups), grp.count, grp.K, l_win) != (1, UL_CBS, UL_K, UL_L)
            or turbo.kernel_route("v9", l_win, 32) != "v9"):
        raise AssertionError(f"PUSCH: segmentation {pcfg.plan}, window {l_win}: not "
                             f"{UL_CBS} CBs of K={UL_K} at L={UL_L} on the v9 route")
    occupied = {name: pucch_prbs(c, name) for name, c in pucchs.items()}
    used = [(prb, s) for prbs in occupied.values() for s, prb in enumerate(prbs)]
    if len(set(used)) != len(used) or any(UL_PRB_START <= p < UL_PRB_START + UL_NOF_PRB
                                          for p, _ in used):
        raise AssertionError(f"PUCCH resources overlap each other or the PUSCH: {occupied}")
    plan = pcfg.uci_plan
    t0 = time.perf_counter()
    rx, sent = ul_traffic(dev, gen, BATCH)
    torch.cuda.synchronize()
    log(f"UL path: cell {UL_CELL_ID}, 100 PRB, subframe {UL_SUBFRAME}, batch {BATCH}, "
        f"{SNR_DB} dB; PUSCH PRB {UL_PRB_START}-{UL_PRB_START + UL_NOF_PRB - 1} 64QAM TBS "
        f"{UL_TBS} ({grp.count} CBs of K={grp.K}, L={l_win}), UCI {UL_UCI} (Q'_CQI "
        f"{plan.q_prime_cqi}, Q'_ACK {plan.q_prime_ack}, G_data {plan.g_data}); PUCCH PRBs "
        f"(slot 0, slot 1) {occupied}; made in {time.perf_counter() - t0:.2f} s (first call)")

    reset_counts()
    out = ul_receive(rx)
    torch.cuda.synchronize()
    counts = launch_counts()
    checks = check_ul(out, sent, "UL path")
    if {name for name, n in counts.items() if n} != {"map_fused16"}:
        raise AssertionError(f"the UL path launched {counts}, expected only map_fused16")
    per_decode = counts["map_fused16"]
    log(f"UL path: every check exact on {BATCH}/{BATCH} ({', '.join(checks)}); launches "
        f"{counts}: {per_decode} map_fused16 launches a PUSCH decode")

    nmse, srs_estimate = srs_sounding(dev, gen, BATCH)
    if not nmse < SRS_NMSE_MAX:
        raise AssertionError(f"SRS estimate: normalised MSE {nmse} >= {SRS_NMSE_MAX}")
    log(f"UL path: SRS over {UL_NOF_PRB} PRB, {BATCH} captures through a two-tap channel: "
        f"normalised MSE of the estimate {nmse:.3e} (< {SRS_NMSE_MAX})")

    pr_cfg = prach.PrachConfig(symbol_sz=2048, root_seq_index=PRACH_ROOT,
                               zero_corr_zone=PRACH_ZCZ)
    caps, idx, delay = prach_captures(dev, gen, pr_cfg, BATCH, PRACH_NOISE)
    det = prach.detect(pr_cfg, caps)
    want = torch.zeros((BATCH + PRACH_NOISE, 64), dtype=torch.bool, device=dev)
    want[torch.arange(BATCH, device=dev), idx] = True
    got_delay = det["delay_samples"][torch.arange(BATCH, device=dev), idx].double()
    expected, near_half = prach_expected_delay(pr_cfg, idx, delay)
    err = (got_delay - expected).abs()
    vs_sent = float((got_delay - delay.double()).abs().max())
    step = pr_cfg.seq_len_samples / prach.NFFT_DETECT
    if not torch.equal(det["detected"], want):
        raise AssertionError(f"PRACH: detections differ from the sent preambles: "
                             f"{int((det['detected'] != want).sum())} of "
                             f"{want.numel()} flags")
    if not (bool((err[~near_half] <= 1).all()) and bool((err[near_half] <= step + 1).all())
            and vs_sent <= step):
        raise AssertionError(f"PRACH delays: max error {float(err.max())} samples against the "
                             f"detector's reading, {vs_sent} against the sent delay")
    log(f"UL path: PRACH root {PRACH_ROOT}, zero-correlation zone {PRACH_ZCZ} (N_cs "
        f"{pr_cfg.n_cs}): the sent preamble and only it detected on {BATCH}/{BATCH}, nothing "
        f"on {PRACH_NOISE} captures of noise; delays within 1 sample of the detector's "
        f"reading on {int((~near_half).sum())} captures (within one {step:.0f}-sample step on "
        f"{int(near_half.sum())} whose peak lies within 0.1 bin of a bin midpoint), max "
        f"|reading - sent delay| {vs_sent:.1f} samples; min sent power "
        f"{float(det['power'][want].min()):.3f}, max other {float(det['power'][~want].max()):.3f}")

    # ---- timing: the PUSCH decode alone, then each stage's device time -----
    times = []
    for _ in range(PATH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = pusch.decode(pcfg, rx, n_iter=N_ITER)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_exact(p["crc_ok"], p["bits"], sent["tb"], "PUSCH (timed)")
    log(f"[{card}] PUSCH decode (96 PRB 64QAM TBS {UL_TBS}, UCI) of {BATCH} subframes: best "
        f"of {PATH_REPS} {min(times) * 1e3:.2f} ms "
        f"({', '.join(f'{x * 1e3:.2f}' for x in times)}) = {BATCH / min(times):.1f} "
        f"subframes/s")
    profile_window(lambda: pusch.decode(pcfg, rx, n_iter=N_ITER), card,
                   f"PUSCH decode of {BATCH}", min(times))
    stages = {"PUCCH 1a": lambda: pucch.decode_format1(pucchs["1a"], rx, 1),
              "PUCCH 2": lambda: pucch.decode_format2(pucchs["2"], rx, 11),
              "PUCCH 2b": lambda: pucch.decode_format2(pucchs["2b"], rx, 11, nof_ack=2),
              "PUCCH 3": lambda: pucch.decode_format3(pucchs["3"], rx, 11),
              "SRS estimate": srs_estimate,
              f"PRACH detect of {BATCH + PRACH_NOISE}": lambda: prach.detect(pr_cfg, caps)}
    for name, fn in stages.items():
        host_s = min(stage_time(fn) for _ in range(PATH_REPS))
        profile_window(fn, card, f"{name} (host best of {PATH_REPS} {host_s * 1e3:.3f} ms)",
                       host_s)
    return dict(path="pusch.decode, 100 PRB, PUSCH 96 PRB 64QAM TBS 71112 with UCI, "
                "default TURBO_KERNEL", launches=per_decode,
                decode_ms=min(times) * 1e3)


def stage_time(fn) -> float:
    """Host-clock seconds of one call of fn, to its end on the device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mbsfn_path(dev, gen, card: str) -> dict:
    """PMCH at 100 PRB (area 1, subframe 1, 64QAM, TBS 46888), BATCH grids
    through AWGN at SNR_DB, decoded under the default TURBO_KERNEL: every
    crc_ok and bit exact, only map_fused16 launched.  Returns map_fused16's
    mbsfn_path entry for the kernels line."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import pmch
    from srsran_4g_tpu_torch.ops import turbo

    os.environ.pop("TURBO_KERNEL", None)
    cfg = pmch.PmchConfig(nof_prb=100, area_id=1, subframe=1, mod="64qam", tbs=PMCH_TBS)
    grp = cfg.plan.groups[0]
    l_win = turbo.window_length(grp.K, 208, 32)
    if (len(cfg.plan.groups), grp.count, grp.K, l_win) != (1, PMCH_CBS, PMCH_K, PMCH_L):
        raise AssertionError(f"PMCH: segmentation {cfg.plan}, window {l_win}")
    bits = torch.randint(0, 2, (BATCH, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
    rx = awgn.awgn(pmch.encode(cfg, bits), awgn.snr_to_noise_var(SNR_DB, device=dev),
                   generator=gen)
    reset_counts()
    out = pmch.decode(cfg, rx, n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_exact(out["crc_ok"], out["bits"], bits, "PMCH")
    if {name for name, n in counts.items() if n} != {"map_fused16"}:
        raise AssertionError(f"the PMCH path launched {counts}, expected only map_fused16")
    log(f"MBSFN path: PMCH 100 PRB area 1 subframe 1 64QAM TBS {cfg.tbs} (code rate "
        f"{cfg.tbs / cfg.g_bits:.3f}, {grp.count} CBs of K={grp.K}, L={l_win}), batch {BATCH}, "
        f"{SNR_DB} dB: crc_ok {int(out['crc_ok'].sum())}/{BATCH}, bits equal; launches {counts}")
    times, _, out = timed_decodes(cfg, rx, PATH_REPS, decode=pmch.decode)
    check_exact(out["crc_ok"], out["bits"], bits, "PMCH (timed)")
    log(f"[{card}] PMCH decode of {BATCH} subframes: best of {PATH_REPS} "
        f"{min(times) * 1e3:.2f} ms ({', '.join(f'{t * 1e3:.2f}' for t in times)}) = "
        f"{BATCH / min(times):.1f} subframes/s")
    profile_window(lambda: pmch.decode(cfg, rx, n_iter=N_ITER), card,
                   f"PMCH decode of {BATCH}", min(times))
    return dict(path="pmch.decode, 100 PRB 64QAM TBS 46888, default TURBO_KERNEL",
                launches=counts["map_fused16"], decode_ms=min(times) * 1e3)


def sync_stream(dev, gen, n_sf: int, lead: int, cfo: float, nbr_shift: int,
                noise: bool = True):
    """The UE's input: ``n_sf`` subframes of cell SYNC_CELL_ID at 100 PRB from
    ``enb_dl.assemble_subframe`` (64QAM PDSCH on every PRB, CRS, PSS/SSS,
    PCFICH, the MIB in subframe 0 of each frame), after ``lead`` samples;
    the neighbour SYNC_NBR_ID (CRS and PSS/SSS only, SYNC_NBR_DB weaker,
    ``nbr_shift`` samples later); a CFO of ``cfo`` subcarriers on both and
    AWGN at SNR_DB.  Returns (stream (1, n), the stream less the serving
    cell (the neighbour and the noise), clean serving samples (n_sf,
    sf_len), the serving grids (n_sf, 14, nre), the MIB bits)."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import enb_dl, grid, pdsch

    cell = grid.CellConfig(nof_prb=100, cell_id=SYNC_CELL_ID, cfi=1)
    nbr = grid.CellConfig(nof_prb=100, cell_id=SYNC_NBR_ID, cfi=1)
    mib = torch.randint(0, 2, (1, 24), generator=gen, device=dev, dtype=torch.int8)
    grids, nbr_sf = [], []
    for k in range(n_sf):
        cfg = pdsch.PdschConfig(cell=cell, rnti=0x1234, subframe=k % 10, mod="64qam",
                                tbs=75376)
        tb = torch.randint(0, 2, (1, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
        grids.append(enb_dl.assemble_subframe(cfg, tb, mib_bits=mib, frame_idx=k // 10)[0])
        ncfg = pdsch.PdschConfig(cell=nbr, rnti=1, subframe=k % 10, mod="qpsk", tbs=16)
        g = pdsch.add_crs(ncfg, torch.zeros((1, 14, nbr.nre), dtype=torch.complex64,
                                            device=dev))
        nbr_sf.append(enb_dl.subframe_to_samples(nbr, enb_dl.put_sync_signals(nbr, g, k % 10)))
    grids = torch.stack(grids)
    clean = enb_dl.subframe_to_samples(cell, grids)  # (n_sf, sf_len)
    sf_len = clean.shape[-1]
    n = lead + n_sf * sf_len + 2 * sf_len
    x = torch.zeros(n, dtype=torch.complex64, device=dev)
    x[lead:lead + n_sf * sf_len] = clean.reshape(-1)
    nb = torch.cat(nbr_sf, dim=-1)[0] * 10 ** (-SYNC_NBR_DB / 20)
    x[lead + nbr_shift:lead + nbr_shift + nb.shape[-1]] += nb[:n - lead - nbr_shift]
    ph = 2 * np.pi * cfo * torch.arange(n, device=dev, dtype=torch.float64) / 2048
    ramp = torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
    serving = torch.zeros_like(x)
    serving[lead:lead + n_sf * sf_len] = clean.reshape(-1)
    x = x * ramp
    if noise:
        x = awgn.awgn(x, awgn.snr_to_noise_var(SNR_DB, device=dev), generator=gen)
    return x[None], (x - serving * ramp)[None], clean, grids, mib


def evm_db(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """EVM of got against want after the least-squares complex gain, in dB,
    and that gain's magnitude."""
    g = torch.sum(got * want.conj()) / torch.sum(want.abs() ** 2)
    e = torch.sum((got - g * want).abs() ** 2) / torch.sum((g * want).abs() ** 2)
    return 10 * float(torch.log10(e)), float(g.abs())


def sync_path(dev, gen, card: str) -> None:
    """The UE around the downlink at 100 PRB: UeSync FIND → TRACK over a
    SYNC_SF-subframe stream with a neighbour, the MIB, CRS measurements, the
    neighbour search, FDD/TDD detection, resampling to 23.04 Msps and back,
    AGC and CFR, every check against the values put in."""
    from srsran_4g_tpu_torch.models import enb_dl, grid, meas, sync, tdd, ue_sync
    from srsran_4g_tpu_torch.ops import agc, cfr, ofdm, resampling
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, _symbol_offsets

    ocfg = OfdmConfig(nof_prb=100)
    sf_len, n = ocfg.sf_len, ocfg.symbol_sz
    lead = int(torch.randint(0, SYNC_LEAD_MAX + 1, (1,), generator=gen, device=dev))
    cfo = float((2 * torch.rand(1, generator=gen, device=dev) - 1) * DL_CFO)
    nbr_shift = int(torch.randint(sf_len // 8, sf_len, (1,), generator=gen, device=dev))
    t0 = time.perf_counter()
    x, rest, clean, grids, mib = sync_stream(dev, gen, SYNC_SF, lead, cfo, nbr_shift)
    torch.cuda.synchronize()
    log(f"sync path: {SYNC_SF} subframes of cell {SYNC_CELL_ID} at 100 PRB after a lead of "
        f"{lead}, neighbour {SYNC_NBR_ID} {SYNC_NBR_DB} dB weaker {nbr_shift} samples later, CFO "
        f"{cfo:+.5f} subcarrier, {SNR_DB} dB; made in {time.perf_counter() - t0:.2f} s")

    # ---- FIND, the MIB, TRACK --------------------------------------------------
    us = ue_sync.UeSync(nof_prb=100)
    t0 = time.perf_counter()
    found = us.zerocopy(x[0, :2 * sf_len])
    find_s = time.perf_counter() - t0
    start = int(found["offset"]) - int(_symbol_offsets(ocfg)[6])
    checks = {"FIND in sync": found["in_sync"], "cell id": found.get("cell_id") == SYNC_CELL_ID,
              "subframe start exact": start == lead, "subframe 0": us.s.sf_idx == 0}
    mib_out = ue_sync.decode_mib(found["cell_id"], found["sf_samples"][None])
    checks["MIB crc_ok"] = bool(mib_out["crc_ok"].all())
    checks["MIB bits"] = torch.equal(mib_out["mib"], mib)
    track_s, lost = [], 0
    outs = []
    for k in range(SYNC_SF):
        chunk = x[0, start + k * sf_len:start + (k + 1) * sf_len]
        t0 = time.perf_counter()
        o = us.zerocopy(chunk)
        track_s.append(time.perf_counter() - t0)
        lost += not (o["in_sync"] and o["state"] == ue_sync.TRACK)
        outs.append(o)
    cfo_err = abs(us.s.cfo_hz_acc - cfo)
    checks.update({"TRACK in sync on every subframe": lost == 0,
                   f"{SYNC_SF // 10} frames tracked": us.s.frames_tracked == SYNC_SF // 10,
                   f"|CFO error| < {SYNC_CFO_TOL}": cfo_err < SYNC_CFO_TOL})
    log(f"[{card}] UE sync: FIND {find_s * 1e3:.2f} ms; TRACK per subframe best "
        f"{min(track_s) * 1e3:.3f} ms, median {float(np.median(track_s)) * 1e3:.3f} ms, "
        f"subframes 0/5 (PSS checked) median "
        f"{float(np.median(track_s[::5])) * 1e3:.3f} ms, host clock; CFO estimate "
        f"{us.s.cfo_hz_acc:+.5f} (error {cfo_err:.2e} subcarrier)")

    # ---- measurements on a tracked subframe 0 -----------------------------------
    # the SINR put in: the serving CRS at 0 dB against what the rest of the
    # stream (the neighbour and the noise) puts on the same REs
    cell = grid.CellConfig(nof_prb=100, cell_id=SYNC_CELL_ID, cfi=1)
    m = meas.measure_cell(ofdm.demodulate(ocfg, outs[10]["sf_samples"][None]), cell, 0)
    ls, ks = grid.crs_pattern(cell, 0)
    g_rest = ofdm.demodulate(ocfg, rest[:, start + 10 * sf_len:start + 11 * sf_len])
    sinr_db = -10 * float(torch.log10((g_rest[0, torch.as_tensor(ls, device=dev)[:, None],
                                              torch.as_tensor(ks, device=dev)].abs() ** 2)
                                      .mean()))
    rsrp_db = 10 * float(torch.log10(m["rsrp"][0]))
    snr_db, resid_hz = float(m["snr_db"][0]), float(m["cfo_hz"][0])
    cfo_meas_hz = us.s.cfo_hz_acc * 15e3 + resid_hz
    checks.update({f"|RSRP| < {SYNC_RSRP_TOL_DB} dB": abs(rsrp_db) < SYNC_RSRP_TOL_DB,
                   f"SNR within {SYNC_SNR_TOL_DB} dB of the SINR put in":
                   abs(snr_db - sinr_db) < SYNC_SNR_TOL_DB,
                   f"|CFO| within {SYNC_CFO_HZ_TOL} Hz": abs(cfo_meas_hz - cfo * 15e3)
                   < SYNC_CFO_HZ_TOL})
    log(f"sync path: measure_cell RSRP {rsrp_db:+.3f} dB (sent 0 dB), SNR {snr_db:.2f} dB "
        f"(the SINR put in on the CRS REs {sinr_db:.2f} dB: AWGN at {SNR_DB} dB and the "
        f"neighbour), CFO {cfo_meas_hz:+.1f} Hz (sent {cfo * 15e3:+.1f} Hz; residual after "
        f"tracking {resid_hz:+.1f} Hz), RSRQ {float(m['rsrq_db'][0]):.2f} dB")
    t0 = time.perf_counter()
    cells = meas.find_neighbour_cells(x[:, start:start + SYNC_SF * sf_len], 100,
                                      serving_cell_id=SYNC_CELL_ID)
    torch.cuda.synchronize()
    nbr_s = time.perf_counter() - t0
    ids = [c["cell_id"] for c in cells]
    checks["neighbour found"] = SYNC_NBR_ID in ids
    checks["serving excluded"] = SYNC_CELL_ID not in ids
    log(f"[{card}] find_neighbour_cells on the {SYNC_SF} subframes: {nbr_s * 1e3:.2f} ms; "
        f"found (cell, peak/RMS) {[(c['cell_id'], round(c['peak_ratio'], 2)) for c in cells]} "
        f"(the JAX package's threshold 2.0 also passes N_ID_2 hypotheses of noise)")

    # ---- FDD / TDD -----------------------------------------------------------------
    cap = x[:, :2 * sf_len]
    f = sync.find_pss(cap, n)
    fdd = tdd.detect_frame_type(cap, f["offset"], f["n_id_2"], ocfg)
    tdd_cell = grid.CellConfig(nof_prb=100, cell_id=SYNC_CELL_ID, cfi=1)
    tdd_x = torch.cat([enb_dl.subframe_to_samples(tdd_cell, enb_dl.put_sync_signals_tdd(
        tdd_cell, torch.zeros((1, 14, 1200), dtype=torch.complex64, device=dev), sf))
        for sf in range(3)], dim=-1)
    tdd_x = tdd_x + (torch.randn(tdd_x.shape, generator=gen, device=dev,
                                 dtype=torch.complex64) * 10 ** (-SNR_DB / 20))
    ft = sync.find_pss(tdd_x, n)
    tdd_res = tdd.detect_frame_type(tdd_x, ft["offset"], ft["n_id_2"], ocfg)
    checks.update({
        "FDD stream: FDD": int(fdd.frame_type[0]) == 0,
        "FDD stream: cell id": int(3 * fdd.n_id_1[0] + f["n_id_2"][0]) == SYNC_CELL_ID,
        "TDD stream: TDD": int(tdd_res.frame_type[0]) == 1,
        "TDD stream: cell id": int(3 * tdd_res.n_id_1[0] + ft["n_id_2"][0]) == SYNC_CELL_ID,
        "TDD stream: PSS offset": int(ft["offset"][0]) == tdd.pss_to_sf_start(ocfg, "tdd")})

    # ---- resampling 30.72 -> 23.04 Msps and back ---------------------------------
    r15 = OfdmConfig(nof_prb=100, custom_symbol_sz=1536)
    flat = clean.reshape(1, -1)
    t0 = time.perf_counter()
    poly = resampling.resample_polyphase(flat, 0.75)
    fft34 = resampling.resample_fft(flat, 3, 4)
    back = resampling.resample_fft(fft34, 4, 3)
    torch.cuda.synchronize()
    rs_s = time.perf_counter() - t0
    evm = {}
    for name, y, cfg_r in (("polyphase 3/4", poly, r15), ("FFT 3/4", fft34, r15),
                           ("FFT 3/4 and back", back, ocfg)):
        g_rx = ofdm.demodulate(cfg_r, y[0, :SYNC_SF * cfg_r.sf_len].reshape(SYNC_SF, -1))
        evm[name] = evm_db(g_rx, grids)
    x23 = resampling.resample_polyphase(x, 0.75)
    f23 = sync.find_pss(x23[:, :2 * r15.sf_len], 1536)
    res23 = tdd.detect_frame_type(x23, f23["offset"], f23["n_id_2"], r15)
    checks.update({
        f"polyphase EVM < {SYNC_EVM_POLY_DB} dB": evm["polyphase 3/4"][0] < SYNC_EVM_POLY_DB,
        f"FFT EVM < {SYNC_EVM_FFT_DB} dB": max(evm["FFT 3/4"][0], evm["FFT 3/4 and back"][0])
        < SYNC_EVM_FFT_DB,
        "23.04 Msps: cell id": int(3 * res23.n_id_1[0] + f23["n_id_2"][0]) == SYNC_CELL_ID,
        "23.04 Msps: FDD": int(res23.frame_type[0]) == 0})
    log(f"[{card}] resampling {SYNC_SF} subframes (polyphase 3/4, FFT 3/4, FFT 4/3): "
        f"{rs_s * 1e3:.2f} ms host clock; in-band EVM against the sent grids (dB, |gain|): "
        + ", ".join(f"{k} {v[0]:.2f} ({v[1]:.4f})" for k, v in evm.items())
        + f"; the 23.04 Msps stream searched at symbol_sz 1536: cell "
        f"{int(3 * res23.n_id_1[0] + f23['n_id_2'][0])}, frame type "
        f"{'TDD' if int(res23.frame_type[0]) else 'FDD'}")

    # ---- AGC from -20 dB, then CFR on the eNB's symbols -------------------------
    acfg = agc.AgcConfig()
    frames = x[0, lead:lead + SYNC_SF * sf_len].reshape(SYNC_SF // 10, 10 * sf_len)
    frames = frames * (acfg.target * 10 ** (-20 / 20) / float(frames.abs().max()))
    gain = torch.zeros(1, device=dev)
    gains, peaks = [], []
    for i in range(AGC_FRAMES):
        y, gain = agc.agc_step(acfg, frames[i % frames.shape[0]][None], gain)
        gains.append(float(gain[0]))
        peaks.append(float(y.abs().max()))
    last = gains[-5:]
    out_db = 20 * np.log10(peaks[-1] / acfg.target)
    checks.update({f"AGC gain within {AGC_TOL_DB} dB of +20": abs(gains[-1] - 20) < AGC_TOL_DB,
                   f"AGC settled (last 5 within {AGC_TOL_DB} dB)":
                   max(last) - min(last) < AGC_TOL_DB})
    log(f"sync path: AGC from -20 dB over {AGC_FRAMES} frames: gain (dB) "
        f"{', '.join(f'{g:.2f}' for g in gains)}; last output peak {out_db:+.2f} dB against "
        f"the target")
    offs = torch.as_tensor(_symbol_offsets(ocfg), device=dev)
    bodies = clean[:, offs[:, None] + torch.arange(n, device=dev)].reshape(-1, n)
    ccfg = cfr.CfrConfig(symbol_sz=n, nof_re=1200)
    t0 = time.perf_counter()
    clipped = cfr.cfr_apply(ccfg, bodies)
    torch.cuda.synchronize()
    cfr_s = time.perf_counter() - t0
    papr_in, papr_out = cfr.papr_db(bodies), cfr.papr_db(clipped)
    drop = float((papr_in - papr_out).mean())
    bins = torch.as_tensor(ofdm._sc_to_bin(ocfg), device=dev)
    cfr_evm = evm_db(torch.fft.fft(clipped)[:, bins], torch.fft.fft(bodies)[:, bins])
    checks.update({f"PAPR drop > {CFR_DROP_DB} dB": drop > CFR_DROP_DB,
                   f"CFR in-band EVM < {CFR_EVM_DB} dB": cfr_evm[0] < CFR_EVM_DB})
    log(f"[{card}] CFR on {bodies.shape[0]} symbols: {cfr_s * 1e3:.2f} ms; PAPR mean "
        f"{float(papr_in.mean()):.2f} -> {float(papr_out.mean()):.2f} dB (max "
        f"{float(papr_in.max()):.2f} -> {float(papr_out.max()):.2f}), mean drop {drop:.2f} dB; "
        f"in-band EVM {cfr_evm[0]:.2f} dB")
    if not all(checks.values()):
        raise AssertionError(f"sync path: {checks}")
    log(f"sync path: every check passed ({', '.join(checks)})")

    # ---- device time of the tracking loop --------------------------------------------
    def track_frame():
        t = ue_sync.UeSync(nof_prb=100, state=ue_sync.UeSyncState(
            state=ue_sync.TRACK, cell_id=SYNC_CELL_ID, cfo_hz_acc=us.s.cfo_hz_acc))
        for k in range(10):
            t.zerocopy(x[0, start + k * sf_len:start + (k + 1) * sf_len])

    profile_window(track_frame, card, "UE sync TRACK over 10 subframes",
                   sum(sorted(track_s)[:10]))


class TurboSpy:
    """Hooks on the default route's turbo wrappers: each wrapper's (B, K, L,
    T) shapes and the inputs of its largest call.  It only observes: each
    wrapper still counts its own launches."""

    def __init__(self) -> None:
        self.shapes: dict[str, dict] = {w: {} for w in SYS_WRAPPERS}
        self.largest: dict[str, tuple] = {}

    def __enter__(self):
        from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

        self._saved = [(w, getattr(tm, w)) for w in SYS_WRAPPERS]
        for w, fn in self._saved:
            setattr(tm, w, self._spy(w, fn))
        return self

    def __exit__(self, *exc):
        from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

        for w, fn in self._saved:
            setattr(tm, w, fn)
        return False

    def _spy(self, name: str, fn):
        def spy(gs, gp, a0, b0, t, l, nb, nw):
            key = (nb, l * nw, l, t)
            self.shapes[name][key] = self.shapes[name].get(key, 0) + 1
            if gs.shape[1] > self.largest.get(name, (0,))[0]:
                self.largest[name] = (gs.shape[1], (gs.clone(), gp.clone(), a0.clone(),
                                                    b0.clone(), t, l, nb, nw))
            return fn(gs, gp, a0, b0, t, l, nb, nw)
        return spy


class SystemClock(TurboSpy):
    """Hooks on the nodes' once-a-TTI ``tick`` and on the default route's
    turbo wrappers for one system run: each TTI's host time (the device
    synchronised at every TTI boundary), a torch.profiler window of
    SYS_PROFILE_TTIS TTIs starting SYS_PROFILE_AFTER TTIs after the last UE
    attached, each wrapper's (B, K, L, T) shapes with the inputs of its
    largest call, and the host time of each of SYS_STAGES a TTI.  The hooks
    only observe: each wrapper still counts its own launches."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.ues: list = []
        self.stamps: list[float] = []
        self.attach_tti: int | None = None
        self.window: tuple[int, int] | None = None
        super().__init__()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.stage_s: dict[str, dict[int, float]] = {st: {} for st in SYS_STAGES}
        self.stage_n: dict[str, int] = {st: 0 for st in SYS_STAGES}

    def __enter__(self):
        from srsran_4g_tpu_torch.apps import nodes
        from srsran_4g_tpu_torch.models import pdcch, pdsch, pusch
        from srsran_4g_tpu_torch.ops import convcode
        from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm
        from srsran_4g_tpu_torch.runtime import lte_air

        owners = dict(LteAirPhy=lte_air.LteAirPhy, pdcch=pdcch, pdsch=pdsch, pusch=pusch,
                      convcode=convcode)
        self._saved = [(nodes.UeNode, "tick", nodes.UeNode.tick),
                       (nodes.EnbNode, "tick", nodes.EnbNode.tick)]
        self._saved += [(tm, w, getattr(tm, w)) for w in SYS_WRAPPERS]
        for st in SYS_STAGES:
            owner, name = owners[st.split(".")[0]], st.split(".")[1]
            self._saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, self._timed(st, getattr(owner, name)))
        ue_tick, enb_tick = nodes.UeNode.tick, nodes.EnbNode.tick
        clock = self

        def ue_hook(ue):
            if ue not in clock.ues:
                clock.ues.append(ue)
            ue_tick(ue)

        def enb_hook(enb):
            clock.tti_boundary()
            enb_tick(enb)

        nodes.UeNode.tick, nodes.EnbNode.tick = ue_hook, enb_hook
        for w in SYS_WRAPPERS:
            setattr(tm, w, self._spy(w, getattr(tm, w)))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        if self.window is not None and len(self.window) == 1:
            self.prof.stop()
        return False

    def _timed(self, stage: str, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                tti = len(self.stamps) - 1
                self.stage_s[stage][tti] = self.stage_s[stage].get(tti, 0.0) + (
                    time.perf_counter() - t0)
                self.stage_n[stage] += 1
        return timed

    def stage_ms(self, ttis: range) -> dict[str, float]:
        """Mean host ms a TTI of each stage over ``ttis``, outside the
        profiled window."""
        keep = [t for t in ttis if self.window is None or len(self.window) != 2
                or not self.window[0] <= t < self.window[1]]
        return {st: sum(v.get(t, 0.0) for t in keep) / len(keep) * 1e3
                for st, v in self.stage_s.items()}

    def tti_boundary(self) -> None:
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        tti = len(self.stamps) - 1
        if self.attach_tti is None and self.ues and all(u.nas.is_registered() for u in self.ues):
            self.attach_tti = tti
        start = None if self.attach_tti is None else self.attach_tti + SYS_PROFILE_AFTER
        if tti == start:
            self.prof.start()
            self.window = (tti,)
        elif start is not None and tti == start + SYS_PROFILE_TTIS:
            self.prof.stop()
            self.window = (start, tti)

    def tti_ms(self) -> np.ndarray:
        """Host ms of every complete TTI outside the profiled window."""
        ms = np.diff(self.stamps) * 1e3
        keep = np.ones(len(ms), bool)
        if self.window is not None and len(self.window) == 2:
            keep[self.window[0]:self.window[1]] = False
        return ms[keep]


def sys_checks_run(stats, ues, n_ues: int, n_pings: int) -> dict[str, bool]:
    """tests/test_run_lte.py::_run's criteria (and its 2-UE case's distinct
    C-RNTIs)."""
    return {
        "camped on PCI 1 over the air": all(u.sync_state == "camped" and u.acq_pci == 1
                                            and u.acq_sfn >= 0 for u in ues),
        "SI acquired": all(u.rrc.idle.si_acquired() for u in ues),
        "one PRACH per UE": stats["prach"] == n_ues,
        "distinct C-RNTIs": len({u.crnti for u in ues}) == n_ues,
        "attached": all(u.nas.is_registered() for u in ues),
        "0 PDSCH/PUSCH KO": stats["pdsch_ko"] == 0 and stats["pusch_ko"] == 0,
        "0% DL ping loss": stats["dl_ping_rx"] == n_pings * n_ues,
        "0% UL ping loss": stats["ul_ping_rx"] >= n_pings * n_ues,
        "dci_tx >= pdsch_tx": stats["dci_tx"] >= stats["pdsch_tx"],
        "PHICH ACKs": stats["phich_ack"] > 0,
        "PHICH ACK+NACK >= PUSCH - 4":
            stats["phich_ack"] + stats["phich_nack"] >= stats["pusch_tx"] - 4,
        "CQI >= 13 after the first report": all(c >= 13 for u in ues for c in u.cqi_sent[1:]),
    }


# the JAX test's other matrix points (tests/test_run_lte.py), each with that
# test's own assertions: (name, run arguments, checks of (ok, stats, ues))
SYS_MATRIX = (
    ("EPA 5 Hz at 14 dB, 6 PRB, 1 UE, 500 TTIs",
     dict(n_ttis=500, n_pings=2, snr_db=14.0, nof_prb=6, n_ues=1, fading_profile="epa",
          doppler_hz=5.0),
     lambda ok, st, ues: {
         "ok": ok, "KO occurred": st["pdsch_ko"] + st["pusch_ko"] > 0,
         "PHICH NACKs": st["phich_nack"] > 0,
         "retransmissions": st["dl_retx"] > 0 or st["pusch_ko"] > 0,
         "pings": st["dl_ping_rx"] == 2 and st["ul_ping_rx"] >= 2,
         "CQI tracks the fading": min(ues[0].cqi_sent) < 10 and len(set(ues[0].cqi_sent)) > 2}),
    ("TM4 at 15 PRB", dict(n_ttis=300, n_pings=2, snr_db=30.0, nof_prb=15, n_ues=1, tm=4),
     lambda ok, st, ues: {
         "ok": ok, "rank-2 sent": st["pdsch_tx_rank2"] > 0, "rank-2 decoded": st["pdsch_rank2"] > 0,
         "0 KO": st["pdsch_ko"] == 0 and st["pusch_ko"] == 0,
         "pings": st["dl_ping_rx"] == 2 and st["ul_ping_rx"] >= 2}),
    ("TDD at 6 PRB", dict(n_ttis=300, n_pings=2, snr_db=30.0, nof_prb=6, n_ues=1, tdd=True),
     lambda ok, st, ues: {
         "ok": ok, "one PRACH": st["prach"] == 1, "0 KO": st["pdsch_ko"] == 0 and st["pusch_ko"] == 0,
         "pings": st["dl_ping_rx"] == 2 and st["ul_ping_rx"] >= 2,
         "camped on PCI 1": ues[0].sync_state == "camped" and ues[0].acq_pci == 1}),
    ("2-CC CA at 6 PRB, a 1,400-byte burst",
     dict(n_ttis=360, n_pings=2, snr_db=30.0, nof_prb=6, n_ues=1, n_cc=2, burst_bytes=1400),
     lambda ok, st, ues: {
         "ok": ok, "SCell carried data": st["scell_tx"] > 0, "0 PDSCH KO": st["pdsch_ko"] == 0,
         "SCell activated": 1 in ues[0].mac.demux.active_scells}),
    ("SI on DCI 1C at 50 PRB", dict(n_ttis=300, n_pings=2, snr_db=30.0, nof_prb=50, n_ues=1,
                                    si_1c=True),
     lambda ok, st, ues: {
         "ok": ok, "SI on 1C sent": st["si_1c_tx"] > 0, "0 PDSCH KO": st["pdsch_ko"] == 0,
         "SI acquired": all(u.rrc.idle.si_acquired() for u in ues)}),
)


def system_path(dev, card: str) -> dict:
    """The port's tools/run_lte.run at 100 PRB with two UEs on the card,
    every criterion of tests/test_run_lte.py::_run, timed per TTI and
    profiled over SYS_PROFILE_TTIS TTIs after the attach; then each turbo
    kernel the run launched against its plain version at the largest shape
    it saw, the matrix points of SYS_MATRIX, and the fading response at 100
    PRB against the CPU's.  Returns each default-route kernel's entry for
    the kernels line."""
    from torch.autograd import DeviceType

    from srsran_4g_tpu_torch.channel import fading
    from srsran_4g_tpu_torch.tools import run_lte

    run = dict(SYS_RUN)
    log(f"system path: run_lte.run({', '.join(f'{k}={v}' for k, v in run.items())}) on {dev}")
    reset_counts()
    with SystemClock() as clock:
        t0 = time.perf_counter()
        ok, stats, ues, _ = run_lte.run(**run, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    checks = sys_checks_run(stats, ues, run["n_ues"], run["n_pings"])
    checks["run_lte's own verdict"] = ok
    checks["profiled window inside the run"] = clock.window is not None and len(clock.window) == 2
    checks["default-route kernels launched"] = sum(launches[w] for w in SYS_WRAPPERS) > 0
    log(f"system path: stats {stats}; attached at TTI {clock.attach_tti}; CQI "
        + "; ".join(f"ue{u.idx} {u.cqi_sent}" for u in ues))
    if not all(checks.values()):
        raise AssertionError(f"system path: {checks}")
    log(f"system path: every criterion passed ({', '.join(checks)})")
    ms = clock.tti_ms()
    after = ms[clock.attach_tti:] if clock.attach_tti is not None else ms
    log(f"[{card}] system path: {run['n_ttis']} TTIs in {wall:.2f} s = "
        f"{run['n_ttis'] / wall:.2f} TTIs/s; host ms a TTI (the air's is 1 ms), outside "
        f"the profiled window: median {np.median(ms):.2f}, p90 {np.percentile(ms, 90):.2f}, "
        f"max {ms.max():.2f} (after the attach: median {np.median(after):.2f}, "
        f"p90 {np.percentile(after, 90):.2f})")
    kernels = [e for e in clock.prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / SYS_PROFILE_TTIS
    n_k = sum(e.count for e in kernels) / SYS_PROFILE_TTIS
    profiled = (clock.stamps[clock.window[1]] - clock.stamps[clock.window[0]]) * 1e3
    prof = dict(window=list(clock.window), device_ms_per_tti=busy, kernels_per_tti=n_k,
                host_ms_per_tti_profiled=profiled / SYS_PROFILE_TTIS,
                host_ms_per_tti_median=float(np.median(after)))
    if busy <= 0:
        log(f"[{card}] system path: profiler saw no device time: idle share not measured")
    else:
        prof["idle_share"] = 1 - busy / float(np.median(after))
        log(f"[{card}] system path, TTIs {clock.window[0]}-{clock.window[1] - 1} profiled: "
            f"device {busy:.3f} ms in {n_k:.0f} kernels a TTI; idle share "
            f"{prof['idle_share']:.3f} of the unprofiled median TTI after the attach "
            f"({np.median(after):.2f} ms; {profiled / SYS_PROFILE_TTIS:.2f} ms a TTI under "
            f"the profiler)")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / 1e3 / SYS_PROFILE_TTIS:8.4f} ms a TTI  "
                f"x{e.count / SYS_PROFILE_TTIS:<7.1f} {e.key[:90]}")
    steady = range(clock.attach_tti, len(clock.stamps) - 1)
    stages = clock.stage_ms(steady)
    top = sum(v for k, v in stages.items() if k.startswith("LteAirPhy."))
    log(f"[{card}] system path, host ms a TTI by stage after the attach (TTIs "
        f"{steady.start}-{steady.stop - 1} outside the profiled window; mean TTI "
        f"{np.mean(after):.2f} ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; the air's calls {top:.2f}, the rest (nodes, MAC/RLC/PDCP/RRC/NAS, "
        f"EPC) {np.mean(after) - top:.2f}")
    prof["stage_ms"] = dict(stages, rest=float(np.mean(after) - top))
    log(f"system path launches: {launches}; shapes (B, K, L, T): "
        + "; ".join(f"{w} {dict(sorted(v.items()))}" for w, v in clock.shapes.items()))

    # ---- each kernel the run launched, against its plain version ----------------
    entries = {w: kernel_entry(w, clock.largest[w][1], launches[w], clock.shapes[w], card,
                               "system path") for w in SYS_WRAPPERS if w in clock.largest}
    clock.largest.clear()

    # ---- the fading channel on the card against the CPU ---------------------------
    cfg = fading.FadingConfig("etu", 300.0, 30.72e6)
    tt = torch.linspace(0.5, 0.501, 14, dtype=torch.float32)
    ff = (torch.arange(-600, 600, dtype=torch.float32) / 2048)
    err = float((fading.freq_response(cfg, 15, tt.to(dev), ff.to(dev)).cpu()
                 - fading.freq_response(cfg, 15, tt, ff)).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"fading response on the card vs the CPU: max |diff| {err}")
    log(f"fading response at 100 PRB (ETU 300 Hz, t = 0.5 s), card vs CPU: max|diff| {err:.3g}")

    # ---- the JAX test's other matrix points ------------------------------------
    matrix = {}
    for name, kw, check in SYS_MATRIX:
        t0 = time.perf_counter()
        ok, st, m_ues, _ = run_lte.run(**kw, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res = check(ok, st, m_ues)
        log(f"[{card}] system matrix {name}: {kw['n_ttis']} TTIs in {secs:.2f} s "
            f"({kw['n_ttis'] / secs:.2f} TTIs/s); {st}; CQI {m_ues[0].cqi_sent}")
        if not all(res.values()):
            raise AssertionError(f"system matrix {name}: {res}")
        matrix[name] = dict(s=secs, ttis_per_s=kw["n_ttis"] / secs)
    log(f"system path: every matrix point passed its test's assertions")
    return dict(entries=entries, wall_s=wall, ttis_per_s=run["n_ttis"] / wall,
                tti_ms=dict(median=float(np.median(ms)), p90=float(np.percentile(ms, 90)),
                            max=float(ms.max())),
                profile=prof, matrix=matrix)


def _note_largest(seen: dict, turbo: dict) -> None:
    """Keep, for each wrapper, the largest (B, K, L, T) by lanes that a
    child's ``turbo`` report names."""
    for w, (b, k, l, t) in turbo["largest"].items():
        if w not in seen or b * k // l > seen[w][0] * seen[w][1] // seen[w][2]:
            seen[w] = (b, k, l, t)


def phy_e2e_run(card: str, seen: dict) -> dict:
    """tools/phy_e2e at PROC_PHY_E2E_PRB: an eNB process streams
    PROC_PHY_E2E_SF PDSCH subframes over the IQ bridge, a UE process decodes
    them; every CRC must pass and the payload match."""
    from srsran_4g_tpu_torch.tools.three_process import ROOT, free_base

    port = free_base(0)
    cmd = [sys.executable, "-m", "srsran_4g_tpu_torch.tools.phy_e2e", "--port", str(port),
           "--subframes", str(PROC_PHY_E2E_SF), "--prb", str(PROC_PHY_E2E_PRB)]
    t0 = time.perf_counter()
    enb = subprocess.Popen(cmd[:3] + ["enb"] + cmd[3:], cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        ue = subprocess.run(cmd[:3] + ["ue"] + cmd[3:], cwd=ROOT, capture_output=True, text=True,
                            timeout=PROC_TIMEOUT)
        enb_out, _ = enb.communicate(timeout=PROC_TIMEOUT)
    finally:
        if enb.poll() is None:
            enb.kill()
        enb.wait(timeout=30)
    secs = time.perf_counter() - t0
    want = f"{PROC_PHY_E2E_SF}/{PROC_PHY_E2E_SF} subframes CRC-OK"
    if ue.returncode or enb.returncode or want not in ue.stdout \
            or "payload match=True" not in ue.stdout:
        raise AssertionError(f"phy_e2e at {PROC_PHY_E2E_PRB} PRB: UE rc {ue.returncode}:\n"
                             f"{ue.stdout}\n{ue.stderr}\neNB rc {enb.returncode}:\n{enb_out}")
    turbo = json.loads(next(line for line in ue.stdout.splitlines()
                            if line.startswith("ue: turbo "))[len("ue: turbo "):])
    _note_largest(seen, turbo)
    log(f"[{card}] phy_e2e at {PROC_PHY_E2E_PRB} PRB: {want}, payload match, two processes in "
        f"{secs:.2f} s; UE turbo {turbo}")
    return dict(s=secs, launches=turbo["launches"], largest=turbo["largest"])


def process_path(dev, card: str) -> dict:
    """The three-process deployment on the card: the native runtime built in
    this process first (the kernels are built already), then each point of
    PROC_POINTS as OS processes through tools/three_process, every criterion
    of tests/test_three_process_e2e.py asserted on the children's RESULT
    lines, timed from the eNB's bridges up to the last RESULT (the attach
    off the UEs' ATTACHED lines), each child's turbo launches read; then
    phy_e2e at 100 PRB; then each turbo kernel the children launched against
    its plain version at the largest shape they reported.  Returns each
    default-route kernel's entry for the kernels line."""
    from srsran_4g_tpu_torch.runtime import native
    from srsran_4g_tpu_torch.tools import three_process as tp

    t0 = time.perf_counter()
    native.load()
    log(f"process path: native runtime loaded in {time.perf_counter() - t0:.2f} s")
    seen: dict[str, tuple] = {}
    runs, full = {}, None
    for name, kw in PROC_POINTS:
        log(f"process path: {name}: {kw} on {dev}")
        r = tp.run(tp.Point(**kw), device="cuda", timeout=PROC_TIMEOUT)
        checks = tp.criteria(r)
        children = {**{f"srsue{i}": st for i, st in enumerate(r.ue)}, "srsenb": r.enb}
        launches = {c: st["turbo"]["launches"] for c, st in children.items()}
        for st in children.values():
            _note_largest(seen, st["turbo"])
        log(f"process path: {name}: UEs {r.ue}; eNB {r.enb}; EPC {r.epc}")
        if not all(checks.values()):
            raise AssertionError(f"process path {name}: {checks}")
        log(f"[{card}] process path {name}: every criterion passed ({', '.join(checks)}); "
            f"bridges up {r.setup_s:.2f} s after the eNB started; {r.point.ttis} TTIs in "
            f"{r.wall_s:.2f} s from there to the last RESULT = {r.ttis_per_s:.2f} TTIs/s; "
            f"attached at "
            + ", ".join(f"{s:.2f}" for s in r.attach_s) + f" s; turbo launches {launches}")
        runs[name] = dict(s=r.wall_s, ttis_per_s=r.ttis_per_s, setup_s=r.setup_s,
                          attach_s=r.attach_s,
                          launches=launches)
        if full is None:
            full = launches
            total = {w: sum(n.get(w, 0) for n in launches.values()) for w in SYS_WRAPPERS}
            if not sum(total.values()):
                raise AssertionError(f"process path {name}: no default-route kernel launched")
    e2e = phy_e2e_run(card, seen)

    # ---- each kernel the children launched, against its plain version -------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    entries = {}
    for w, (b, k, l, t) in sorted(seen.items()):
        if w not in SYS_ROUTE:
            raise AssertionError(f"process path: the children launched {w}, off the default route")
        r = check_kernel(SYS_ROUTE[w], gamma_inputs(dev, gen, b, k, l, t), time_it=True)
        nbytes, adds, maxes = work(w, b, k, l, t)
        bound_ms, bound_by = bound(nbytes, adds, maxes, "bf16" if w in BF16_WRAPPERS else "f32")
        entries[w] = dict(
            launches=sum(n.get(w, 0) for n in full.values()),
            largest=dict(blocks=b, K=k, L=l, T=t, lanes=b * (k // l)),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        log(f"[{card}] process path {w} at the largest shape the children reported B={b} K={k} "
            f"L={l} T={t}: {r['ms']:.4f} ms against a bound of {bound_ms:.4f} ms ({bound_by}); "
            f"plain {r['plain_ms']:.2f} ms; max|diff| {r['max_abs_err']}")
    return dict(entries=entries, runs=runs, phy_e2e=e2e)


def nr_point(dev, gen, card: str, mod: str, tbs: int, snr_db: float, n_cb: int,
             harq: bool = False) -> dict:
    """One NR PDSCH point at 100 MHz: encode → AWGN → decode of NR_BATCH slots
    on the card (with rv 2 combined onto rv 0's soft-buffers when ``harq``),
    every CRC and bit checked; timed (best of NR_REPS), profiled, the LDPC
    decode profiled alone on the LLRs it was given; then slot 0 decoded again
    on the CPU, bits and CRC flags identical."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid_nr, pdsch_nr, sch_nr
    from srsran_4g_tpu_torch.ops import ldpc

    name = f"harq {mod}" if harq else mod
    car = grid_nr.NrCarrierConfig(**NR_CARRIER)
    cfgs = [pdsch_nr.PdschNrConfig(carrier=car, rnti=NR_RNTI, slot=NR_SLOT, mod=mod, tbs=tbs,
                                   rv=rv) for rv in ((0, 2) if harq else (0,))]
    seg = cfgs[0].seg
    if (seg.C, seg.K, seg.bg, seg.z) != (n_cb, 8448, 1, 384):
        raise AssertionError(f"NR {name}: unexpected segmentation {seg}")
    log(f"nr path {name}: 273 PRB 30 kHz, {mod}, TBS {tbs}, G {cfgs[0].g_bits}, {seg.C} CBs "
        f"of K={seg.K} (BG{seg.bg}, Z={seg.z}), code rate {tbs / cfgs[0].g_bits:.3f}, "
        f"{NR_BATCH} slots, {snr_db} dB" + (", rv 0 then rv 2 combined" if harq else ""))
    bits = torch.randint(0, 2, (NR_BATCH, tbs), generator=gen, device=dev, dtype=torch.int8)
    nv = awgn.snr_to_noise_var(snr_db, device=dev)
    rx = [awgn.awgn(pdsch_nr.encode(c, bits), nv, generator=gen) for c in cfgs]
    first = pdsch_nr.decode(cfgs[0], rx[0])
    if harq:
        if bool(first["crc_ok"].all()):
            raise AssertionError(f"NR {name}: rv 0 alone passed every slot at {snr_db} dB")
        log(f"nr path {name}: rv 0 alone: {int(first['crc_ok'].sum())}/{NR_BATCH} slots pass")
        soft0 = first["softbuffers"]

        def decode():
            return pdsch_nr.decode(cfgs[1], rx[1], softbuffers=soft0)
    else:
        def decode():
            return pdsch_nr.decode(cfgs[0], rx[0])
    out = decode()
    if not bool(out["crc_ok"].all()) or not torch.equal(out["bits"], bits):
        raise AssertionError(f"NR {name}: CRC {out['crc_ok'].tolist()}, bits equal "
                             f"{(out['bits'] == bits).all(dim=1).tolist()}")
    if out["bits"].shape != (NR_BATCH, tbs) or not bool(torch.isfinite(out["noise_var"]).all()):
        raise AssertionError(f"NR {name}: output of the wrong shape or not finite")
    times = [stage_time(decode) for _ in range(NR_REPS)]
    best = min(times)
    torch.cuda.reset_peak_memory_stats()
    decode()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{card}] nr path {name}: every CRC passed, bits equal; decode of {NR_BATCH} slots best "
        f"{best * 1e3:.2f} ms of {NR_REPS} ({', '.join(f'{t * 1e3:.2f}' for t in times)}) = "
        f"{NR_BATCH / best:.1f} slots/s; peak memory {peak:.2f} GiB")
    prof = profile_window(decode, card, f"nr path {name} decode", best) or (float("nan"),) * 2

    # the LDPC decode alone, on the LLRs the decode gave it
    seen = {}
    real = ldpc.decode

    def spy(llrs, *a, **kw):
        seen["args"] = (llrs, *a)
        seen["kw"] = kw
        return real(llrs, *a, **kw)

    sch_nr.ldpc.decode = spy
    try:
        decode()
    finally:
        sch_nr.ldpc.decode = real
    ldpc_s = min(stage_time(lambda: real(*seen["args"], **seen["kw"])) for _ in range(NR_REPS))
    ldpc_prof = profile_window(lambda: real(*seen["args"], **seen["kw"]), card,
                               f"nr path {name} LDPC decode alone ({seen['args'][0].shape[0]} "
                               f"code words)", ldpc_s) or (float("nan"),) * 2
    log(f"[{card}] nr path {name}: LDPC decode {ldpc_s * 1e3:.2f} ms (host), device "
        f"{ldpc_prof[0]:.3f} ms in {ldpc_prof[1]:.0f} kernels = {ldpc_prof[0] / prof[0]:.3f} of "
        f"the decode's device time")

    # slot 0 on the CPU: the same port code, bits and CRC flags identical
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    out_c = pdsch_nr.decode(cfgs[0], rx[0][:1].to(cpu))
    if harq:
        out_c = pdsch_nr.decode(cfgs[1], rx[1][:1].to(cpu), softbuffers=out_c["softbuffers"])
    if not (torch.equal(out_c["bits"], out["bits"][:1].cpu())
            and torch.equal(out_c["crc_ok"], out["crc_ok"][:1].cpu())):
        raise AssertionError(f"NR {name}: slot 0 decodes differently on the CPU")
    log(f"nr path {name}: slot 0 on the CPU: bits and CRC flags identical to the card's "
        f"({time.perf_counter() - t0:.2f} s)")
    return dict(mod=mod, tbs=tbs, cbs=seg.C, snr_db=snr_db, slots=NR_BATCH,
                decode_ms=best * 1e3, slots_per_s=NR_BATCH / best, device_ms=prof[0],
                kernels=prof[1], idle_share=1 - prof[0] / (best * 1e3), peak_gib=peak,
                ldpc_ms=ldpc_s * 1e3, ldpc_device_ms=ldpc_prof[0], ldpc_kernels=ldpc_prof[1],
                ldpc_share=ldpc_prof[0] / prof[0])


def dci_path(dev, gen, card: str) -> dict:
    """DCI 1_0 for 273 PRB through the 38.212 polar chain at every
    aggregation level: payloads → dci_encode → QPSK → AWGN → soft demod →
    dci_decode, every CRC passing and payload equal; an RNTI that was not
    sent fails every CRC; the decode timed and profiled."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import dci_nr
    from srsran_4g_tpu_torch.ops import modem, polar_3gpp

    a = dci_nr.DciNr10(n_rb=NR_CARRIER["nof_prb"]).nof_bits
    nv = awgn.snr_to_noise_var(DCI_SNR_DB, device=dev)
    out = {}
    for agg in DCI_AGG:
        e = 108 * agg
        payload = torch.randint(0, 2, (DCI_BATCH, a), generator=gen, device=dev,
                                dtype=torch.int8)
        coded = polar_3gpp.dci_encode(payload, e, NR_RNTI)
        y = awgn.awgn(modem.modulate("qpsk", coded), nv, generator=gen)
        llr = modem.demodulate_soft("qpsk", y, nv)

        def decode(rnti=NR_RNTI):
            return polar_3gpp.dci_decode(llr, a, rnti)

        got = decode()
        if not bool(got["crc_ok"].all()) or not torch.equal(got["bits"].to(torch.int8), payload):
            raise AssertionError(f"DCI at L={agg}: CRC {got['crc_ok'].tolist()}")
        other = decode(NR_RNTI ^ 0x00FF)
        if bool(other["crc_ok"].any()):
            raise AssertionError(f"DCI at L={agg}: the unsent RNTI passed "
                                 f"{int(other['crc_ok'].sum())} CRCs")
        best = min(stage_time(decode) for _ in range(NR_REPS))
        prof = profile_window(decode, card, f"dci_decode of {DCI_BATCH} at L={agg}", best) \
            or (float("nan"),) * 2
        n = polar_3gpp.dci_sets(a + 24, e)[0]
        log(f"[{card}] DCI 1_0 ({a} bits) at L={agg} (E={e}, N={1 << n}): {DCI_BATCH}/"
            f"{DCI_BATCH} CRCs pass, payloads equal, the unsent RNTI fails all; dci_decode "
            f"{best * 1e3:.2f} ms, {prof[1]:.0f} kernels, device {prof[0]:.3f} ms")
        out[agg] = dict(E=e, N=1 << n, ms=best * 1e3, kernels=prof[1], device_ms=prof[0])
    return out


def nr_path(dev, card: str) -> dict:
    """The NR PDSCH at 100 MHz on the card (NR_POINTS, then the HARQ IR
    point), the NR CRC polynomials at the TB length against the host's
    integer CRC (``crc.crc_np``), then DCI polar coding at every aggregation
    level.  No turbo kernel may launch: NR uses none."""
    from srsran_4g_tpu_torch.ops import crc

    reset_counts()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bits = torch.randint(0, 2, (2, NR_CRC_BITS), generator=gen, device=dev, dtype=torch.int8)
    for key in ("24A", "24C", "11", "6"):
        got = crc.crc_compute(bits, key).cpu().numpy()
        if not np.array_equal(got, crc.crc_np(bits.cpu().numpy(), key)):
            raise AssertionError(f"CRC {key} at {NR_CRC_BITS} bits differs from crc_np's")
    log(f"nr path: CRC 24A, 24C, 11 and 6 of {NR_CRC_BITS}-bit messages on the card equal "
        f"the host's integer CRC")
    points = {p[0]: nr_point(dev, gen, card, *p) for p in NR_POINTS}
    points[f"harq {NR_HARQ[0]}"] = nr_point(dev, gen, card, *NR_HARQ, harq=True)
    dci = dci_path(dev, gen, card)
    if any(launch_counts().values()):
        raise AssertionError(f"nr path launched turbo kernels: {launch_counts()}")
    return dict(points=points, dci=dci)


class NrSlotClock:
    """Hooks on one ``tools.run_nr.run``: the UE MAC's once-a-slot ``tick``
    stamps each slot's host time (the device synchronised at the boundary),
    ``RrcNrUe`` is caught to see when its NAS registers, each of
    ``NrAirPhy``'s calls (NR_SYS_STAGES) and ``pdcch_nr.blind_decode`` are
    timed a slot, and, with ``profile``, torch.profiler covers the slots up
    to the registration and NR_SYS_PROFILE_SLOTS slots after it.  The hooks
    only observe."""

    def __init__(self, profile: bool) -> None:
        from torch.profiler import ProfilerActivity

        self.acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        self.profile = profile
        self.stamps: list[float] = []
        self.ue = None
        self.reg_slot: int | None = None
        self.profs: dict[str, tuple] = {}   # name -> (profiler, first slot, end slot)
        self.stage_s: dict[str, dict[int, float]] = {st: {} for st in NR_SYS_STAGES}
        self.search_s: list[float] = []

    def __enter__(self):
        from srsran_4g_tpu_torch.models import pdcch_nr
        from srsran_4g_tpu_torch.stack import rrc_nr, ue_mac_nr
        from srsran_4g_tpu_torch.tools import run_nr

        clock = self
        tick, init = ue_mac_nr.UeMacNr.tick, rrc_nr.RrcNrUe.__init__
        blind = pdcch_nr.blind_decode
        self._saved = [(ue_mac_nr.UeMacNr, "tick", tick), (rrc_nr.RrcNrUe, "__init__", init),
                       (pdcch_nr, "blind_decode", pdcch_nr.blind_decode)]
        self._saved += [(run_nr.NrAirPhy, st, getattr(run_nr.NrAirPhy, st))
                        for st in NR_SYS_STAGES]

        def tick_hook(mac, n):
            clock.slot_boundary()
            return tick(mac, n)

        def init_hook(ue, *a, **kw):
            init(ue, *a, **kw)
            clock.ue = ue

        def search(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return blind(*a, **kw)
            finally:
                torch.cuda.synchronize()
                clock.search_s.append(time.perf_counter() - t0)

        ue_mac_nr.UeMacNr.tick, rrc_nr.RrcNrUe.__init__ = tick_hook, init_hook
        pdcch_nr.blind_decode = search
        for st in NR_SYS_STAGES:
            setattr(run_nr.NrAirPhy, st, self._timed(st, getattr(run_nr.NrAirPhy, st)))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        for name, (_, _, end) in list(self.profs.items()):
            if end is None:
                self._stop(name)
        return False

    def _start(self, name: str) -> None:
        from torch.profiler import profile

        prof = profile(activities=self.acts)
        prof.start()
        self.profs[name] = (prof, len(self.stamps) - 1, None)   # from the slot now starting

    def _stop(self, name: str) -> None:
        prof, first, _ = self.profs[name]
        prof.stop()
        self.profs[name] = (prof, first, len(self.stamps) - 1)  # to the slot before it

    def _timed(self, stage: str, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                slot = len(self.stamps) - 1
                self.stage_s[stage][slot] = self.stage_s[stage].get(slot, 0.0) + (
                    time.perf_counter() - t0)
        return timed

    def slot_boundary(self) -> None:
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        slot = len(self.stamps) - 1   # the slot now starting
        if self.profile and slot == 0:
            self._start("attach")
        if self.reg_slot is None and self.ue is not None and self.ue.nas.state == "REGISTERED":
            self.reg_slot = slot
            if self.profile:
                self._stop("attach")
                self._start("after")
        elif (self.profile and self.reg_slot is not None and "after" in self.profs
              and self.profs["after"][2] is None and slot == self.reg_slot + NR_SYS_PROFILE_SLOTS):
            self._stop("after")

    def slot_ms(self) -> np.ndarray:
        return np.diff(self.stamps) * 1e3

    def window(self, name: str, card: str, host_stamps: list[float]) -> dict:
        """Device ms and kernels a slot over one profiled window, and its idle
        share against ``host_stamps``: an unprofiled run's slot boundaries
        (the run is deterministic, so its slots carry the same work)."""
        from torch.autograd import DeviceType

        prof, first, end = self.profs[name]
        n = max(end - first, 1)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        host = (host_stamps[end] - host_stamps[first]) * 1e3
        out = dict(slots=[first, end], device_ms_per_slot=busy / n,
                   kernels_per_slot=sum(e.count for e in kernels) / n, host_ms_per_slot=host / n,
                   host_ms_per_slot_profiled=(self.stamps[end] - self.stamps[first]) * 1e3 / n)
        if busy <= 0:
            log(f"[{card}] nr system path, {name} window: profiler saw no device time: idle "
                f"share not measured")
        else:
            out["idle_share"] = 1 - busy / host
        log(f"[{card}] nr system path, slots {first}-{end - 1} ({name}) profiled: device "
            f"{out['device_ms_per_slot']:.4f} ms in {out['kernels_per_slot']:.1f} kernels a slot"
            + (f"; idle share {out['idle_share']:.3f} of the unprofiled run's "
               f"{out['host_ms_per_slot']:.2f} ms a slot" if "idle_share" in out else "")
            + f" ({out['host_ms_per_slot_profiled']:.2f} ms a slot under the profiler)")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.self_device_time_total / 1e3 / n:8.4f} ms a slot  x{e.count / n:<7.1f} "
                f"{e.key[:90]}")
        return out


def nr_sys_checks(ok, stats, ue, amf) -> dict[str, bool]:
    """tests/test_run_nr.py::test_nr_sa_system_e2e's criteria."""
    from srsran_4g_tpu_torch.stack.usim import UsimConfig

    return {"SSB found": stats["ssb_found"] == 1,
            "exactly one PRACH": stats.get("prach_detected") == 1,
            "REGISTERED": ue.nas.state == "REGISTERED",
            "the AMF registered the IMSI": amf.registered_ues() == [UsimConfig().imsi],
            "0 PDSCH/PUSCH KO": stats["pdsch_ko"] == 0 and stats["pusch_ko"] == 0,
            "2 DL and 2 UL pings": stats["dl_ping_rx"] == 2 and stats["ul_ping_rx"] == 2,
            "HARQ-ACKs on PUCCH-NR": stats["ack_rx"] >= 1,
            "run_nr's own verdict": ok}


def nr_pusch_point(dev, gen, card: str, uci: bool) -> dict:
    """PUSCH-NR at 273 PRB, 64QAM, TBS 159,880, NR_BATCH slots at 30 dB on
    the card (with NR_UCI's ACK and CSI multiplexed when ``uci``): every CRC,
    data, ACK and CSI bit checked, timed and profiled; slot 0 decoded again
    on the CPU, identical."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid_nr, pusch_nr

    mod, tbs, snr_db, _ = NR_POINTS[1]
    car = grid_nr.NrCarrierConfig(**NR_CARRIER)
    kw = dict(carrier=car, rnti=NR_RNTI, slot=NR_SLOT, mod=mod, tbs=tbs)
    cfg = (pusch_nr.PuschNrUciConfig(uci=pusch_nr.NrUciCfg(**NR_UCI), **kw) if uci
           else pusch_nr.PuschNrConfig(**kw))
    name = f"PUSCH-NR {mod}" + (f" with UCI ({NR_UCI['o_ack']} ACK, {NR_UCI['o_csi']} CSI)"
                                if uci else "")
    bits = torch.randint(0, 2, (NR_BATCH, tbs), generator=gen, device=dev, dtype=torch.int8)
    ack, csi = (torch.randint(0, 2, (NR_BATCH, NR_UCI[k]), generator=gen, device=dev,
                              dtype=torch.int8) for k in ("o_ack", "o_csi"))
    tx = pusch_nr.encode_uci(cfg, bits, ack, csi) if uci else pusch_nr.encode(cfg, bits)
    rx = awgn.awgn(tx, awgn.snr_to_noise_var(snr_db, device=dev), generator=gen)

    def decode(x=rx):
        return pusch_nr.decode_uci(cfg, x) if uci else pusch_nr.decode(cfg, x)

    out = decode()
    want = dict(bits=bits, **(dict(ack_bits=ack, csi_bits=csi) if uci else {}))
    if not bool(out["crc_ok"].all()) or not all(torch.equal(out[k], v) for k, v in want.items()):
        raise AssertionError(f"{name}: CRC {out['crc_ok'].tolist()}, "
                             + ", ".join(f"{k} equal {torch.equal(out[k], v)}"
                                         for k, v in want.items()))
    best = min(stage_time(decode) for _ in range(NR_REPS))
    prof = profile_window(decode, card, f"nr channels: {name} decode of {NR_BATCH}", best) \
        or (float("nan"),) * 2
    t0 = time.perf_counter()
    cpu = decode(rx[:1].cpu())
    for k in ("crc_ok", *want):
        if not torch.equal(cpu[k], out[k][:1].cpu()):
            raise AssertionError(f"{name}: slot 0 on the CPU differs in {k}")
    log(f"[{card}] nr channels: {name} at 273 PRB, TBS {tbs}, {NR_BATCH} slots, {snr_db} dB: "
        f"every CRC and bit right; decode best {best * 1e3:.2f} ms of {NR_REPS} = "
        f"{NR_BATCH / best:.1f} slots/s; slot 0 on the CPU identical "
        f"({time.perf_counter() - t0:.2f} s)")
    return dict(ms=best * 1e3, slots_per_s=NR_BATCH / best, device_ms=prof[0], kernels=prof[1])


def nr_channels(dev, gen, card: str) -> dict:
    """The NR SA path's channels alone at full width on the card, each batch
    from the seeded generator, each held against the CPU run of the same
    inputs: PUSCH-NR (nr_pusch_point), a PDCCH-NR blind search of a 273 PRB
    CORESET (NR_PDCCH_BATCH captures, one DCI each at L = 1, 2 or 4, and an
    RNTI that was not sent, which must find nothing), PUCCH-NR F2 (CRC11 +
    polar) and F1, and the SSB search + PBCH on captures at random delays."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import dci_nr, pdcch_nr, pucch_nr, ssb, ue_sync_nr

    cpu = torch.device("cpu")
    out = {"pusch": nr_pusch_point(dev, gen, card, uci=False),
           "pusch_uci": nr_pusch_point(dev, gen, card, uci=True)}

    # ---- PDCCH-NR: one DCI a capture, the levels in turn --------------------
    coreset = pdcch_nr.CoresetConfig(nof_prb=NR_CARRIER["nof_prb"], pci=NR_CARRIER["pci"],
                                     slot=NR_SLOT)
    a = dci_nr.DciNr10(n_rb=NR_CARRIER["nof_prb"]).nof_bits
    payload = torch.randint(0, 2, (NR_PDCCH_BATCH, a), generator=gen, device=dev,
                            dtype=torch.int8)
    sent = []
    for i in range(NR_PDCCH_BATCH):
        agg, first = NR_PDCCH_AT[i % 3]
        start = (first + agg * (i // 3)) % (coreset.nof_cce - agg + 1) // agg * agg
        sent.append(pdcch_nr.encode(coreset, payload[i], NR_RNTI, aggregation=agg,
                                    start_cce=start))
    rx = awgn.awgn(torch.cat(sent), awgn.snr_to_noise_var(NR_PDCCH_SNR_DB, device=dev),
                   generator=gen)

    def search(rnti=NR_RNTI, x=rx):
        return pdcch_nr.blind_decode(coreset, x, rnti=rnti, dci_len=a)

    got, miss = search(), search(NR_RNTI ^ 0x00FF)
    if not bool(got["found"].all()) or not torch.equal(got["bits"], payload):
        raise AssertionError(f"PDCCH-NR search: found {int(got['found'].sum())}/"
                             f"{NR_PDCCH_BATCH}, bits equal {torch.equal(got['bits'], payload)}")
    if bool(miss["found"].any()):
        raise AssertionError(f"PDCCH-NR search: the unsent RNTI found {int(miss['found'].sum())}")
    for rnti, res in ((NR_RNTI, got), (NR_RNTI ^ 0x00FF, miss)):
        ref = search(rnti, rx.cpu())
        if not all(torch.equal(ref[k], res[k].cpu()) for k in ("found", "bits", "agg")):
            raise AssertionError(f"PDCCH-NR search for {rnti:#x}: the CPU differs")
    best = min(stage_time(search) for _ in range(NR_REPS))
    prof = profile_window(search, card, f"nr channels: PDCCH-NR search of {NR_PDCCH_BATCH}",
                          best) or (float("nan"),) * 2
    one = min(stage_time(lambda: search(x=rx[:1])) for _ in range(NR_REPS))
    prof1 = profile_window(lambda: search(x=rx[:1]), card, "nr channels: PDCCH-NR search of 1",
                           one) or (float("nan"),) * 2
    levels = {int(v): int(n) for v, n in zip(*torch.unique(got["agg"], return_counts=True))}
    log(f"[{card}] nr channels: PDCCH-NR search of a 273 PRB CORESET ({coreset.nof_cce} CCEs, "
        f"45 + 22 + 11 candidates) over {NR_PDCCH_BATCH} captures at {NR_PDCCH_SNR_DB} dB: "
        f"every DCI found with its bits (levels found {levels}), the unsent RNTI found none, "
        f"the CPU identical; {best * 1e3:.2f} ms a batch, {one * 1e3:.2f} ms for one capture")
    out["pdcch"] = dict(ms=best * 1e3, device_ms=prof[0], kernels=prof[1], ms_one=one * 1e3,
                        device_ms_one=prof1[0], kernels_one=prof1[1], levels=levels)

    # ---- PUCCH-NR F2 (CRC11 + polar) and F1 ---------------------------------
    f2 = pucch_nr.PucchNrF2Config(**NR_PUCCH_F2)
    uci = torch.randint(0, 2, (NR_PUCCH_BATCH, f2.nof_uci_bits), generator=gen, device=dev,
                        dtype=torch.int8)
    nv = awgn.snr_to_noise_var(NR_PUCCH_SNR_DB, device=dev)
    rx2 = awgn.awgn(pucch_nr.f2_encode(f2, uci), nv, generator=gen)
    f1 = pucch_nr.PucchNrF1Config(pci=NR_CARRIER["pci"], nof_symb=4)
    ack = torch.randint(0, 2, (NR_PUCCH_BATCH, 1), generator=gen, device=dev, dtype=torch.int8)
    rx1 = awgn.awgn(pucch_nr.f1_encode(f1, ack), nv, generator=gen)
    r2, r1 = pucch_nr.f2_decode(f2, rx2), pucch_nr.f1_decode(f1, rx1)
    if not (bool(r2["ok"].all()) and torch.equal(r2["bits"], uci)
            and torch.equal(r1["bits"], ack)):
        raise AssertionError(f"PUCCH-NR: F2 CRC {int(r2['ok'].sum())}/{NR_PUCCH_BATCH}, bits "
                             f"{torch.equal(r2['bits'], uci)}; F1 {torch.equal(r1['bits'], ack)}")
    c2, c1 = pucch_nr.f2_decode(f2, rx2.cpu()), pucch_nr.f1_decode(f1, rx1.cpu())
    if not (torch.equal(c2["bits"], r2["bits"].cpu()) and torch.equal(c2["ok"], r2["ok"].cpu())
            and torch.equal(c1["bits"], r1["bits"].cpu())):
        raise AssertionError("PUCCH-NR: the CPU differs")
    best2 = min(stage_time(lambda: pucch_nr.f2_decode(f2, rx2)) for _ in range(NR_REPS))
    prof2 = profile_window(lambda: pucch_nr.f2_decode(f2, rx2), card,
                           f"nr channels: PUCCH-NR F2 decode of {NR_PUCCH_BATCH}", best2) \
        or (float("nan"),) * 2
    log(f"[{card}] nr channels: PUCCH-NR F2 ({f2.nof_uci_bits} bits, E {f2.e_bits}) and F1 "
        f"ACKs, {NR_PUCCH_BATCH} each at {NR_PUCCH_SNR_DB} dB: every CRC and bit right, the "
        f"CPU identical; F2 decode {best2 * 1e3:.2f} ms")
    out["pucch_f2"] = dict(ms=best2 * 1e3, device_ms=prof2[0], kernels=prof2[1])

    # ---- SSB search + PBCH on captures at random delays ---------------------
    mib = torch.randint(0, 2, (NR_SSB_BATCH, 32), generator=gen, device=dev, dtype=torch.int8)
    t = ue_sync_nr.ssb_to_samples(ssb.assemble(ssb.SsbConfig(pci=NR_SSB_PCI), mib))
    delay = torch.randint(0, 600, (NR_SSB_BATCH,), generator=gen, device=dev)
    n = 600 + t.shape[1] + 200
    pos = delay[:, None] + torch.arange(t.shape[1], device=dev)[None]
    stream = torch.zeros((NR_SSB_BATCH, n), dtype=torch.complex64, device=dev)
    stream.scatter_(1, pos, t)
    sig = float(t.abs().square().mean())
    cap = awgn.awgn(stream, sig * float(awgn.snr_to_noise_var(NR_SSB_SNR_DB, device=dev)),
                    generator=gen)

    def cell_search(x=cap):
        found = ue_sync_nr.pss_time_correlate(x, 256)
        grid = ue_sync_nr.extract_ssb_grid(x, found["offset"], 256, 18)
        return found, ssb.search_pci(grid), ssb.decode_pbch(ssb.SsbConfig(pci=NR_SSB_PCI), grid)

    found, pci, pbch = cell_search()
    if not (torch.equal(found["offset"], delay + 18) and bool((pci["pci"] == NR_SSB_PCI).all())
            and bool(pbch["crc_ok"].all()) and torch.equal(pbch["payload"], mib)):
        raise AssertionError(f"SSB search: offsets {torch.equal(found['offset'], delay + 18)}, "
                             f"PCI {int((pci['pci'] == NR_SSB_PCI).sum())}, CRC "
                             f"{int(pbch['crc_ok'].sum())}/{NR_SSB_BATCH}")
    f_c, p_c, b_c = cell_search(cap.cpu())
    if not (torch.equal(f_c["offset"], found["offset"].cpu())
            and torch.equal(p_c["pci"], pci["pci"].cpu())
            and torch.equal(b_c["payload"], pbch["payload"].cpu())
            and torch.equal(b_c["crc_ok"], pbch["crc_ok"].cpu())
            and float((f_c["metric"] - found["metric"].cpu()).abs().max()) <= 1e-3):
        raise AssertionError("SSB search: the CPU differs")
    best3 = min(stage_time(cell_search) for _ in range(NR_REPS))
    prof3 = profile_window(cell_search, card, f"nr channels: SSB search + PBCH of "
                           f"{NR_SSB_BATCH}", best3) or (float("nan"),) * 2
    log(f"[{card}] nr channels: SSB search + PBCH over {NR_SSB_BATCH} captures of {n} samples "
        f"at {NR_SSB_SNR_DB} dB: every offset exact, PCI {NR_SSB_PCI}, MIB CRC and bits right, "
        f"the CPU identical (metric within 1e-3); {best3 * 1e3:.2f} ms a batch")
    out["ssb"] = dict(ms=best3 * 1e3, device_ms=prof3[0], kernels=prof3[1])
    return out


def nr_system_path(dev, card: str) -> dict:
    """The port's tools/run_nr.run at 100 MHz (NR_SYS_RUN) on the card, held
    to tests/test_run_nr.py's criteria with no turbo kernel launched, three
    times: cold (the first calls' costs in its wall time), warm (slots/s, the
    slot's host ms, each air call and the PDCCH-NR search a DL slot), and
    under torch.profiler over the attach's slots and NR_SYS_PROFILE_SLOTS
    slots after the registration (device ms and kernels a slot; idle share
    against the warm run's host time of the same slots); the peak memory;
    then the path's channels alone at full width (nr_channels)."""
    from srsran_4g_tpu_torch.tools import run_nr

    run = dict(NR_SYS_RUN)
    log(f"nr system path: run_nr.run({', '.join(f'{k}={v}' for k, v in run.items())}) on {dev}, "
        f"cold, warm, then profiled")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    clocks, walls = [], []
    for profiled in (False, False, True):
        with NrSlotClock(profile=profiled) as clock:
            t0 = time.perf_counter()
            ok, stats, ue, amf = run_nr.run(**run, device=dev)
            clock.slot_boundary()   # the end of the last slot
            walls.append(time.perf_counter() - t0)
        checks = nr_sys_checks(ok, stats, ue, amf)
        checks["no turbo kernel launched"] = not any(launch_counts().values())
        if not all(checks.values()):
            raise AssertionError(f"nr system path: {checks}; {stats}")
        if clocks and (stats != clocks[0][1] or clock.reg_slot != clocks[0][0].reg_slot):
            raise AssertionError(f"nr system path: runs differ: {stats}, {clocks[0][1]}")
        clocks.append((clock, stats))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"nr system path: stats {stats}; registered at slot {clock.reg_slot}; every "
        f"criterion passed in each run ({', '.join(checks)})")
    (cold, _), (warm, _), (pclock, _) = clocks
    ms = warm.slot_ms()
    loop_s = warm.stamps[-1] - warm.stamps[0]
    dl_slots = len(warm.stage_s["gnb_dl_tx"])
    stages = {st: sum(v.values()) * 1e3 / len(ms) for st, v in warm.stage_s.items()}
    search_ms = np.asarray(warm.search_s) * 1e3
    log(f"[{card}] nr system path: {run['n_slots']} slots: cold run {walls[0]:.2f} s "
        f"({run['n_slots'] / walls[0]:.2f} slots/s; its slot loop "
        f"{cold.stamps[-1] - cold.stamps[0]:.2f} s), warm run {walls[1]:.2f} s = "
        f"{run['n_slots'] / walls[1]:.2f} slots/s, its slot loop {loop_s:.2f} s = "
        f"{run['n_slots'] / loop_s:.2f} slots/s (the air's 2,000 at 30 kHz); warm host ms a "
        f"slot: median {np.median(ms):.3f}, p90 {np.percentile(ms, 90):.2f}, max "
        f"{ms.max():.2f}; {dl_slots} slots carried a DL grid; peak memory {peak:.3f} GiB")
    log(f"[{card}] nr system path, warm host ms a slot by air call (mean over the run): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; the rest (stack, MAC, RLC, NAS, AMF) {np.mean(ms) - sum(stages.values()):.3f}")
    log(f"[{card}] nr system path: {len(search_ms)} PDCCH-NR searches "
        f"({len(search_ms) / max(dl_slots, 1):.2f} a DL slot), median {np.median(search_ms):.2f} "
        f"ms, {search_ms.sum() / max(dl_slots, 1):.2f} ms a DL slot")
    prof = {name: pclock.window(name, card, warm.stamps) for name in pclock.profs}
    channels = nr_channels(dev, torch.Generator(device=dev).manual_seed(SEED), card)
    if any(launch_counts().values()):
        raise AssertionError(f"nr system path launched turbo kernels: {launch_counts()}")
    search_kernels = channels["pdcch"]["kernels_one"]
    log(f"[{card}] nr system path: a PDCCH-NR search of one capture takes {search_kernels:.0f} "
        f"kernels ({channels['pdcch']['device_ms_one']:.3f} device ms), "
        f"{search_kernels * len(search_ms) / max(dl_slots, 1):.0f} a DL slot")
    return dict(cold_s=walls[0], warm_s=walls[1], slots_per_s=run["n_slots"] / walls[1],
                loop_slots_per_s=run["n_slots"] / loop_s, reg_slot=warm.reg_slot,
                slot_ms=dict(median=float(np.median(ms)), p90=float(np.percentile(ms, 90)),
                             max=float(ms.max())),
                dl_slots=dl_slots, stage_ms=stages, peak_gib=peak,
                search=dict(n=len(search_ms), ms_median=float(np.median(search_ms)),
                            ms_per_dl_slot=float(search_ms.sum() / max(dl_slots, 1)),
                            kernels=search_kernels),
                profile=prof, channels=channels)


# ---- the sidelink TM3/4 transmitter: a fixture of this script and of the
# port's tests, built from the port's own pieces (the JAX package has no
# TM3/4 transmitter, so the port has none either) ------------------------------


def sl_samples(grids: torch.Tensor, symbol_sz: int) -> torch.Tensor:
    """(S, 14, nre) sidelink subframe grids → (S·15·symbol_sz,) samples, the
    inverse of ``sidelink.sl_subframe_grid``: SC-FDMA with the +7.5 kHz
    shift whose phase origin is each symbol's body, so each cyclic prefix
    continues its symbol (the body's tail, negated)."""
    from srsran_4g_tpu_torch.models import sidelink as SL

    s, _, nre = grids.shape
    n = symbol_sz
    X = grids.new_zeros((s, 14, n))
    X[..., -(nre // 2):] = grids[..., :nre // 2]
    X[..., :nre // 2] = grids[..., nre // 2:]
    x = torch.fft.ifft(X, dim=-1) * np.sqrt(n)
    body = SL._body_index(n, False, torch.device("cpu")).numpy()
    sym = np.concatenate([np.full(n + body[l, 0] - (body[l - 1, -1] + 1 if l else 0), l)
                          for l in range(14)])
    k = np.concatenate([np.arange(body[l - 1, -1] + 1 if l else 0, body[l, -1] + 1) - body[l, 0]
                        for l in range(14)])
    rot = torch.as_tensor(np.exp(1j * np.pi * k / n).astype(np.complex64), device=grids.device)
    idx = (torch.as_tensor(sym, device=grids.device), torch.as_tensor(k % n, device=grids.device))
    return (x[:, idx[0], idx[1]] * rot).reshape(-1)


def slss_grid(n_sl_id: int, nof_prb: int, mib_bits: np.ndarray, dev) -> torch.Tensor:
    """(14, nre) TM3/4 SLSS subframe: the PSBCH (MIB-SL-V2X) with its DMRS,
    the PSSS on symbols 1-2 and the SSSS on 11-12, each on the 62 centre
    subcarriers either side of DC where ``slss_find``'s matched filter
    reads them."""
    from srsran_4g_tpu_torch.models import sidelink as SL

    g = SL.psbch_tx_subframe(n_sl_id, nof_prb, mib_bits[None], tm=4, device=dev)[0]
    c = nof_prb * 6
    cols = torch.cat([torch.arange(c - 31, c), torch.arange(c + 1, c + 32)]).to(dev)
    g[1:3, cols] = torch.as_tensor(SL.psss_for_id(n_sl_id), device=dev)
    g[11:13, cols] = torch.as_tensor(SL.ssss_sequence(n_sl_id), device=dev)
    return g


def sl34_grids(sci_bits: np.ndarray, sub_channel: int, cyclic_shift: int, tb: torch.Tensor,
               pool, sf_idx: int, rv: int) -> torch.Tensor:
    """(1, 14, nre) TM3/4 PSCCH (SCI format 1 on the subchannel's first 2 PRB,
    its DMRS at ``cyclic_shift``) and the adjacent PSSCH the SCI grants
    (N_X_ID from the PSCCH CRC), with the port's receive-side tables."""
    from srsran_4g_tpu_torch.models import ra, sch, sidelink as SL
    from srsran_4g_tpu_torch.models.pusch import transform_precode
    from srsran_4g_tpu_torch.ops import modem
    from srsran_4g_tpu_torch.ops.scrambling import scramble_bits

    dev, nre = tb.device, pool.nof_prb * 12
    n_data = len(SL.SL34_DATA_SYMS)
    layout = dict(data_syms=SL.SL34_DATA_SYMS, dmrs_syms=SL.SL34_DMRS_SYMS)
    e = n_data * SL.PSCCH34_NOF_PRB * 12 * 2
    bits = torch.as_tensor(sci_bits[None], dtype=torch.int8, device=dev)
    coded = SL._crc_tbcc(bits, e)[..., SL._perms_t(e, 2, True, dev)[0]]
    syms = modem.modulate("qpsk", scramble_bits(coded, SL._gold_t(SL.PSCCH_SCRAMBLING_SEED,
                                                                  e, dev)))
    grid = SL._sl_map(transform_precode(syms.reshape(1, n_data, 24)),
                      np.tile(SL._pscch34_dmrs(cyclic_shift)[None], (4, 1)), nre,
                      sub_channel * pool.size_sub_channel, SL.PSCCH34_NOF_PRB, **layout)
    n_x = SL.sci0_n_x_id(sci_bits)
    sci = SL.SciFormat1.unpack(sci_bits, pool.num_sub_channel)
    ps, nprb = SL.pssch34_prbs(sub_channel, sci.riv, pool.size_sub_channel,
                               pool.num_sub_channel, pool.start_prb_sub_channel)
    mod = ra.ul_mcs_to_mod(sci.mcs)
    qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[mod]
    g = n_data * 12 * nprb * qm
    cw = sch.dlsch_encode(sch.dlsch_plan(tb.shape[-1], g, qm, rv), tb[None])
    cw = cw[..., SL._perms_t(g, qm, True, dev)[0]]
    cinit = ((n_x << 14) + ((sf_idx % 10) << 9) + 510) % (1 << 31)
    syms = modem.modulate(mod, scramble_bits(cw, SL._gold_t(cinit, g, dev)))
    return grid + SL._sl_map(transform_precode(syms.reshape(1, n_data, 12 * nprb)),
                             SL._pssch34_dmrs(n_x, sf_idx, nprb), nre, ps, nprb, **layout)


def sl_tm4_stream(dev, gen, rng, pool, symbol_sz: int, schedule, n_sl_id: int,
                  mib_bits: np.ndarray, lead: int, snr_db: float):
    """A TM3/4 capture: ``lead`` samples of noise, one SLSS subframe, then a
    data subframe for each entry of ``schedule`` — a list of vehicles
    (sub_channel, l_subch, mcs, retransmission[, cyclic shift]), each a
    PSCCH at its cyclic shift (else a random one) and the PSSCH it grants
    with random TB bits (``gen``) — each
    subframe at a random phase (``rng``), AWGN at ``snr_db`` per RE.  The
    SLSS subframe is subframe index 0, data subframe i index (i+1) % 10.
    Returns (samples (L,) complex64, the vehicles sent: dicts of sf, sci,
    sub_channel, tbs, tb)."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import ra, sidelink as SL, sl_rx

    nre = pool.nof_prb * 12
    grids, sent = [slss_grid(n_sl_id, pool.nof_prb, mib_bits, dev)], []
    for i, vehicles in enumerate(schedule):
        g = torch.zeros((1, 14, nre), dtype=torch.complex64, device=dev)
        for sub, l_subch, mcs, retx, *cs in vehicles:
            sci = SL.SciFormat1(priority=int(rng.integers(8)), resource_reserv=1,
                                riv=ra.riv_encode(pool.num_sub_channel, l_subch, sub),
                                mcs=mcs, retransmission=retx)
            _, nprb = SL.pssch34_prbs(sub, sci.riv, pool.size_sub_channel,
                                      pool.num_sub_channel, pool.start_prb_sub_channel)
            tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(mcs), nprb)
            tb = torch.randint(0, 2, (tbs,), generator=gen, device=dev, dtype=torch.int8)
            shift = cs[0] if cs else int(rng.choice(sl_rx.CYCLIC_SHIFTS))
            g = g + sl34_grids(sci.pack(pool.num_sub_channel), sub, shift, tb, pool,
                               (i + 1) % 10, sl_rx.PSSCH_RV[1 if retx else 0])
            sent.append(dict(sf=i + 1, sci=sci, sub_channel=sub, tbs=tbs, tb=tb))
        grids.append(g[0])
    phase = torch.as_tensor(np.exp(2j * np.pi * rng.random(len(grids))).astype(np.complex64),
                            device=dev)
    x = (sl_samples(torch.stack(grids), symbol_sz).reshape(len(grids), -1) * phase[:, None])
    x = torch.cat([x.new_zeros(lead), x.reshape(-1)])
    return awgn.awgn(x, 10.0 ** (-snr_db / 10.0), generator=gen), sent


def sl_schedule(n_sf: int, mcs: int) -> list:
    """SL_DATA_SF's traffic: two vehicles on subchannels 0-4 and 5-9 in three
    of every four subframes, one over all ten in every fourth."""
    return [[(0, 10, mcs, 0)] if i % 4 == 3 else [(0, 5, mcs, 0), (5, 5, mcs, 0)]
            for i in range(n_sf)]


def kernel_entry(w: str, args, launches: int, shapes: dict, card: str, what: str) -> dict:
    """A default-route kernel against its plain version at the largest shape
    a path launched it at, timed and bounded, for the kernels line."""
    r = check_kernel(SYS_ROUTE[w], args, time_it=True)
    gs, _, _, _, t, l, b, nw = args
    nbytes, adds, maxes = work(w, b, l * nw, l, t)
    bound_ms, bound_by = bound(nbytes, adds, maxes, "bf16" if w in BF16_WRAPPERS else "f32")
    log(f"[{card}] {what} {w} at its largest shape B={b} K={l * nw} L={l} T={t}: "
        f"{r['ms']:.4f} ms against a bound of {bound_ms:.4f} ms ({bound_by}); plain "
        f"{r['plain_ms']:.2f} ms; max|diff| {r['max_abs_err']}; {launches} launches")
    return dict(launches=launches,
                shapes=[dict(blocks=k[0], K=k[1], L=k[2], T=k[3], calls=n)
                        for k, n in sorted(shapes.items())],
                largest=dict(blocks=b, K=l * nw, L=l, T=t, lanes=gs.shape[1]),
                max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)


def sidelink_path(dev, card: str) -> dict:
    """20 MHz V2X TM4 from samples: SLSS timing and the PSBCH (MIB-SL-V2X),
    then ``sl_rx.decode_capture`` over the SLSS subframe and SL_DATA_SF data
    subframes (the PSCCH blind search of every subframe in one batch, a
    PSSCH decode per SCI through the turbo kernels); every SCI and TB checked
    against what was sent, both default-route kernels launched and held
    against their plain versions at the largest shape, one subframe decoded
    again on the CPU, the host time a subframe, then SL_PROFILE_SF data
    subframes profiled.  Returns each kernel's entry for the kernels line."""
    from srsran_4g_tpu_torch.models import sidelink as SL, sl_rx

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    pool = sl_rx.SlPool.default(SL_PRB, SL_TM)
    mib = SL.MibSl(**SL_MIB).pack(v2x=True)
    sf_len, n_sf = 15 * SL_SYMBOL_SZ, 1 + SL_DATA_SF
    lead = int(rng.integers(sf_len))
    samples, sent = sl_tm4_stream(dev, gen, rng, pool, SL_SYMBOL_SZ,
                                  sl_schedule(SL_DATA_SF, SL_MCS), SL_N_SL_ID, mib, lead,
                                  SL_SNR_DB)
    log(f"sidelink path: {SL_PRB} PRB TM{SL_TM}, {pool.num_sub_channel} subchannels of "
        f"{pool.size_sub_channel} PRB, lead {lead}, 1 SLSS + {SL_DATA_SF} data subframes, "
        f"{len(sent)} vehicles at MCS {SL_MCS}, {SL_SNR_DB} dB")

    # ---- SLSS timing and the PSBCH ------------------------------------------
    coarse = SL.slss_find(samples, SL_PRB, SL_SYMBOL_SZ, 37 if SL_N_SL_ID >= 168 else 26)
    sync = SL.psbch_sync_decode(samples, SL_PRB, SL_SYMBOL_SZ, SL_N_SL_ID, tm=SL_TM)
    sync_s = stage_time(lambda: SL.psbch_sync_decode(samples, SL_PRB, SL_SYMBOL_SZ, SL_N_SL_ID,
                                                     tm=SL_TM))
    checks = {"SLSS timing exact": coarse["offset"] == lead,
              "PSBCH CRC": sync["crc_ok"],
              "MIB-SL-V2X bits": sync["crc_ok"] and np.array_equal(sync["mib"], mib),
              # the first CRC-passing fine-timing hypothesis: 8 samples into the CP
              "PSBCH offset the first hypothesis": sync["offset"] == lead - 8}
    if not all(checks.values()):
        raise AssertionError(f"sidelink path: {checks}; slss {coarse}, offset {sync['offset']}")

    # ---- the blind receiver, cold then counted -------------------------------
    def receive(n=n_sf, x=samples, offset=sync["offset"], first=0):
        return sl_rx.decode_capture(x, SL_PRB, SL_TM, SL_SYMBOL_SZ, pool, first_sf_idx=first,
                                    file_offset=offset, max_subframes=n)

    cold_s = stage_time(receive)
    decoded, pssch_s, search_s = [], [], []
    orig_pssch, orig_search = SL.pssch34_decode, sl_rx.pscch34_search

    def pssch_spy(grid, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_pssch(grid, *args, **kw)
        decoded.append(out["bits"][0])
        torch.cuda.synchronize()
        pssch_s.append(time.perf_counter() - t0)
        return out

    def search_spy(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_search(*args, **kw)
        search_s.append(time.perf_counter() - t0)
        return out

    reset_counts()
    SL.pssch34_decode, sl_rx.pscch34_search = pssch_spy, search_spy
    try:
        with TurboSpy() as spy:
            t0 = time.perf_counter()
            res = receive()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        SL.pssch34_decode, sl_rx.pscch34_search = orig_pssch, orig_search
    launches = launch_counts()
    events = res["events"]
    got = [(e["sf"], e["sub_channel"], e["sci"], e["mcs"], e["tbs"]) for e in events]
    want = [(s["sf"], s["sub_channel"], s["sci"], SL_MCS, s["tbs"]) for s in sent]
    checks = {f"{len(sent)} of {len(sent)} SCIs": res["num_decoded_sci"] == len(sent),
              "every SCI's subframe, subchannel, fields, MCS and TBS": got == want,
              "every TB's CRC": res["num_decoded_tb"] == len(sent)
              and all(e["crc_ok"] for e in events),
              "every TB's bits": len(decoded) == len(sent) and all(
                  torch.equal(d, s["tb"]) for d, s in zip(decoded, sent)),
              "map_fused16 and map_windowed launched": all(launches[w] > 0 for w in SL_SHAPES),
              "no other turbo kernel": not any(v for w, v in launches.items()
                                               if w not in SL_SHAPES),
              "the shapes": all(max(spy.shapes[w], key=lambda k: k[0] * k[1] // k[2])[:3]
                                == SL_SHAPES[w] for w in SL_SHAPES)}
    if not all(checks.values()):
        raise AssertionError(f"sidelink path: {checks}; {res['num_decoded_sci']} SCIs, "
                             f"{res['num_decoded_tb']} TBs; launches {launches}; "
                             f"shapes {spy.shapes}")
    log(f"sidelink path: every check passed ({', '.join(checks)}); launches {launches}; "
        f"shapes (B, K, L, T): " + "; ".join(f"{w} {dict(sorted(v.items()))}"
                                             for w, v in spy.shapes.items()))

    # ---- one subframe again on the CPU ----------------------------------------
    cpu = receive(1, samples.cpu(), sync["offset"] + sf_len, 1)
    card_sf1 = [dict(e, sf=0) for e in events if e["sf"] == 1]
    if cpu["events"] != card_sf1 or len(card_sf1) != 2:
        raise AssertionError(f"sidelink path: the CPU's events of subframe 1 differ: "
                             f"{cpu['events']} vs {card_sf1}")

    # ---- host time a subframe, and a profile of SL_PROFILE_SF data subframes --
    by_sf = {}
    for e, secs in zip(events, pssch_s):
        by_sf[e["sf"]] = by_sf.get(e["sf"], 0.0) + secs
    per_sf = np.asarray([by_sf.get(sf, 0.0) for sf in range(1, n_sf)]) * 1e3
    share = search_s[0] / n_sf * 1e3
    log(f"[{card}] sidelink path: {n_sf} subframes decoded in {wall * 1e3:.2f} ms "
        f"({wall / n_sf * 1e3:.2f} ms a subframe against the air's 1 ms; cold run "
        f"{cold_s * 1e3:.2f} ms); SLSS + PSBCH sync {sync_s * 1e3:.2f} ms; PSCCH search of "
        f"all {n_sf} subframes in one batch {search_s[0] * 1e3:.2f} ms ({share:.2f} ms a "
        f"subframe); PSSCH decodes a data subframe: median {np.median(per_sf):.2f} ms, p90 "
        f"{np.percentile(per_sf, 90):.2f} ms; host ms a data subframe (its decodes + its "
        f"search share): median {np.median(per_sf) + share:.2f}, p90 "
        f"{np.percentile(per_sf, 90) + share:.2f}")
    n_prof = 1 + min(SL_PROFILE_SF, SL_DATA_SF)
    grids = SL.sl_subframe_grid(samples[sync["offset"]:sync["offset"] + n_prof * sf_len]
                                .reshape(n_prof, sf_len), SL_PRB, SL_SYMBOL_SZ)
    rx_s = min(stage_time(lambda: receive(n_prof)) for _ in range(3))
    srch_s = min(stage_time(lambda: sl_rx.pscch34_search(grids, pool)) for _ in range(3))
    prof = profile_window(lambda: receive(n_prof), card, f"sidelink path: the receiver over "
                          f"{n_prof} subframes", rx_s) or (float("nan"),) * 2
    prof_s = profile_window(lambda: sl_rx.pscch34_search(grids, pool), card,
                            f"sidelink path: the PSCCH search of {n_prof} subframes",
                            srch_s) or (float("nan"),) * 2
    log(f"[{card}] sidelink path over {n_prof} subframes: {rx_s * 1e3:.2f} ms host, device "
        f"{prof[0]:.3f} ms in {prof[1]:.0f} kernels (idle {1 - prof[0] / (rx_s * 1e3):.3f}); "
        f"the PSCCH search {srch_s * 1e3:.2f} ms host, device {prof_s[0]:.3f} ms in "
        f"{prof_s[1]:.0f} kernels (idle {1 - prof_s[0] / (srch_s * 1e3):.3f}); the PSSCH "
        f"decodes and the rest {(rx_s - srch_s) * 1e3:.2f} ms host, device "
        f"{prof[0] - prof_s[0]:.3f} ms in {prof[1] - prof_s[1]:.0f} kernels")
    entries = {w: kernel_entry(w, spy.largest[w][1], launches[w], spy.shapes[w], card,
                               "sidelink path") for w in SL_SHAPES}
    return dict(entries=entries, wall_ms=wall * 1e3, ms_per_sf=wall / n_sf * 1e3,
                cold_ms=cold_s * 1e3, sync_ms=sync_s * 1e3, search_ms=search_s[0] * 1e3,
                pssch_ms_per_sf=dict(median=float(np.median(per_sf)),
                                     p90=float(np.percentile(per_sf, 90))),
                profile=dict(subframes=n_prof, host_ms=rx_s * 1e3, device_ms=prof[0],
                             kernels=prof[1], search_host_ms=srch_s * 1e3,
                             search_device_ms=prof_s[0], search_kernels=prof_s[1]))


def nb_channel(dev, gen, grid: torch.Tensor, snr_db: float) -> torch.Tensor:
    """A random complex gain (amplitude 0.5-1.5, any phase) a capture and
    AWGN at ``snr_db`` per RE of unit power after the gain."""
    from srsran_4g_tpu_torch.channel import awgn

    shape = (grid.shape[0],) + (1,) * (grid.dim() - 1)
    amp = 0.5 + torch.rand(shape, generator=gen, device=dev)
    ph = 2 * np.pi * torch.rand(shape, generator=gen, device=dev)
    noise = awgn.awgn(torch.zeros_like(grid), 10.0 ** (-snr_db / 10.0), generator=gen)
    return (grid + noise) * torch.polar(amp, ph)


def timed_point(fn, card: str, what: str) -> dict:
    """Best of 3 host ms of fn() and one profiled call (device ms, kernels)."""
    best = min(stage_time(fn) for _ in range(3))
    prof = profile_window(fn, card, what, best, reps=1, cpu_ops=False) or (float("nan"),) * 2
    return dict(ms=best * 1e3, device_ms=prof[0], kernels=prof[1],
                idle=1 - prof[0] / (best * 1e3))


def nbiot_path(dev, card: str) -> dict:
    """A standalone NB-IoT cell from grids, NB_BATCH captures a batch, each
    with a random complex gain and AWGN: the NPSS metric, the NSSS search over
    all 504 ids (three cell ids across the batch), the NPBCH carrying an
    ``rrc_nbiot.MibNb`` at three frames (one r14), DCI N1 on each NPDCCH
    candidate (and an RNTI not sent), the NPDSCH at three points, one the
    BCCH carrying a packed SIB1-NB; every CRC, bit, cell id and field
    checked, one capture of each point decoded again on the CPU, each point
    timed and profiled; no turbo kernel may launch."""
    from srsran_4g_tpu_torch.models import nbiot, nbiot_data as nb
    from srsran_4g_tpu_torch.stack import rrc_nbiot

    gen = torch.Generator(device=dev).manual_seed(SEED)
    b = NB_BATCH
    reset_counts()
    out, checks = {}, {}
    zeros = torch.zeros((b, 14, 12), dtype=torch.complex64, device=dev)

    # ---- NPSS and NSSS ----------------------------------------------------
    rx = nb_channel(dev, gen, nbiot.put_npss(zeros), 5.0)
    noise = nb_channel(dev, gen, zeros, 0.0)
    checks["NPSS metric > 0.5, noise < 0.2"] = bool((nbiot.npss_metric(rx) > 0.5).all()) \
        and bool((nbiot.npss_metric(noise) < 0.2).all())
    cells = torch.as_tensor(NB_NSSS_CELLS, device=dev)[torch.arange(b, device=dev) % 3]
    g = torch.cat([nbiot.put_nsss(zeros[i::3], c) for i, c in enumerate(NB_NSSS_CELLS)])
    cells = torch.cat([cells[i::3] for i in range(3)])
    rx_nsss = nb_channel(dev, gen, g, 6.0)
    det = nbiot.nsss_detect(rx_nsss)
    checks["NSSS cell ids"] = torch.equal(det["cell_id"], cells)
    ref = nbiot.nsss_detect(rx_nsss[:1].cpu())
    checks["NSSS on the CPU"] = torch.equal(ref["cell_id"], det["cell_id"][:1].cpu()) and \
        float((ref["metric"] - det["metric"][:1].cpu()).abs().max()) <= 1e-3
    out["nsss"] = timed_point(lambda: nbiot.nsss_detect(rx_nsss), card,
                              f"nbiot path: NSSS over 504 ids, {b} grids")

    # ---- NPBCH with an rrc_nbiot MIB-NB ----------------------------------
    mib = rrc_nbiot.MibNb(sfn_msb=5, scheduling_info_sib1=3, system_info_value_tag=9)
    mib_bits = np.unpackbits(np.frombuffer(mib.pack(), np.uint8))[:nbiot.MIB_NB_LEN]
    bits = torch.as_tensor(np.tile(mib_bits, (b, 1)).astype(np.int8), device=dev)
    for frame, r14 in NB_NPBCH_FRAMES:
        block = (frame // nbiot.NPBCH_REP) % nbiot.NPBCH_BLOCKS
        rx_b = nb_channel(dev, gen, nbiot.npbch_encode(NB_CELL, bits, frame_idx=frame,
                                                       is_r14=r14), 8.0)

        def dec(x=rx_b, block=block, frame=frame, r14=r14):
            return nbiot.npbch_decode(NB_CELL, x, block_idx=block, nf=frame, is_r14=r14)

        res = dec()
        rx_mib = rrc_nbiot.MibNb.unpack(np.packbits(res["mib"][0].cpu().numpy().astype(
            np.uint8)).tobytes())
        c = dec(rx_b[:1].cpu())
        checks[f"NPBCH frame {frame}"] = bool(res["crc_ok"].all()) and torch.equal(
            res["mib"], bits) and bool((res["n_ports"] == 1).all()) and rx_mib == mib \
            and all(torch.equal(c[k], res[k][:1].cpu()) for k in c)
        out[f"npbch_{frame}"] = timed_point(dec, card, f"nbiot path: NPBCH frame {frame} of {b}")

    # ---- NPDCCH: DCI N1 on each candidate, and an unsent RNTI -------------
    dci = nb.DciN1(i_delay=0, i_sf=1, mcs=4, i_rep=0, ndi=1, harq_ack=2)
    dci_bits = torch.as_tensor(np.tile(dci.pack(), (b, 1)), device=dev)
    for cand, (ncce, l_agg) in enumerate(nb.CANDIDATES):
        rx_c = nb_channel(dev, gen, nb.npdcch_encode(dci_bits, NB_RNTI, NB_CELL, subframe=1,
                                                     ncce=ncce, l_agg=l_agg), 8.0)

        def dec(x=rx_c, rnti=NB_RNTI):
            return nb.npdcch_blind_decode(x, rnti, NB_CELL, subframe=1)

        res, miss = dec(), dec(rnti=NB_RNTI + 1)
        c = dec(rx_c[:1].cpu())
        checks[f"NPDCCH candidate {cand}"] = bool(res["crc_ok"][:, cand].all()) and \
            torch.equal(res["bits"][:, cand], dci_bits) and \
            nb.unpack_dci_n1(res["bits"][0, cand].cpu().numpy()) == dci and \
            not bool(miss["crc_ok"].any()) and \
            all(torch.equal(c[k], res[k][:1].cpu()) for k in c)
        out[f"npdcch_{cand}"] = timed_point(dec, card, f"nbiot path: NPDCCH search of {b} "
                                            f"(DCI on candidate {cand})")

    # ---- NPDSCH, and SIB1-NB on the BCCH ------------------------------------
    sib1 = rrc_nbiot.Sib1Nb(cell_id=NB_CELL)
    for name, kw, snr in NB_NPDSCH:
        cfg = nb.NpdschConfig(**dict(dict(n_id_ncell=NB_CELL, rnti=NB_RNTI, sfn=8, start_sf=4),
                                     **kw))
        if cfg.is_bcch:
            payload = np.unpackbits(np.frombuffer(sib1.pack(), np.uint8))
            tb = torch.as_tensor(np.tile(np.pad(payload, (0, cfg.tbs - payload.size)),
                                         (b, 1)).astype(np.int8), device=dev)
        else:
            tb = torch.randint(0, 2, (b, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
        rx_d = nb_channel(dev, gen, nb.npdsch_encode(cfg, tb), snr)

        def dec(x=rx_d, cfg=cfg):
            return nb.npdsch_decode(cfg, x)

        res = dec()
        # the CPU on NB_CPU_RERUN captures and on every capture whose CRC failed on the card
        sel = torch.unique(torch.cat([torch.arange(min(NB_CPU_RERUN, b), device=dev),
                                      (~res["crc_ok"]).nonzero()[:, 0]]))
        c = dec(rx_d[sel].cpu())
        n_ko = int((~res["crc_ok"]).sum())
        undetected = int(((res["bits"] != tb).any(dim=-1) & res["crc_ok"]).sum())
        checks[f"NPDSCH {name}: block errors {n_ko}/{b} <= {NB_NPDSCH_BLER:g}"] = \
            n_ko <= NB_NPDSCH_BLER * b
        checks[f"NPDSCH {name}: every TB whose CRC passes exact"] = undetected == 0
        checks[f"NPDSCH {name}: the CPU identical on {len(sel)} captures"] = all(
            torch.equal(c[k], res[k][sel].cpu()) for k in c)
        if cfg.is_bcch:
            first = int(res["crc_ok"].to(torch.int8).argmax())  # a capture whose CRC passed
            got = np.packbits(res["bits"][first].cpu().numpy().astype(np.uint8)).tobytes()
            checks["SIB1-NB unpacked"] = rrc_nbiot.Sib1Nb.unpack(got[:len(sib1.pack())]) == sib1
        out[f"npdsch {name}"] = timed_point(dec, card, f"nbiot path: NPDSCH {name}, TBS "
                                            f"{cfg.tbs} over {cfg.nof_sf} subframes, {b}")
    checks["no turbo kernel launched"] = not any(launch_counts().values())
    if not all(checks.values()):
        raise AssertionError(f"nbiot path: {checks}")
    log(f"[{card}] nbiot path: every check passed ({', '.join(checks)}); "
        + "; ".join(f"{k} {v['ms']:.2f} ms, device {v['device_ms']:.3f} ms in "
                    f"{v['kernels']:.0f} kernels, idle {v['idle']:.3f}" for k, v in out.items()))
    return out


def nr_sib_captures(dev, gen, rng, cs, a: int, nof_prb: int = NR_SIB_PRB,
                    symbol_sz: int = NR_SIB_SYMBOL_SZ, pci: int = NR_SIB_PCI,
                    batch: int = NR_SIB_BATCH, snr_db: float = NR_SIB_SNR_DB,
                    mcs: int = NR_SIB_MCS, fc_hz: float = NR_SIB_FC_HZ, levels=(4, 8, 16)):
    """``batch`` one-slot 15 kHz captures (slot 0) of CORESET#0 (``cs``) and
    SIB1 on a ``nof_prb`` carrier: an SI-RNTI DCI 1_0 (its 38.212 SI fields:
    the RIV of all of CORESET#0's PRB, time row 0, ``mcs``, zero padding to
    ``a`` bits) on a random Type0 candidate at each of ``levels`` in turn,
    the PDCCH DMRS on every CORESET RB, the SIB1 PDSCH it grants (type-1 DMRS
    on symbols 2, 7, 11 at +3 dB), the ``fc_hz`` upconversion phase, AWGN at
    ``snr_db`` per RE.  Returns (samples (B, slot_len), the payloads (B, a),
    the candidates (l_agg, ncce) sent, the SIB1 bits (B, tbs))."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import coreset0 as C0, dci_nr, ra_nr, sch_nr
    from srsran_4g_tpu_torch.ops import modem, polar_3gpp, sequence

    b, nre, n = batch, nof_prb * 12, symbol_sz
    riv = dci_nr.riv_encode(cs.nof_prb, 0, cs.nof_prb)
    fields = [(riv, dci_nr._riv_bits(cs.nof_prb)), (0, 4), (0, 1), (mcs, 5)]
    dci = np.zeros(a, np.int8)
    dci[:sum(w for _, w in fields)] = [(v >> (w - 1 - i)) & 1 for v, w in fields
                                       for i in range(w)]
    payload = torch.as_tensor(np.tile(dci, (b, 1)), device=dev)
    grid = torch.zeros((b, 14, nre), dtype=torch.complex64, device=dev)
    # PDCCH DMRS on every CORESET RB, per symbol
    crb = cs.offset_rb + np.arange(cs.nof_prb)
    for l in range(cs.duration):
        k = torch.as_tensor((crb[:, None] * 12 + np.array([1, 5, 9])).reshape(-1), device=dev)
        grid[:, l, k] = torch.as_tensor(C0._pdcch_dmrs(pci, 0, l, cs.nof_prb), device=dev)
    cands = C0.type0_candidates(cs.nof_prb * cs.duration // 6)
    sent = []
    for i in range(b):
        l_agg = levels[i % len(levels)]
        ncce = int(rng.choice([c for lv, c in cands if lv == l_agg]))
        rbs = np.asarray(C0.interleaved_candidate_rbs(cs, ncce, l_agg))
        e = 2 * cs.duration * len(rbs) * 9
        coded = polar_3gpp.dci_encode(payload[i:i + 1], e, SI_RNTI_NR)
        scr = torch.as_tensor(polar_3gpp.pdcch_scramble_seq(e, pci).astype(np.int8),
                              device=dev)
        syms = modem.modulate("qpsk", torch.bitwise_xor(coded.to(torch.int8), scr))[0]
        k = ((cs.offset_rb + rbs)[:, None] * 12 + np.array(C0._DATA_OFF)).reshape(-1)
        for l in range(cs.duration):
            m = len(k)
            grid[i, l, torch.as_tensor(k, device=dev)] = syms[l * m:(l + 1) * m]
        sent.append((l_agg, ncce))
    # the SIB1 PDSCH over CORESET#0's 96 PRB, time row 0 (S 2, L 12)
    _, s_sym, l_sym = C0.TIME_DEFAULT_A_POS2[0]
    dmrs_syms = C0.dmrs_positions_type_a(s_sym + l_sym)
    data_syms = [l for l in range(s_sym, s_sym + l_sym) if l not in dmrs_syms]
    qm, r = ra_nr.mcs_to_qm_r(mcs)
    tbs = ra_nr.tbs(cs.nof_prb, mcs, nof_symb=l_sym, nof_dmrs_re=12 * len(dmrs_syms))
    sc = torch.arange(cs.offset_rb * 12, (cs.offset_rb + cs.nof_prb) * 12, device=dev)
    g_bits = len(data_syms) * len(sc) * qm
    seg = sch_nr.nr_segment(tbs, g_bits, qm, 0, target_rate=r)
    sib1 = torch.randint(0, 2, (b, tbs), generator=gen, device=dev, dtype=torch.int8)
    cw = sch_nr.encode(seg, sib1)
    scr = sequence.gold_sequence_np(((SI_RNTI_NR << 15) + pci) % (1 << 31), g_bits)
    syms = modem.modulate({2: "qpsk", 4: "16qam", 6: "64qam"}[qm], torch.bitwise_xor(
        cw.to(torch.int8), torch.as_tensor(scr.astype(np.int8), device=dev)))
    grid[:, torch.as_tensor(data_syms, device=dev)[:, None], sc] = syms.reshape(
        b, len(data_syms), len(sc))
    for l in dmrs_syms:
        grid[:, l, sc[::2]] = np.sqrt(2) * torch.as_tensor(
            C0._sch_dmrs(pci, 0, l, 0, cs.nof_prb), device=dev)
    # OFDM with the 38.211 §5.4 upconversion phase e^{-j2π f_c t_l}
    X = grid.new_zeros((b, 14, n))
    X[..., -(nre // 2):] = grid[..., :nre // 2]
    X[..., :nre // 2] = grid[..., nre // 2:]
    _, ph = C0._slot_tables(nof_prb, n, fc_hz, 0, dev)
    x = torch.fft.ifft(X if ph is None else X / ph, dim=-1) * np.sqrt(n)
    cp = [n * (160 if l in (0, 7) else 144) // 2048 for l in range(14)]
    x = torch.cat([torch.cat([x[:, l, -cp[l]:], x[:, l]], dim=-1) for l in range(14)], dim=-1)
    return awgn.awgn(x, 10.0 ** (-snr_db / 10.0), generator=gen), payload, sent, sib1


def nr_sib_path(dev, card: str) -> dict:
    """NR CORESET#0 + SIB1 from samples at 20 MHz / 15 kHz: ``nr_slot_grid``
    (with fc_hz) → ``blind_decode_type0`` → ``decode_pdsch_common`` on the
    grant read from each decoded DCI, every DCI and SIB1 bit checked, an
    unsent RNTI finding nothing, one capture again on the CPU; then CSI-RS
    at 273 PRB / 30 kHz over NR_CSI_BATCH slots at 0-25 dB, each SINR within
    3 dB of the SNR put in and the CQIs equal to the CPU's.  No turbo kernel
    may launch."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import coreset0 as C0, csi_nr, dci_nr, grid_nr

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    reset_counts()
    point_a = NR_SIB_FC_HZ - NR_SIB_PRB * 6 * 15e3
    cs = C0.coreset_zero(NR_SIB_PCI, NR_SIB_SSB_HZ, NR_SIB_CORESET0)
    a = dci_nr.DciNr10(n_rb=cs.nof_prb).nof_bits
    x, payload, sent, sib1 = nr_sib_captures(dev, gen, rng, cs, a)
    log(f"nr sib path: {NR_SIB_PRB} PRB at 15 kHz, CORESET#0 index {NR_SIB_CORESET0} "
        f"({cs.nof_prb} PRB x {cs.duration} symbols at RB {cs.offset_rb}; SSB centre "
        f"{NR_SIB_SSB_HZ / 1e6:.2f} MHz above pointA {point_a / 1e6:.3f} MHz), {NR_SIB_BATCH} "
        f"captures at {NR_SIB_SNR_DB} dB, DCI 1_0 of {a} bits at L = 4, 8, 16, SIB1 TBS "
        f"{sib1.shape[1]} at MCS {NR_SIB_MCS}")

    def field(bits, lo, w):
        return int("".join(str(int(v)) for v in bits[lo:lo + w]), 2)

    def receive(samples, rnti=SI_RNTI_NR):
        grid = C0.nr_slot_grid(samples, NR_SIB_PRB, NR_SIB_SYMBOL_SZ, fc_hz=NR_SIB_FC_HZ)
        hit = C0.blind_decode_type0_batch(grid, NR_SIB_PCI, 0, cs, rnti, a)
        return grid, hit

    def pdsch(grid, hit):
        bits = hit["bits"][0].cpu().numpy()
        rb = dci_nr._riv_bits(cs.nof_prb)
        riv, time_assign, mcs = field(bits, 0, rb), field(bits, rb, 4), field(bits, rb + 5, 5)
        return C0.decode_pdsch_common(grid, NR_SIB_PCI, 0, SI_RNTI_NR, cs.offset_rb, riv,
                                      cs.nof_prb, time_assign, mcs)

    grid, hit = receive(x)
    res = pdsch(grid, hit)
    miss = receive(x, 0x1234)[1]
    where = [hit["candidates"][int(i)] for i in hit["index"].cpu()]
    g1, h1 = receive(x[:1].cpu())
    r1 = pdsch(g1, h1)
    checks = {"every DCI found with its bits": bool(hit["found"].all())
              and torch.equal(hit["bits"].to(torch.int8), payload),
              "at the candidate sent": where == sent,
              "the grant: 96 PRB, time row 0": res["rb"] == (0, cs.nof_prb)
              and res["syms"] == (2, 12) and res["tbs"] == sib1.shape[1],
              "every SIB1 CRC and bit": bool(res["crc_ok"].all())
              and torch.equal(res["bits"], sib1),
              "the unsent RNTI finds nothing": not bool(miss["found"].any()),
              "one capture on the CPU": torch.equal(h1["bits"], hit["bits"][:1].cpu())
              and torch.equal(h1["index"], hit["index"][:1].cpu())
              and torch.equal(r1["bits"], res["bits"][:1].cpu())
              and torch.equal(r1["crc_ok"], res["crc_ok"][:1].cpu())
              and float((g1 - grid[:1].cpu()).abs().max()) <= 1e-3}
    out = {"slot_grid": timed_point(lambda: C0.nr_slot_grid(x, NR_SIB_PRB, NR_SIB_SYMBOL_SZ,
                                                            fc_hz=NR_SIB_FC_HZ), card,
                                    f"nr sib path: slot grids of {NR_SIB_BATCH}"),
           "type0_search": timed_point(lambda: C0.blind_decode_type0_batch(
               grid, NR_SIB_PCI, 0, cs, SI_RNTI_NR, a), card,
               f"nr sib path: Type0 search of {NR_SIB_BATCH}"),
           "sib1_pdsch": timed_point(lambda: pdsch(grid, hit), card,
                                     f"nr sib path: SIB1 PDSCH of {NR_SIB_BATCH}")}

    # ---- CSI-RS at 273 PRB / 30 kHz ---------------------------------------
    car = grid_nr.NrCarrierConfig(**NR_CARRIER)
    csi = csi_nr.CsiRsConfig(carrier=car, slot=NR_SLOT)
    snr = torch.linspace(0.0, 25.0, NR_CSI_BATCH, device=dev)
    h = torch.polar(0.5 + torch.rand(NR_CSI_BATCH, generator=gen, device=dev),
                    2 * np.pi * torch.rand(NR_CSI_BATCH, generator=gen, device=dev))
    tx = csi_nr.put_csi_rs(csi, torch.zeros((NR_CSI_BATCH, 14, car.nre), dtype=torch.complex64,
                                            device=dev))
    nv = (10.0 ** (-snr / 10.0) * h.abs() ** 2)[:, None, None]
    rx = tx * h[:, None, None] + awgn.awgn(torch.zeros_like(tx), 1.0, generator=gen) * nv.sqrt()
    m = csi_nr.measure(csi, rx)
    rep, rep_cpu = csi_nr.generate_report(m["sinr_db"]), csi_nr.generate_report(
        csi_nr.measure(csi, rx.cpu())["sinr_db"])
    err = (m["sinr_db"] - snr).abs()
    checks["CSI-RS SINR within 3 dB of the SNR"] = bool((err < 3.0).all())
    checks["CQIs equal to the CPU's"] = torch.equal(rep["cqi"].cpu(), rep_cpu["cqi"])
    out["csi_rs"] = timed_point(lambda: csi_nr.generate_report(csi_nr.measure(csi, rx)["sinr_db"]),
                                card, f"nr sib path: CSI-RS measure + report of {NR_CSI_BATCH}")
    checks["no turbo kernel launched"] = not any(launch_counts().values())
    if not all(checks.values()):
        raise AssertionError(f"nr sib path: {checks}; candidates {where[:6]} vs {sent[:6]}")
    log(f"[{card}] nr sib path: every check passed ({', '.join(checks)}); CSI-RS |SINR - SNR| "
        f"max {float(err.max()):.2f} dB, CQIs {sorted(set(rep['cqi'].tolist()))}; "
        + "; ".join(f"{k} {v['ms']:.2f} ms, device {v['device_ms']:.3f} ms in "
                    f"{v['kernels']:.0f} kernels, idle {v['idle']:.3f}" for k, v in out.items()))
    out["csi_sinr_err_db_max"] = float(err.max())
    return out


def multichip_path(dev, card: str, main_decode_s: float) -> dict:
    """The sharded pipeline (``parallel/pipeline`` through ``tools/multichip``)
    at MC_RUNS, each rank a child process: bits and CRCs exact at the bench
    configuration, the step timed (best of MC_REPS), at (a) and (b) the
    sharded FIR and OFDM demod held against the dense ones (atol 1e-4) and
    at (b) the halo exchange, the grid all_reduce and the hard-bit
    all_gather timed alone; every rank's map_fused16 launches, code-block
    lanes and peak memory; then map_fused16 against its plain version at a
    rank's shape of (b)."""
    from srsran_4g_tpu_torch.parallel import dist
    from srsran_4g_tpu_torch.tools import multichip

    reset_counts()
    try:
        dist.check_backend("nccl", 2, dev)
    except ValueError as e:
        log(f"multichip path: two ranks on {torch.cuda.device_count()} card(s) go over Gloo: {e}")
    else:
        raise AssertionError("NCCL was not refused two ranks on one card")
    out = {}
    for name, n, backend, configs, batch in MC_RUNS:
        t0 = time.perf_counter()
        res = multichip.launch(n, device=dev.type, backend=backend, configs=configs, batch=batch,
                               reps=MC_REPS if batch else 0, measure=bool(batch),
                               timeout=MC_TIMEOUT)
        wall_s = time.perf_counter() - t0
        bad = multichip.check(res)
        dp, sp = multichip.mesh_shape(n)
        for cname, c0 in res[0]["configs"].items():
            for r in res:
                c = r["configs"][cname]
                others = {k: v for k, v in c["launches"].items() if k != "map_fused16" and v}
                if not c["launches"].get("map_fused16") or others:
                    bad.append(f"rank {r['rank']} {cname}: launches {c['launches']}")
                if cname == "bench" and batch and c["cb_lanes"] != batch * 13 // sp:
                    bad.append(f"rank {r['rank']}: {c['cb_lanes']} code-block lanes")
            first = max(r["configs"][cname]["first_ms"] for r in res)
            timing = f"first step {first:.1f} ms"
            if "step_ms" in c0:  # the slowest rank's best step
                step = max(min(r["configs"][cname]["step_ms"]) for r in res)
                timing = (f"step best {step:.2f} ms ({timing}) = {c0['rows'] / step * 1e3:.1f} "
                          f"subframes/s; the main path's decode of {BATCH} "
                          f"{main_decode_s * 1e3:.2f} ms")
            log(f"[{card}] multichip ({name}) {n} rank(s) over {backend}, mesh dp={dp} sp={sp}, "
                f"{cname} x {c0['rows']}: metrics {c0['metrics']}; {timing}; map_fused16 "
                f"launches a rank {[r['configs'][cname]['launches'].get('map_fused16') for r in res]}"
                f", code-block lanes a rank {c0['cb_lanes']} (K {c0['K']})")
            for r in res:
                extra = {k: r["configs"][cname][k]
                         for k in ("collective_ms", "stream_check", "profile")
                         if k in r["configs"][cname]}
                if "profile" in extra:
                    extra["idle"] = 1 - extra["profile"]["device_ms"] / min(
                        r["configs"][cname]["step_ms"])
                if extra:
                    log(f"[{card}] multichip ({name}) rank {r['rank']} {cname}: {json.dumps(extra)}")
        log(f"[{card}] multichip ({name}): peak MiB a rank "
            f"{[r.get('peak_mib') for r in res]}; {wall_s:.1f} s with start-up")
        if bad:
            raise AssertionError(f"multichip ({name}): {bad}")
        out[name] = dict(ranks=n, backend=backend, mesh=dict(dp=dp, sp=sp), wall_s=wall_s,
                         ranks_results=res)
    if any(launch_counts().values()):
        raise AssertionError("the parent launched a turbo kernel in the multichip path")

    # map_fused16 against its plain version at a rank's shape of (b)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, k, l, t = MC_PER_RANK
    r = check_kernel("map_fused16", gamma_inputs(dev, gen, b, k, l, t), time_it=True)
    nbytes, adds, maxes = work("map_fused16", b, k, l, t)
    bound_ms, bound_by = bound(nbytes, adds, maxes, "bf16")
    rank_b = out["b"]["ranks_results"]
    launches = [x["configs"]["bench"]["launches"]["map_fused16"] for x in rank_b]
    log(f"[{card}] map_fused16 at a rank's shape of (b) B={b} K={k} L={l} T={t}: "
        f"{r['ms']:.4f} ms against a bound of {bound_ms:.4f} ms ({bound_by}); plain "
        f"{r['plain_ms']:.2f} ms; max|diff| {r['max_abs_err']}; launches a rank {launches}")
    out["map_fused16"] = dict(
        launches_a_rank=launches, shapes=dict(blocks=b, K=k, L=l, T=t, lanes=b * (k // l)),
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bound_ms,
        bound_by=bound_by, bytes=nbytes,
        step_ms={key: max(min(x["configs"]["bench"]["step_ms"]) for x in out[key]["ranks_results"])
                 for key in ("a", "b")})
    return out


@contextlib.contextmanager
def plain_kernel(name: str):
    """The wrapper ``name`` of ``ops/cuda/turbo_map`` replaced by its plain
    version while inside (the attribute swap TurboSpy makes), so that a
    decode on the card's tensors runs the plain version."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    saved = getattr(tm, name)
    setattr(tm, name, getattr(tm, name + "_ref"))
    try:
        yield
    finally:
        setattr(tm, name, saved)


def check_curve(points: list[tuple[float, float]], n: int, what: str) -> None:
    """Raise unless the error rates (x, p) fall with x within three standard
    errors of the binomial over n trials, point to point."""
    for (x0, p0), (x1, p1) in zip(points, points[1:]):
        se = math.sqrt((p0 * (1 - p0) + p1 * (1 - p1)) / n)
        if p1 > p0 + 3 * se:
            raise AssertionError(f"{what}: {p1} at {x1} above {p0} at {x0} by more than "
                                 f"3 standard errors ({se:.3g})")


def sweep_path(dev, card: str) -> dict:
    """The error-rate tools on the card at SWEEP_FRAMES frames a point:
    ``tools.ber_sweep`` (K = 6144, its 13-point Eb/N0 grid, 5 iterations, no
    early stop), then ``tools.bler_sweep`` (the LDPC chain, 8 points; the 50
    PRB PDSCH, 3 cases x 5 points), writing to a temporary directory.  Held:
    map_fused16 launched 2 x iters times a BER point; at every BER point with
    0 < FER < 1 and the points on either side of the waterfall, hard bits
    and APP LLRs identical to the same decode with map_fused16's plain
    version; at every PDSCH point with 0 < BLER < 1 and each case's lowest
    point with BLER < 1, the CRC flags and bits likewise; no errors at the
    clean points; every curve non-increasing within three binomial standard
    errors (over the frames; BER too).  Logs the three tables, seconds and
    Mb/s a point, peak memory, and map_fused16 at the sweep's shape against
    its plain version and its bound."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm
    from srsran_4g_tpu_torch.tools import ber_sweep, bler_sweep

    torch.cuda.reset_peak_memory_stats()
    n = SWEEP_FRAMES
    log(f"sweep path: {n} frames a point; turbo K={SWEEP_K}, {SWEEP_ITERS} iterations, "
        f"window {ber_sweep.WINDOW}; LDPC {bler_sweep.LDPC}; PDSCH {bler_sweep.CELL}")
    ber_cmp, pdsch_cmp, per_point, seconds = [], [], [], {}
    state = dict(waterfall=False, clean=False, top=None, below=set())

    def compare_ber(row, llr, hard, app):
        t0 = time.perf_counter()
        with plain_kernel("map_fused16"):
            h_p, a_p = ber_sweep.decode_point(llr, SWEEP_ITERS)
        err = float((a_p - app).abs().max())
        if not torch.equal(h_p, hard) or err != 0:
            raise AssertionError(f"BER point {row['ebn0_db']} dB: map_fused16 differs from its "
                                 f"plain version (max |diff| {err})")
        ber_cmp.append(dict(ebn0_db=row["ebn0_db"], fer=row["fer"], max_abs_err=err,
                            plain_s=time.perf_counter() - t0))

    def on_ber(row, dt, llr, hard, app):
        per_point.append(tm.launches["map_fused16"] - sum(per_point))
        seconds[f"turbo/ebn0={row['ebn0_db']:.2f}"] = dt
        if row["fer"] < 1 and not state["waterfall"]:
            state["waterfall"] = True
            if state["top"] is not None:  # the last point with every frame in error
                compare_ber(*state["top"])
        if 0 < row["fer"] < 1 or (row["fer"] == 0 and not state["clean"]):
            compare_ber(row, llr, hard, app)
        state["clean"] = state["clean"] or row["fer"] == 0
        state["top"] = (row, llr, hard, app) if row["fer"] == 1 else None

    def on_ldpc(key, row, dt):
        seconds[key] = dt
        if any(launch_counts().values()):
            raise AssertionError(f"the LDPC chain launched turbo kernels: {launch_counts()}")

    def on_pdsch(key, row, dt, inputs, outputs):
        seconds[key] = dt
        first_below = row["bler"] < 1 and row["mod"] not in state["below"]
        if row["bler"] < 1:
            state["below"].add(row["mod"])
        if not (0 < row["bler"] < 1 or first_below):
            return
        with plain_kernel("map_fused16"):
            dec, ok = bler_sweep.pdsch_point(*inputs)
        if not (torch.equal(ok, outputs[1]) and torch.equal(dec, outputs[0])):
            raise AssertionError(f"{key}: map_fused16 gives other CRC flags or bits than its "
                                 f"plain version")
        pdsch_cmp.append(dict(key=key, bler=row["bler"]))

    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        ber = ber_sweep.run(SWEEP_K, n, SWEEP_ITERS, ber_sweep.grid(*SWEEP_EBN0), dev,
                            os.path.join(tmp, "ber_turbo.json"), on_ber)
        ber_launches = launch_counts()
        reset_counts()
        bler = bler_sweep.run(n, dev, tmp, os.path.join(tmp, "bler_sweep.ckpt.json"),
                              on_ldpc, on_pdsch)
        pdsch_launches = launch_counts()
        written = sorted(os.listdir(tmp))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if written != ["ber_turbo.json", "bler_ldpc.json", "bler_pdsch.json"]:
        raise AssertionError(f"the sweeps wrote {written}")
    rows = ber["points"]
    want = {w: 0 for w in WRAPPERS} | {"map_fused16": 2 * SWEEP_ITERS * len(rows)}
    if ber_launches != want or per_point != [2 * SWEEP_ITERS] * len(rows):
        raise AssertionError(f"BER sweep launches {ber_launches}, a point {per_point}")
    if set(k for k, v in pdsch_launches.items() if v) != {"map_fused16"}:
        raise AssertionError(f"PDSCH sweep launches {pdsch_launches}")
    if len(ber_cmp) < 2 or len(pdsch_cmp) < 2 or state["below"] != {
            c[0] for c in bler_sweep.PDSCH_CASES}:
        raise AssertionError(f"too few points held against the plain version: BER {ber_cmp}, "
                             f"PDSCH {pdsch_cmp}")
    bad = [r for r in rows if r["ebn0_db"] >= SWEEP_TURBO_CLEAN and (r["ber"] or r["fer"])]
    bad += [r for r in bler["ldpc"] if r["ebn0_db"] >= SWEEP_LDPC_CLEAN and r["bler"]]
    for mod, _, _ in bler_sweep.PDSCH_CASES:
        bad += [r for r in [r for r in bler["pdsch"] if r["mod"] == mod][-2:] if r["bler"]]
    if bad:
        raise AssertionError(f"errors at points that must be clean: {bad}")
    check_curve([(r["ebn0_db"], r["fer"]) for r in rows], n, "turbo FER")
    check_curve([(r["ebn0_db"], r["ber"]) for r in rows], n, "turbo BER")
    check_curve([(r["ebn0_db"], r["bler"]) for r in bler["ldpc"]], n, "LDPC BLER")
    for mod, _, _ in bler_sweep.PDSCH_CASES:
        check_curve([(r["snr_db"], r["bler"]) for r in bler["pdsch"] if r["mod"] == mod], n,
                    f"PDSCH {mod} BLER")

    tbs = bler_sweep.LDPC[0]
    ldpc_s = sum(v for k, v in seconds.items() if k.startswith("ldpc/"))
    log(f"[{card}] turbo BER sweep (K={SWEEP_K}, {n} frames, {SWEEP_ITERS} iterations): "
        f"{json.dumps(rows)}")
    log(f"[{card}] LDPC sweep (TBS {tbs}, {n} blocks): {json.dumps(bler['ldpc'])}; "
        f"ldpc chain: {n * tbs * len(bler['ldpc']) / ldpc_s / 1e6:.1f} Mb/s info (all points)")
    log(f"[{card}] PDSCH sweep ({bler_sweep.CELL['nof_prb']} PRB, {n} TBs): "
        f"{json.dumps(bler['pdsch'])}")
    log(f"[{card}] sweep seconds a point: {json.dumps(seconds)}")
    log(f"[{card}] PDSCH Mb/s a point: " + json.dumps(
        {f"pdsch/{r['mod']}/snr={r['snr_db']:.1f}": n * r["tbs"] / seconds[
            f"pdsch/{r['mod']}/snr={r['snr_db']:.1f}"] / 1e6 for r in bler["pdsch"]}))
    log(f"[{card}] held against map_fused16's plain version: BER {json.dumps(ber_cmp)}; "
        f"PDSCH {json.dumps(pdsch_cmp)}; peak memory {peak:.2f} GiB")
    log(f"[{card}] sweep launches: BER {ber_launches['map_fused16']}, PDSCH {pdsch_launches}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, k, l, t = n, SWEEP_K, ber_sweep.WINDOW, ber_sweep.TRAIN
    r = check_kernel("map_fused16", gamma_inputs(dev, gen, b, k, l, t), time_it=True)
    nbytes, adds, maxes = work("map_fused16", b, k, l, t)
    bound_ms, bound_by = bound(nbytes, adds, maxes, "bf16")
    log(f"[{card}] map_fused16 at the BER sweep's shape B={b} K={k} L={l} T={t} "
        f"(N={b * k // l}): {r['ms']:.4f} ms against a bound of {bound_ms:.4f} ms ({bound_by}, "
        f"{nbytes} bytes); plain {r['plain_ms']:.2f} ms; max|diff| {r['max_abs_err']}")
    return dict(map_fused16=dict(
        launches=ber_launches["map_fused16"] + pdsch_launches["map_fused16"],
        launches_ber=ber_launches["map_fused16"], launches_pdsch=pdsch_launches["map_fused16"],
        shapes=dict(blocks=b, K=k, L=l, T=t, lanes=b * (k // l)), max_abs_err=r["max_abs_err"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
        compared=dict(ber=ber_cmp, pdsch=pdsch_cmp)),
        peak_gib=peak, seconds=seconds)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    phase_s: dict[str, float] = {}

    def phase(fn, *args):
        """Run one phase, logging its seconds."""
        t0 = time.perf_counter()
        res = fn(*args)
        phase_s[fn.__name__] = time.perf_counter() - t0
        log(f"phase {fn.__name__}: {phase_s[fn.__name__]:.1f} s")
        return res

    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch
    from srsran_4g_tpu_torch.ops.cuda import build
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    torch.backends.cuda.matmul.allow_tf32 = False  # CRC matmuls: plain f32
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    log(card)
    log(f"SM clock max {smi('clocks.max.sm')}, {torch.cuda.get_device_properties(0).multi_processor_count} "
        f"SMs; op rates assume {SM_COUNT} SMs at {CLOCK_HZ / 1e9} GHz, per SM and clock "
        f"{ADD_PER_SM_CLOCK} adds, {MAX_PER_SM_CLOCK} maxes, {DISPATCH_PER_SM_CLOCK} dispatched")
    log(" ".join(subprocess.run(["nvidia-smi", "--version"], check=True,
                                capture_output=True, text=True).stdout.split()))
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton "
        f"{pkg_version('triton')}, numpy {np.__version__}, python {sys.version.split()[0]}")
    log(subprocess.run([build._nvcc(), "--version"], check=True, capture_output=True,
                       text=True).stdout.strip().splitlines()[-1])

    # ---- build every kernel source, all nvcc processes at once ------------
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    libs = build.build(sources)
    log(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- each kernel against its plain version, on the card ---------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=100, cell_id=123, cfi=1),
                            rnti=0x1234, subframe=4, mod="64qam", tbs=75376)
    grp = cfg.plan.groups[0]
    if (len(cfg.plan.groups), grp.count, grp.K) != (1, 13, 5824):
        raise AssertionError(f"unexpected segmentation {cfg.plan}")
    n_bench = BATCH * grp.count * (grp.K // 208)
    geos = {"map_fused16": tm.fused16_geometry(n_bench, 208),
            "turbo_map": tm.windowed_geometry(n_bench, 208, 32, 1),
            "map_windowed16": tm.windowed_geometry(n_bench, 208, 32, 1, metric_bytes=16),
            "map_v3": tm.windowed_geometry(n_bench, 208, 32, 2),
            "map_fused_r2": tm.fused_geometry(n_bench, 208, 2),
            "map_fused_r4": tm.fused_geometry(n_bench, 208, 4)}
    for route, geo in geos.items():
        log(f"{route} at the bench shape: {geo}")
    usage = {route: build.kernel_usage(libs[source[:-3]].with_suffix(".log").read_text(),
                                       *kernel_symbol(route, radix, geos.get(route)))
             for route, (_, radix, source, _, _) in ROUTES.items()}
    for route, u in usage.items():
        log(f"{route} kernel at the bench shape: {u}")
    kern = check_kernels(dev, gen, BATCH * grp.count, grp.K)

    # ---- the main path: encode → CRS → AWGN → decode ----------------------
    log(f"main path: 100 PRB 64QAM TBS {cfg.tbs}, G={cfg.g_bits}, "
        f"{cfg.plan.segm.C} CBs of K={grp.K}, batch {BATCH} subframes, "
        f"n_iter {N_ITER}, {SNR_DB} dB")
    bits = torch.randint(0, 2, (BATCH, cfg.tbs), generator=gen, device=dev,
                         dtype=torch.int8)
    t0 = time.perf_counter()
    tx = pdsch.add_crs(cfg, pdsch.encode(cfg, bits))
    rx = awgn.awgn(tx, awgn.snr_to_noise_var(SNR_DB), generator=gen)
    torch.cuda.synchronize()
    log(f"encode + CRS + AWGN: {time.perf_counter() - t0:.2f} s (first call)")

    paths = {"v9": drive_path(cfg, rx, bits, "v9")}
    out = pdsch.decode(cfg, rx, n_iter=N_ITER)
    h, nv, snr = out["h"], out["noise_var"], out["snr_db"]
    if h.shape != (BATCH, cfg.cell.nsymb, cfg.cell.nre) or not (
            torch.isfinite(h).all() and torch.isfinite(nv).all()):
        raise AssertionError("channel estimate is not finite or has the wrong shape")
    log(f"estimated SNR {float(snr.mean()):.2f} dB")

    # ---- the default path's timing (the card's name and power limit beside
    # every number) ----------------------------------------------------------
    times, _, out = timed_decodes(cfg, rx, DECODE_REPS)
    if not bool(out["crc_ok"].all()):
        raise AssertionError("a timed decode failed its CRC")
    best = main_decode_s = min(times)
    stages = [staged_decode(cfg, rx) for _ in range(3)][-1]
    log(f"[{card}] decode of {BATCH} subframes: best {best * 1e3:.2f} ms of "
        f"{DECODE_REPS} ({', '.join(f'{t * 1e3:.2f}' for t in times)} ms) = "
        f"{BATCH / best:.1f} subframes/s")
    log(f"[{card}] per-stage (CUDA events, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; map_fused16 kernel {paths['v9']['map_fused16']} x "
        f"{kern['map_fused16']['ms']:.4f} ms")
    profile_decode(cfg, rx, best, card)
    sweeps(cfg, tx, rx, bits, gen, card)

    # ---- the other TURBO_KERNEL paths, then the 2x2 lane -------------------
    for kernel in PATH_KERNELS:
        if kernel != "v9":
            paths[kernel] = drive_path(cfg, rx, bits, kernel)
    best = time_paths(cfg, rx, bits, card)
    path_device_ms = {}
    for kernel in ("bf16", "v7", "v8"):  # the redesigned kernels' decodes
        os.environ["TURBO_KERNEL"] = kernel
        log(f"[{card}] TURBO_KERNEL={kernel} decode, profiled:")
        prof = profile_decode(cfg, rx, best[kernel], card,
                              turbo="fused_kernel" if kernel != "bf16" else "windowed_kernel")
        path_device_ms[kernel] = dict(zip(("decode_device_ms", "kernel_device_ms"), prof or ()))
    os.environ.pop("TURBO_KERNEL", None)
    phase(mimo_lane, dev, gen, card)
    default_route = phase(mcs23_path, dev, gen, card, kern)
    phase(dl_path, dev, gen, card)
    probe_kernels = phase(probes_phase, card)
    phase(control_path, dev, gen, card)
    new_paths = {"ul_path": (phase(ul_path, dev, gen, card), UL_CBS, UL_K, UL_L),
                 "mbsfn_path": (phase(mbsfn_path, dev, gen, card), PMCH_CBS, PMCH_K, PMCH_L)}
    phase(sync_path, dev, gen, card)
    system = phase(system_path, dev, card)
    process = phase(process_path, dev, card)
    nr = phase(nr_path, dev, card)
    log(f"[{card}] nr path: " + json.dumps(nr))
    nr_system = phase(nr_system_path, dev, card)
    log(f"[{card}] nr system path: " + json.dumps(nr_system))
    sidelink = phase(sidelink_path, dev, card)
    log(f"[{card}] sidelink path: " + json.dumps(sidelink))
    log(f"[{card}] nbiot path: " + json.dumps(phase(nbiot_path, dev, card)))
    log(f"[{card}] nr sib path: " + json.dumps(phase(nr_sib_path, dev, card)))
    multi = phase(multichip_path, dev, card, main_decode_s)
    sweep = phase(sweep_path, dev, card)
    fused16_paths = {}
    for key, (entry, cbs, k_cb, l_win) in new_paths.items():
        nbytes, adds, maxes = work("map_fused16", BATCH * cbs, k_cb, l_win, 32)
        bound_ms, bound_by = bound(nbytes, adds, maxes, "bf16")
        r = kern[key]
        log(f"[{card}] map_fused16 on the {key} at B={BATCH * cbs} K={k_cb} L={l_win} T=32: "
            f"{entry['launches']} launches a decode, {r['ms']:.4f} ms against a bound of "
            f"{bound_ms:.4f} ms ({bound_by}); plain {r['plain_ms']:.2f} ms")
        fused16_paths[key] = dict(
            entry, shapes=dict(blocks=BATCH * cbs, K=k_cb, L=l_win, T=32,
                               lanes=BATCH * cbs * (k_cb // l_win)),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)

    b, k, l, t = BATCH * grp.count, grp.K, 208, 32
    kernels = []
    for route, (wrapper, _, source, line, path) in ROUTES.items():
        nbytes, adds, maxes = work(wrapper, b, k, l, t)
        kind = "bf16" if wrapper in BF16_WRAPPERS else "f32"
        bound_ms, bound_by = bound(nbytes, adds, maxes, kind)
        log(f"{route} bound at B={b} K={k} L={l} T={t}: {nbytes} bytes, {adds} adds + "
            f"{maxes} maxes ({kind}; {op_ms(adds, maxes, kind):.4f} ms) "
            f"-> {bound_ms:.4f} ms ({bound_by}); kernel {kern[route]['ms']:.4f} ms")
        kernels.append(dict(
            name=route, route="cuda", source=f"srsran_4g_tpu_torch/csrc/{source}",
            replaces=f"srsran_4g_tpu/ops/pallas/turbo_map.py:{line}",
            path=f"TURBO_KERNEL={path}",
            shapes=dict(blocks=b, K=k, L=l, T=t, lanes=b * (k // l)),
            launches=paths[path][wrapper], max_abs_err=kern[route]["max_abs_err"],
            ms=kern[route]["ms"], plain_ms=kern[route]["plain_ms"], bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, library_ms=None,
            geometry=geos[route]._asdict() if route in geos else dict(threads=128, smem_bytes=0),
            **usage[route],
            **({"vs_turbo_map_max_abs_err": kern[route]["vs_turbo_map"]}
               if "vs_turbo_map" in kern[route] else {}),
            **({"default_route": default_route} if route == "turbo_map" else {}),
            **({"system_path": dict(system["entries"].get(wrapper, dict(launches=0)),
                                    ttis_per_s=system["ttis_per_s"], tti_ms=system["tti_ms"],
                                    profile=system["profile"])}
               if wrapper in SYS_WRAPPERS else {}),
            **({"process_path": dict(process["entries"].get(wrapper, dict(launches=0)),
                                     runs=process["runs"], phy_e2e=process["phy_e2e"])}
               if wrapper in SYS_WRAPPERS else {}),
            **(fused16_paths if route == "map_fused16" else {}),
            **({"sidelink_path": sidelink["entries"][wrapper]}
               if route in ("map_fused16", "turbo_map") else {}),
            **({"multichip_path": multi["map_fused16"]} if route == "map_fused16" else {}),
            **({"sweep_path": sweep["map_fused16"]} if route == "map_fused16" else {}),
            **path_device_ms.get(path, {})))
    log(f"[{card}] phase seconds: {json.dumps(phase_s)}; the whole script "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels + probe_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
