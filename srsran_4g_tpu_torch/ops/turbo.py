"""LTE turbo codec: rate-1/3 PCCC encoder + windowed max-log-MAP decoder.

TS 36.212 §5.1.3.2.  Port counterpart of ``srsran_4g_tpu/ops/turbo.py``.

Constituent RSC code: g0 = 1 + D² + D³ (feedback), g1 = 1 + D + D³, 8
states, trellis-terminated with 3 tail bits per encoder.

Decoder: batched over code blocks; each half-iteration is a windowed BCJR
whose K-step recursions are split into W = K/L windows run in parallel,
each with a T-step training prologue (window 0's alpha and the last
window's beta start from exact boundary metrics).  The half-iteration runs
in the CUDA kernels of ``ops/cuda/turbo_map.py`` on a card and in their
plain torch versions on the CPU, in the dataflow that ``TURBO_KERNEL``
selects (``kernel_route``); the inputs are laid out for them here, lane =
window·B + block.  The exact full-length recursion (``window=None``, or a
K with no valid window) is the same function at L = K, T = 0, W = 1.

LLR convention: positive ⇒ bit 1; extrinsic scaling (default 0.75)
compensates max-log optimism.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from srsran_4g_tpu_torch.ops.crc import crc_check
from srsran_4g_tpu_torch.utils.constants import TURBO_F1, TURBO_F2, cb_size_index

_NEG = -1e30


# --- trellis tables (host precompute) ---------------------------------------


@functools.lru_cache(maxsize=1)
def _trellis() -> dict[str, np.ndarray]:
    """RSC trellis tables. State s = (r1<<2)|(r2<<1)|r3, r1 = newest reg."""
    ns = np.zeros((8, 2), dtype=np.int64)  # next state
    par = np.zeros((8, 2), dtype=np.int64)  # parity output
    tail_u = np.zeros(8, dtype=np.int64)  # termination input bit
    for s in range(8):
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for u in (0, 1):
            a = u ^ r2 ^ r3  # feedback g0 = 1 + D^2 + D^3
            ns[s, u] = (a << 2) | (r1 << 1) | r2
            par[s, u] = a ^ r1 ^ r3  # output g1 = 1 + D + D^3
        tail_u[s] = r2 ^ r3  # input that zeroes the feedback
    return dict(ns=ns, par=par, tail_u=tail_u)


@functools.lru_cache(maxsize=8)
def _trellis_t(device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in _trellis().items()}


@functools.lru_cache(maxsize=256)
def qpp_permutation(k: int) -> np.ndarray:
    """QPP interleaver π for code-block size K: out[i] = in[π(i)]."""
    idx = cb_size_index(k)
    f1, f2 = int(TURBO_F1[idx]), int(TURBO_F2[idx])
    i = np.arange(k, dtype=np.int64)
    return (f1 * i + f2 * i * i) % k


@functools.lru_cache(maxsize=256)
def qpp_inverse(k: int) -> np.ndarray:
    p = qpp_permutation(k)
    ip = np.empty_like(p)
    ip[p] = np.arange(k, dtype=np.int64)
    return ip


@functools.lru_cache(maxsize=256)
def _qpp_t(k: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(qpp_permutation(k), device=device),
            torch.as_tensor(qpp_inverse(k), device=device))


# --- encoder ----------------------------------------------------------------


def _rsc_encode(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One constituent RSC encoder, in closed GF(2) form (no K-step loop).

    The feedback register a_k = u_k ^ a_{k-2} ^ a_{k-3} is u filtered by
    1/(1 + D² + D³).  That polynomial is primitive, so the filter's impulse
    response has period 7 (1,0,1,1,1,0,0, ...) and
    a_k = a_{k-7} ^ f_k with the 7-tap FIR f_k = u_k ^ u_{k-2} ^ u_{k-3} ^
    u_{k-4}: a is a prefix XOR (cumsum mod 2) along stride 7.  The parity
    is a_k ^ a_{k-1} ^ a_{k-3}; the state after K steps is
    (a_{K-1}, a_{K-2}, a_{K-3}).  Bit-exact with the step-by-step trellis.

    Args:  bits (B, K) 0/1.
    Returns: (parity (B, K) int8, final_state (B,) int64).
    """
    u = bits.to(torch.int32)
    b, k = u.shape
    up = F.pad(u, (4, 0))  # up[:, j + 4] = u[:, j]
    f = u ^ up[:, 2:k + 2] ^ up[:, 1:k + 1] ^ up[:, 0:k]
    kp = -(-k // 7) * 7
    fp = F.pad(f, (0, kp - k)).reshape(b, kp // 7, 7)
    a = (torch.cumsum(fp, dim=1, dtype=torch.int32) & 1).reshape(b, kp)[:, :k]
    ap = F.pad(a, (3, 0))  # ap[:, j + 3] = a[:, j]
    parity = a ^ ap[:, 2:k + 2] ^ ap[:, 0:k]
    state = (a[:, k - 1] << 2) | (a[:, k - 2] << 1) | a[:, k - 3]
    return parity.to(torch.int8), state.to(torch.int64)


def _rsc_tail(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Trellis termination: 3 (sys, parity) tail bit pairs, (B, 3) each."""
    t = _trellis_t(state.device)
    sys_bits, par_bits = [], []
    for _ in range(3):
        u = t["tail_u"][state]
        sys_bits.append(u)
        par_bits.append(t["par"][state, u])
        state = t["ns"][state, u]
    return (torch.stack(sys_bits, dim=-1).to(torch.int8),
            torch.stack(par_bits, dim=-1).to(torch.int8))


def turbo_encode(bits: torch.Tensor) -> torch.Tensor:
    """Turbo-encode code blocks.

    Args:
      bits: (B, K) systematic bits (incl. any attached CRC), K a valid
        code-block size.

    Returns:
      d: (B, 3, K+4) int8 — the three output streams incl. tail bits
      (systematic, parity 1, parity 2) in the §5.1.3.2.2 tail arrangement.
    """
    k = bits.shape[-1]
    perm, _ = _qpp_t(k, bits.device)
    p1, s1 = _rsc_encode(bits)
    p2, s2 = _rsc_encode(bits[..., perm])
    x1, z1 = _rsc_tail(s1)  # enc1 tail: sys x_K..x_K+2, parity z_K..z_K+2
    x2, z2 = _rsc_tail(s2)
    b8 = bits.to(torch.int8)
    d0 = torch.cat([b8, x1[:, 0:1], z1[:, 1:2], x2[:, 0:1], z2[:, 1:2]], dim=-1)
    d1 = torch.cat([p1, z1[:, 0:1], x1[:, 2:3], z2[:, 0:1], x2[:, 2:3]], dim=-1)
    d2 = torch.cat([p2, x1[:, 1:2], z1[:, 2:3], x2[:, 1:2], z2[:, 2:3]], dim=-1)
    return torch.stack([d0, d1, d2], dim=-2)


# --- max-log-MAP half-iteration ---------------------------------------------


@functools.lru_cache(maxsize=16)
def _step_tables(device: torch.device,
                 dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Predecessor (alpha) and successor (beta) tables of the trellis, with
    their input/parity bits as 0/1 coefficients of the metrics' dtype."""
    t = _trellis()
    ns, par = t["ns"], t["par"]
    pred = np.zeros((8, 2), np.int64)
    pred_u = np.zeros((8, 2), np.int64)
    pred_p = np.zeros((8, 2), np.int64)
    fill = np.zeros(8, np.int64)
    for s in range(8):
        for u in (0, 1):
            j = fill[ns[s, u]]
            pred[ns[s, u], j], pred_u[ns[s, u], j] = s, u
            pred_p[ns[s, u], j] = par[s, u]
            fill[ns[s, u]] += 1
    coef = dict(dtype=dtype, device=device)
    return dict(
        pred0=torch.as_tensor(pred[:, 0], device=device),
        pred1=torch.as_tensor(pred[:, 1], device=device),
        u0=torch.as_tensor(pred_u[:, 0], **coef),
        u1=torch.as_tensor(pred_u[:, 1], **coef),
        q0=torch.as_tensor(pred_p[:, 0], **coef),
        q1=torch.as_tensor(pred_p[:, 1], **coef),
        ns0=torch.as_tensor(ns[:, 0], device=device),
        ns1=torch.as_tensor(ns[:, 1], device=device),
        p0=torch.as_tensor(par[:, 0], **coef),
        p1=torch.as_tensor(par[:, 1], **coef),
    )


@functools.lru_cache(maxsize=8)
def _r4_tables(device: torch.device) -> dict:
    """Radix-4 (two steps fused) tables.  For the path j = 2·u1 + u2: alpha's
    predecessor two steps before each state (``pred``) and beta's successor
    two steps after it (``next``), each with the path's two parity bits as
    float32 0/1 columns (``ap1``/``ap2``, ``bp1``/``bp2``), and the path's
    input bits ``u1``/``u2`` as floats."""
    t = _trellis()
    ns, par = t["ns"], t["par"]
    pred, nxt = np.zeros((8, 4), np.int64), np.zeros((8, 4), np.int64)
    ap1, ap2, bp1, bp2 = (np.zeros((8, 4), np.float32) for _ in range(4))
    for p in range(8):
        for j in range(4):
            u1, u2 = j >> 1, j & 1
            m = ns[p, u1]
            s = ns[m, u2]
            pred[s, j], ap1[s, j], ap2[s, j] = p, par[p, u1], par[m, u2]
            nxt[p, j], bp1[p, j], bp2[p, j] = s, par[p, u1], par[m, u2]
    tensors = dict(pred=pred, next=nxt, ap1=ap1, ap2=ap2, bp1=bp1, bp2=bp2)
    return dict({k: torch.as_tensor(v, device=device) for k, v in tensors.items()},
                u1=(0.0, 0.0, 1.0, 1.0), u2=(0.0, 1.0, 0.0, 1.0))


def _alpha_step(alpha, g_sys, g_par):
    """alpha_k (..., 8) → alpha_{k+1}, normalised to its max.
    g_sys/g_par: (...,) branch LLR terms."""
    t = _step_tables(alpha.device, alpha.dtype)
    gs, gp = g_sys[..., None], g_par[..., None]
    c0 = alpha[..., t["pred0"]] + t["u0"] * gs + t["q0"] * gp
    c1 = alpha[..., t["pred1"]] + t["u1"] * gs + t["q1"] * gp
    out = torch.maximum(c0, c1)
    # normalise by the max so unreachable states stay ~_NEG without the
    # reachable ones losing f32 precision
    return out - out.amax(dim=-1, keepdim=True)


def _beta_step(beta, g_sys, g_par):
    """beta_{k+1} (..., 8) → beta_k, normalised to its max."""
    t = _step_tables(beta.device, beta.dtype)
    gs, gp = g_sys[..., None], g_par[..., None]
    c0 = beta[..., t["ns0"]] + t["p0"] * gp
    c1 = beta[..., t["ns1"]] + gs + t["p1"] * gp
    out = torch.maximum(c0, c1)
    return out - out.amax(dim=-1, keepdim=True)


def _llr_from_metrics(alpha, beta_next, g_sys, g_par):
    """A-posteriori LLR given alpha_k, beta_{k+1} (..., 8) and gamma terms."""
    t = _step_tables(alpha.device, alpha.dtype)
    gp = g_par[..., None]
    m0 = (alpha + t["p0"] * gp + beta_next[..., t["ns0"]]).amax(dim=-1)
    m1 = (alpha + t["p1"] * gp + beta_next[..., t["ns1"]]).amax(dim=-1)
    return m1 + g_sys - m0


def _exact_boundary_beta(tail_sys: torch.Tensor, tail_par: torch.Tensor) -> torch.Tensor:
    """beta_K from the 3 termination steps. tail_*: (B, 3) LLRs → (B, 8)."""
    b = torch.full(tail_sys.shape[:-1] + (8,), _NEG, dtype=torch.float32,
                   device=tail_sys.device)
    b[..., 0] = 0.0
    for i in (2, 1, 0):
        b = _beta_step(b, tail_sys[..., i], tail_par[..., i])
    return b


@functools.lru_cache(maxsize=256)
def _window_rows(k: int, l: int, t: int, device: torch.device) -> torch.Tensor:
    """(L+2T, W) trellis index of gamma row r in window w: w·L − T + r,
    clamped to [0, K) (the clamped rows are frozen by the kernel's masks)."""
    w = k // l
    k_idx = np.arange(w)[None, :] * l - t + np.arange(l + 2 * t)[:, None]
    return torch.as_tensor(np.clip(k_idx, 0, k - 1), device=device)


def _windowed_inputs(lsa, lp, tail_sys, tail_par, win_len: int, train_len: int):
    """Lay (B, K) gammas out as the kernel's inputs: (L+2T, N) gamma rows,
    lane = window·B + block, and the (8, N) initial alpha/beta metrics.

    lsa/lp: (B, K) combined systematic+apriori and parity LLRs; tail_*:
    (B, 3).  Returns (gs_ext, gp_ext, a_init, b_init, nof_w).
    """
    b, k = lsa.shape
    l, t = win_len, train_len
    if k % l:
        raise ValueError(f"window {l} does not divide K={k}")
    w = k // l
    n = w * b
    gidx = _window_rows(k, l, t, lsa.device)
    gs_ext = lsa.t()[gidx].reshape(l + 2 * t, n).contiguous()
    gp_ext = lp.t()[gidx].reshape(l + 2 * t, n).contiguous()
    a_init = torch.zeros((8, n), dtype=torch.float32, device=lsa.device)
    a_init[1:, :b] = _NEG  # window 0: exact start in state 0
    b_init = torch.zeros((8, n), dtype=torch.float32, device=lsa.device)
    b_init[:, (w - 1) * b:] = _exact_boundary_beta(tail_sys, tail_par).t()
    return gs_ext, gp_ext, a_init, b_init, w


def kernel_route(name: str, l: int, t: int) -> str:
    """The dataflow that ``TURBO_KERNEL=name`` selects at window L, training
    T: the JAX package's rule (``srsran_4g_tpu/ops/turbo.py:433-452`` and
    ``ops/pallas/turbo_map.py:1456-1478``).

    Returns "v4"…"v9" for the paired family (even L, even T >= 2; v7, v8
    and v9 need L % 4 == 0 and otherwise become v4); "v3" and "bf16", which
    name bodies of ``map_windowed_pallas``, at every shape; and "v1" for
    everything else, any unknown name included.  JAX's one further rule, v6
    → v7 when v6's stores would not fit the TPU's 15 MB scoped-VMEM budget,
    is left out: it is a TPU memory limit that Hopper does not have, so the
    port runs v6 as asked.
    """
    if name in ("v7", "v8", "v9") and l % 4:
        name = "v4"
    if name in ("v4", "v5", "v6", "v7", "v8", "v9") and l % 2 == 0 \
            and t % 2 == 0 and t >= 2:
        return name
    return name if name in ("v3", "bf16") else "v1"


def _map_windowed(lsa, lp, tail_sys, tail_par, win_len: int, train_len: int):
    """One windowed max-log BCJR half-iteration over (B, K) code blocks →
    a-posteriori LLRs (B, K), in the dataflow ``TURBO_KERNEL`` names
    (default v9): v9 → ``map_fused16`` (bf16), v7/v8 → ``map_fused`` at
    radix 2/4, v5/v6 → ``sweep`` at radix 4/2 then ``emit``, bf16 →
    ``map_windowed16``, v3 → ``map_v3``, and v1, v4 → ``map_windowed``."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    b, k = lsa.shape
    l, t = win_len, train_len
    route = kernel_route(os.environ.get("TURBO_KERNEL", "v9"), l, t)
    gs_ext, gp_ext, a_init, b_init, w = _windowed_inputs(
        lsa, lp, tail_sys, tail_par, l, t)
    args = (gs_ext, gp_ext, a_init, b_init, t, l, b, w)
    if route == "v9":
        llr = tm.map_fused16(*args)
    elif route in ("v7", "v8"):
        llr = tm.map_fused(*args, radix=2 if route == "v7" else 4)
    elif route in ("v5", "v6"):
        astore, bstore = tm.sweep(*args, radix=4 if route == "v5" else 2)
        n = w * b
        llr = tm.emit(gs_ext[t:t + l].view(l // 2, 2, n),
                      gp_ext[t:t + l].view(l // 2, 2, n), astore, bstore)
    elif route == "bf16":
        llr = tm.map_windowed16(*args)
    elif route == "v3":
        llr = tm.map_v3(*args)
    else:
        llr = tm.map_windowed(*args)
    return llr.reshape(l, w, b).permute(2, 1, 0).reshape(b, k)


def _map_full(lsa, lp, tail_sys, tail_par):
    """Exact max-log BCJR over the full trellis: one window, no training."""
    return _map_windowed(lsa, lp, tail_sys, tail_par, lsa.shape[-1], 0)


# --- full decoder -----------------------------------------------------------


def turbo_decode(
    d_llr: torch.Tensor,
    n_iter: int = 5,
    window: int | None = 208,
    train: int = 32,
    ext_scale: float = 0.75,
    early_crc: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode turbo code blocks from d-stream LLRs.

    Args:
      d_llr: (B, 3, K+4) float32 LLRs (positive ⇒ bit 1) for the three
        streams incl. tails — the output of rate dematching / HARQ combining.
      n_iter: full decoder iterations (2 half-iterations each).
      window: window length L, or None for the exact full-length recursion.
        The largest divisor of K that is <= window and > train is used.
      train: training prologue length T.
      ext_scale: extrinsic scaling factor for max-log.
      early_crc: CRC key ("24A"/"24B") appended to each code block.  When
        given, the decoder checks every block's CRC after each half-
        iteration, freezes the blocks that pass, and stops when all have
        passed (one host sync per half-iteration).

    Returns:
      (hard_bits (B, K) int8, app_llr (B, K) float32).
    """
    k = d_llr.shape[-1] - 4
    d0, d1, d2 = d_llr[:, 0], d_llr[:, 1], d_llr[:, 2]
    ls, lp1, lp2 = d0[:, :k], d1[:, :k], d2[:, :k]
    # §5.1.3.2.2 tail arrangement (see turbo_encode)
    t1_sys = torch.stack([d0[:, k], d2[:, k], d1[:, k + 1]], dim=-1)
    t1_par = torch.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], dim=-1)
    t2_sys = torch.stack([d0[:, k + 2], d2[:, k + 2], d1[:, k + 3]], dim=-1)
    t2_par = torch.stack([d1[:, k + 2], d0[:, k + 3], d2[:, k + 3]], dim=-1)

    perm, iperm = _qpp_t(k, d_llr.device)
    ls_int = ls[:, perm]

    if window is not None:
        # largest divisor of K that is <= the requested window and > train,
        # so awkward sizes still get a parallel-window decode
        window = next(
            (l for l in range(min(window, k), train, -1) if k % l == 0), None
        )

    def half(lsa, lp, tsys, tpar):
        if window is None:
            return _map_full(lsa, lp, tsys, tpar)
        return _map_windowed(lsa, lp, tsys, tpar, window, train)

    def h1(la):
        lsa = ls + la
        lapp = half(lsa, lp1, t1_sys, t1_par)
        e = ext_scale * (lapp - lsa)
        return e[:, perm], lapp

    def h2(la):
        lsa = ls_int + la
        lapp = half(lsa, lp2, t2_sys, t2_par)
        e = ext_scale * (lapp - lsa)
        return e[:, iperm], lapp[:, iperm]

    la = torch.zeros_like(ls)
    app = torch.zeros_like(ls)
    if early_crc is None:
        for _ in range(n_iter):
            la, _ = h1(la)
            la, app = h2(la)
        return (app > 0).to(torch.int8), app

    # One half-iteration at a time with a CRC check after each: a block
    # whose CRC passes is frozen (its APP/extrinsics no longer change), and
    # the loop ends once every block has passed.  The check costs one host
    # sync per half-iteration; at high SNR the first half usually ends it.
    done = torch.zeros(ls.shape[0], dtype=torch.bool, device=ls.device)
    for hi in range(2 * n_iter):
        la_n, app_n = (h1 if hi % 2 == 0 else h2)(la)
        keep = done[:, None]
        la = torch.where(keep, la, la_n)
        app = torch.where(keep, app, app_n)
        done = done | crc_check(app > 0, early_crc)
        if bool(done.all()):
            break
    return (app > 0).to(torch.int8), app
