"""NR LDPC encoder/decoder (BG1/BG2), TS 38.212 §5.3.2.

Port counterpart of ``srsran_4g_tpu/ops/ldpc.py``.  The lifted parity-check
structure is folded on the host into static index tensors, cached per
(base graph, Z, device):

- the decoder's (row, edge, z) → variable gather index with each edge's
  cyclic shift baked in, and its transpose: for every variable, the flat
  positions of its edges in ascending order, padded with a slot that holds 0;
- the encoder's per-row gathers over the systematic (core rows) and
  systematic + core-parity (extension rows) columns.

A flooded decoder iteration is one gather, a masked min-sum over the edge
axis and one accumulation per variable.  JAX scatter-adds the check messages
(``zeros.at[:, gidx].add(delta)``), whose indices repeat; on CUDA a
scatter-add sums repeats with atomics in no fixed order.  Here each
variable's messages are gathered and added one edge slot at a time, in
ascending edge order, the order of the JAX scatter, so the sum is the same
on the CPU and the card.

Encoding XORs the gathered bits of each parity row (an integer sum mod 2),
solving the 4Z×4Z core through its host-precomputed GF(2) inverse as a
float32 matmul mod 2 (at most 4Z = 1,536 terms of 0/1, exact).

Normalized min-sum (factor 0.8), fixed iterations; the flooded schedule is
the default, the layered one (a host loop over the 42/46 base-graph rows)
is kept for parity.  Base-graph shift tables are TS 38.212 Tables
5.3.2-2/-3 (utils/ldpc_tables.npz, copied from the JAX package).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

_NO_CNCT = 65535
_BIG = 1e30  # magnitude of a masked edge, never the minimum

# lifting sets (TS 38.212 Table 5.3.2-1): iLS → allowed Z values
LIFT_SETS = {
    0: (2, 4, 8, 16, 32, 64, 128, 256),
    1: (3, 6, 12, 24, 48, 96, 192, 384),
    2: (5, 10, 20, 40, 80, 160, 320),
    3: (7, 14, 28, 56, 112, 224),
    4: (9, 18, 36, 72, 144, 288),
    5: (11, 22, 44, 88, 176, 352),
    6: (13, 26, 52, 104, 208),
    7: (15, 30, 60, 120, 240),
}


def lift_index(z: int) -> int:
    for ils, zs in LIFT_SETS.items():
        if z in zs:
            return ils
    raise ValueError(f"invalid lifting size {z}")


@functools.lru_cache(maxsize=1)
def _tables():
    path = os.path.join(os.path.dirname(__file__), "..", "utils", "ldpc_tables.npz")
    with np.load(os.path.abspath(path)) as f:
        return {k: f[k] for k in f.files}


def bg_params(bg: int) -> tuple[int, int, int]:
    """(n_info_blocks Kb, n_check M, n_cols Nfull)."""
    return (22, 46, 68) if bg == 1 else (10, 42, 52)


@functools.lru_cache(maxsize=64)
def _shift_matrix(bg: int, z: int) -> np.ndarray:
    """(M, Nfull) shifts mod Z, -1 = no connection."""
    t = _tables()["bg1" if bg == 1 else "bg2"][lift_index(z)].astype(np.int64)
    return np.where(t == _NO_CNCT, -1, t % z)


@functools.lru_cache(maxsize=64)
def _edge_structure(bg: int, z: int):
    """Static decoder structure: gather indices + mask.

    Returns (gidx (M, D, Z) int32 into the flat (Nfull*Z,) variable vector,
    mask (M, D, 1) float32, degrees).
    """
    h = _shift_matrix(bg, z)
    m, nfull = h.shape
    deg = (h >= 0).sum(axis=1)
    d = int(deg.max())
    gidx = np.zeros((m, d, z), dtype=np.int32)
    mask = np.zeros((m, d, 1), dtype=np.float32)
    zr = np.arange(z)
    for i in range(m):
        cols = np.nonzero(h[i] >= 0)[0]
        for e, c in enumerate(cols):
            gidx[i, e] = c * z + (zr + h[i, c]) % z
            mask[i, e] = 1.0
    return gidx, mask, deg


@functools.lru_cache(maxsize=64)
def _var_edges(bg: int, z: int) -> np.ndarray:
    """(Dv, Nfull*Z) int64: column v lists the flat (M*D*Z) positions of
    variable v's edges in ascending order, padded with M*D*Z (a zero slot)."""
    gidx, mask, _ = _edge_structure(bg, z)
    n_edges = gidx.size
    valid = np.broadcast_to(mask > 0, gidx.shape).reshape(-1)
    pos = np.nonzero(valid)[0]
    var = gidx.reshape(-1)[pos].astype(np.int64)
    order = np.argsort(var, kind="stable")  # ascending edges within a variable
    pos, var = pos[order], var[order]
    n_var = bg_params(bg)[2] * z
    counts = np.bincount(var, minlength=n_var)
    slot = np.arange(var.size) - (np.cumsum(counts) - counts)[var]
    out = np.full((int(counts.max()), n_var), n_edges, np.int64)
    out[slot, var] = pos
    return out


@functools.lru_cache(maxsize=64)
def _core_inverse(bg: int, z: int) -> np.ndarray:
    """GF(2) inverse of the 4Z×4Z parity core (columns Kb..Kb+3, rows 0..3).

    Solves M_c · p_core = t so p_core = inv · t; returned as (4Z, 4Z) uint8.
    """
    kb, _, _ = bg_params(bg)
    h = _shift_matrix(bg, z)
    n = 4 * z
    mat = np.zeros((n, n), dtype=np.uint8)
    for i in range(4):
        for j in range(4):
            s = h[i, kb + j]
            if s >= 0:
                rows = i * z + np.arange(z)
                cols = j * z + (np.arange(z) + s) % z
                mat[rows, cols] ^= 1
    a = np.concatenate([mat, np.eye(n, dtype=np.uint8)], axis=1)  # Gauss-Jordan
    for col in range(n):
        piv = col + np.argmax(a[col:, col])
        assert a[piv, col], "singular LDPC core"
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
        sel = a[:, col].copy()
        sel[col] = 0
        a[sel.astype(bool)] ^= a[col]
    return a[:, n:]


def _row_gather(h: np.ndarray, rows: range, n_cols: int, z: int) -> np.ndarray:
    """(len(rows), D, Z) flat indices into n_cols*Z bits (+1 zero slot at the
    end): row i's connections to columns < n_cols, each cyclically shifted,
    so that XOR-ing over D gives the row's parity contribution."""
    sub = h[list(rows), :n_cols]
    d = int((sub >= 0).sum(axis=1).max())
    out = np.full((len(rows), d, z), n_cols * z, np.int64)
    zr = np.arange(z)
    for r, row in enumerate(sub):
        for e, c in enumerate(np.nonzero(row >= 0)[0]):
            out[r, e] = c * z + (zr + row[c]) % z
    return out


@functools.lru_cache(maxsize=64)
def _enc_tables(bg: int, z: int, device: torch.device) -> dict[str, torch.Tensor]:
    kb, m, _ = bg_params(bg)
    h = _shift_matrix(bg, z)
    return dict(
        core=torch.as_tensor(_row_gather(h, range(4), kb, z), device=device),
        ext=torch.as_tensor(_row_gather(h, range(4, m), kb + 4, z), device=device),
        inv_t=torch.as_tensor(_core_inverse(bg, z).T.astype(np.float32), device=device))


@functools.lru_cache(maxsize=64)
def _dec_tables(bg: int, z: int, device: torch.device) -> dict[str, torch.Tensor]:
    gidx, mask, deg = _edge_structure(bg, z)
    rows = [torch.as_tensor(gidx[i, :deg[i]].reshape(-1).astype(np.int64), device=device)
            for i in range(gidx.shape[0])]
    return dict(gidx=torch.as_tensor(gidx.reshape(-1).astype(np.int64), device=device),
                mask=torch.as_tensor(mask > 0, device=device),
                var_edges=torch.as_tensor(_var_edges(bg, z), device=device),
                rows=rows)


def _parity(bits_ext: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """XOR over the edge axis of bits gathered by (R, D, Z) idx → (B, R*Z)."""
    b = bits_ext.shape[0]
    return (bits_ext[:, idx].sum(dim=2, dtype=torch.int32) & 1).reshape(b, -1)


def encode(bits: torch.Tensor, bg: int, z: int) -> torch.Tensor:
    """Encode (B, Kb*Z) info bits → (B, Nfull*Z) int8 full codeword (before
    the 2Z-column puncturing of rate matching)."""
    kb, m, _ = bg_params(bg)
    b = bits.shape[0]
    if bits.shape[1] != kb * z:
        raise ValueError(f"LDPC BG{bg} Z={z} encodes {kb * z} bits, got {bits.shape[1]}")
    t = _enc_tables(bg, z, bits.device)
    zero = bits.new_zeros((b, 1), dtype=torch.int8)
    sys_bits = torch.cat([bits.to(torch.int8), zero], dim=-1)
    core = _parity(sys_bits, t["core"])  # (B, 4Z): rows 0..3 over the systematic part
    p_core = torch.matmul(core.to(torch.float32), t["inv_t"]).to(torch.int32) & 1
    head = torch.cat([bits.to(torch.int8), p_core.to(torch.int8)], dim=-1)
    p_ext = _parity(torch.cat([head, zero], dim=-1), t["ext"])  # rows 4..M-1
    return torch.cat([head, p_ext.to(torch.int8)], dim=-1)


def _minsum(v2c: torch.Tensor, mask: torch.Tensor, norm: float, dim: int) -> torch.Tensor:
    """Normalized min-sum check update along ``dim`` (the edge axis): each
    edge gets norm × (the smallest other magnitude) with the sign of the
    product of the other signs; masked edges give 0."""
    mag = torch.where(mask, v2c.abs(), _BIG)
    m1, idx1 = torch.min(mag, dim=dim, keepdim=True)  # first index of a tie
    shape = [1] * v2c.ndim
    shape[dim] = v2c.shape[dim]
    first = torch.arange(v2c.shape[dim], device=v2c.device).view(shape) == idx1
    m2 = torch.where(first, _BIG, mag).amin(dim=dim, keepdim=True)
    mins = norm * torch.where(first, m2, m1)
    neg = (v2c < 0) & mask
    flip = neg ^ (neg.sum(dim=dim, keepdim=True, dtype=torch.int32) & 1).bool()
    return torch.where(mask, torch.where(flip, -mins, mins), 0.0)


def _var_sum(c2v: torch.Tensor, var_edges: torch.Tensor) -> torch.Tensor:
    """Sum each variable's check messages, (B, M*D*Z) → (B, Nfull*Z), in
    ascending edge order (one add per edge slot: the same on every device)."""
    ext = torch.cat([c2v, c2v.new_zeros((c2v.shape[0], 1))], dim=-1)
    g = ext[:, var_edges]  # (B, Dv, Nfull*Z)
    acc = g[:, 0]
    for k in range(1, g.shape[1]):
        acc = acc + g[:, k]
    return acc


def decode(
    llrs: torch.Tensor, bg: int, z: int, n_iter: int = 10, norm: float = 0.8,
    schedule: str = "flooded",
) -> torch.Tensor:
    """Normalized min-sum decode (flooding or layered schedule).

    Args:
      llrs: (B, Nfull*Z) float32, positive ⇒ bit 1, zeros for punctured /
        not-transmitted positions.
      schedule: "flooded" (default, one update of every check per iteration)
        or "layered" (sequential row updates; use ~half the iterations).

    Returns (B, Kb*Z) int8 hard info bits.
    """
    if schedule == "layered":
        return _decode_layered(llrs, bg, z, n_iter, norm)
    if schedule != "flooded":
        raise ValueError(f"unknown LDPC schedule {schedule!r}")
    kb, m, _ = bg_params(bg)
    t = _dec_tables(bg, z, llrs.device)
    b = llrs.shape[0]
    d = t["mask"].shape[1]
    chan = -llrs.to(torch.float32)  # internal: positive ⇒ bit 0
    lq = chan
    c2v = torch.zeros((b, m, d, z), dtype=torch.float32, device=llrs.device)
    for _ in range(n_iter):
        v2c = lq[:, t["gidx"]].reshape(b, m, d, z) - c2v
        c2v = _minsum(v2c, t["mask"], norm, dim=2)
        lq = chan + _var_sum(c2v.reshape(b, -1), t["var_edges"])
    return (lq[:, :kb * z] < 0).to(torch.int8)


def _decode_layered(llrs: torch.Tensor, bg: int, z: int, n_iter: int,
                    norm: float) -> torch.Tensor:
    """Layered normalized min-sum: the APP (lq) is updated row by row within
    an iteration, so each check sees the newest messages.  A row's edges
    touch distinct variables, so its update adds once to each (the JAX
    scan's padded edges add 0)."""
    kb, _, _ = bg_params(bg)
    t = _dec_tables(bg, z, llrs.device)
    b = llrs.shape[0]
    lq = -llrs.to(torch.float32)
    c2v = [lq.new_zeros((b, gi.numel() // z, z)) for gi in t["rows"]]
    ones = torch.ones((1, 1), dtype=torch.bool, device=llrs.device)
    for _ in range(n_iter):
        for i, gi in enumerate(t["rows"]):
            v2c = lq[:, gi].reshape(c2v[i].shape) - c2v[i]
            new = _minsum(v2c, ones, norm, dim=1)
            lq = lq.index_add(1, gi, (new - c2v[i]).reshape(b, -1))
            c2v[i] = new
    return (lq[:, :kb * z] < 0).to(torch.int8)


# --- rate matching (TS 38.212 §5.4.2.1, simplified: no Qm interleaver) ------


@functools.lru_cache(maxsize=256)
def _rm_ring(bg: int, z: int, rv: int, n_filler: int, k_prime: int) -> np.ndarray:
    """One pass of the circular buffer: indices into the (Nfull*Z,) codeword
    from k0 on, skipping the first 2Z punctured columns and the <NULL>
    filler range [k_prime, K) (TS 38.212 §5.4.2.1)."""
    kb, _, nfull = bg_params(bg)
    n = (nfull - 2) * z
    k0_frac = {1: (0, 17, 33, 56), 2: (0, 13, 25, 43)}[bg][rv]
    k0 = (k0_frac * n // ((66 if bg == 1 else 50) * z)) * z  # multiple of Z
    pos = np.arange(n)
    src = pos + 2 * z
    valid = ~((src >= k_prime) & (src < kb * z)) if n_filler else np.ones(n, bool)
    ring = np.nonzero(valid[(k0 + pos) % n])[0]
    return ((k0 + ring) % n + 2 * z).astype(np.int64)


def _rm_indices(bg: int, z: int, e: int, rv: int, n_filler: int, k_prime: int) -> np.ndarray:
    """Circular-buffer indices into the (Nfull*Z,) codeword for E bits."""
    sel = _rm_ring(bg, z, rv, n_filler, k_prime)
    return np.tile(sel, -(-e // sel.size))[:e]


@functools.lru_cache(maxsize=256)
def _rm_indices_t(bg, z, e, rv, n_filler, k_prime, device) -> torch.Tensor:
    return torch.as_tensor(_rm_indices(bg, z, e, rv, n_filler, k_prime), device=device)


def rm_select(codeword: torch.Tensor, bg: int, z: int, e: int, rv: int = 0,
              n_filler: int = 0, k_prime: int = 0) -> torch.Tensor:
    """Bit selection from the circular buffer (first 2Z columns punctured,
    filler <NULL> positions skipped)."""
    return codeword[:, _rm_indices_t(bg, z, e, rv, n_filler, k_prime, codeword.device)]


def rm_collect(e_llr: torch.Tensor, bg: int, z: int, rv: int = 0,
               n_filler: int = 0, k_prime: int = 0,
               softbuffer: torch.Tensor | None = None) -> torch.Tensor:
    """Soft-combine received LLRs back into the (Nfull*Z) buffer (HARQ).

    Each pass over the circular buffer adds to distinct positions, so the
    repetitions of E > ring accumulate in transmit order, as in JAX."""
    nfull = bg_params(bg)[2]
    e = e_llr.shape[-1]
    idx = _rm_indices_t(bg, z, e, rv, n_filler, k_prime, e_llr.device)
    ring = _rm_ring(bg, z, rv, n_filler, k_prime).size
    out = (torch.zeros((e_llr.shape[0], nfull * z), dtype=torch.float32, device=e_llr.device)
           if softbuffer is None else softbuffer.to(torch.float32).clone())
    vals = e_llr.to(torch.float32)
    for s in range(0, e, ring):
        out.index_add_(1, idx[s:s + ring], vals[:, s:s + ring])
    return out
