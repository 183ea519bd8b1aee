"""K3's split-KV arithmetic (mxnet_tpu_torch/csrc/paged_decode_attention.cu)
emulated in numpy float32 on the CPU, and held against the JAX package's
paged decode attention: the jnp path and the Pallas kernel in interpret
mode.

The kernel cannot run here (no card, no nvcc), so this file follows its
steps with the same grouping of the sums:

- ``plan``: a cluster of S <= 8 ranks sized from P_max, each owning
  ceil(P_max / S) logical pages; a page larger than the shared-memory
  budget is split into ``parts``, and a rank's pages pass through at
  most ``batch`` at a time (the constants are read from the source);
- per rank, four warps each keep an online softmax over 32-key chunks
  (keys warp * 32 + lane, + 128, ...) of every batch, over the keys
  before the length only: rows at or past it, NaN here, are gathered
  with their page but never reach a sum;
- the warps' states merge into the rank's, and the ranks' states merge
  in rank order; an empty slot gives zeros.

Tolerance 1e-5 against both references (fp32 sums in another order, as
in tests/test_torch_kvquant.py); the jnp path is given the pools with
the garbage zeroed (its masked softmax multiplies masked rows by 0),
the Pallas kernel the NaN pools themselves.

K2 (mxnet_tpu_torch/csrc/decode_attention.cu, a dense cache) runs the
same cluster body (csrc/split_decode.cuh) over another row source, and
the second half of this file follows it the same way against the JAX
package's decode attention: its ``plan`` gives each of S <= 8 ranks
ceil(S_max / 8) keys rounded up to a warp's 32, a rank copies only its
rows before the length (in pieces of kCopyBytes on a contiguous cache, a
row a copy on a row-strided one), at most ``batch`` rows at a time.
"""
import math
import re
from pathlib import Path

import numpy as onp
import pytest
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jat

ATT_TOL = 1e-5
NEG_INF = onp.float32(-1e30)
WARPS, CHUNK = 4, 32

_CSRC = Path(__file__).resolve().parent.parent / "mxnet_tpu_torch" / "csrc"
_BODY = (_CSRC / "split_decode.cuh").read_text()
_DENSE = (_CSRC / "decode_attention.cu").read_text()
MAX_RANKS = int(re.search(r"constexpr int kMaxRanks = (\d+);", _BODY)[1])
BUDGET = int(re.search(r"constexpr int kBudget = (\d+) \* 1024;",
                       _BODY)[1]) * 1024
ROW_ALIGN = int(re.search(r"constexpr int kRowAlign = (\d+);", _DENSE)[1])
COPY_BYTES = int(re.search(r"constexpr int kCopyBytes = (\d+);",
                           _DENSE)[1])


def plan(p_max, ps, d, elem, budget=BUDGET):
    """The kernel's ``plan()``: (S, parts, units per rank, batch)."""
    ppr = -(-p_max // MAX_RANKS)
    s = -(-p_max // ppr)
    row = 2 * d * elem
    parts = 1
    while (ps // parts) * row + 8 > budget or ps % parts:
        parts += 1
    unit = ps // parts
    upr = ppr * parts
    return s, parts, upr, min(upr, budget // (unit * row + 8))


def _merge(ms, ls, accs):
    """States (m (R,), l (R,), acc (R, D)) merged in the given order."""
    m = ms[0]
    for x in ms[1:]:
        m = onp.maximum(m, x)
    w = [onp.exp(x - m) for x in ms]
    lsum = onp.zeros_like(ls[0])
    acc = onp.zeros_like(accs[0])
    for wk, lk, ak in zip(w, ls, accs):
        lsum = lsum + lk * wk
        acc = acc + ak * wk[:, None]
    return m, lsum, acc


class _Warps:
    """The four warps of one rank: each keeps an online softmax over the
    32-key chunks (keys warp * 32 + lane, + 128, ...) of every batch in
    shared memory, over its first ``nk`` rows only."""

    def __init__(self, sq, d):
        self.m = [onp.full(sq, NEG_INF, onp.float32) for _ in range(WARPS)]
        self.l = [onp.zeros(sq, onp.float32) for _ in range(WARPS)]
        self.acc = [onp.zeros((sq, d), onp.float32) for _ in range(WARPS)]

    def batch(self, qs, kb, vb, kscale, vscale, nk, key0, b, log):
        """One batch: buffer rows ``kb``/``vb`` (int8 or fp32) with each
        row's K and V scale; buffer row j is key ``key0 + j``."""
        kb, vb = kb.astype(onp.float32), vb.astype(onp.float32)
        kscale = onp.asarray(kscale, onp.float32)
        vscale = onp.asarray(vscale, onp.float32)
        for w in range(WARPS):
            for k0 in range(w * CHUNK, nk, WARPS * CHUNK):
                keys = onp.arange(k0, min(k0 + CHUNK, nk))
                if log is not None:
                    log += [("sum", b, key0 + int(j)) for j in keys]
                s = (qs @ kb[keys].T) * kscale[keys]
                m_new = onp.maximum(self.m[w], s.max(axis=1))
                alpha = onp.exp(self.m[w] - m_new)
                p = onp.exp(s - m_new[:, None])
                self.l[w] = self.l[w] * alpha + p.sum(axis=1)
                pv = p * vscale[keys]
                self.acc[w] = self.acc[w] * alpha[:, None] + pv @ vb[keys]
                self.m[w] = m_new

    def merged(self):
        return _merge(self.m, self.l, self.acc)


def emulate(q, kp, vp, table, lengths, scale, ks=None, vs=None,
            budget=BUDGET, log=None):
    """K3's output, step by step in float32. ``log`` (a list) collects
    each copied (slot, logical page) and each summed (slot, key)."""
    b_n, h_n, sq, d = q.shape
    n_pages, _, ps, _ = kp.shape
    p_max = table.shape[1]
    int8 = ks is not None
    s_n, parts, upr, batch = plan(p_max, ps, d, 1 if int8 else 4, budget)
    unit = ps // parts
    out = onp.zeros(q.shape, onp.float32)
    for b in range(b_n):
        ln = max(0, min(int(lengths[b]), p_max * ps))
        n_units = -(-ln // unit)
        for h in range(h_n):
            qs = (q[b, h] * onp.float32(scale)).astype(onp.float32)
            ranks = []
            for rank in range(s_n):
                u_begin = rank * upr
                u_end = min(u_begin + upr, n_units)
                if u_begin >= u_end:
                    continue             # no copy, no state
                warps = _Warps(sq, d)
                for ub in range(u_begin, u_end, batch):
                    nu = min(batch, u_end - ub)
                    nk = min(nu * unit, ln - ub * unit)
                    krows, vrows, kscale, vscale = [], [], [], []
                    for i in range(nu):          # the whole unit arrives
                        u = ub + i
                        lp = u // parts
                        pg = min(max(int(table[b, lp]), 0), n_pages - 1)
                        off = (u - lp * parts) * unit
                        krows.append(kp[pg, h, off:off + unit])
                        vrows.append(vp[pg, h, off:off + unit])
                        kscale += [ks[pg, h] if int8 else 1.0] * unit
                        vscale += [vs[pg, h] if int8 else 1.0] * unit
                        if log is not None:
                            log.append(("copy", b, lp))
                    warps.batch(qs, onp.concatenate(krows),
                                onp.concatenate(vrows), kscale, vscale, nk,
                                ub * unit, b, log)
                ranks.append(warps.merged())
            if ranks:
                _, lsum, a = _merge(*zip(*ranks))
                out[b, h] = a / lsum[:, None]
    return out


# -- the plan ---------------------------------------------------------------
@pytest.mark.parametrize("p_max,ps,d,elem,expect", [
    (64, 16, 64, 4, (8, 1, 8, 8)),      # the engine's: 8 ranks x 8 pages
    (64, 16, 64, 1, (8, 1, 8, 8)),
    (61, 16, 64, 4, (8, 1, 8, 8)),      # the last rank holds 5 pages
    (9, 16, 64, 4, (5, 1, 2, 2)),
    (1, 16, 64, 4, (1, 1, 1, 1)),
    (8, 256, 128, 4, (8, 4, 4, 1)),     # a page in 4 parts, one at a time
    (320, 16, 128, 4, (8, 1, 40, 6)),   # 40 pages a rank, 6 at a time
])
def test_plan_rank_ranges(p_max, ps, d, elem, expect):
    s, parts, upr, batch = plan(p_max, ps, d, elem)
    assert (s, parts, upr, batch) == expect
    assert 1 <= s <= MAX_RANKS and ps % parts == 0
    # the ranks' logical pages tile [0, P_max), none of them empty
    ppr = upr // parts
    pages = [list(range(r * ppr, min((r + 1) * ppr, p_max)))
             for r in range(s)]
    assert all(pages) and sum(pages, []) == list(range(p_max))
    # a batch of units fits the budget
    assert batch >= 1
    assert batch * ((ps // parts) * 2 * d * elem + 8) <= BUDGET


# -- inputs -------------------------------------------------------------------
H, D, PS, P_MAX = 2, 16, 4, 20
#: ranks own 3 pages (12 keys) at P_max = 20: lengths on either side of
#: rank edges, mid-page ends (1, 13, 79) and the full 80
LENGTHS = [0, 1, 11, 12, 13, 24, 79, 80]


def _inputs(sq, int8, seed=0):
    """q, the pools with NaN (or random int8) past every length, on the
    scrap page 0 and on unreferenced pages, the same pools with the
    fp32 garbage zeroed, the table (entries past a slot's pages on the
    scrap page), lengths, and the per-page scales with NaN on every
    page no slot reaches (and 0 there, for the jnp path)."""
    rng = onp.random.RandomState(seed)
    need = [-(-n // PS) for n in LENGTHS]
    n_pages = 1 + sum(need) + 3
    perm = rng.permutation(onp.arange(1, n_pages))
    table = onp.zeros((len(LENGTHS), P_MAX), "i4")
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n]
        at += n
    shape = (n_pages, H, PS, D)
    if int8:
        kp, vp = (rng.randint(-127, 128, shape).astype("i1")
                  for _ in range(2))
        kz, vz = kp, vp
    else:
        kp = onp.full(shape, onp.nan, "f4")
        vp = onp.full(shape, onp.nan, "f4")
        for i, n in enumerate(LENGTHS):
            for t in range(n):
                pg, r = table[i, t // PS], t % PS
                kp[pg, :, r] = rng.standard_normal((H, D)) * 0.5
                vp[pg, :, r] = rng.standard_normal((H, D)) * 0.5
        kz, vz = onp.nan_to_num(kp), onp.nan_to_num(vp)
    used = perm[:at]
    scales = []
    for _ in range(2):
        sc = onp.full((n_pages, H), onp.nan, "f4")
        sc[used] = rng.uniform(0.005, 0.03, (len(used), H))
        scales.append(sc)
    q = (rng.standard_normal((len(LENGTHS), H, sq, D)) * 0.5).astype("f4")
    return (q, kp, vp, kz, vz, table, onp.asarray(LENGTHS, "i4"), scales)


def _jnp_ref(q, kz, vz, table, lengths, scales, int8):
    kw = {}
    if int8:
        kw = dict(k_scale=jnp.asarray(onp.nan_to_num(scales[0])),
                  v_scale=jnp.asarray(onp.nan_to_num(scales[1])))
    return onp.asarray(jat.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kz), jnp.asarray(vz),
        jnp.asarray(table), jnp.asarray(lengths), **kw))


def _emulate(q, kp, vp, table, lengths, scales, int8, **kw):
    sc = dict(ks=scales[0], vs=scales[1]) if int8 else {}
    return emulate(q, kp, vp, table, lengths, 1.0 / math.sqrt(D), **sc,
                   **kw)


# -- the arithmetic against the reference ------------------------------------
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("sq", [1, 4])
def test_split_kv_matches_jax(sq, int8):
    q, kp, vp, kz, vz, table, lengths, scales = _inputs(sq, int8)
    out = _emulate(q, kp, vp, table, lengths, scales, int8)
    assert onp.isfinite(out).all()
    assert (out[0] == 0).all()                 # len == 0 gives zeros
    ref = _jnp_ref(q, kz, vz, table, lengths, scales, int8)
    assert onp.abs(out - ref).max() < ATT_TOL


@pytest.mark.requires_pallas
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_split_kv_matches_pallas_kernel(int8):
    q, kp, vp, _kz, _vz, table, lengths, scales = _inputs(1, int8, seed=1)
    out = _emulate(q, kp, vp, table, lengths, scales, int8)
    kw = {}
    if int8:
        kw = dict(k_scale=jnp.asarray(onp.nan_to_num(scales[0])),
                  v_scale=jnp.asarray(onp.nan_to_num(scales[1])))
    pal = onp.asarray(jat.paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), interpret=True, **kw))
    assert onp.abs(out - pal).max() < ATT_TOL


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_pages_in_parts_and_batches(int8):
    """A budget of half a page splits each page in two and passes one
    part at a time, so every rank runs several batches: the online
    softmax carries across them and the result holds."""
    q, kp, vp, kz, vz, table, lengths, scales = _inputs(4, int8, seed=2)
    elem = 1 if int8 else 4
    small = PS * D * elem + 8    # K, V and the scales of half a page
    assert plan(P_MAX, PS, D, elem, small)[1:] == (2, 6, 1)
    out = _emulate(q, kp, vp, table, lengths, scales, int8, budget=small)
    ref = _jnp_ref(q, kz, vz, table, lengths, scales, int8)
    assert onp.isfinite(out).all()
    assert onp.abs(out - ref).max() < ATT_TOL


@pytest.mark.parametrize("budget", [BUDGET, PS * D * 4 + 8])
def test_only_valid_pages_copied_and_keys_summed(budget):
    """No page at or past ceil(len / ps) is copied (nor the scrap page
    through one), and no key at or past len reaches a sum; every key
    before it does, once."""
    q, kp, vp, _kz, _vz, table, lengths, scales = _inputs(1, False)
    log = []
    _emulate(q, kp, vp, table, lengths, scales, False, budget=budget,
             log=log)
    for b, n in enumerate(LENGTHS):
        copied = {lp for op, bb, lp in log if op == "copy" and bb == b}
        assert copied == set(range(-(-n // PS)))
        assert all(table[b, lp] != 0 for lp in copied)
        summed = [k for op, bb, k in log if op == "sum" and bb == b]
        assert sorted(summed) == sorted(list(range(n)) * H)


# ===========================================================================
# K2: the dense cache
# ===========================================================================
def dense_plan(s_max, d, elem, budget=BUDGET):
    """decode_attention.cu's ``plan()``: (S, keys per rank, batch)."""
    s_max = max(s_max, 1)
    rows = -(-(-(-s_max // MAX_RANKS)) // ROW_ALIGN) * ROW_ALIGN
    return -(-s_max // rows), rows, min(rows, budget // (2 * d * elem))


def dense_emulate(q, k, v, lengths, scale, ks=None, vs=None, budget=BUDGET,
                  contiguous=True, log=None):
    """K2's output, step by step in float32. ``log`` collects each copy
    (slot, head, first row, rows) and each summed (slot, key)."""
    b_n, h_n, sq, d = q.shape
    s_max = k.shape[2]
    int8 = ks is not None
    elem = 1 if int8 else 4
    s_n, rows, batch = dense_plan(s_max, d, elem, budget)
    piece = max(1, COPY_BYTES // (d * elem)) if contiguous else 1
    out = onp.zeros(q.shape, onp.float32)
    for b in range(b_n):
        ln = max(0, min(int(lengths[b]), s_max))
        for h in range(h_n):
            qs = (q[b, h] * onp.float32(scale)).astype(onp.float32)
            ranks = []
            for rank in range(s_n):
                row_end = min((rank + 1) * rows, ln)
                if rank * rows >= row_end:
                    continue             # no copy, no state
                warps = _Warps(sq, d)
                for rb in range(rank * rows, row_end, batch):
                    nk = min(batch, row_end - rb)
                    for i in range(0, nk, piece):   # only rows before len
                        if log is not None:
                            log.append(("copy", b, h, rb + i,
                                        min(piece, nk - i)))
                    kscale = [ks[b, h] if int8 else 1.0] * nk
                    vscale = [vs[b, h] if int8 else 1.0] * nk
                    warps.batch(qs, k[b, h, rb:rb + nk], v[b, h, rb:rb + nk],
                                kscale, vscale, nk, rb, b, log)
                ranks.append(warps.merged())
            if ranks:
                _, lsum, a = _merge(*zip(*ranks))
                out[b, h] = a / lsum[:, None]
    return out


@pytest.mark.parametrize("s_max,d,elem,expect", [
    (1024, 64, 4, (8, 128, 128)),   # the engine's: 8 ranks x 128 keys
    (1024, 64, 1, (8, 128, 128)),
    (1000, 64, 4, (8, 128, 128)),   # the last rank holds 104 keys
    (64, 64, 4, (2, 32, 32)),
    (1, 16, 4, (1, 32, 32)),
    (0, 16, 4, (1, 32, 32)),        # an empty cache: one rank, no keys
    (4096, 128, 4, (8, 512, 112)),  # 512 keys a rank, 112 at a time
])
def test_dense_plan_rank_ranges(s_max, d, elem, expect):
    s, rows, batch = dense_plan(s_max, d, elem)
    assert (s, rows, batch) == expect
    assert 1 <= s <= MAX_RANKS and rows % ROW_ALIGN == 0
    # the ranks' keys tile [0, S_max), none of them empty
    if s_max:
        keys = [list(range(r * rows, min((r + 1) * rows, s_max)))
                for r in range(s)]
        assert all(keys) and sum(keys, []) == list(range(s_max))
    assert 1 <= batch and batch * 2 * d * elem <= BUDGET


DH, DD = 2, 16
#: (S_max, lengths): ranks own 128 keys at S_max 1024 and 1000: lengths
#: on either side of rank edges, 0, 1 and the full cache
DENSE_SETS = [
    (1024, [0, 1, 127, 128, 129, 511, 512, 513, 895, 896, 897, 1024]),
    (1000, [0, 1, 127, 128, 129, 500, 895, 896, 999, 1000]),
]


def _dense_inputs(s_max, lengths, sq, int8, seed=0):
    """q; K/V with NaN (or random int8) past every length; the same
    with the fp32 garbage zeroed; (B, H) scales with NaN on every empty
    slot (and 0 there, for the jnp path)."""
    rng = onp.random.RandomState(seed)
    b = len(lengths)
    shape = (b, DH, s_max, DD)
    if int8:
        k, v = (rng.randint(-127, 128, shape).astype("i1") for _ in range(2))
        kz, vz = k, v
    else:
        k, v = ((rng.standard_normal(shape) * 0.5).astype("f4")
                for _ in range(2))
        for i, n in enumerate(lengths):
            k[i, :, n:] = onp.nan
            v[i, :, n:] = onp.nan
        kz, vz = onp.nan_to_num(k), onp.nan_to_num(v)
    scales = []
    for _ in range(2):
        sc = rng.uniform(0.005, 0.03, (b, DH)).astype("f4")
        sc[[i for i, n in enumerate(lengths) if n == 0]] = onp.nan
        scales.append(sc)
    q = (rng.standard_normal((b, DH, sq, DD)) * 0.5).astype("f4")
    return q, k, v, kz, vz, onp.asarray(lengths, "i4"), scales


def _dense_emulate(q, k, v, lengths, scales, int8, **kw):
    sc = dict(ks=scales[0], vs=scales[1]) if int8 else {}
    return dense_emulate(q, k, v, lengths, 1.0 / math.sqrt(DD), **sc, **kw)


def _dense_jnp(q, kz, vz, lengths, scales, int8):
    kw = {}
    if int8:
        kw = dict(k_scale=jnp.asarray(onp.nan_to_num(scales[0])),
                  v_scale=jnp.asarray(onp.nan_to_num(scales[1])))
    return onp.asarray(jat.decode_attention(
        jnp.asarray(q), jnp.asarray(kz), jnp.asarray(vz),
        jnp.asarray(lengths), **kw))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("s_max,lengths", DENSE_SETS,
                         ids=[f"S={s}" for s, _ in DENSE_SETS])
def test_dense_split_matches_jax(s_max, lengths, sq, int8):
    q, k, v, kz, vz, ln, scales = _dense_inputs(s_max, lengths, sq, int8)
    out = _dense_emulate(q, k, v, ln, scales, int8)
    assert onp.isfinite(out).all()
    assert (out[0] == 0).all()                 # len == 0 gives zeros
    ref = _dense_jnp(q, kz, vz, ln, scales, int8)
    assert onp.abs(out - ref).max() < ATT_TOL


@pytest.mark.requires_pallas
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("sq", [1, 4])
def test_dense_split_matches_pallas_kernel(sq, int8):
    s_max, lengths = DENSE_SETS[1]
    q, k, v, _kz, _vz, ln, scales = _dense_inputs(s_max, lengths, sq, int8,
                                                  seed=1)
    out = _dense_emulate(q, k, v, ln, scales, int8)
    kw = {}
    if int8:
        kw = dict(k_scale=jnp.asarray(onp.nan_to_num(scales[0])),
                  v_scale=jnp.asarray(onp.nan_to_num(scales[1])))
    pal = onp.asarray(jat.decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln),
        interpret=True, **kw))
    assert onp.abs(out - pal).max() < ATT_TOL


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_dense_rows_in_batches(int8):
    """A budget of 40 rows makes every long rank run four batches
    (40 + 40 + 40 + 8 of 128 keys): the warps' online softmax carries
    across them and the result holds."""
    s_max, lengths = DENSE_SETS[0]
    q, k, v, kz, vz, ln, scales = _dense_inputs(s_max, lengths, 4, int8,
                                                seed=2)
    elem = 1 if int8 else 4
    small = 40 * 2 * DD * elem
    assert dense_plan(s_max, DD, elem, small) == (8, 128, 40)
    out = _dense_emulate(q, k, v, ln, scales, int8, budget=small)
    assert onp.isfinite(out).all()
    ref = _dense_jnp(q, kz, vz, ln, scales, int8)
    assert onp.abs(out - ref).max() < ATT_TOL


@pytest.mark.parametrize("contiguous", [True, False],
                         ids=["contiguous", "row_strided"])
@pytest.mark.parametrize("budget", [BUDGET, 40 * 2 * DD * 4])
def test_dense_only_valid_rows_copied_and_summed(budget, contiguous):
    """Every copy lies below the slot's length, and together they cover
    [0, len) once per head; every key before the length is summed once
    per head, none at or past it."""
    for s_max, lengths in DENSE_SETS:
        q, k, v, _kz, _vz, ln, scales = _dense_inputs(s_max, lengths, 1,
                                                      False)
        log = []
        _dense_emulate(q, k, v, ln, scales, False, budget=budget,
                       contiguous=contiguous, log=log)
        for b, n in enumerate(lengths):
            for h in range(DH):
                rows = [r for op, bb, *rest in log if op == "copy"
                        and bb == b and rest[0] == h
                        for r in range(rest[1], rest[1] + rest[2])]
                assert all(r < n for r in rows)
                assert sorted(rows) == list(range(n))
            summed = [kk for op, bb, kk, *_ in log if op == "sum" and bb == b]
            assert sorted(summed) == sorted(list(range(n)) * DH)
