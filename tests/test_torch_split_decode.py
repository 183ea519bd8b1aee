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

_SRC = (Path(__file__).resolve().parent.parent / "mxnet_tpu_torch" / "csrc"
        / "paged_decode_attention.cu").read_text()
MAX_RANKS = int(re.search(r"constexpr int kMaxRanks = (\d+);", _SRC)[1])
BUDGET = int(re.search(r"constexpr int kBudget = (\d+) \* 1024;",
                       _SRC)[1]) * 1024


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
                m = [onp.full(sq, NEG_INF, onp.float32)
                     for _ in range(WARPS)]
                l = [onp.zeros(sq, onp.float32) for _ in range(WARPS)]
                acc = [onp.zeros((sq, d), onp.float32)
                       for _ in range(WARPS)]
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
                    kb = onp.concatenate(krows).astype(onp.float32)
                    vb = onp.concatenate(vrows).astype(onp.float32)
                    for w in range(WARPS):
                        for k0 in range(w * CHUNK, nk, WARPS * CHUNK):
                            keys = onp.arange(k0, min(k0 + CHUNK, nk))
                            if log is not None:
                                log += [("sum", b, ub * unit + int(j))
                                        for j in keys]
                            s = (qs @ kb[keys].T) * onp.asarray(
                                kscale, onp.float32)[keys]
                            m_new = onp.maximum(m[w], s.max(axis=1))
                            alpha = onp.exp(m[w] - m_new)
                            p = onp.exp(s - m_new[:, None])
                            l[w] = l[w] * alpha + p.sum(axis=1)
                            pv = p * onp.asarray(vscale, onp.float32)[keys]
                            acc[w] = acc[w] * alpha[:, None] + pv @ vb[keys]
                            m[w] = m_new
                ranks.append(_merge(m, l, acc))
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
