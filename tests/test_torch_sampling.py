"""The port's sampling heads (mxnet_tpu_torch.ops.sampling) against the
JAX package's on the same numpy logits.

Guarantees under test (those of tests/test_sampling.py for
``warp_logits`` and ``sample_tokens``):
- ``warp_logits`` keeps exactly the tokens the JAX function keeps (the
  same mask) and scales them alike (fp32, rtol=1e-6): top-k keeps the k
  largest, top-p the minimal nucleus, temperature divides, at least one
  token survives;
- ``sample_tokens`` is deterministic per generator, row-independent,
  greedy rows are the argmax of the raw logits, draws stay inside the
  top-k support, and the empirical distribution of 4000 draws is within
  a total-variation distance of 0.05 of the warped softmax (the bound of
  tests/test_sampling.py). Draws are never compared with the JAX
  package's token for token: Philox and Threefry streams differ.
"""
import numpy as onp
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.ops import sampling as jsmp
from mxnet_tpu_torch.ops import sampling as tsmp

NEG = -1e29   # "masked" threshold for assertions (NEG_INF is -1e30)


def _softmax(x):
    e = onp.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _gens(seeds):
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


KNOBS = [
    ("mixed", [0.0, 1.0, 0.7, 1.3, 2.0, 0.5], [0, 5, 1, 40, 3, 0],
     [1.0, 0.9, 0.5, 0.3, 1.0, 0.95]),
    ("top_k_only", [1.0] * 6, [1, 2, 3, 10, 0, 41], [1.0] * 6),
    ("top_p_only", [0.8] * 6, [0] * 6, [0.05, 0.2, 0.5, 0.8, 0.99, 1.0]),
]


@pytest.mark.parametrize("t,k,p", [c[1:] for c in KNOBS],
                         ids=[c[0] for c in KNOBS])
def test_warp_logits_matches_jax(t, k, p):
    rng = onp.random.RandomState(0)
    lg = (rng.randn(6, 41) * 2.0).astype("f4")
    t, k, p = (onp.asarray(t, "f4"), onp.asarray(k, "i4"),
               onp.asarray(p, "f4"))
    w = tsmp.warp_logits(torch.from_numpy(lg), t, k, p).numpy()
    jw = onp.asarray(jsmp.warp_logits(jnp.asarray(lg), t, k, p))
    onp.testing.assert_array_equal(w > NEG, jw > NEG)
    onp.testing.assert_allclose(w[w > NEG], jw[jw > NEG], rtol=1e-6)
    assert ((w > NEG).sum(axis=-1) >= 1).all()


def test_top_k_keeps_exactly_k_largest():
    rng = onp.random.RandomState(1)
    lg = rng.randn(5, 23).astype("f4")
    for k in (1, 3, 10, 22):
        w = tsmp.warp_logits(torch.from_numpy(lg), onp.ones(5, "f4"),
                             onp.full(5, k, "i4"), onp.ones(5, "f4")).numpy()
        for row in range(5):
            kept = w[row] > NEG
            assert kept.sum() == k
            assert (lg[row][kept] >= onp.sort(lg[row])[-k]).all()
    for k in (0, 23, 99):
        w = tsmp.warp_logits(torch.from_numpy(lg), onp.ones(5, "f4"),
                             onp.full(5, k, "i4"), onp.ones(5, "f4")).numpy()
        assert (w > NEG).all()


def test_top_p_minimal_nucleus_and_temperature():
    rng = onp.random.RandomState(2)
    lg = (rng.randn(6, 17) * 2.0).astype("f4")
    probs = _softmax(lg.astype("f8"))
    for p in (0.1, 0.5, 0.9):
        w = tsmp.warp_logits(torch.from_numpy(lg), onp.ones(6, "f4"),
                             onp.zeros(6, "i4"), onp.full(6, p, "f4")).numpy()
        for row in range(6):
            order = onp.argsort(-probs[row], kind="stable")
            cum = probs[row][order].cumsum()
            n_keep = int((onp.concatenate([[0.0], cum[:-1]]) < p).sum())
            assert set(onp.where(w[row] > NEG)[0]) == set(order[:n_keep])
    w = tsmp.warp_logits(torch.from_numpy(lg), onp.full(6, 2.0, "f4"),
                         onp.zeros(6, "i4"), onp.ones(6, "f4")).numpy()
    onp.testing.assert_allclose(w, lg / 2.0, rtol=1e-6)
    # an extreme nucleus and top_k=1 still leave the head token
    w = tsmp.warp_logits(torch.tensor([[5.0, 0.0, -1.0]]),
                         onp.asarray([0.01], "f4"), onp.asarray([1], "i4"),
                         onp.asarray([1e-6], "f4")).numpy()
    assert (w[0] > NEG).sum() == 1 and w[0].argmax() == 0


def test_sample_tokens_greedy_rows_seeded_and_row_independent():
    rng = onp.random.RandomState(3)
    lg = torch.from_numpy(rng.randn(4, 29).astype("f4"))
    t = onp.asarray([0.0, 1.0, 0.0, 0.7], "f4")
    k, p = onp.zeros(4, "i4"), onp.ones(4, "f4")
    a = tsmp.sample_tokens(_gens(range(4)), lg, t, k, p)
    assert a.dtype == torch.int64
    assert a[0] == lg[0].argmax() and a[2] == lg[2].argmax()
    b = tsmp.sample_tokens(_gens(range(4)), lg, t, k, p)
    assert torch.equal(a, b), "same seeds must sample the same tokens"
    # a row's draw depends on its own generator only
    t1 = onp.ones(4, "f4")
    base = tsmp.sample_tokens(_gens([5, 6, 7, 8]), lg, t1, k, p)
    other = tsmp.sample_tokens(_gens([5, 60, 70, 80]), lg, t1, k, p)
    assert other[0] == base[0]
    # and not on which row it rides in
    moved = tsmp.sample_tokens(_gens([60, 70, 5, 80]), lg[[1, 2, 0, 3]],
                               t1, k, p)
    assert moved[2] == base[0]
    # the generator advances: a second draw from the same generators
    # differs somewhere over a few calls
    gens = _gens([5, 6, 7, 8])
    draws = [tsmp.sample_tokens(gens, lg, t1, k, p) for _ in range(4)]
    assert any(not torch.equal(draws[0], d) for d in draws[1:])


def test_sample_respects_top_k_support():
    rng = onp.random.RandomState(5)
    lg = rng.randn(64, 31).astype("f4")
    tok = tsmp.sample_tokens(_gens(range(64)), torch.from_numpy(lg),
                             onp.full(64, 1.5, "f4"), onp.full(64, 4, "i4"),
                             onp.ones(64, "f4")).numpy()
    for row in range(64):
        assert int(tok[row]) in set(onp.argsort(-lg[row])[:4].tolist())


@pytest.mark.parametrize("t,k,p", [(1.0, 0, 1.0), (0.8, 2, 1.0),
                                   (1.3, 0, 0.8)],
                         ids=["plain", "top_k", "top_p"])
def test_sample_distribution_tv_bound(t, k, p):
    """4000 independent draws (one generator each) from one row of
    logits: the empirical distribution is within TV 0.05 of the warped
    softmax that the JAX function defines."""
    trials = 4000
    lg = onp.asarray([1.2, 0.1, -0.4, 2.0, -1.0], "f4")
    rows = torch.from_numpy(onp.broadcast_to(lg, (trials, 5)).copy())
    tok = tsmp.sample_tokens(
        _gens(range(10_000, 10_000 + trials)), rows,
        onp.full(trials, t, "f4"), onp.full(trials, k, "i4"),
        onp.full(trials, p, "f4")).numpy()
    emp = onp.bincount(tok, minlength=5) / trials
    w = onp.asarray(jsmp.warp_logits(jnp.asarray(lg[None]),
                                     onp.asarray([t], "f4"),
                                     onp.asarray([k], "i4"),
                                     onp.asarray([p], "f4")))[0]
    expect = _softmax(w.astype("f8"))
    tv = 0.5 * onp.abs(emp - expect).sum()
    assert tv < 0.05, (emp, expect, tv)
    assert emp[expect < 1e-12].sum() == 0    # masked tokens never drawn
