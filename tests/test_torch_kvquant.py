"""The port's int8 KV cache against the JAX package's, on the same numpy
inputs and the same gpt_small weights (vocab 1000, 64 units, 2 layers,
4 heads).

Guarantees under test:
- ``kv_scale`` / ``kv_quantize`` are BITWISE the reference's (true
  division, round half to even, clip to ±127, the 1e-12 floor in
  ``kv_quantize`` only), an all-zero row and exact .5 ties included;
- int8 decode attention, dense and paged (the plain versions the int8
  instances of K2 and K3 are held to on the card), matches the JAX jnp
  path and the Pallas kernel in interpret mode within 1e-5 (the bound of
  tests/test_quantized.py), ignores garbage past every length and NaN
  scales on pages no slot reaches, and returns zeros for an empty slot;
- the int8-KV generation calls (dense prefill/decode; paged fresh
  prefill, chunk, decode, peek) track the JAX calls: scales within 1e-6
  relative, int8 entries differing by at most 1 in at most 0.1 % of the
  entries (torch and XLA compute K/V with other rounding, and an entry
  next to a rounding tie may flip), and logits within the model tests'
  rtol=2e-3 with atol=1e-3 (a flipped entry moves its dequantized value
  by one scale step, amax / 127);
- a fresh page inherits the previous page's scale, COW copies scales,
  inactive rows touch only page 0's data and scale;
- the int8-KV engines, dense and paged, with and without int8 weights,
  give the JAX int8-KV engines' greedy tokens on a fixed corpus.
"""
import numpy as onp
import pytest
import torch
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.ops import attention as jat
from mxnet_tpu.ops import quantized as jqz
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import attention as tat
from mxnet_tpu_torch.ops import quantized as tqz
from mxnet_tpu_torch.serving import GenerationEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATT_TOL = 1e-5
LOGIT_TOL = dict(rtol=2e-3, atol=1e-3)
VOCAB, HEADS, DH = 1000, 4, 16
SLOTS, SMAX, PS, CHUNK = 4, 64, 8, 16
N_PAGES = SLOTS * SMAX // PS + 1
P_MAX = SMAX // PS


def _t(a):
    return torch.from_numpy(onp.array(a))


# -- the int8 convention ------------------------------------------------
def _kv_cases():
    rng = onp.random.RandomState(0)
    x = rng.randn(3, 4, 8, 16).astype("f4")
    x[1, 2] = 0.0                        # an all-zero (row, head): scale 0
    # exact ties: amax 127/16 makes the scale exactly 1/16, so (k + .5)/16
    # divides to k + .5
    x[2, 1] = (onp.arange(8 * 16).reshape(8, 16) % 9 - 4 + 0.5) / 16.0
    x[2, 1, 0, 0] = 127.0 / 16.0
    return x


def test_kv_scale_and_quantize_bitwise_equal_to_jax():
    x = _kv_cases()
    s = tqz.kv_scale(_t(x), (2, 3))
    js = jqz.kv_scale(jnp.asarray(x), (2, 3))
    assert s.dtype == torch.float32
    onp.testing.assert_array_equal(s.numpy(), onp.asarray(js))
    assert s[1, 2].item() == 0.0 and s[2, 1].item() == 1.0 / 16.0
    q = tqz.kv_quantize(_t(x), s[:, :, None, None])
    jq = jqz.kv_quantize(jnp.asarray(x), js[:, :, None, None])
    assert q.dtype == torch.int8
    onp.testing.assert_array_equal(q.numpy(), onp.asarray(jq))
    assert q[1, 2].abs().max().item() == 0        # the floor, not NaN
    tie = q[2, 1].numpy().astype(int)
    assert set(tie[0, 1:4].tolist()) <= {-4, -2, 0, 2, 4}   # half to even


# -- int8 decode attention (the plain versions of K2-int8 / K3-int8) -----
def _quant(rng, x, live):
    """Per-(slot, head) amax scales over the live rows; random int8
    garbage past each length."""
    xz = onp.where(live, x, 0.0).astype("f4")
    s = onp.asarray(jqz.kv_scale(jnp.asarray(xz), (2, 3)))
    q = onp.asarray(jqz.kv_quantize(jnp.asarray(xz), s[:, :, None, None]))
    junk = rng.randint(-127, 128, q.shape).astype("i1")
    return onp.where(live, q, junk).astype("i1"), s


def _dense_int8(sq, seed=1):
    rng = onp.random.RandomState(seed)
    b, h, s, d = 5, 2, 48, 16
    lengths = onp.asarray([0, 1, 17, 32, 48], "i4")
    live = (onp.arange(s)[None, :] < lengths[:, None])[:, None, :, None]
    kq, ks = _quant(rng, rng.randn(b, h, s, d).astype("f4"), live)
    vq, vs = _quant(rng, rng.randn(b, h, s, d).astype("f4"), live)
    q = rng.randn(b, h, sq, d).astype("f4")
    return q, kq, vq, ks, vs, lengths


@pytest.mark.parametrize("sq", [1, 3])
def test_int8_decode_attention_matches_jax(sq):
    q, kq, vq, ks, vs, lengths = _dense_int8(sq)
    out = tat.decode_attention(_t(q), _t(kq), _t(vq), _t(lengths),
                               k_scale=_t(ks), v_scale=_t(vs)).numpy()
    ref = jat.decode_attention(jnp.asarray(q), jnp.asarray(kq),
                               jnp.asarray(vq), jnp.asarray(lengths),
                               k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs))
    assert onp.abs(out - onp.asarray(ref)).max() < ATT_TOL
    assert onp.abs(out[0]).max() == 0.0
    # an empty slot's scale may be anything: it is never used
    ks2, vs2 = ks.copy(), vs.copy()
    ks2[0] = vs2[0] = onp.nan
    out2 = tat.decode_attention(_t(q), _t(kq), _t(vq), _t(lengths),
                                k_scale=_t(ks2), v_scale=_t(vs2)).numpy()
    onp.testing.assert_array_equal(out2, out)


@pytest.mark.requires_pallas
@pytest.mark.parametrize("sq", [1, 3])
def test_int8_decode_attention_matches_pallas_kernel(sq):
    q, kq, vq, ks, vs, lengths = _dense_int8(sq, seed=2)
    out = tat.decode_attention(_t(q), _t(kq), _t(vq), _t(lengths),
                               k_scale=_t(ks), v_scale=_t(vs)).numpy()
    pal = jat.decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), block_k=16, interpret=True)
    assert onp.abs(out - onp.asarray(pal)).max() < ATT_TOL


PAGED_LENGTHS = [0, 1, PS - 1, PS, PS + 1, P_MAX * PS]


def _paged_int8(sq, seed=3):
    """An int8 pool with each slot's pages at shuffled places, random
    int8 in every row (garbage past each length), per-page scales on
    the pages the lengths reach and 0 elsewhere; plus the same scales
    with NaN on the scrap page and every unreferenced page."""
    rng = onp.random.RandomState(seed)
    b, h, d = len(PAGED_LENGTHS), 2, 16
    perm = rng.permutation(onp.arange(1, N_PAGES))
    table = onp.zeros((b, P_MAX), "i4")
    at = 0
    for i, n in enumerate(PAGED_LENGTHS):
        need = -(-n // PS)
        table[i, :need] = perm[at:at + need]
        at += need
    used = perm[:at]
    kp, vp = (rng.randint(-127, 128, (N_PAGES, h, PS, d)).astype("i1")
              for _ in range(2))
    ksc, vsc = (onp.zeros((N_PAGES, h), "f4") for _ in range(2))
    for sc in (ksc, vsc):
        sc[used] = rng.uniform(0.005, 0.03, (len(used), h))
    nan_k, nan_v = (onp.full((N_PAGES, h), onp.nan, "f4") for _ in range(2))
    nan_k[used], nan_v[used] = ksc[used], vsc[used]
    q = rng.randn(b, h, sq, d).astype("f4")
    return (q, kp, vp, table, onp.asarray(PAGED_LENGTHS, "i4"), ksc, vsc,
            nan_k, nan_v)


def test_expand_page_scales_matches_jax():
    *_, table, _ln, ksc, _vsc, _nk, _nv = _paged_int8(1)
    onp.testing.assert_array_equal(
        tat.expand_page_scales(_t(ksc), _t(table), PS).numpy(),
        onp.asarray(jat.expand_page_scales(jnp.asarray(ksc),
                                           jnp.asarray(table), PS)))


@pytest.mark.parametrize("sq", [1, 3])
def test_int8_paged_decode_attention_matches_jax(sq):
    """The port equals the JAX jnp path on the finite-scale pool, and
    gives the same output, bit for bit, when the scrap page and every
    unreferenced page carry NaN scales (it never reads them)."""
    q, kp, vp, table, lengths, ksc, vsc, nk, nv = _paged_int8(sq)
    out = tat.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(lengths), k_scale=_t(ksc),
                                     v_scale=_t(vsc)).numpy()
    ref = jat.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), k_scale=jnp.asarray(ksc),
        v_scale=jnp.asarray(vsc))
    assert onp.abs(out - onp.asarray(ref)).max() < ATT_TOL
    assert onp.abs(out[0]).max() == 0.0
    out_nan = tat.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                         _t(lengths), k_scale=_t(nk),
                                         v_scale=_t(nv)).numpy()
    onp.testing.assert_array_equal(out_nan, out)
    # the dense int8 op over the gathered view is the same function
    dense = tat.decode_attention(
        _t(q), tat.gather_pages(_t(kp), _t(table)).float()
        * tat.expand_page_scales(_t(ksc), _t(table), PS)[..., None],
        tat.gather_pages(_t(vp), _t(table)).float()
        * tat.expand_page_scales(_t(vsc), _t(table), PS)[..., None],
        _t(lengths)).numpy()
    onp.testing.assert_array_equal(out, dense)


@pytest.mark.requires_pallas
@pytest.mark.parametrize("sq", [1, 3])
def test_int8_paged_decode_attention_matches_pallas_kernel(sq):
    q, kp, vp, table, lengths, ksc, vsc, _nk, _nv = _paged_int8(sq, seed=4)
    out = tat.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(lengths), k_scale=_t(ksc),
                                     v_scale=_t(vsc)).numpy()
    pal = jat.paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), k_scale=jnp.asarray(ksc),
        v_scale=jnp.asarray(vsc), interpret=True)
    assert onp.abs(out - onp.asarray(pal)).max() < ATT_TOL


def test_int8_kernel_wrapper_checks():
    """The int8 instances' wrappers refuse what their kernels do not
    take, before any build or launch (the checks run on any tensor)."""
    q, kq, vq, ks, vs, lengths = (_t(a) for a in _dense_int8(1))
    with pytest.raises(ValueError, match="come together"):
        tat._decode_cuda(q, kq, vq, lengths, 0.1, ks, None)
    with pytest.raises(TypeError, match="int8"):
        tat._decode_cuda(q, kq.float(), vq.float(), lengths, 0.1, ks, vs)
    with pytest.raises(ValueError, match="scales"):
        tat._decode_cuda(q, kq, vq, lengths, 0.1, ks[:2], vs)
    wide = torch.zeros(5, 2, 48, 24, dtype=torch.int8)[..., :16]
    with pytest.raises(ValueError, match="16-byte"):
        tat._decode_cuda(q, wide, wide, lengths, 0.1, ks, vs)
    pq, kp, vp, table, pl, ksc, vsc, _nk, _nv = (
        _t(a) for a in _paged_int8(1))
    with pytest.raises(ValueError, match="scales"):
        tat._paged_decode_cuda(pq, kp, vp, table, pl, 0.1, ksc.T, vsc)
    with pytest.raises(TypeError, match="float32"):
        tat._paged_decode_cuda(pq, kp, vp, table, pl, 0.1)


# -- the int8-KV generation calls ----------------------------------------
@pytest.fixture(scope="module")
def pair():
    onp.random.seed(1234)
    mx.np.random.seed(1234)
    jnet = jgpt.gpt_small()
    jnet.initialize(mx.init.Xavier())
    jnet._gen_params()
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = tgpt.gpt_small(device="cpu")
    tgpt.load_jax_params(tnet, params)
    return jnet, tnet


def _check_cache(tc, jc):
    """Scales within 1e-6 relative; int8 entries within 1 of the JAX
    model's, at most 0.1 % of them off."""
    for key in ("k_scale", "v_scale"):
        for a, b in zip(tc[key], jc[key]):
            onp.testing.assert_allclose(a.numpy(), onp.asarray(b),
                                        rtol=1e-6, atol=0)
    off = total = 0
    for key in ("k", "v"):
        for a, b in zip(tc[key], jc[key]):
            diff = onp.abs(a.numpy().astype(int)
                           - onp.asarray(b).astype(int))
            assert diff.max() <= 1, key
            off += int((diff > 0).sum())
            total += diff.size
    assert off <= 1e-3 * total, (off, total)


def test_int8_dense_generation_calls_match_jax(pair):
    jnet, tnet = pair
    rng = onp.random.RandomState(5)
    padded = onp.zeros((2, 16), "i4")
    padded[0, :11] = rng.randint(0, VOCAB, 11)
    padded[1, :5] = rng.randint(0, VOCAB, 5)
    jc = jnet.init_cache(SLOTS, SMAX, dtype="int8")
    tc = tnet.init_cache(SLOTS, SMAX, dtype="int8")
    assert tc["k"][0].dtype == torch.int8
    assert tuple(tc["k_scale"][0].shape) == (SLOTS, HEADS)
    jl, jc = jnet.prefill(padded, [11, 5], jc, slots=[1, 3])
    tl, tc = tnet.prefill(padded, [11, 5], tc, slots=[1, 3])
    onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), **LOGIT_TOL)
    _check_cache(tc, jc)
    for _ in range(4):
        toks = rng.randint(0, VOCAB, SLOTS).astype("i4")
        jl, jc = jnet.decode_step(toks, jc)
        tl, tc = tnet.decode_step(toks, tc)
        onp.testing.assert_allclose(tl.numpy()[[1, 3]],
                                    onp.asarray(jl)[[1, 3]], **LOGIT_TOL)
    _check_cache(tc, jc)
    assert tc["len"].tolist() == [4, 15, 4, 9]


def _row(*pages):
    row = onp.zeros(P_MAX, "i4")
    row[:len(pages)] = pages
    return row


def test_int8_paged_generation_calls_match_jax(pair):
    """A fresh prefill, a two-chunk prompt sharing the first slot's
    first page, a peek, a COW copy and decode steps across a page
    boundary, through both packages' int8 pools."""
    jnet, tnet = pair
    rng = onp.random.RandomState(6)
    jc = jnet.init_paged_cache(SLOTS, N_PAGES, PS, SMAX, dtype="int8")
    tc = tnet.init_paged_cache(SLOTS, N_PAGES, PS, SMAX, dtype="int8")
    assert tuple(tc["v_scale"][1].shape) == (N_PAGES, HEADS)
    short = onp.zeros((1, 16), "i4")
    short[0, :13] = rng.randint(0, VOCAB, 13)
    jl, jc = jnet.prefill_paged(short, 13, 0, _row(5, 6, 7), jc, fresh=True)
    tl, tc = tnet.prefill_paged(short, 13, 0, _row(5, 6, 7), tc, fresh=True)
    onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), **LOGIT_TOL)
    prompt = onp.concatenate([short[0, :8], rng.randint(0, VOCAB, 14)])
    row = _row(5, 10, 11, 12)
    for start in (8, 16):
        nv = min(CHUNK, prompt.size - start)
        chunk = onp.zeros((1, CHUNK), "i4")
        chunk[0, :nv] = prompt[start:start + nv]
        jl, jc = jnet.prefill_paged(chunk, nv, 2, row, jc, start=start)
        tl, tc = tnet.prefill_paged(chunk, nv, 2, row, tc, start=start)
        onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl),
                                    **LOGIT_TOL)
    jp = jnet.peek_logits_paged(int(short[0, 12]), 0, jc)
    tp = tnet.peek_logits_paged(int(short[0, 12]), 0, tc)
    onp.testing.assert_allclose(tp.numpy(), onp.asarray(jp), **LOGIT_TOL)
    jc = jnet.copy_page_paged(6, 20, jc)
    tc = tnet.copy_page_paged(6, 20, tc)
    jc = jnet.bind_slot_paged(0, _row(5, 20, 7), 13, jc)
    tc = tnet.bind_slot_paged(0, _row(5, 20, 7), 13, tc)
    _check_cache(tc, jc)
    active = onp.asarray([1, 0, 1, 0], "i4")
    for _ in range(5):       # slot 0 crosses into page 7 at position 16
        toks = rng.randint(0, VOCAB, SLOTS).astype("i4")
        jl, jc = jnet.decode_step_paged(toks, active, jc)
        tl, tc = tnet.decode_step_paged(toks, active, tc)
        onp.testing.assert_allclose(tl.numpy()[[0, 2]],
                                    onp.asarray(jl)[[0, 2]], **LOGIT_TOL)
    _check_cache(tc, jc)
    assert tc["len"].tolist() == onp.asarray(jc["len"]).tolist() \
        == [18, 0, 27, 0]


def test_fresh_page_inherits_the_previous_pages_scale(pair):
    """The first token a decode step writes into a page quantizes with
    (and stamps) the previous page's scale, whatever stale scale the
    recycled page held; later tokens of the page reuse it."""
    _, tnet = pair
    cache = tnet.init_paged_cache(SLOTS, N_PAGES, PS, SMAX, dtype="int8")
    toks = onp.zeros((1, 8), "i4")
    toks[0] = onp.random.RandomState(7).randint(0, VOCAB, 8)
    _, cache = tnet.prefill_paged(toks, 8, 1, _row(3, 9), cache, fresh=True)
    for sc in (*cache["k_scale"], *cache["v_scale"]):
        sc[9] = 123.0                     # a recycled page's stale scale
    active = onp.asarray([0, 1, 0, 0], "i4")
    for step in range(2):
        _, cache = tnet.decode_step_paged(onp.full(SLOTS, 4 + step, "i4"),
                                          active, cache)
        for sc in (*cache["k_scale"], *cache["v_scale"]):
            assert torch.equal(sc[9], sc[3])
    assert cache["len"].tolist() == [0, 10, 0, 0]


def test_cow_copies_scales_and_inactive_rows_touch_only_page_0(pair):
    _, tnet = pair
    cache = tnet.init_paged_cache(SLOTS, N_PAGES, PS, SMAX, dtype="int8")
    toks = onp.zeros((1, 16), "i4")
    toks[0, :10] = onp.random.RandomState(8).randint(0, VOCAB, 10)
    _, cache = tnet.prefill_paged(toks, 10, 0, _row(3, 4), cache, fresh=True)
    cache = tnet.copy_page_paged(4, 11, cache)
    for key in ("k", "v", "k_scale", "v_scale"):
        for t in cache[key]:
            assert torch.equal(t[11], t[4])
    cache = tnet.bind_slot_paged(2, _row(3, 4), 5, cache)   # stale alias
    before = {key: [t.clone() for t in cache[key]]
              for key in ("k", "v", "k_scale", "v_scale")}
    _, cache = tnet.decode_step_paged(onp.asarray([5, 6, 7, 8], "i4"),
                                      onp.asarray([1, 0, 0, 0], "i4"), cache)
    assert cache["len"].tolist() == [11, 0, 5, 0]
    for key in ("k", "v"):
        for b, a in zip(before[key], cache[key]):
            changed = sorted({(int(p), int(r)) for p, _h, r, _d in
                              (b != a).nonzero().tolist()})
            # slot 0's own row 10 (page 4, row 2), and the scrap page
            assert {pr for pr in changed if pr[0] != 0} == {(4, 2)}
    for key in ("k_scale", "v_scale"):
        for b, a in zip(before[key], cache[key]):
            # page 4 keeps its scale; the scrap page keeps its own
            assert torch.equal(b, a)


# -- engines -------------------------------------------------------------
def _corpus(seed=9):
    rng = onp.random.RandomState(seed)
    sys_prompt = rng.randint(0, VOCAB, 24).astype("i4")
    prompts = [rng.randint(0, VOCAB, n).astype("i4") for n in (3, 17, 30, 9)]
    prompts += [onp.concatenate([sys_prompt, rng.randint(0, VOCAB, n)
                                 .astype("i4")]) for n in (4, 11)]
    prompts.append(prompts[-1].copy())         # an exact repeat: a peek
    budgets = [4 + i % 5 for i in range(len(prompts))]
    return prompts, budgets


def _serve(eng, prompts, budgets):
    out = [s.result(timeout=300).tokens for s in
           [eng.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]]
    eng.close()
    return out


ENGINES = [
    ("dense", {}),
    ("dense_int8_weights", dict(quantize="int8_weights")),
    ("paged", dict(paged=True, page_size=PS, prefill_chunk=CHUNK,
                   n_pages=N_PAGES)),
    ("paged_int8_weights", dict(paged=True, page_size=PS,
                                prefill_chunk=CHUNK, n_pages=N_PAGES,
                                quantize="int8_weights")),
]


@pytest.mark.parametrize("kw", [e[1] for e in ENGINES],
                         ids=[e[0] for e in ENGINES])
def test_int8_kv_engine_token_identical_to_jax(kw):
    """Each configuration on a model pair of its own (an int8-weight
    engine arms its model's tables): every request's greedy tokens
    equal the JAX int8-KV engine's; precision reads as the
    reference's."""
    jnet, tnet = _models_for_engine()
    prompts, budgets = _corpus()
    common = dict(max_slots=SLOTS, max_length=SMAX, max_new_tokens=8,
                  queue_limit=64, kv_dtype="int8", **kw)
    jeng = JaxEngine(jnet, **common)
    ref = _serve(jeng, prompts, budgets)
    telemetry.reset()
    eng = GenerationEngine(tnet, device="cpu", **common)
    assert eng.precision == jeng.precision == (
        "int8_weights+int8_kv" if "quantize" in kw else "int8_kv")
    got = _serve(eng, prompts, budgets)
    for i, (g, j) in enumerate(zip(got, ref)):
        assert g == j, f"request {i} diverged"
    per_slot = telemetry.gauge_value(
        "serving.generate.quant.kv_bytes_per_slot")
    assert per_slot == sum(
        t.numel() * t.element_size() for key in ("k", "v", "k_scale",
                                                  "v_scale")
        for t in eng._cache[key]) // SLOTS
    if kw.get("paged"):
        assert eng._pool.free_count == eng._pool.n_pages - 1


def _models_for_engine():
    onp.random.seed(77)
    mx.np.random.seed(77)
    jnet = jgpt.gpt_small()
    jnet.initialize(mx.init.Xavier())
    jnet._gen_params()
    tnet = tgpt.gpt_small(device="cpu")
    tgpt.load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                                jnet.collect_params().items()})
    return jnet, tnet
