"""The port's other optimizers, ``Updater`` and the fused update against
the JAX package's.

Each optimizer of the reference that ``tests/test_torch_optimizer.py``
does not hold (Adamax through DCASGD) takes 3 steps of a (32, 64) weight
and a (64,) bias, with ``rescale_grad``, ``clip_gradient``, weight
decay, an ``lr_mult`` and a ``wd_mult``, through its functional
``_step``: the reference's ``_step`` runs under ``jax.disable_jit()``
(no class compiles a program), on the hypers its own ``_hyper`` gives
after ``_update_count``, and the port's on its own. Hypers must be
equal; weights and states agree within 2e-6 in fp32 (the same
arithmetic in the same order; a ``power`` or a norm may differ in the
last bits). ``_step_mp`` runs float16 weights on fp32 masters: the
masters within 2e-6, the weights within one float16 step. SGLD's
deterministic part is exact and its noise has std sqrt(lr) and repeats
at a seed. ``Updater`` states cross the packages through their pickles;
the fused update gives the per-parameter loop's bits and returns False
for SGLD.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = ((32, 64), (64,))
STEPS = 3

OPTS = {
    "adamax": {"learning_rate": 0.01},
    "nadam": {"learning_rate": 0.01},
    "adabelief": {"learning_rate": 0.01},
    "rmsprop": {"learning_rate": 0.01},
    "rmsprop_centered": {"learning_rate": 0.01, "centered": True},
    "adagrad": {"learning_rate": 0.05},
    "groupadagrad": {"learning_rate": 0.05},
    "adadelta": {"learning_rate": 1.0},
    "ftrl": {"learning_rate": 0.1},
    "ftml": {"learning_rate": 0.01},
    "lamb": {"learning_rate": 0.01},
    "lamb_bounded": {"learning_rate": 0.01, "lower_bound": 0.5,
                     "upper_bound": 2.0, "bias_correction": False},
    "lars": {"learning_rate": 0.1},
    "lans": {"learning_rate": 0.01},
    "signum": {"learning_rate": 0.01, "wd_lh": 0.01},
    "signum_nomom": {"learning_rate": 0.01, "momentum": 0.0},
    "dcasgd": {"learning_rate": 0.01, "momentum": 0.9},
}


def _name(key):
    return key.split("_")[0]


def _make(mod, key, **extra):
    kw = dict(OPTS[key], rescale_grad=0.5, clip_gradient=1.5, **extra)
    if _name(key) != "groupadagrad":
        kw["wd"] = 0.01
    opt = mod.create(_name(key), **kw)
    opt.set_lr_mult({0: 0.5})
    opt.set_wd_mult({1: 0.0})
    return opt


def _shapes(key):
    return SHAPES[:1] if _name(key) == "groupadagrad" else SHAPES


def _arrays(key, seed=0):
    rng = onp.random.RandomState(seed + len(key))
    shapes = _shapes(key)
    ws = [rng.standard_normal(s).astype("f4") for s in shapes]
    gs = [[(2 * rng.standard_normal(s)).astype("f4") for s in shapes]
          for _ in range(STEPS)]
    return ws, gs


def _leaves(state):
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return onp.asarray(x, "f4")


def _same_hyper(hp, hr):
    assert set(hp) == set(hr)
    for k in hr:
        if hr[k] is None:
            assert hp[k] is None, k
        else:
            assert onp.asarray(hp[k]) == onp.asarray(hr[k]), k


@pytest.mark.parametrize("mp", [False, True], ids=["fp32", "mp_f16"])
@pytest.mark.parametrize("key", list(OPTS))
def test_step_matches_reference(key, mp):
    ref = _make(jopt, key, multi_precision=mp)
    port = _make(topt, key, multi_precision=mp)
    ws, gs = _arrays(key)
    dt = "float16" if mp else "float32"
    jw = [jnp.asarray(w, dt) for w in ws]
    tw = [torch.from_numpy(w).to(getattr(torch, dt)) for w in ws]
    js = [ref.create_state_multi_precision(i, jmx.nd.NDArray(w))
          for i, w in enumerate(jw)]
    ts = [port.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    rcls, pcls = type(ref), type(port)
    with jax.disable_jit():
        for step in gs:
            for i, g in enumerate(step):
                ref._update_count(i)
                port._update_count(i)
                hr, hp = ref._hyper(i), port._hyper(i)
                _same_hyper(hp, hr)
                jg = jnp.asarray(g, dt)
                tg = torch.from_numpy(g).to(getattr(torch, dt))
                if mp:
                    jw[i], js[i] = rcls._step_mp(jw[i], jg, js[i], hr)
                    tw[i], ts[i] = pcls._step_mp(tw[i], tg, ts[i], hp)
                else:
                    jw[i], js[i] = rcls._step(jw[i], jg, js[i], hr)
                    tw[i], ts[i] = pcls._step(tw[i], tg, ts[i], hp)
    for a, b in zip(tw, jw):
        assert str(a.dtype).endswith(str(b.dtype))
        tol = 2.0 ** -10 if mp else 2e-6
        onp.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)
    for sa, sb in zip(ts, js):
        la, lb = _leaves(sa), _leaves(sb)
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            assert a.dtype == torch.float32 or not mp
            onp.testing.assert_allclose(_np(a), _np(b), rtol=2e-6,
                                        atol=1e-6)


def test_every_reference_name_is_registered():
    assert set(topt._REGISTRY) == set(jopt._REGISTRY)
    assert set(topt.__all__) == set(jopt.__all__)
    for name in jopt._REGISTRY:
        kw = {} if name != "groupadagrad" else {"wd": 0.0}
        assert isinstance(topt.create(name, **kw), topt._REGISTRY[name])
    with pytest.raises(ValueError, match="Weight decay"):
        topt.create("groupadagrad", wd=0.1)


def test_sgld_deterministic_part_and_noise():
    shape, lr = (256, 256), 0.04
    rng = onp.random.RandomState(3)
    w0 = rng.standard_normal(shape).astype("f4")
    g = rng.standard_normal(shape).astype("f4")

    def run(seed):
        tmx.random_state.seed(seed)
        opt = topt.create("sgld", learning_rate=lr, wd=0.01)
        w = torch.from_numpy(w0.copy())
        opt.update(0, w, torch.from_numpy(g), ())
        return w

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    hyper = topt.create("sgld", learning_rate=lr, wd=0.01)
    hyper._update_count(0)
    h = hyper._hyper(0)
    w = torch.from_numpy(w0)
    det = w - float(h["lr"] / onp.float32(2)) * topt.Optimizer._pre(
        torch.from_numpy(g), w, h)
    noise = (a - det).double()
    assert abs(noise.mean().item()) < 0.01 * lr ** 0.5 * 10
    assert abs(noise.std().item() / lr ** 0.5 - 1) < 0.02
    # the reference's deterministic part is the same expression
    with jax.disable_jit():
        jdet = jnp.asarray(w0) - h["lr"] / 2 * jopt.Optimizer._pre(
            jnp.asarray(g), jnp.asarray(w0), h)
    onp.testing.assert_allclose(det.numpy(), onp.asarray(jdet), rtol=2e-6,
                                atol=1e-6)


def _params(n=3, seed=0, dtypes=("float32", "float16", "float32")):
    rng = onp.random.RandomState(seed)
    ws = [torch.from_numpy(rng.standard_normal((8, 4 + i)).astype("f4"))
          .to(getattr(torch, dtypes[i % len(dtypes)])) for i in range(n)]
    gs = [[torch.from_numpy(rng.standard_normal(tuple(w.shape))
                            .astype("f4")).to(w.dtype) for w in ws]
          for _ in range(STEPS)]
    return ws, gs


@pytest.mark.parametrize("name", ["lamb", "nadam", "sgd", "sgld"])
def test_fused_update_equals_loop(name):
    ws, gs = _params()

    def run(fused):
        tmx.random_state.seed(1)
        opt = topt.create(name, learning_rate=0.01, multi_precision=True,
                          wd=0.01)
        opt.set_lr_mult({1: 0.5})
        w = [x.clone() for x in ws]
        st = [opt.create_state_multi_precision(i, x) for i, x in enumerate(w)]
        ran = []
        for step in gs:
            if fused:
                ran.append(opt.fused_update_multi_precision(
                    [0, 1, 2], w, step, st))
            else:
                for i in range(3):
                    opt.update_multi_precision([i], [w[i]], [step[i]],
                                               [st[i]])
        return w, st, ran, opt

    wf, sf, ran, of = run(True)
    wl, sl, _, ol = run(False)
    assert ran == [name != "sgld"] * STEPS
    assert of._index_update_count == ol._index_update_count
    for a, b in zip(wf, wl):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(sf), _leaves(sl)):
        assert torch.equal(a, b)


def _updater_run(mod, arr, name, ws, gs, states=None):
    upd = mod.optimizer.get_updater(mod.optimizer.create(
        name, learning_rate=0.01))
    if states is not None:
        upd.set_states(states)
    w = [arr(x) for x in ws]
    for step in gs:
        for i, g in enumerate(step):
            upd(i, arr(g), w[i])
    return upd, w


@pytest.mark.parametrize("name", ["nadam", "rmsprop"])
def test_updater_states_cross_packages(name):
    rng = onp.random.RandomState(4)
    ws = [rng.standard_normal((6, 5)).astype("f4") for _ in range(2)]
    gs = [[rng.standard_normal((6, 5)).astype("f4") for _ in range(2)]
          for _ in range(2)]
    with jmx.cpu():
        jupd, jw = _updater_run(jmx, jmx.np.array, name, ws, gs[:1])
    tupd, tw = _updater_run(tmx, torch.from_numpy, name, ws, gs[:1])
    jblob, tblob = jupd.get_states(), tupd.get_states()
    js, ts = pickle.loads(jblob), pickle.loads(tblob)
    assert set(js) == set(ts)
    for k in js:
        for a, b in zip(_leaves(ts[k]), _leaves(js[k])):
            assert isinstance(a, onp.ndarray) and a.dtype == b.dtype
            onp.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)
    # each package resumes from the other's file and takes the next step
    with jmx.cpu():
        _, jw2 = _updater_run(jmx, jmx.np.array, name,
                              [w.asnumpy() for w in jw], gs[1:], tblob)
    _, tw2 = _updater_run(tmx, torch.from_numpy, name,
                          [w.numpy() for w in tw], gs[1:], jblob)
    for a, b in zip(tw2, jw2):
        onp.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=2e-6,
                                    atol=1e-7)
    # dump_optimizer carries the optimizer; an old Nadam (m, v) state
    # takes m_schedule = 1
    upd = topt.get_updater(topt.create(name))
    upd.set_states(tupd.get_states(dump_optimizer=True))
    assert type(upd.optimizer) is type(tupd.optimizer)
    if name == "nadam":
        upd.set_states(pickle.dumps({0: (ws[0], ws[1])}))
        assert len(upd.states[0]) == 3 and float(upd.states[0][2]) == 1.0


def test_setstate_fills_new_attributes():
    opt = topt.create("lamb")
    d = dict(opt.__dict__)
    del d["bias_correction"]
    fresh = topt.LAMB.__new__(topt.LAMB)
    fresh.__setstate__(d)
    assert fresh.bias_correction is True


def test_top_level_names():
    """``mx.amp``, ``mx.gluon.data`` and the optimizer's ``Updater`` and
    ``get_updater`` under the reference's names."""
    for path in ("amp", "gluon.data", "gluon.data.vision",
                 "gluon.data.vision.transforms", "optimizer.Updater",
                 "optimizer.get_updater", "image.imresize",
                 "grad_fusion.build_buckets"):
        ref, got = jmx, tmx
        for part in path.split("."):
            ref, got = getattr(ref, part), getattr(got, part)
        assert type(got) is type(ref) or callable(got), path
