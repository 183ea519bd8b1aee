"""``mxnet_tpu_torch.parallel.TrainStep`` on the GPT model, on the CPU,
against the JAX package's ``TrainStep``.

``gpt_small`` (2 layers, 64 units, vocabulary 97) with the JAX model's
parameters carried across by ``load_jax_params``, one seeded batch of
8 x 32 tokens (labels the tokens shifted by one):

- 3 fp32 Adam steps: losses within 1e-4 relative of the JAX step's,
  and step-one gradients (``gradients``) within 1e-5 x max|g| per
  tensor of the JAX model's under ``autograd.record`` (a k_proj bias,
  whose exact gradient is 0, against the model's largest gradient);
- 3 SGD-momentum steps: the parameters within 1e-5 (SGD's update is
  linear in the gradient, so the parameters are well conditioned; an
  Adam step divides by sqrt(v) and is not compared this way);
- the port of ``test_trainstep_bf16_fp32_masters_and_bounded_loss``
  (``tests/test_multitick.py``), same name;
- a padded batch (explicit ``pad=``, pad marks, a bucketing policy)
  equals the unpadded one; ``run_chain`` equals sequential steps; the
  optimizer state survives a change of batch signature (held to the JAX
  step over the same two signatures);
- ``mesh=``/``param_rules=``/``layout=`` raise ``NotPortedError``;
- ``grad_req`` ``"null"`` and ``"add"``, ``warmup`` (updates nothing),
  the telemetry counters, and no graph from the serving calls;
- ``Dropout``: the identity at rate 0 and in predict mode; in training
  the kept share within 3 sigma of 1 - p at p = 0.1 and 0.5, kept
  values scaled by 1 / (1 - p), ``axes`` sharing one draw, and the same
  generator seed repeating the mask.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import gpt as jgpt

from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import bucketing as tbucketing
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch import random_state, telemetry
from mxnet_tpu_torch.base import NotPortedError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, UNITS, LAYERS, HEADS = 97, 64, 2, 4
ADAM = ("adam", {"learning_rate": 0.01})
SGD_MOM = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})

def _jax_net(seed=1234):
    onp.random.seed(seed)
    jmx.np.random.seed(seed)
    net = jgpt.gpt_small(vocab_size=VOCAB, units=UNITS, num_layers=LAYERS,
                         num_heads=HEADS, max_length=128)
    net.initialize(jmx.init.Xavier())
    net._gen_params()
    return net


@pytest.fixture(scope="module")
def jax_net():
    """The seeded JAX model every port model of the module copies; the
    step-one gradient test differentiates it (no update)."""
    return _jax_net()


@pytest.fixture(scope="module")
def jax_params(jax_net):
    return {k: p.data().asnumpy()
            for k, p in jax_net.collect_params().items()}


def _port_net(params, dropout=0.0):
    net = tgpt.gpt_small(vocab_size=VOCAB, units=UNITS, num_layers=LAYERS,
                         num_heads=HEADS, max_length=128, dropout=dropout,
                         device="cpu")
    return tgpt.load_jax_params(net, params)


def _batch(rows=8, seed=1):
    x = onp.random.RandomState(seed).randint(0, VOCAB, (rows, 33))
    return x[:, :-1].astype("i4"), x[:, 1:].astype("i4")


class _JaxLmLoss:
    def __call__(self, out, label):
        return jgluon.loss.SoftmaxCrossEntropyLoss()(
            out.reshape(-1, out.shape[-1]), label.reshape(-1))


class _LmLoss:
    """The LM loss as ``tests/test_multitick.py`` writes it: one value
    per token of the flattened batch. The step's masked mean takes the
    first ``batch`` of those rows (the reference's rule, kept: see
    ``test_flattened_loss_masks_like_reference``)."""

    def __call__(self, out, label):
        return tloss.SoftmaxCrossEntropyLoss()(
            out.reshape(-1, out.shape[-1]), label.reshape(-1))


#: the per-sequence LM loss (one value per batch row, the mean over its
#: tokens): the step's mean over the rows is the mean over every token
_row_loss = tloss.SoftmaxCrossEntropyLoss()
_jax_row_loss = jgluon.loss.SoftmaxCrossEntropyLoss()


def _jax_run(opt, batches, loss=_jax_row_loss):
    net = _jax_net()
    step = jparallel.TrainStep(net, loss, opt[0], dict(opt[1]))
    losses = [float(step(jmx.np.array(d), jmx.np.array(l)))
              for d, l in batches]
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


def _port_run(params, opt, batches, loss=_row_loss, **kw):
    net = _port_net(params)
    step = tparallel.TrainStep(net, loss, opt[0], dict(opt[1]), **kw)
    losses = [float(step(torch.from_numpy(d), torch.from_numpy(l)))
              for d, l in batches]
    return losses, net, step


@pytest.fixture(scope="module")
def jax_adam():
    return _jax_run(ADAM, [_batch()] * 3)


def test_adam_losses_match_reference(jax_params, jax_adam):
    ref, _ = jax_adam
    got, net, _ = _port_run(jax_params, ADAM, [_batch()] * 3)
    assert got[-1] < got[0]
    for a, b in zip(got, ref):
        assert abs(a - b) <= 1e-4 * abs(b), (got, ref)
    assert {p._read().dtype for p in net.collect_params().values()} \
        == {torch.float32}


def test_flattened_loss_masks_like_reference(jax_params):
    """A loss of one value per token (``loss.shape[0]`` = batch x seq)
    is masked against the data's batch size, so the step's mean covers
    the first ``batch`` tokens only: the reference's rule, which the port
    keeps (the losses equal the JAX step's), not the mean over every
    token."""
    d, l = _batch()
    ref, _ = _jax_run(ADAM, [(d, l)], loss=_JaxLmLoss())
    got, net, _ = _port_run(jax_params, ADAM, [(d, l)], loss=_LmLoss())
    assert abs(got[0] - ref[0]) <= 1e-4 * abs(ref[0])
    full = float(_LmLoss()(_port_net(jax_params)(torch.from_numpy(d)),
                           torch.from_numpy(l)).mean())
    assert abs(got[0] - full) > 1e-3


def test_step_one_gradients_match_reference(jax_net, jax_params):
    d, l = _batch()
    jnet = jax_net
    for p in jnet.collect_params().values():
        p.zero_grad()
    with jautograd.record():
        loss = _jax_row_loss(jnet(jmx.np.array(d)), jmx.np.array(l)).mean()
    loss.backward()
    ref = {k: p.grad().asnumpy() for k, p in jnet.collect_params().items()}

    net = _port_net(jax_params)
    step = tparallel.TrainStep(net, _row_loss, *ADAM)
    got_loss, grads = step.gradients(torch.from_numpy(d), torch.from_numpy(l))
    assert abs(float(got_loss) - float(loss)) <= 1e-6 * float(loss)
    assert list(grads) == list(ref)
    top = max(float(onp.abs(r).max()) for r in ref.values())
    for name, g in grads.items():
        r = ref[name]
        # a k_proj bias adds q . b to every score of a row, which the
        # softmax cancels: its exact gradient is 0 and both sides hold
        # rounding noise, held to the model's largest gradient instead
        scale = top if name.endswith("k_proj.bias") \
            else float(onp.abs(r).max())
        assert float(onp.abs(g.numpy() - r).max()) <= 1e-5 * scale, name
        # grad_req "write": the parameter's buffer holds the gradient
        assert torch.equal(net.collect_params()[name].grad()._data, g)
    # gradients() applies nothing
    assert step.optimizer.num_update == 0


def test_sgd_momentum_params_match_reference(jax_params):
    ref_losses, ref = _jax_run(SGD_MOM, [_batch()] * 3)
    got_losses, net, _ = _port_run(jax_params, SGD_MOM, [_batch()] * 3)
    for a, b in zip(got_losses, ref_losses):
        assert abs(a - b) <= 1e-4 * abs(b)
    for name, p in net.collect_params().items():
        onp.testing.assert_allclose(p._read().numpy(), ref[name], atol=1e-5,
                                    rtol=0, err_msg=name)


def test_trainstep_bf16_fp32_masters_and_bounded_loss(jax_params):
    """TrainStep(compute_dtype="bfloat16") keeps fp32 master weights
    and optimizer state while the loss tracks the fp32 step; the
    default stays bitwise-deterministic."""
    data, label = (torch.from_numpy(a) for a in _batch(16, seed=1))

    def run(**kw):
        net = _port_net(jax_params)
        step = tparallel.TrainStep(net, _LmLoss(), "adam",
                                   {"learning_rate": 0.01}, **kw)
        losses = [float(step(data, label)) for _ in range(3)]
        dtypes = {str(p._read().dtype) for p in
                  net.collect_params().values()}
        states = {str(t.dtype) for s in step._opt_states for t in s}
        return losses, dtypes | states

    l_fp, d_fp = run()
    l_fp2, _ = run()
    assert [float.hex(a) for a in l_fp] == [float.hex(a) for a in l_fp2]
    l_bf, d_bf = run(compute_dtype="bfloat16")
    assert d_bf == d_fp == {"torch.float32"}
    assert all(abs(a - b) < 0.15 for a, b in zip(l_fp, l_bf))
    assert l_bf[-1] < l_bf[0]
    with pytest.raises(ValueError, match="compute_dtype"):
        run(compute_dtype="int8")


def _row_step(params, **kw):
    net = _port_net(params)
    return net, tparallel.TrainStep(net, _row_loss, "sgd",
                                    {"learning_rate": 0.5}, **kw)


def _padded(d, l, rows):
    pad = rows - d.shape[0]
    return (onp.concatenate([d, onp.repeat(d[-1:], pad, 0)]),
            onp.concatenate([l, onp.repeat(l[-1:], pad, 0)]))


@pytest.mark.parametrize("how", ["pad_arg", "pad_marks", "policy"])
def test_padded_batch_equals_unpadded(jax_params, how):
    d, l = _batch(6, seed=4)
    net_a, step_a = _row_step(jax_params)
    loss_a = float(step_a(torch.from_numpy(d), torch.from_numpy(l)))
    telemetry.reset()
    if how == "policy":
        net_b, step_b = _row_step(
            jax_params, bucketing=tbucketing.BucketingPolicy(buckets=[8]))
        loss_b = float(step_b(torch.from_numpy(d), torch.from_numpy(l)))
        assert telemetry.counter_value("parallel.train_step.bucket_pad") \
            == (1 if telemetry.enabled() else 0)
    else:
        dp, lp = (torch.from_numpy(a) for a in _padded(d, l, 8))
        net_b, step_b = _row_step(jax_params)
        if how == "pad_marks":
            tbucketing.mark_pad(dp, 2)
            tbucketing.mark_pad(lp, 2)
            loss_b = float(step_b(dp, lp))
        else:
            loss_b = float(step_b(dp, lp, pad=2))
    assert abs(loss_a - loss_b) <= 1e-6 * loss_a
    for (name, pa), pb in zip(net_a.collect_params().items(),
                              net_b.collect_params().values()):
        torch.testing.assert_close(pa._read(), pb._read(), atol=1e-6,
                                   rtol=1e-6, msg=name)


def test_scalar_loss_warns_on_padded_batch(jax_params):
    net = _port_net(jax_params)
    step = tparallel.TrainStep(net, lambda o, l: _LmLoss()(o, l).mean(),
                               *ADAM)
    d, l = (torch.from_numpy(a) for a in _batch(4))
    with pytest.warns(UserWarning, match="padded rows"):
        step(d, l, pad=1)


def test_run_chain_equals_sequential_steps(jax_params):
    batches = [_batch(8, seed=s) for s in (1, 2, 3)]
    net_b = _port_net(jax_params)
    step_b = tparallel.TrainStep(net_b, _row_loss, *ADAM)
    telemetry.reset()
    chain = step_b.run_chain(
        torch.from_numpy(onp.stack([b[0] for b in batches])),
        torch.from_numpy(onp.stack([b[1] for b in batches])))
    assert chain.shape == (3,)
    if telemetry.enabled():
        assert telemetry.counter_value(
            "parallel.train_step.chained_steps") == 3
    assert step_b.optimizer._index_update_count[0] == 3
    net_c = _port_net(jax_params)
    step_c = tparallel.TrainStep(net_c, _row_loss, *ADAM)
    seq = [float(step_c(torch.from_numpy(d), torch.from_numpy(l)))
           for d, l in batches]
    assert [float(x) for x in chain] == seq
    for pa, pb in zip(net_b.collect_params().values(),
                      net_c.collect_params().values()):
        assert torch.equal(pa._read(), pb._read())


def test_optimizer_state_survives_signature_change(jax_params):
    """A last odd batch (a new signature) does not reset Adam: the
    states are created once and shared, as in the reference."""
    batches = [_batch(8, seed=1), _batch(4, seed=2), _batch(8, seed=3)]
    ref, _ = _jax_run(ADAM, batches)
    got, _, step = _port_run(jax_params, ADAM, batches,
                             bucketing=False)
    assert len(step._entries) == 2
    for a, b in zip(got, ref):
        assert abs(a - b) <= 1e-4 * abs(b), (got, ref)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"layout": "dp"},
                                {"param_rules": [("w", None)]}])
def test_mesh_and_layout_raise_not_ported(jax_params, kw):
    with pytest.raises(NotPortedError, match="item 20"):
        tparallel.TrainStep(_port_net(jax_params), _LmLoss(), "sgd", **kw)


def test_parallel_module_surface(jax_params):
    assert tparallel.get_mesh() is None
    for fn in (tparallel.set_mesh, tparallel.mesh_scope):
        with pytest.raises(NotPortedError, match="item 20"):
            fn(None)
    step = tparallel.TrainStep(_port_net(jax_params), _LmLoss(), "sgd")
    with pytest.raises(NotPortedError, match="item 23"):
        step.compiled_hlo(None, None)


def test_grad_req_null_and_add(jax_params):
    net = _port_net(jax_params)
    params = net.collect_params()
    frozen = params["word_embed.weight"]
    frozen.grad_req = "null"
    before = frozen._read().clone()
    step = tparallel.TrainStep(net, _LmLoss(), "sgd", {"learning_rate": 1.0})
    d, l = (torch.from_numpy(a) for a in _batch())
    _, grads = step.gradients(d, l)
    assert "word_embed.weight" not in grads
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        frozen.grad()
    step(d, l)
    assert torch.equal(frozen._read(), before)
    head = params["lm_head.weight"]
    head.grad_req = "add"
    head.zero_grad()
    step.gradients(d, l)
    once = head.grad()._data.clone()
    step.gradients(d, l)
    torch.testing.assert_close(head.grad()._data, 2 * once)
    with pytest.raises(ValueError, match="grad_req"):
        head.grad_req = "sometimes"


def test_warmup_updates_nothing(jax_params):
    net = _port_net(jax_params)
    before = {k: p._read().clone() for k, p in net.collect_params().items()}
    step = tparallel.TrainStep(net, _LmLoss(), *ADAM)
    telemetry.reset()
    sigs = step.warmup([((8, 32), (8, 32))], dtype="int32")
    assert len(sigs) == 1 and step.optimizer.num_update == 0
    if telemetry.enabled():
        assert telemetry.counter_value("parallel.train_step.build") == 1
        assert telemetry.counter_value("parallel.train_step.warmup") == 1
    for k, p in net.collect_params().items():
        assert torch.equal(p._read(), before[k]), k
    d, l = (torch.from_numpy(a) for a in _batch())
    step(d, l)
    assert len(step._entries) == 1     # the warmed entry serves the step


def test_serving_calls_build_no_graph(jax_params):
    net = _port_net(jax_params)
    step = tparallel.TrainStep(net, _LmLoss(), *ADAM)
    d, l = (torch.from_numpy(a) for a in _batch(2))
    step(d, l)
    assert not any(p._read().requires_grad
                   for p in net.collect_params().values())
    assert not net(d).requires_grad
    cache = net.init_cache(2)
    logits, _ = net.prefill(d, torch.full((2,), 32, dtype=torch.int32),
                            cache)
    assert logits.grad_fn is None and not logits.requires_grad
    # the parameters still convert to numpy as they are (no grad)
    assert net.collect_params()["lm_head.weight"]._read().numpy().shape \
        == (VOCAB, UNITS)


def test_dropout_in_the_model_trains(jax_params):
    """GPT with dropout 0.1: the training step's forward drops (its loss
    differs from the predict-mode forward's), and it still learns."""
    net = _port_net(jax_params, dropout=0.1)
    d, l = (torch.from_numpy(a) for a in _batch())
    clean = float(_LmLoss()(net(d), l).mean())
    step = tparallel.TrainStep(net, _LmLoss(), *ADAM)
    random_state.seed(3)
    losses = [float(step(d, l)) for _ in range(3)]
    assert losses[0] != clean and abs(losses[0] - clean) < 0.5
    assert losses[-1] < losses[0]


# -- Dropout ---------------------------------------------------------------
def test_dropout_identity_at_rate_zero_and_in_predict_mode():
    x = torch.randn(4, 5)
    with tautograd.train_mode():
        assert tnn.Dropout(0.0)(x) is x
    assert tnn.Dropout(0.5)(x) is x
    with tautograd.predict_mode():
        assert tnn.Dropout(0.5)(x) is x


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_one_minus_p_scaled(p):
    n = 200_000
    x = torch.full((n,), 3.0)
    with tautograd.train_mode():
        y = tnn.Dropout(p)(x)
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - p)) <= 3 * math.sqrt(p * (1 - p) / n)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        3.0 / (1 - p)))


def test_dropout_seed_repeats_mask_and_axes_share_draws():
    x = torch.ones(4, 6, 8)
    drop = tnn.Dropout(0.5, axes=(1,))
    with tautograd.train_mode():
        random_state.seed(7)
        a = drop(x)
        b = drop(x)
        random_state.seed(7)
        c = drop(x)
    assert torch.equal(a, c) and not torch.equal(a, b)
    assert torch.equal(a, a[:, :1].expand_as(a))   # one draw along axis 1
