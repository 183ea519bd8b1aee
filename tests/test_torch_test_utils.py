"""The port's ``mx.test_utils`` on the CPU: the cases of
``tests/test_test_utils_helpers.py`` on the port, the helpers'
results against the JAX package's where both compute one (the
tolerance tables, ``np_reduce``, ``collapse_sum_like``, the factories),
and the helpers that wait for a later item raising ``NotPortedError``
with it (the Symbol API, item 26; ``hybridize``, item 15)."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import test_utils as tu
from mxnet_tpu_torch.base import NotPortedError

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def test_name_parity():
    """Every public name of the reference's test_utils is the port's."""
    ref = {n for n, v in vars(jmx.test_utils).items()
           if not n.startswith("_") and getattr(v, "__module__", None)
           in (None, "mxnet_tpu.test_utils")}
    ref |= {"assert_allclose", "create_2d_np_tensor", "default_dtype"}
    missing = sorted(n for n in ref if not hasattr(tu, n))
    assert not missing, missing
    assert len(ref) >= 60


def test_tolerance_helpers():
    x = onp.ones(3, "f2")
    rt, at = tu.get_tols(x, onp.ones(3, "f4"))
    assert rt == 1e-2 and at == 1e-3
    assert tu.default_numeric_eps(onp.float64) == 1e-6
    for name in ("default_rtols", "default_atols"):
        assert getattr(tu, name)() == getattr(jmx.test_utils, name)()
    for args in ((None, None, None), (x, None, None), (onp.ones(2), None,
                                                       None)):
        assert tu.get_rtol(*args) == jmx.test_utils.get_rtol(*args)
        assert tu.get_atol(*args) == jmx.test_utils.get_atol(*args)


def test_assert_variants():
    a = onp.array([1.0, onp.nan])
    tu.assert_almost_equal_ignore_nan(a, onp.array([1.0, onp.nan]))
    with pytest.raises(AssertionError):
        tu.assert_almost_equal_ignore_nan(a, onp.array([2.0, onp.nan]))
    tu.assert_almost_equal_with_err(onp.array([1, 2, 3, 9.0]),
                                    onp.array([1, 2, 3, 4.0]), etol=0.3)
    with pytest.raises(AssertionError):
        tu.assert_almost_equal_with_err(onp.array([1, 2, 3, 9.0]),
                                        onp.array([1, 2, 3, 4.0]),
                                        etol=0.1)
    tu.assert_exception(lambda: 1 / 0, ZeroDivisionError)
    with pytest.raises(AssertionError):
        tu.assert_exception(lambda: None, ValueError)
    tu.assert_almost_equal(tmx.np.ones((2,)), onp.ones(2))
    with pytest.raises(AssertionError, match="differ"):
        tu.assert_almost_equal(tmx.np.ones((2,)), onp.zeros(2))
    assert tu.almost_equal(onp.ones(2), onp.ones(2) + 1e-6)
    assert tu.same(tmx.np.ones((2,)), onp.ones(2))
    assert tu.find_max_violation(onp.array([1.0, 3.0]),
                                 onp.array([1.0, 1.0]), 0, 0)[1] == 2.0


def test_np_reduce_and_collapse():
    d = onp.arange(24.0).reshape(2, 3, 4)
    onp.testing.assert_allclose(tu.np_reduce(d, (0, 2), True, onp.sum),
                                d.sum(axis=(0, 2), keepdims=True))
    for args in ((d, 1, False, onp.max), (d, None, True, onp.sum)):
        onp.testing.assert_array_equal(tu.np_reduce(*args),
                                       jmx.test_utils.np_reduce(*args))
    g = tu.collapse_sum_like(onp.ones((4, 3)), (1, 3))
    onp.testing.assert_allclose(g, onp.full((1, 3), 4.0))
    onp.testing.assert_array_equal(
        tu.collapse_sum_like(onp.ones((2, 4, 3)), (4, 1)),
        jmx.test_utils.collapse_sum_like(onp.ones((2, 4, 3)), (4, 1)))


def test_sparse_and_tensor_factories():
    arr, dense = tu.rand_sparse_ndarray((6, 5), "csr", density=0.4)
    assert arr.stype == "csr"
    onp.testing.assert_allclose(arr.asnumpy(), dense, rtol=1e-6)
    arr2, dense2 = tu.rand_sparse_ndarray((6, 5), "row_sparse",
                                          density=0.5)
    assert arr2.stype == "row_sparse"
    onp.testing.assert_allclose(arr2.asnumpy(), dense2, rtol=1e-6)
    assert tu.create_sparse_array((4, 3), "csr").stype == "csr"
    v = tu.create_vector(5)
    assert v.shape == (5,) and v.dtype == jmx.test_utils.create_vector(
        5).dtype
    t = tu.create_2d_tensor(3, 4)
    onp.testing.assert_array_equal(
        t.asnumpy(), jmx.test_utils.create_2d_tensor(3, 4).asnumpy())
    r = tu.rand_ndarray((2, 3), ctx=tmx.cpu())
    assert r.shape == (2, 3) and r.ctx == tmx.cpu()
    assert len(tu.rand_shape_nd(3)) == 3 and len(tu.rand_shape_2d()) == 2
    assert len(tu.random_sample(range(10), 4)) == 4


def test_rand_ndarray_follows_the_current_context():
    """``ctx=None`` is the current context: the card by default, the
    CPU here inside ``with mx.cpu()``."""
    assert tu.rand_ndarray((2,)).ctx == tmx.current_context() == tmx.cpu()
    assert tu.default_context() == tmx.gpu(0)


def test_compare_optimizer_same_and_different():
    tu.compare_optimizer(tmx.optimizer.SGD(learning_rate=0.1),
                         tmx.optimizer.SGD(learning_rate=0.1),
                         [(4, 3)], "float32")
    tu.compare_optimizer(tmx.optimizer.Adam(learning_rate=0.1),
                         tmx.optimizer.Adam(learning_rate=0.1),
                         [(4, 3), (2,)], "float32")
    with pytest.raises(AssertionError):
        tu.compare_optimizer(tmx.optimizer.SGD(learning_rate=0.1),
                             tmx.optimizer.SGD(learning_rate=0.5),
                             [(4, 3)], "float32", compare_states=False)
    with pytest.raises(NotPortedError, match="item 16"):
        tu.compare_optimizer(jmx.optimizer.SGD(), jmx.optimizer.SGD(),
                             [(2,)], "float32")


def test_check_numeric_gradient_and_consistency():
    tu.check_numeric_gradient(lambda x, y: x * y + tmx.np.sin(x),
                              [onp.array([0.3, -0.7]),
                               onp.array([1.5, 2.0])])
    with pytest.raises(AssertionError):
        tu.check_numeric_gradient(
            lambda x: tmx.np.array(x.asnumpy() ** 2) + x, [onp.ones(2)])
    outs = tu.check_consistency(lambda x: x * 2, [tmx.np.ones((3,))],
                                ctx_list=[tmx.cpu(), tmx.cpu()])
    assert len(outs) == 2


def test_verify_generator_normal():
    from scipy import stats
    buckets, probs = tu.gen_buckets_probs_with_ppf(stats.norm(0, 1).ppf, 10)
    tmx.np.random.seed(7)

    def gen(n):
        return tmx.np.random.normal(0, 1, size=(n,))

    assert tu.verify_generator(gen, buckets, probs, nsamples=20_000,
                               nrepeat=3) >= 1
    assert tu.mean_check(gen, 0.0, 1.0, nsamples=20_000)
    assert tu.var_check(gen, 1.0, nsamples=20_000)
    with pytest.raises(AssertionError):
        tu.verify_generator(lambda n: tmx.np.random.normal(2.0, 1,
                                                           size=(n,)),
                            buckets, probs, nsamples=20_000, nrepeat=3)
    _, p, counts = tu.chi_square_check(
        lambda n: tmx.np.array(onp.arange(n) % 2), [0, 1], [0.5, 0.5],
        nsamples=1000)
    assert p > 0.99 and counts.tolist() == [500, 500]


def test_dummy_iter_and_speed():
    class Batches:
        provide_data, provide_label, batch_size = ["d"], ["l"], 5

        def __init__(self):
            self.n = 0

        def __next__(self):
            self.n += 1
            return self.n

    dummy = tu.DummyIter(Batches())
    assert next(dummy) is next(dummy) == 1
    assert tu.check_speed(func=lambda: tmx.np.ones((2,)) * 2, N=3) >= 0


def test_same_array_and_environment():
    x = tmx.np.ones((3,))
    assert tu.same_array(x, x)
    assert tu.same_array(x, x[1:])
    assert not tu.same_array(x, tmx.np.ones((3,)))
    import os
    with tu.environment("MXTT_TEST_VAR", "1"):
        assert os.environ["MXTT_TEST_VAR"] == "1"
    assert "MXTT_TEST_VAR" not in os.environ


def test_download_serves_local_files(tmp_path):
    src = tmp_path / "a.txt"
    src.write_text("x")
    out = tu.download(f"file://{src}", dirname=str(tmp_path / "d"))
    assert open(out).read() == "x"
    with pytest.raises(IOError, match="no network"):
        tu.download(str(tmp_path / "missing.txt"))


@pytest.mark.parametrize("name, args, item", [
    ("check_symbolic_forward", (None, [], []), 26),
    ("check_symbolic_backward", (None, [], None, []), 26),
    ("same_symbol_structure", (None, None), 26),
    ("numeric_grad", (None, {}), 26),
    ("check_gluon_hybridize_consistency", (None, []), 15),
])
def test_helpers_of_later_items_raise(name, args, item):
    with pytest.raises(NotPortedError, match=f"item {item}"):
        getattr(tu, name)(*args)
    with pytest.raises(NotPortedError, match="item 26"):
        tu.check_speed(sym=object())
