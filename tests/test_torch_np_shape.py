"""The port's creation helpers and shape manipulation (mx.np) against the
JAX package's, on the CPU: ``logspace`` ... ``indices``, axes moves,
stacking and splitting, ``repeat``, flips, ``pad`` in every mode (with
``reflect_type``, ``stat_length``, ``end_values``, per-axis widths and
constants), ``append``/``insert``/``delete``, ``trim_zeros``,
``unique`` with its three returns, ``resize``; the data movement crossed
over bool, uint8, uint16, uint32, int8, int32, float16 and float32, and
``pad``'s gradient under ``autograd.record()``. Data movement is exact;
tolerances in ``test_torch_np_common.py``."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_np_common import DTYPES, EW, RED, check, grad_pair, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


CREATION = [
    ("logspace", (0.0, 2.0), {"num": 7}),
    ("logspace", (1.0, 3.0), {"num": 5, "base": 2.0, "endpoint": False}),
    ("identity", (3,), {"dtype": "int32"}),
    ("tri", (4,), {"dtype": "uint16"}), ("tril_indices", (3, 1, 5), {}),
    ("triu_indices", (4,), {"k": 1}),
    ("indices", ((3, 1, 2),), {"dtype": "int32"}),
    ("blackman", (9,), {}), ("hanning", (1,), {}),
]


@pytest.mark.parametrize("name,args,kw", CREATION, ids=lambda v: repr(v))
def test_creation(name, args, kw):
    check(name, args, kw, tol=EW)


@pytest.mark.parametrize("dtype", DTYPES)
def test_movement_every_dtype(dtype):
    """The functions whose port routes by dtype (a wide unsigned type
    moves as the signed type of its width; bool and 16-bit types through
    torch's own kernels), in every dtype of the cross."""
    x = values(dtype, shape=(3, 4), seed=40)
    y = values(dtype, shape=(3, 4), seed=41)
    v = values(dtype, shape=(5,), seed=42)
    cases = [
        ("tril", (x,), {"k": 1}), ("roll", (x, (1, -1), (0, 1)), {}),
        ("pad", (x, 2), {"mode": "edge"}),
    ]
    for name, args, kw in cases:
        check(name, args, kw)


@pytest.mark.parametrize("dtype", ["float32"])
def test_movement(dtype):
    x = values(dtype, shape=(3, 4), seed=40)
    y = values(dtype, shape=(3, 4), seed=41)
    v = values(dtype, shape=(5,), seed=42)
    cases = [
        ("diag", (x,), {"k": 1}), ("diagflat", (v,), {}),
        ("diagonal", (x,), {"offset": 1}), ("dstack", ([x, y],), {}),
        ("column_stack", ([v, v],), {}), ("rot90", (x,), {}),
        ("vstack", ([x, v[:4]],), {}), ("append", (x, y), {"axis": 0}),
        ("repeat", (x, 2), {"axis": 1}), ("delete", (v, 1), {}),
        ("resize", (v, (3, 4)), {}), ("broadcast_arrays", (x, v[:4]), {}),
    ]
    for name, args, kw in cases:
        check(name, args, kw)


def test_atleast_and_split_forms():
    x = values("float32", shape=(2, 3, 4), seed=43)
    s = onp.float32(3.0)
    for name in ("atleast_1d", "atleast_2d", "atleast_3d"):
        check(name, (s,))
        check(name, (x[0, 0],))
    check("dsplit", (x, 2))
    check("array_split", (x, [1, 2]), {"axis": 2})
    check("array_split", (x[0], 2), {"axis": 1})
    check("hsplit", (x[0, 0], [1, 3]))
    check("moveaxis", (x, [0, 1], [-1, 0]))
    check("rollaxis", (x, 2, 1))
    check("meshgrid", (x[0, 0], x[0, :, 0]), {"indexing": "ij"})
    check("column_stack", ([x[0], x[1]],))
    check("dstack", ([x[0, 0], x[1, 0]],))


PAD_MODES = [
    ("constant", {}), ("constant", {"constant_values": 7}),
    ("constant", {"constant_values": ((1, 2), (3, 4))}),
    ("edge", {}), ("wrap", {}), ("reflect", {}), ("symmetric", {}),
    ("reflect", {"reflect_type": "odd"}),
    ("symmetric", {"reflect_type": "odd"}),
    ("linear_ramp", {}), ("linear_ramp", {"end_values": (5, -3)}),
    ("maximum", {}), ("minimum", {}), ("mean", {}), ("median", {}),
    ("mean", {"stat_length": 2}), ("maximum", {"stat_length": ((1, 2),
                                                              (2, 1))}),
    ("empty", {}),
]
#: the modes whose integer case computes (rounds or floors) a value
INT_PAD = ("linear_ramp", "mean")


@pytest.mark.parametrize("width", [((1, 2), (3, 0))], ids=repr)
@pytest.mark.parametrize("mode,kw", PAD_MODES, ids=lambda v: repr(v))
def test_pad_modes(mode, kw, width):
    x = values("float32", shape=(3, 4), seed=44)
    check("pad", (x, width), dict(kw, mode=mode))
    if mode not in INT_PAD:
        return
    i = values("int32", shape=(3, 4), seed=45) * 3
    # an integer linear ramp floors float32 values, and XLA's fused graph
    # rounds 5 (1 - 1/3) + 5 / 3 to 4.9999995 where jnp's formula, one
    # operation at a time, gives 5, as the port does: that case is held
    # to the reference run op by op
    check("pad", (i, width), dict(kw, mode=mode),
          nojit=mode == "linear_ramp")


def test_pad_wide_unsigned_and_1d():
    u = values("uint32", shape=(5,), seed=46)
    u[2] = onp.iinfo("uint32").max
    for mode in ("constant", "edge", "reflect", "wrap", "maximum"):
        check("pad", (u, (2, 3)), {"mode": mode})
    check("pad", (values("uint16", shape=(2, 3), seed=47), 1),
          {"mode": "mean"})


def test_pad_gradient():
    x = values("float32", shape=(3, 4), seed=48)
    t, j = grad_pair("pad", x, {"pad_width": 2, "mode": "reflect"},
                     reduce="sq")
    same(t, j, RED)


def test_insert_delete_forms():
    x = values("int32", shape=(3, 5), seed=49)
    v = values("float32", shape=(6,), seed=50)
    check("insert", (x, slice(1, 4), [7, 8, 9]), {"axis": 1})
    check("delete", (v, onp.array([True, False, True, False, False,
                                   True])))
    check("append", (v, 3.0))


@pytest.mark.parametrize("trim", ["fb", "f", "b"])
def test_trim_zeros(trim):
    a = onp.array([0, 0, 3, 0, 5, 2, 0, 0], "i4")
    check("trim_zeros", (a,), {"trim": trim})
    check("trim_zeros", (a.astype("f4"),), {"trim": trim})
    check("trim_zeros", (onp.zeros(4, "i4"),), {"trim": trim})


@pytest.mark.parametrize("dtype", DTYPES)
def test_unique_every_dtype(dtype):
    x = values(dtype, shape=(4, 6), seed=51)
    if dtype.startswith("float"):
        x = onp.round(x).astype(dtype)
    check("unique", (x,))
    check("unique", (x,), {"return_index": True, "return_inverse": True,
                           "return_counts": True})


def test_unique_axis():
    x = values("int32", shape=(6, 3), seed=52) % 2
    check("unique", (x,), {"axis": 0, "return_index": True,
                           "return_counts": True})
    check("unique", (x,), {"axis": 1, "return_inverse": True})
    check("unique", (x.reshape(-1),), {"return_inverse": True})


def test_resize_and_ascontiguous():
    v = values("float32", shape=(7,), seed=53)
    check("resize", (v, (2, 2)))
    check("resize", (v, (3, 5)))
    check("resize", (values("uint16", shape=(2, 2), seed=54), 6))
    for pkg in (tmx, jmx):
        a = pkg.np.ascontiguousarray(v, dtype="float16")
        assert a.dtype == onp.float16 and a.shape == (7,)


def test_diag_indices_from():
    x = values("float32", shape=(3, 3, 3), seed=55)
    check("diag_indices_from", (x,))
    check("tril_indices_from", (x[0],), {"k": 1})
    check("triu_indices_from", (x[0],))


@pytest.mark.parametrize("dtype", DTYPES)
def test_broadcast_arrays_scalar_and_bare_clip(dtype):
    """F7: ``broadcast_arrays`` lifts a Python scalar beside an array
    (2 as int32, 2.5 as float32, True as bool), and ``clip`` with
    neither bound returns its input."""
    x = values(dtype, seed=80)
    for s in (2, 2.5, True):
        check("broadcast_arrays", (x, s), nojit=True)
    check("clip", (x,), nojit=True)
