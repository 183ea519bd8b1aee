"""The port's runtime-compiled user kernels (mxnet_tpu_torch.rtc) on
the CPU, where there is no card, no NVRTC and no Triton: ``CudaModule``
(CUDA C compiled by NVRTC for sm_90a) and ``PallasModule`` (Python
kernel source in Triton, the counterpart of the JAX package's Pallas
source).

What runs here, for both routes: declaration parsing (Triton source is
read with ``ast``, without importing Triton), ``list_kernels``,
``exports``, unknown names, the calling-convention, arity and dtype
checks (all before anything runs), the refusal of a CPU launch, and for
the Triton route the ImportError naming Triton that its first launch
raises here and the refusal of Pallas ``BlockSpec``s. The JAX package's
rtc tests (tests/test_extensions.py: ``scale_add``, ``negate``,
``double`` with ``grad=``, ``ident`` opaque) and the example's
``scale2`` are held against the port's wiring: the one
compile-and-launch seam of each route (``Kernel._compute``,
``TritonKernel._compute``) is replaced, in the test only, by a CPU
stand-in that computes the named kernel, and outputs and gradients are
compared with the JAX ``PallasModule`` (interpret mode) on the same
inputs (rtol=1e-6, atol=1e-6). That checks marshalling, output
allocation and autograd; the compiled kernels themselves are held
against their plain versions on the card by chip_smoke.py.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EW = dict(rtol=1e-6, atol=1e-6)

CUDA_SRC = r'''
// elementwise kernels of the rtc tests, in the port's convention
extern "C" __global__ void scale_add(const float* __restrict__ x,
                                     const float* __restrict__ y,
                                     float* __restrict__ out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * 2.0f + y[i];
}
extern "C" __global__ void negate(const float* x, float* out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = -x[i];
}
/* extern "C" __global__ void commented_out(float* o, long long n) {} */
extern "C" __global__ void __launch_bounds__(256)
double_it(const float *x, float *out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * 2.0f;
}
extern "C" __global__ void to_index(const int* idx, const unsigned char* m,
                                    long long* out, long long n) {}
__device__ float helper(float v) { return v; }
'''

PALLAS_SRC = """
def scale_add(x_ref, y_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0 + y_ref[...]

def negate(x_ref, o_ref):
    o_ref[...] = -x_ref[...]

def double_it(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0

def ident(x_ref, o_ref):
    o_ref[...] = x_ref[...]

def scale2(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0
"""

#: the same kernels in Triton, in the port's convention (pointers in
#: order, the output, n, BLOCK); scale_add declares its pointer types
TRITON_SRC = '''
import triton
import triton.language as tl


@triton.jit
def scale_add(x: "*fp32", y: "*fp32", out: "*fp32", n,
              BLOCK: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    tl.store(out + i, tl.load(x + i, mask=m) * 2.0 + tl.load(y + i, mask=m),
             mask=m)


@triton.jit
def negate(x, out, n, BLOCK: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    tl.store(out + i, -tl.load(x + i, mask=m), mask=m)


@triton.jit()
def double_it(x, out, n, BLOCK: tl.constexpr = 256):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    tl.store(out + i, tl.load(x + i, mask=m) * 2.0, mask=m)


@jit
def ident(x, out, n, BLOCK: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    tl.store(out + i, tl.load(x + i, mask=m), mask=m)


@triton.jit
def scale2(x: "*fp32", out: "*fp32", n, BLOCK: tl.constexpr,
           SCALE: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    tl.store(out + i, tl.load(x + i, mask=m) * SCALE, mask=m)


def helper(v):
    return v
'''

IDENT_SRC = r'''
extern "C" __global__ void ident(const float* x, float* o, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) o[i] = x[i];
}
extern "C" __global__ void scale2(const float* x, float* o, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) o[i] = x[i] * 2.0f;
}
'''

#: what each kernel computes, for the CPU stand-in of the seam
STAND_IN = {
    "scale_add": lambda x, y: x * 2.0 + y,
    "negate": lambda x: -x,
    "double_it": lambda x: x * 2.0,
    "ident": lambda x: x,
    "scale2": lambda x: x * 2.0,
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture
def stand_in(monkeypatch):
    """Replace the compile-and-launch seam with a CPU computation of the
    named kernel; records each call's input shapes and dtypes."""
    calls = []

    def compute(self, ins, out):
        assert all(t.is_contiguous() and not t.requires_grad for t in ins)
        calls.append((self.name, [(tuple(t.shape), t.dtype) for t in ins],
                      (tuple(out.shape), out.dtype)))
        out.copy_(STAND_IN[self.name](*ins))

    monkeypatch.setattr(rtc.Kernel, "_compute", compute)
    return calls


def test_import_loads_no_nvrtc_and_touches_no_device():
    assert rtc._libs == {} and rtc._modules == {}
    assert not torch.cuda.is_initialized()


def test_parse_declarations():
    decls = rtc.parse_kernels(CUDA_SRC)
    assert sorted(decls) == ["double_it", "negate", "scale_add", "to_index"]
    assert decls["scale_add"] == [("float", True), ("float", True),
                                  ("float", True), ("long long", False)]
    assert decls["to_index"] == [("int", True), ("unsigned char", True),
                                 ("long long", True), ("long long", False)]
    mod = tmx.rtc.CudaModule(CUDA_SRC)
    assert mod.list_kernels() == ["double_it", "negate", "scale_add",
                                  "to_index"]
    k = mod.get_kernel("to_index")
    assert k._in_dtypes == [torch.int32, torch.uint8]


def test_exports_and_unknown_names():
    mod = tmx.rtc.CudaModule(CUDA_SRC, exports=["negate"])
    assert mod.list_kernels() == ["negate"]
    with pytest.raises(ValueError, match="does not define"):
        tmx.rtc.CudaModule(CUDA_SRC, exports=["negate", "missing"])
    with pytest.raises(ValueError, match="no kernel 'scale_add'"):
        mod.get_kernel("scale_add")
    with pytest.raises(ValueError, match="no kernel 'helper'"):
        tmx.rtc.CudaModule(CUDA_SRC).get_kernel("helper")
    with pytest.raises(TypeError):
        tmx.rtc.CudaModule(lambda: None)


@pytest.mark.parametrize("src", [
    'extern "C" __global__ void k(float* o) {}',
    'extern "C" __global__ void k(const float* x, float* o, int n) {}',
    'extern "C" __global__ void k(float x, float* o, long long n) {}',
    'extern "C" __global__ void k(const float2* x, float* o, long long n) {}',
], ids=["no_n", "int_n", "scalar_input", "unknown_type"])
def test_convention_violations_raise_at_get_kernel(src):
    with pytest.raises(ValueError):
        tmx.rtc.CudaModule(src).get_kernel("k")


def test_launch_checks_arity_and_dtypes_before_running(stand_in):
    mod = tmx.rtc.CudaModule(CUDA_SRC)
    k = mod.get_kernel("scale_add")
    x = tmx.np.ones((4,))
    with pytest.raises(TypeError, match="takes 2 inputs"):
        k(x)
    with pytest.raises(TypeError, match="takes 2 inputs"):
        k(x, x, x)
    # a float64 tensor must never reach a float*
    x64 = tmx.NDArray(torch.ones(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float64.*float\\*"):
        k(x, x64)
    with pytest.raises(TypeError, match="int32"):
        k(tmx.np.ones((4,), dtype="int32"), x)
    # the output's dtype is checked against the declared out pointer
    with pytest.raises(TypeError, match="out_dtype"):
        mod.get_kernel("negate", out_dtype="float16")(x)
    t = mod.get_kernel("to_index")
    with pytest.raises(TypeError, match="out_dtype"):
        t(tmx.np.ones((3,), dtype="int32"), tmx.np.ones((3,), dtype="uint8"))
    assert stand_in == []


def test_cpu_launch_raises():
    k = tmx.rtc.CudaModule(CUDA_SRC).get_kernel("negate")
    with pytest.raises(RuntimeError, match="runs on the card"):
        k(tmx.np.ones((3,)))
    assert rtc._libs == {}
    assert tmx.ops.launch_counts()["rtc"] == 0


def test_pallas_module_points_at_cuda_module():
    """``PallasModule`` is the Triton route now: without Triton (as on
    this CPU) its first launch raises an ImportError naming Triton, on a
    CPU context and with ``interpret=True`` alike; nothing runs a plain
    version instead."""
    mod = tmx.rtc.PallasModule(TRITON_SRC)
    for kw in ({}, {"interpret": True}):
        k = mod.get_kernel("negate", **kw)
        with pytest.raises(ImportError, match="Triton"):
            k(tmx.np.ones((3,)))
    assert tmx.ops.launch_counts()["rtc_triton"] == 0


def _inputs(*shapes, seed=0):
    rng = onp.random.RandomState(seed)
    return [rng.uniform(-1, 1, s).astype("f4") for s in shapes]


def test_scale_add_and_negate_against_pallas(stand_in):
    """tests/test_extensions.py::test_pallas_module_from_source."""
    xa, ya = _inputs((8, 128), (8, 128))
    tmod = tmx.rtc.CudaModule(CUDA_SRC)
    jmod = jmx.rtc.PallasModule(PALLAS_SRC)
    tz = tmod.get_kernel("scale_add").launch(tmx.np.array(xa),
                                             tmx.np.array(ya))
    jz = jmod.get_kernel("scale_add").launch(jmx.np.array(xa),
                                             jmx.np.array(ya))
    assert tz.shape == jz.shape and tz.dtype == jz.dtype
    assert tz.ctx == tmx.cpu()
    onp.testing.assert_allclose(tz.asnumpy(), jz.asnumpy(), **EW)
    tn = tmod.get_kernel("negate")(tmx.np.array(xa))
    jn = jmod.get_kernel("negate")(jmx.np.array(xa))
    onp.testing.assert_allclose(tn.asnumpy(), jn.asnumpy(), **EW)
    assert [c[0] for c in stand_in] == ["scale_add", "negate"]
    assert stand_in[0][1] == [((8, 128), torch.float32)] * 2


def test_array_like_inputs_and_out_shape(stand_in):
    k = tmx.rtc.CudaModule(IDENT_SRC).get_kernel("scale2")
    out = k([1.0, 2.0, 3.0])
    onp.testing.assert_allclose(out.asnumpy(), [2.0, 4.0, 6.0])
    # non-contiguous inputs reach the kernel contiguous
    x = tmx.np.array(onp.arange(12, dtype="f4").reshape(3, 4)).T
    onp.testing.assert_allclose(k(x).asnumpy(),
                                onp.arange(12).reshape(3, 4).T * 2.0)
    kk = tmx.rtc.CudaModule(CUDA_SRC).get_kernel("scale_add", out_like=1)
    a, b = _inputs((5,), (5,))
    onp.testing.assert_allclose(
        kk(tmx.np.array(a), tmx.np.array(b)).asnumpy(), a * 2 + b, **EW)


def _grad_case(pkg, mod, xa):
    x = pkg.np.array(xa)
    x.attach_grad()
    k = mod.get_kernel(
        "double_it", grad=lambda ct, x: (ct * 2.0,))
    with pkg.autograd.record():
        y = k(x)
        out = (y * pkg.np.array(onp.arange(1, 33, dtype="f4")
                                .reshape(4, 8))).sum()
    out.backward()
    return y.asnumpy(), x.grad.asnumpy()


def test_kernel_with_custom_grad_against_pallas(stand_in):
    """tests/test_extensions.py::test_pallas_kernel_with_custom_grad."""
    xa, = _inputs((4, 8))
    ty, tg = _grad_case(tmx, tmx.rtc.CudaModule(CUDA_SRC), xa)
    jy, jg = _grad_case(jmx, jmx.rtc.PallasModule(PALLAS_SRC), xa)
    onp.testing.assert_allclose(ty, jy, **EW)
    onp.testing.assert_allclose(tg, jg, **EW)
    onp.testing.assert_allclose(tg, 2.0 * onp.arange(1, 33).reshape(4, 8))


def _opaque_case(pkg, mod, xa):
    x = pkg.np.array(xa)
    x.attach_grad()
    k = mod.get_kernel("ident")
    with pkg.autograd.record():
        out = (k(x) * 2.0).sum() + (x * 3.0).sum()
    out.backward()
    return out.asnumpy(), x.grad.asnumpy()


def test_kernel_without_grad_is_opaque_against_pallas(stand_in):
    """tests/test_extensions.py::test_pallas_kernel_without_grad_is_opaque
    (with a second path that is differentiable)."""
    xa, = _inputs((4,))
    to, tg = _opaque_case(tmx, tmx.rtc.CudaModule(IDENT_SRC), xa)
    jo, jg = _opaque_case(jmx, jmx.rtc.PallasModule(PALLAS_SRC), xa)
    onp.testing.assert_allclose(to, jo, **EW)
    onp.testing.assert_allclose(tg, jg, **EW)
    onp.testing.assert_allclose(tg, onp.full(4, 3.0))
    # alone, the opaque kernel gives zeros (write overwrites old grads)
    x = tmx.np.array(xa)
    x.attach_grad()
    x.grad[:] = 7.0
    with tmx.autograd.record():
        y = (tmx.rtc.CudaModule(IDENT_SRC).get_kernel("ident")(x)
             * 2.0).sum()
    y.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), onp.zeros(4))


def test_kernel_outside_record_is_off_the_tape(stand_in):
    x = tmx.np.array([1.0, 2.0])
    x.attach_grad()
    y = tmx.rtc.CudaModule(IDENT_SRC).get_kernel(
        "scale2", grad=lambda ct, x: ct * 2.0)(x)
    assert not tmx.autograd._on_tape(y)
    onp.testing.assert_allclose(y.asnumpy(), [2.0, 4.0])


# ---------------------------------------------------------------------------
# the Triton route: PallasModule
# ---------------------------------------------------------------------------
@pytest.fixture
def triton_stand_in(monkeypatch):
    """The Triton seam replaced by a CPU computation of the named
    kernel; records each call's inputs, output and constexprs."""
    calls = []

    def compute(self, ins, out):
        assert all(t.is_contiguous() and not t.requires_grad for t in ins)
        calls.append((self.name, [(tuple(t.shape), t.dtype) for t in ins],
                      (tuple(out.shape), out.dtype), dict(self._meta)))
        if self.name == "scale2":
            out.copy_(ins[0] * self._meta["SCALE"])
        else:
            out.copy_(STAND_IN[self.name](*ins))

    monkeypatch.setattr(rtc.TritonKernel, "_compute", compute)
    return calls


def test_triton_module_parses_without_triton():
    """The source is read, not run: no ``triton`` import, the
    ``@triton.jit``, ``@triton.jit()`` and ``@jit`` functions listed
    with their parameters, a plain function left out."""
    import sys
    mod = tmx.rtc.PallasModule(TRITON_SRC)
    assert "triton" not in sys.modules
    assert mod.list_kernels() == ["double_it", "ident", "negate", "scale2",
                                  "scale_add"]
    decls = rtc.parse_triton_kernels(TRITON_SRC)
    assert [(p, a) for p, a, _ in decls["scale_add"]] == [
        ("x", "*fp32"), ("y", "*fp32"), ("out", "*fp32"), ("n", None),
        ("BLOCK", "constexpr")]
    assert decls["double_it"][-1][2] == 256
    k = mod.get_kernel("scale_add")
    assert k._in_dtypes == [torch.float32, torch.float32]
    assert mod.get_kernel("negate")._in_dtypes == [None]
    assert mod.get_kernel("double_it")._meta == {"BLOCK": 256}
    assert mod.get_kernel("scale2", SCALE=3.0)._meta == {"BLOCK": 1024,
                                                         "SCALE": 3.0}
    assert "triton" not in sys.modules
    assert rtc._TRITON == []


def test_triton_exports_and_sources():
    mod = tmx.rtc.PallasModule(TRITON_SRC, exports=["negate"])
    assert mod.list_kernels() == ["negate"]
    with pytest.raises(ValueError, match="does not define"):
        tmx.rtc.PallasModule(TRITON_SRC, exports=["negate", "missing"])
    with pytest.raises(ValueError, match="no kernel 'scale_add'"):
        mod.get_kernel("scale_add")
    with pytest.raises(ValueError, match="no kernel 'helper'"):
        tmx.rtc.PallasModule(TRITON_SRC).get_kernel("helper")
    with pytest.raises(TypeError):
        tmx.rtc.PallasModule(3)

    def twice(x, out, n, BLOCK: "constexpr"):
        pass

    one = tmx.rtc.PallasModule(twice)
    assert one.list_kernels() == ["twice"]
    both = tmx.rtc.PallasModule({"a": twice, "b": twice})
    assert both.list_kernels() == ["a", "b"]
    assert both.get_kernel("b")._in_dtypes == [None]


@pytest.mark.parametrize("src, err", [
    ("@triton.jit\ndef k(out, n):\n    pass\n", ValueError),
    ("@triton.jit\ndef k(x, out, BLOCK: tl.constexpr):\n    pass\n",
     ValueError),
    ("@triton.jit\ndef k(x, BLOCK: tl.constexpr, out, n):\n    pass\n",
     ValueError),
    ("@triton.jit\ndef k(x: '*f7', out, n, BLOCK: tl.constexpr):\n"
     "    pass\n", ValueError),
], ids=["no_block", "no_n", "constexpr_first", "unknown_type"])
def test_triton_convention_violations_raise_at_get_kernel(src, err):
    with pytest.raises(err):
        tmx.rtc.PallasModule(src).get_kernel("k")


def test_triton_block_specs_and_constexprs_refused():
    mod = tmx.rtc.PallasModule(TRITON_SRC)
    for kw in ({"in_specs": [None]}, {"out_specs": None}):
        with pytest.raises(TypeError, match="BlockSpec"):
            mod.get_kernel("negate", **kw)
    with pytest.raises(TypeError, match="SCALE"):
        mod.get_kernel("scale2")
    with pytest.raises(TypeError, match="no constexpr"):
        mod.get_kernel("negate", COLS=4)
    assert mod.get_kernel("negate", BLOCK=128)._meta == {"BLOCK": 128}


def test_triton_launch_checks_before_running(triton_stand_in):
    mod = tmx.rtc.PallasModule(TRITON_SRC)
    k = mod.get_kernel("scale_add")
    x = tmx.np.ones((4,))
    with pytest.raises(TypeError, match="takes 2 inputs"):
        k(x)
    x64 = tmx.NDArray(torch.ones(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float64.*\\*fp32"):
        k(x, x64)
    with pytest.raises(TypeError, match="out_dtype"):
        mod.get_kernel("scale2", SCALE=2.0, out_dtype="float16")(x)
    assert triton_stand_in == []
    # an undeclared pointer takes any dtype
    neg = mod.get_kernel("negate")
    onp.testing.assert_array_equal(
        neg(tmx.np.array([1, 2], dtype="int32")).asnumpy(), [-1, -2])
    assert triton_stand_in[-1][1] == [((2,), torch.int32)]
    assert triton_stand_in[-1][3] == {"BLOCK": 1024}


def test_triton_cpu_launch_raises_on_the_card_route(monkeypatch):
    """With Triton importable, a CPU launch without ``interpret=True``
    is refused before anything compiles."""
    monkeypatch.setattr(rtc, "_TRITON", [object()])
    k = tmx.rtc.PallasModule(TRITON_SRC).get_kernel("negate")
    with pytest.raises(RuntimeError, match="run on the card"):
        k(tmx.np.ones((3,)))
    assert tmx.ops.launch_counts()["rtc_triton"] == 0


def test_triton_scale_add_and_negate_against_pallas(triton_stand_in):
    xa, ya = _inputs((8, 128), (8, 128), seed=3)
    tmod = tmx.rtc.PallasModule(TRITON_SRC)
    jmod = jmx.rtc.PallasModule(PALLAS_SRC)
    tz = tmod.get_kernel("scale_add")(tmx.np.array(xa), tmx.np.array(ya))
    jz = jmod.get_kernel("scale_add")(jmx.np.array(xa), jmx.np.array(ya))
    assert tz.shape == jz.shape and tz.dtype == jz.dtype
    onp.testing.assert_allclose(tz.asnumpy(), jz.asnumpy(), **EW)
    tn = tmod.get_kernel("negate")(tmx.np.array(xa))
    jn = jmod.get_kernel("negate")(jmx.np.array(xa))
    onp.testing.assert_allclose(tn.asnumpy(), jn.asnumpy(), **EW)
    # out_shape / out_dtype allocate the output as the reference does
    t2 = tmod.get_kernel("scale2", SCALE=2.0, out_shape=(8, 128))(
        tmx.np.array(xa))
    j2 = jmod.get_kernel("scale2", out_shape=(8, 128))(jmx.np.array(xa))
    onp.testing.assert_allclose(t2.asnumpy(), j2.asnumpy(), **EW)
    assert [c[0] for c in triton_stand_in] == ["scale_add", "negate",
                                               "scale2"]


def test_triton_kernel_with_custom_grad_against_pallas(triton_stand_in):
    xa, = _inputs((4, 8), seed=4)
    ty, tg = _grad_case(tmx, tmx.rtc.PallasModule(TRITON_SRC), xa)
    jy, jg = _grad_case(jmx, jmx.rtc.PallasModule(PALLAS_SRC), xa)
    onp.testing.assert_allclose(ty, jy, **EW)
    onp.testing.assert_allclose(tg, jg, **EW)


def test_triton_kernel_without_grad_is_opaque_against_pallas(
        triton_stand_in):
    xa, = _inputs((4,), seed=5)
    to, tg = _opaque_case(tmx, tmx.rtc.PallasModule(TRITON_SRC), xa)
    jo, jg = _opaque_case(jmx, jmx.rtc.PallasModule(PALLAS_SRC), xa)
    onp.testing.assert_allclose(to, jo, **EW)
    onp.testing.assert_allclose(tg, jg, **EW)
    onp.testing.assert_allclose(tg, onp.full(4, 3.0))


def test_pointer_annotations_are_stripped_in_place():
    src = rtc._strip_pointer_annotations(TRITON_SRC)
    assert '"*fp32"' not in src
    assert len(src.splitlines()) == len(TRITON_SRC.splitlines())
    assert "def scale_add(x, y, out, n," in src
    assert "BLOCK: tl.constexpr" in src
