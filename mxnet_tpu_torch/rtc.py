"""mx.rtc — runtime-compiled CUDA user kernels (the port of
``mxnet_tpu/rtc.py``; replaces its ``Kernel._build_call``, the
``pl.pallas_call`` of a user's Pallas source).

``CudaModule`` is the MXNet reference's own entry point
(``python/mxnet/rtc.py``, ``src/common/rtc.cc``): it takes CUDA C
source at runtime, compiles it with NVRTC for ``sm_90a`` straight to a
cubin (the driver never JIT-compiles PTX), loads it with the driver API
(``cuModuleLoadData``) and launches it with ``cuLaunchKernel`` on
PyTorch's current stream. Both libraries are loaded with ctypes on the
first compile (``libnvrtc`` by its soname, else from ``$CUDA_HOME`` or
``/usr/local/cuda``; ``libcuda.so.1``): importing this module loads
neither and touches no device. ``nvrtc_info()`` says which NVRTC ran.
The JAX package's ``PallasModule``, which takes Python kernel source,
is ``PallasModule`` here too, over Triton (see its docstring):
importing this module imports no ``triton``.

Calling convention of a user kernel::

    extern "C" __global__ void name(const T0* in0, ..., const Tk* ink,
                                     To* out, long long n)

One pointer per input, in order, then the output pointer, then ``n``,
the output's element count. ``Kernel.launch(*inputs)`` takes NDArrays
(or array-likes, made on the inputs' context) and returns a new NDArray
shaped like input ``out_like`` (or ``out_shape``), of that input's dtype
(or ``out_dtype``). The default launch is ``block=(256, 1, 1)``,
``grid=(ceil(n / 256), 1, 1)``, no dynamic shared memory; ``grid``,
``block`` and ``shared_mem`` given to ``get_kernel`` replace it, and
``options`` reach NVRTC (``-DCOLS=1024`` for a row width, for example).
Pointer types map to dtypes: ``float`` float32, ``double`` float64,
``__half`` float16, ``__nv_bfloat16`` bfloat16, ``int`` int32,
``long long`` int64, ``signed char`` int8, ``unsigned char`` uint8,
``bool`` bool. The declarations are parsed from the source without
compiling; ``launch`` checks the input count and every tensor's dtype
against its pointer type and raises before anything runs. A source that
includes CUDA headers passes their directory with ``-I`` in
``options``.

Autograd: a kernel is opaque to the tape by default (its output takes
part in the graph with a zero gradient to its inputs, as the
reference's ``stop_gradient``). ``grad=fn`` makes it differentiable:
``fn(cotangent, *inputs)`` on NDArrays returns one gradient or a tuple.

There is no CPU path: CUDA C runs on the card, so ``launch`` on a CPU
context raises. Each launch adds one to ``launch_counts()["rtc"]``.
Example::

    src = r'''
    extern "C" __global__ void scale_add(const float* x, const float* y,
                                         float* out, long long n) {
        long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
        if (i < n) out[i] = x[i] * 2.0f + y[i];
    }'''
    k = mx.rtc.CudaModule(src).get_kernel("scale_add")
    z = k.launch(x, y)                      # NDArray in, NDArray out
"""
from __future__ import annotations

import ast
import ctypes
import inspect
import os
import re
import textwrap
import threading

import torch

__all__ = ["CudaModule", "Kernel", "PallasModule", "TritonKernel",
           "nvrtc_info", "launch_counts", "reset_launch_counts",
           "parse_kernels", "parse_triton_kernels", "ARCH", "PTR_DTYPES",
           "TRITON_PTR_DTYPES", "TRITON_BLOCK"]

ARCH = "sm_90a"
#: pointer element type of a declaration -> the tensor dtype it takes
PTR_DTYPES = {
    "float": torch.float32, "double": torch.float64,
    "__half": torch.float16, "__nv_bfloat16": torch.bfloat16,
    "int": torch.int32, "long long": torch.int64,
    "signed char": torch.int8, "unsigned char": torch.uint8,
    "bool": torch.bool,
}
_QUALIFIERS = {"const", "volatile", "__restrict__", "__restrict",
               "restrict"}
_DECL = re.compile(
    r'extern\s+"C"\s+__global__\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?'
    r'void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?'
    r'([A-Za-z_]\w*)\s*\(([^)]*)\)')
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_DEFAULT_BLOCK = 256
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_launches = {"rtc": 0, "rtc_triton": 0}
_lock = threading.RLock()
_libs: dict = {}
#: (source, options) -> cubin bytes
_cubins: dict = {}
#: (source, options, device index) -> (CUmodule, {name: CUfunction})
_modules: dict = {}
#: device index -> its primary CUcontext
_contexts: dict = {}


def launch_counts() -> dict:
    """Snapshot of the launch counter."""
    return dict(_launches)


def reset_launch_counts():
    for k in _launches:
        _launches[k] = 0


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------
def _param(text):
    """``'const float* __restrict__ x'`` -> ``("float", True)``."""
    ptr = "*" in text
    words = [w for w in re.sub(r"[*&]", " ", text).split()
             if w not in _QUALIFIERS]
    if not words:
        raise ValueError(f"cannot parse kernel parameter {text!r}")
    typ = words if len(words) == 1 else words[:-1]    # drop the name
    return " ".join(typ), ptr


def parse_kernels(source: str) -> dict:
    """``{name: [(type, is_pointer), ...]}`` for every
    ``extern "C" __global__`` function of ``source``."""
    out = {}
    for m in _DECL.finditer(_COMMENT.sub(" ", source)):
        params = m.group(2).strip()
        out[m.group(1)] = [] if params in ("", "void") else [
            _param(p) for p in params.split(",")]
    return out


# ---------------------------------------------------------------------------
# NVRTC and the driver API, loaded with ctypes on first use
# ---------------------------------------------------------------------------
def _load_nvrtc():
    cands = ["libnvrtc.so.12", "libnvrtc.so"]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "lib64", "libnvrtc.so"))
    for c in cands:
        try:
            lib = ctypes.CDLL(c)
        except OSError:
            continue
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        return lib
    raise RuntimeError(
        "libnvrtc not found (looked for libnvrtc.so.12 on the loader "
        "path, $CUDA_HOME/lib64, /usr/local/cuda/lib64): rtc.CudaModule "
        "compiles CUDA C with NVRTC")


def _load_cuda():
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise RuntimeError("libcuda.so.1 (the CUDA driver) not found: "
                           "rtc kernels launch through the driver API"
                           ) from e
    if lib.cuInit(0) != 0:
        raise RuntimeError("cuInit failed")
    lib.cuLaunchKernel.argtypes = [ctypes.c_void_p] + [ctypes.c_uint] * 7 \
        + [ctypes.c_void_p] * 3
    return lib


def _lib(name):
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _load_nvrtc() if name == "nvrtc" else _load_cuda()
                _libs[name] = lib
    return lib


def _cu_check(res, what):
    if res != 0:
        name = ctypes.c_char_p()
        _lib("cuda").cuGetErrorName(res, ctypes.byref(name))
        label = name.value.decode() if name.value else "unknown"
        raise RuntimeError(f"{what} failed: {label} (CUresult {res})")


def _nvrtc_check(res, what):
    if res != 0:
        msg = _lib("nvrtc").nvrtcGetErrorString(res).decode()
        raise RuntimeError(f"{what} failed: {msg} (nvrtcResult {res})")


def nvrtc_info() -> dict:
    """The NVRTC this process compiles with: its version and the file
    it was loaded from (loads it)."""
    lib = _lib("nvrtc")
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(lib.nvrtcVersion(ctypes.byref(major), ctypes.byref(minor)),
                 "nvrtcVersion")
    path = None
    with open("/proc/self/maps") as f:
        for line in f:
            if "libnvrtc.so" in line:
                path = line.split()[-1]
                break
    return {"version": f"{major.value}.{minor.value}", "path": path,
            "arch": ARCH}


def _compile(source, options, name="rtc_module.cu") -> bytes:
    """NVRTC: CUDA C source -> an ``sm_90a`` cubin; a compile error
    raises with NVRTC's log."""
    lib = _lib("nvrtc")
    prog = ctypes.c_void_p()
    _nvrtc_check(lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), name.encode(), 0, None, None),
        "nvrtcCreateProgram")
    try:
        opts = [f"--gpu-architecture={ARCH}", "-std=c++17", *options]
        argv = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), argv)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, log)
        if res != 0:
            raise RuntimeError(
                f"NVRTC could not compile the rtc source "
                f"({lib.nvrtcGetErrorString(res).decode()}):\n"
                f"{log.value.decode(errors='replace')}")
        _nvrtc_check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _make_current(dev_index):
    """Make the card's primary context (the one torch uses) current on
    this thread; returns it."""
    cu = _lib("cuda")
    ctx = _contexts.get(dev_index)
    if ctx is None:
        torch.cuda.init()
        dev = ctypes.c_int()
        _cu_check(cu.cuDeviceGet(ctypes.byref(dev), dev_index),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _cu_check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _contexts[dev_index] = ctx
    cur = ctypes.c_void_p()
    _cu_check(cu.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _cu_check(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return ctx


def _module(source, options, dev_index):
    """The loaded module of (source, options) on one card, compiled on
    first use and cached in memory."""
    key = (source, options, dev_index)
    mod = _modules.get(key)
    if mod is None:
        with _lock:
            mod = _modules.get(key)
            if mod is None:
                cubin = _cubins.get((source, options))
                if cubin is None:
                    cubin = _compile(source, options)
                    _cubins[(source, options)] = cubin
                _make_current(dev_index)
                handle = ctypes.c_void_p()
                _cu_check(_lib("cuda").cuModuleLoadData(
                    ctypes.byref(handle), cubin), "cuModuleLoadData")
                mod = (handle, {})
                _modules[key] = mod
    return mod


def _function(source, options, dev_index, name, shared_mem):
    handle, fns = _module(source, options, dev_index)
    fn = fns.get(name)
    if fn is None:
        cu = _lib("cuda")
        fn = ctypes.c_void_p()
        _cu_check(cu.cuModuleGetFunction(ctypes.byref(fn), handle,
                                         name.encode()),
                  f"cuModuleGetFunction({name})")
        if shared_mem > 48 * 1024:
            _cu_check(cu.cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                shared_mem), f"cuFuncSetAttribute({name})")
        fns[name] = fn
    return fn


# ---------------------------------------------------------------------------
# the user-facing module and kernel
# ---------------------------------------------------------------------------
_FRONT_END = []


def _front_end():
    """The front-end modules ``launch`` uses, imported once (they import
    this module's package, so not at import time)."""
    if not _FRONT_END:
        from .ndarray.ndarray import NDArray
        from . import autograd, engine
        from . import numpy as _np
        from .context import current_context
        _FRONT_END.extend((NDArray, autograd, engine, _np, current_context))
    return _FRONT_END


def _dim3(v, what):
    if v is None:
        return None
    v = (int(v),) if isinstance(v, int) else tuple(int(x) for x in v)
    if not 1 <= len(v) <= 3 or min(v) < 1:
        raise ValueError(f"{what} must be 1 to 3 positive ints, got {v}")
    return v + (1,) * (3 - len(v))


class _RtcFunction(torch.autograd.Function):
    """A recorded launch: backward calls the kernel's ``grad`` on
    NDArrays, or gives zeros when the kernel is opaque."""

    @staticmethod
    def forward(ctx, kernel, shape, dtype, *ins):
        ctx.kernel = kernel
        ctx.save_for_backward(*ins)
        return kernel._run(shape, dtype, ins[0].device, ins)

    @staticmethod
    def backward(ctx, ct):
        from .ndarray.ndarray import NDArray
        from . import autograd
        ins = ctx.saved_tensors
        k = ctx.kernel
        if k._grad is None:
            gs = [torch.zeros_like(t) for t in ins]
        else:
            with autograd.pause():
                res = k._grad(NDArray(ct), *[NDArray(t.detach())
                                             for t in ins])
            if not isinstance(res, (tuple, list)):
                res = (res,)
            gs = [None if g is None else
                  (g._data if isinstance(g, NDArray) else torch.as_tensor(g)
                   ).to(device=t.device, dtype=t.dtype)
                  for g, t in zip(res, ins)]
        return (None, None, None, *gs)


class Kernel:
    """A launchable runtime-compiled kernel (parity: rtc.CudaKernel;
    the JAX package's ``rtc.Kernel``). Made by
    :meth:`CudaModule.get_kernel`, which fixes its launch shape."""

    def __init__(self, module, name, params, out_like=0, out_shape=None,
                 out_dtype=None, grid=None, block=None, shared_mem=0,
                 grad=None):
        from .base import resolve_dtype
        if len(params) < 2 or any(not p for _, p in params[:-1]) \
                or params[-1] != ("long long", False):
            raise ValueError(
                f"kernel {name!r} does not follow the rtc calling "
                f"convention (one pointer per input, the output pointer, "
                f"then `long long n`): {params}")
        unknown = [t for t, _ in params[:-1] if t not in PTR_DTYPES]
        if unknown:
            raise ValueError(f"kernel {name!r}: unsupported pointer "
                             f"types {unknown}; known: {sorted(PTR_DTYPES)}")
        self._module = module
        self._output(name, [t for t, _ in params[:-2]],
                     [PTR_DTYPES[t] for t, _ in params[:-2]],
                     params[-2][0], PTR_DTYPES[params[-2][0]], out_like,
                     out_shape, resolve_dtype(out_dtype), grad)
        self._in_decls = [f"{t}*" for t in self._in_decls]
        self._out_decl += "*"
        self._grid = _dim3(grid, "grid")
        self._block = _dim3(block, "block") or (_DEFAULT_BLOCK, 1, 1)
        self._shared_mem = int(shared_mem)
        #: device index -> CUfunction, filled at the first launch there
        self._fns = {}

    def _output(self, name, in_decls, in_dtypes, out_decl, out_decl_dtype,
                out_like, out_shape, out_dtype, grad):
        """The launch contract shared by both routes: the declared type
        of each input (None: any) and of the output, and how the output
        is shaped."""
        self.name = name
        self._in_decls = in_decls
        self._in_dtypes = in_dtypes
        self._out_decl = out_decl
        self._out_decl_dtype = out_decl_dtype
        self._out_like = out_like
        self._out_shape = None if out_shape is None else tuple(out_shape)
        self._out_dtype = out_dtype
        self._grad = grad
        if self._out_shape is None \
                and not 0 <= out_like < len(self._in_dtypes):
            raise ValueError(f"out_like={out_like} is not an input of "
                             f"{name!r}")

    def _out_spec(self, ins):
        if self._out_shape is not None:
            shape = self._out_shape
            dtype = self._out_dtype or (ins[0].dtype if ins
                                        else torch.float32)
        else:
            ref = ins[self._out_like]
            shape, dtype = tuple(ref.shape), self._out_dtype or ref.dtype
        if self._out_decl_dtype is not None \
                and dtype != self._out_decl_dtype:
            raise TypeError(
                f"kernel {self.name!r} writes {self._out_decl} but its "
                f"output would be {dtype}; pass out_dtype")
        return shape, dtype

    def launch(self, *args):
        """Run the kernel over NDArray (or array-like) inputs; returns
        a new NDArray on the inputs' context."""
        NDArray, autograd, engine, _np, current_context = _front_end()
        if len(args) != len(self._in_dtypes):
            raise TypeError(
                f"kernel {self.name!r} takes {len(self._in_dtypes)} "
                f"inputs (its declaration: {len(self._in_dtypes)} input "
                f"pointers, the output, n); got {len(args)}")
        ctx = next((a.ctx for a in args if isinstance(a, NDArray)), None) \
            or current_context()
        ins = [(a if isinstance(a, NDArray) else _np.array(a, ctx=ctx))._data
               for a in args]
        for i, (t, dt) in enumerate(zip(ins, self._in_dtypes)):
            if dt is not None and t.dtype != dt:
                raise TypeError(
                    f"input {i} of kernel {self.name!r} is {t.dtype} but "
                    f"the kernel declares {self._in_decls[i]}")
            if t.device != ins[0].device:
                raise ValueError(f"kernel {self.name!r}: inputs on "
                                 f"{ins[0].device} and {t.device}")
        shape, dtype = self._out_spec(ins)
        dev = ins[0].device if ins else ctx.torch_device
        if ins and autograd.is_recording() and any(
                t.requires_grad for t in ins):
            with torch.enable_grad():
                out = _RtcFunction.apply(self, shape, dtype, *ins)
        else:
            out = self._run(shape, dtype, dev, [t.detach() for t in ins])
        return NDArray(engine.track(out), ctx=ctx)

    __call__ = launch

    def _run(self, shape, dtype, device, ins):
        out = torch.empty(shape, dtype=dtype, device=device)
        self._compute([t.detach().contiguous() for t in ins], out)
        return out

    def _compute(self, ins, out):
        """Compile (once) and launch the kernel into ``out`` on the
        current stream: the only place that runs CUDA C."""
        if out.device.type != "cuda":
            raise RuntimeError(
                f"rtc kernel {self.name!r}: CUDA C runs on the card, and "
                f"this launch is on {out.device}; create the inputs on "
                f"mx.gpu() (there is no CPU version of a user kernel)")
        n = out.numel()
        if n == 0:
            return
        dev = out.device.index
        fn = self._fns.get(dev)
        if fn is None:
            fn = self._fns[dev] = _function(
                self._module.source, self._module.options, dev, self.name,
                self._shared_mem)
        _make_current(dev)
        bx, by, bz = self._block
        gx, gy, gz = self._grid or (-(-n // bx), 1, 1)
        params = [ctypes.c_void_p(t.data_ptr()) for t in (*ins, out)]
        params.append(ctypes.c_longlong(n))
        argv = (ctypes.c_void_p * len(params))(
            *[ctypes.addressof(p) for p in params])
        # torch's raw handle of the current stream (what Triton launches
        # on): no Stream object is built per launch
        stream = torch._C._cuda_getCurrentRawStream(dev)
        _cu_check(_lib("cuda").cuLaunchKernel(
            fn, gx, gy, gz, bx, by, bz, self._shared_mem,
            ctypes.c_void_p(stream), ctypes.cast(argv, ctypes.c_void_p),
            None),
            f"cuLaunchKernel({self.name})")
        _launches["rtc"] += 1


class CudaModule:
    """A module of runtime-compiled CUDA C kernels (parity:
    ``mx.rtc.CudaModule(source, options=(), exports=())``)."""

    def __init__(self, source, options=(), exports=None):
        if not isinstance(source, str):
            raise TypeError("CudaModule takes CUDA C source as a str")
        self.source = source
        self.options = tuple(options)
        self._decls = parse_kernels(source)
        if exports is not None:
            missing = set(exports) - set(self._decls)
            if missing:
                raise ValueError(
                    f"source does not define {sorted(missing)}")
            self._decls = {k: self._decls[k] for k in exports}

    def list_kernels(self):
        return sorted(self._decls)

    def get_kernel(self, name, out_like=0, out_shape=None, out_dtype=None,
                   grid=None, block=None, shared_mem=0, grad=None):
        if name not in self._decls:
            raise ValueError(f"no kernel {name!r}; module defines "
                             f"{self.list_kernels()}")
        return Kernel(self, name, self._decls[name], out_like=out_like,
                      out_shape=out_shape, out_dtype=out_dtype, grid=grid,
                      block=block, shared_mem=shared_mem, grad=grad)

    def load(self, device=None):
        """Compile (or take from the cache) and load this module on a
        card now instead of at the first launch; returns self."""
        from .context import resolve_device
        _module(self.source, self.options, resolve_device(device).index)
        return self


# ---------------------------------------------------------------------------
# PallasModule: Python-source kernels, written in Triton
# ---------------------------------------------------------------------------
#: Triton pointer annotation of a kernel parameter -> the dtype it takes
TRITON_PTR_DTYPES = {
    "*fp32": torch.float32, "*fp64": torch.float64, "*fp16": torch.float16,
    "*bf16": torch.bfloat16, "*i8": torch.int8, "*i16": torch.int16,
    "*i32": torch.int32, "*i64": torch.int64, "*u8": torch.uint8,
    "*i1": torch.bool,
}
#: the block size of a launch whose ``BLOCK`` is not given
TRITON_BLOCK = 1024
_TRITON = []


def _triton():
    """``triton``, imported at the first launch (the CPU has none); its
    cache of compiled kernels defaults to the package's build directory,
    beside the CUDA kernels'."""
    if not _TRITON:
        from ._build import BUILD_DIR
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
        try:
            import triton
        except ImportError as e:
            raise ImportError(
                "rtc.PallasModule kernels are Triton kernels, and `import "
                f"triton` failed ({e}): Triton compiles them for the card "
                "(and interprets them on the CPU with interpret=True)") from e
        _TRITON.append(triton)
    return _TRITON[0]


def _is_jit(node):
    """A ``@triton.jit`` / ``@jit`` decorator (called or not)."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Name):
        return node.id == "jit"
    return isinstance(node, ast.Attribute) and node.attr == "jit" \
        and isinstance(node.value, ast.Name) and node.value.id == "triton"


def _ann_text(node):
    """A parameter annotation as the convention reads it: a pointer
    type's string (``"*fp32"``), ``"constexpr"``, or None."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    text = ast.unparse(node)
    return "constexpr" if text.split(".")[-1] == "constexpr" else text


_NO_DEFAULT = object()


def parse_triton_kernels(source: str) -> dict:
    """``{name: [(parameter, annotation, default), ...]}`` for every
    top-level ``@triton.jit`` function of ``source``, read with ``ast``:
    nothing is executed and ``triton`` is not imported."""
    tree = ast.parse(source)
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) \
                or not any(_is_jit(d) for d in node.decorator_list):
            continue
        args = node.args.posonlyargs + node.args.args
        defaults = [_NO_DEFAULT] * (len(args) - len(node.args.defaults)) \
            + [ast.literal_eval(d) for d in node.args.defaults]
        out[node.name] = [(a.arg, _ann_text(a.annotation), d)
                          for a, d in zip(args, defaults)]
    return out


def _strip_pointer_annotations(source: str) -> str:
    """``source`` without its ``"*fp32"``-style annotations (the
    convention's declarations, which Triton need not read), every other
    character and line in place."""
    lines = source.splitlines(True)
    cuts = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.arg) and isinstance(
                node.annotation, ast.Constant) \
                and isinstance(node.annotation.value, str) \
                and node.annotation.value.startswith("*"):
            ann = node.annotation
            if ann.end_lineno != node.lineno:
                raise ValueError(f"the annotation of {node.arg!r} must sit "
                                 "on its parameter's line")
            cuts.append((node.lineno - 1,
                         node.col_offset + len(node.arg.encode()),
                         ann.end_col_offset))
    for ln, start, end in sorted(cuts, reverse=True):
        b = lines[ln].encode()
        lines[ln] = (b[:start] + b[end:]).decode()
    return "".join(lines)


def _signature(fn):
    """The parameters of a kernel given as a function (or a Triton
    ``JITFunction``) as ``parse_triton_kernels`` gives them."""
    f = getattr(fn, "fn", fn)
    out = []
    for p in inspect.signature(f).parameters.values():
        a = p.annotation
        if a is inspect.Parameter.empty:
            ann = None
        elif isinstance(a, str):
            ann = a
        else:
            ann = "constexpr" if getattr(a, "__name__", "") == "constexpr" \
                else repr(a)
        d = _NO_DEFAULT if p.default is inspect.Parameter.empty \
            else p.default
        out.append((p.name, ann, d))
    return out


class TritonKernel(Kernel):
    """A launchable Triton kernel of a :class:`PallasModule` (the JAX
    package's ``rtc.Kernel`` over a Pallas function). Its launch checks
    and output allocation are ``Kernel``'s; ``_compute`` compiles (once,
    at the first launch) and launches it."""

    def __init__(self, module, name, params, out_like=0, out_shape=None,
                 out_dtype=None, grid=None, grad=None, interpret=None,
                 **kw):
        from .base import resolve_dtype
        specs = sorted(k for k in kw if k in ("in_specs", "out_specs"))
        if specs:
            raise TypeError(
                f"{specs} are Pallas BlockSpecs, which have no meaning for "
                f"a Triton kernel: its program reads what it indexes "
                f"(pass grid= and the kernel's constexprs instead)")
        const = [(p, d) for p, a, d in params if a == "constexpr"]
        runtime = [(p, a) for p, a, _ in params if a != "constexpr"]
        first_const = next((i for i, (_, a, _) in enumerate(params)
                            if a == "constexpr"), len(params))
        if len(runtime) < 2 or first_const != len(runtime) \
                or "BLOCK" not in dict(const):
            raise ValueError(
                f"kernel {name!r} does not follow the rtc calling "
                f"convention (one pointer per input, the output pointer, "
                f"n, then `BLOCK: tl.constexpr` and any other "
                f"constexprs): {[p for p, _, _ in params]}")
        ptrs = runtime[:-1]
        bad = [a for _, a in ptrs if a is not None
               and a not in TRITON_PTR_DTYPES]
        if bad:
            raise ValueError(f"kernel {name!r}: unsupported pointer "
                             f"annotations {bad}; known: "
                             f"{sorted(TRITON_PTR_DTYPES)}")
        unknown = sorted(k for k in kw if k not in dict(const))
        if unknown:
            raise TypeError(f"kernel {name!r} has no constexpr {unknown}; "
                            f"its constexprs: {[p for p, _ in const]}")
        self._meta = {p: d for p, d in const if d is not _NO_DEFAULT}
        self._meta.setdefault("BLOCK", TRITON_BLOCK)
        self._meta.update(kw)
        missing = [p for p, _ in const if p not in self._meta]
        if missing:
            raise TypeError(f"kernel {name!r}: give its constexprs "
                            f"{missing} to get_kernel")
        self._module = module
        self._output(name, [a or "any" for _, a in ptrs[:-1]],
                     [TRITON_PTR_DTYPES.get(a) for _, a in ptrs[:-1]],
                     ptrs[-1][1], TRITON_PTR_DTYPES.get(ptrs[-1][1]),
                     out_like, out_shape, resolve_dtype(out_dtype), grad)
        self._grid = grid
        self._interpret = bool(interpret)

    def _compute(self, ins, out):
        """Compile (once) and launch the kernel into ``out`` on the
        current stream, or run it in Triton's interpreter on the CPU
        with ``interpret=True``: the only place that runs Triton."""
        triton = _triton()
        if not self._interpret and out.device.type != "cuda":
            raise RuntimeError(
                f"rtc kernel {self.name!r}: Triton kernels run on the card, "
                f"and this launch is on {out.device}; create the inputs on "
                f"mx.gpu(), or pass interpret=True to get_kernel to run it "
                f"in Triton's interpreter")
        n = out.numel()
        if n == 0:
            return
        fn = self._module._jit(self.name, self._interpret)
        grid = self._grid
        if grid is None:
            grid = (triton.cdiv(n, self._meta["BLOCK"]),)
        elif isinstance(grid, int):
            grid = (grid,)
        if self._interpret:
            fn[grid](*ins, out, n, **self._meta)
            return
        with torch.cuda.device(out.device):
            fn[grid](*ins, out, n, **self._meta)
        _launches["rtc_triton"] += 1


class PallasModule:
    """A module of kernels given as Python source at runtime (the JAX
    package's ``mx.rtc.PallasModule``), written in Triton: a ``str`` of
    source defining ``@triton.jit`` functions, one such function, or a
    ``dict`` of them.

    A source string is read with ``ast`` when the module is made
    (``list_kernels``, ``exports`` and the calling convention need no
    ``triton``), and executed at the first launch, with ``triton``,
    ``tl`` (``triton.language``) and ``torch`` in its namespace; Triton
    then compiles each kernel for the card at its first launch and
    caches it (``TRITON_CACHE_DIR``, by default
    ``mxnet_tpu_torch/_build/triton``).

    Calling convention of a kernel::

        @triton.jit
        def name(in0, ..., ink, out, n, BLOCK: tl.constexpr, ...):

    one pointer per input, in order, then the output pointer, then
    ``n``, the output's element count, then ``BLOCK`` and any further
    ``tl.constexpr`` the caller gives ``get_kernel``. A pointer may
    declare its dtype with Triton's annotation (``x: "*fp32"``), which
    ``launch`` checks before anything runs; an undeclared one takes any
    dtype. The default grid is ``ceil(n / BLOCK)`` programs, ``BLOCK``
    1024; ``grid`` (an int, a tuple, or a function of the constexprs)
    replaces it. Each launch on the card adds one to
    ``launch_counts()["rtc_triton"]``. Example::

        src = '''
        @triton.jit
        def scale_add(x, y, out, n, BLOCK: tl.constexpr):
            i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            m = i < n
            tl.store(out + i, tl.load(x + i, mask=m) * 2.0
                     + tl.load(y + i, mask=m), mask=m)
        '''
        k = mx.rtc.PallasModule(src).get_kernel("scale_add")
        z = k.launch(x, y)                  # NDArray in, NDArray out
    """

    def __init__(self, source=None, exports=None):
        self.source = None
        self._fns = {}
        self._decls = {}
        if isinstance(source, str):
            self.source = textwrap.dedent(source)
            self._decls = parse_triton_kernels(self.source)
        elif isinstance(source, dict):
            self._fns = dict(source)
        elif callable(source):
            name = getattr(source, "__name__", None) \
                or getattr(source, "fn").__name__
            self._fns = {name: source}
        elif source is not None:
            raise TypeError("source must be str, callable, or dict")
        for k, f in self._fns.items():
            self._decls[k] = _signature(f)
        if exports is not None:
            missing = set(exports) - set(self._decls)
            if missing:
                raise ValueError(
                    f"source does not define {sorted(missing)}")
            self._decls = {k: self._decls[k] for k in exports}
        #: interpret flag -> {name: the Triton function}
        self._jitted = {}

    def list_kernels(self):
        return sorted(self._decls)

    def get_kernel(self, name, out_like=0, out_shape=None, out_dtype=None,
                   grid=None, grad=None, interpret=None, **kw):
        if name not in self._decls:
            raise ValueError(f"no kernel {name!r}; module defines "
                             f"{self.list_kernels()}")
        return TritonKernel(self, name, self._decls[name], out_like=out_like,
                            out_shape=out_shape, out_dtype=out_dtype,
                            grid=grid, grad=grad, interpret=interpret, **kw)

    def _jit(self, name, interpret):
        """The module's Triton functions (their interpreted form with
        ``interpret``), made at the first launch."""
        fns = self._jitted.get(interpret)
        if fns is None:
            with _lock:
                fns = self._jitted.get(interpret)
                if fns is None:
                    fns = self._jitted[interpret] = self._build(interpret)
        return fns[name]

    def _build(self, interpret):
        triton = _triton()
        from triton.runtime.interpreter import InterpretedFunction
        from triton.runtime.jit import JITFunction
        fns = _exec_source(triton, self.source, interpret) \
            if self.source is not None else dict(self._fns)
        for k, f in fns.items():
            kind = InterpretedFunction if interpret else JITFunction
            if not isinstance(f, kind):
                f = getattr(f, "fn", f)
                fns[k] = InterpretedFunction(f) if interpret \
                    else triton.jit(f)
        return {k: fns[k] for k in self._decls}


def _exec_source(triton, source, interpret):
    """Execute a kernel source (its pointer annotations stripped) in a
    namespace of its own; Python's ``inspect``, which Triton reads a
    kernel's source through, finds it in ``linecache`` under a name made
    from its digest."""
    import hashlib
    import linecache
    src = _strip_pointer_annotations(source)
    digest = hashlib.sha256(f"{interpret}\n{src}".encode()).hexdigest()[:16]
    fname = f"<rtc-triton-{digest}>"
    linecache.cache[fname] = (len(src), None, src.splitlines(True), fname)
    ns = {"triton": triton, "tl": triton.language, "torch": torch,
          "__name__": f"mxnet_tpu_torch.rtc.user_{digest}"}
    prev = os.environ.get("TRITON_INTERPRET")
    os.environ["TRITON_INTERPRET"] = "1" if interpret else "0"
    try:
        exec(compile(src, fname, "exec"), ns)
    finally:
        if prev is None:
            os.environ.pop("TRITON_INTERPRET", None)
        else:
            os.environ["TRITON_INTERPRET"] = prev
    return {k: v for k, v in ns.items() if callable(v)
            and hasattr(v, "__getitem__") and not isinstance(v, type)}
