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
The JAX package's ``PallasModule`` becomes a stub here that raises.

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

import ctypes
import os
import re
import threading

import torch

__all__ = ["CudaModule", "Kernel", "PallasModule", "nvrtc_info",
           "launch_counts", "reset_launch_counts", "ARCH", "PTR_DTYPES"]

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

_launches = {"rtc": 0}
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
    _launches["rtc"] = 0


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
        self.name = name
        self._in_types = [t for t, _ in params[:-2]]
        self._in_dtypes = [PTR_DTYPES[t] for t in self._in_types]
        self._out_type = params[-2][0]
        self._out_like = out_like
        self._out_shape = None if out_shape is None else tuple(out_shape)
        self._out_dtype = resolve_dtype(out_dtype)
        self._grid = _dim3(grid, "grid")
        self._block = _dim3(block, "block") or (_DEFAULT_BLOCK, 1, 1)
        self._shared_mem = int(shared_mem)
        self._grad = grad
        #: device index -> CUfunction, filled at the first launch there
        self._fns = {}
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
        if dtype != PTR_DTYPES[self._out_type]:
            raise TypeError(
                f"kernel {self.name!r} writes {self._out_type}* but its "
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
            if t.dtype != dt:
                raise TypeError(
                    f"input {i} of kernel {self.name!r} is {t.dtype} but "
                    f"the kernel declares {self._in_types[i]}*")
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


def PallasModule(*args, **kwargs):
    """The JAX package's Pallas entry point; Pallas has no CUDA
    backend here."""
    raise NotImplementedError(
        "PallasModule compiles Pallas kernels for the TPU; on the card "
        "write the kernel in CUDA C and use mx.rtc.CudaModule (same "
        "runtime-compilation workflow, NVRTC for sm_90a)")
