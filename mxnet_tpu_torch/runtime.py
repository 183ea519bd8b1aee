"""Runtime feature detection (the port of ``mxnet_tpu/runtime.py``).

``Features()`` keeps the reference's names and API (``Feature``,
``LibInfo``, ``feature_list``, ``is_enabled``), each feature read from
what this process has: ``CUDA`` from ``torch.version.cuda`` and a card
being present, ``CUDNN`` and ``NCCL`` from torch's backends, ``NVCC``
(the kernels' compiler, ``_build.py``), ``NVRTC`` (``rtc.CudaModule``;
also under MXNet's name ``CUDA_RTC``) and ``TRITON``
(``rtc.PallasModule``) from their presence. The TPU-only features
(``TPU``, ``XLA``, ``PJRT``, ``PALLAS``) are off, and so are those of
modules the port lacks yet (``DIST_KVSTORE``, item 19; ``PROFILER``,
item 23).
"""
from __future__ import annotations

import importlib.util
from collections import OrderedDict

import torch

__all__ = ["Feature", "LibInfo", "feature_list", "Features"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"✔ {self.name}" if self.enabled else f"✖ {self.name}"


def _has_nvcc() -> bool:
    from . import _build
    try:
        _build._nvcc()
    except Exception:  # noqa: BLE001 - no compiler on this machine
        return False
    return True


def _has_nvrtc() -> bool:
    from . import rtc
    try:
        rtc._lib("nvrtc")
    except Exception:  # noqa: BLE001 - no NVRTC on this machine
        return False
    return True


def _detect():
    cuda = torch.version.cuda is not None and torch.cuda.is_available()
    nvrtc = _has_nvrtc()
    dist = torch.distributed.is_available()
    feats = OrderedDict()
    feats["TPU"] = False
    feats["CUDA"] = cuda
    feats["CUDNN"] = cuda and torch.backends.cudnn.is_available()
    feats["NCCL"] = cuda and dist and torch.distributed.is_nccl_available()
    feats["NVCC"] = _has_nvcc()
    feats["NVRTC"] = nvrtc
    feats["CUDA_RTC"] = nvrtc
    feats["TRITON"] = importlib.util.find_spec("triton") is not None
    feats["XLA"] = False
    feats["PJRT"] = False
    feats["PALLAS"] = False
    feats["BF16"] = True
    feats["INT64_TENSOR_SIZE"] = True
    feats["OPENMP"] = torch.backends.openmp.is_available()
    feats["DIST_KVSTORE"] = False
    feats["F16C"] = True
    feats["MKLDNN"] = torch.backends.mkldnn.is_available()
    feats["ONEDNN"] = torch.backends.mkldnn.is_available()
    feats["TENSORRT"] = False
    feats["OPENCV"] = False
    feats["PROFILER"] = False
    feats["DEVICE_COUNT"] = torch.cuda.device_count() > 0
    return feats


class LibInfo:
    def features(self):
        return [Feature(k, v) for k, v in _detect().items()]


def feature_list():
    return LibInfo().features()


class Features(OrderedDict):
    instance = None

    def __init__(self):
        super().__init__([(f.name, f) for f in feature_list()])

    def __repr__(self):
        return str(list(self.values()))

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"Feature '{feature_name}' is unknown, "
                               f"known features are: {list(self.keys())}")
        return self[feature_name].enabled
