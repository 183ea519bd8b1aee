"""``gluon.utils`` (the port of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``,
``download`` and ``shape_is_known``."""
from __future__ import annotations

import hashlib
import os
import warnings

import torch

from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download", "shape_is_known"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last
    one takes the remainder unless ``even_split``)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch size "
            f"that's a multiple of {num_slice} or set even_split=False to "
            f"allow uneven partitioning of data.")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        end = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * len(data.shape)
        idx[batch_axis] = slice(i * step, end)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split into one slice per context and each slice moved to
    its context (the whole batch for a single context)."""
    from ..numpy import array
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (NDArrays, or tensors in place) by
    ``max_norm / total`` when their global 2-norm ``total`` exceeds
    ``max_norm``. The norm and the scaling stay on the device: without
    ``check_isfinite`` nothing waits for the card and the norm comes
    back as a 0-d NDArray; with it, the norm is read (a float) and a
    non-finite one warns."""
    assert len(arrays) > 0
    ts = [a._data if isinstance(a, NDArray) else a for a in arrays]
    total = torch.sqrt(sum(torch.sum(torch.square(t.detach().float()))
                           for t in ts))
    factor = torch.clamp(max_norm / (total + 1e-8), max=1.0)
    for a, t in zip(arrays, ts):
        new = (t.detach() * factor).to(t.dtype)
        if isinstance(a, NDArray):
            a._install(new)
        else:
            with torch.no_grad():
                a.copy_(new)
    if not check_isfinite:
        return NDArray(total)
    total_f = float(total)
    if not torch.isfinite(torch.tensor(total_f)):
        warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                  "results will be undefined."),
                      stacklevel=2)
    return total_f


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """The file ``url`` names, looked for locally (this package fetches
    nothing over the network): its path, or a RuntimeError saying where
    to put it."""
    fname = url.split("/")[-1]
    target = path if path is not None else fname
    if os.path.isdir(str(target)):
        target = os.path.join(target, fname)
    if os.path.exists(target) and not overwrite:
        return str(target)
    raise RuntimeError(
        f"download({url}) is unavailable: no network egress in this "
        f"environment. Place the file at {target} manually.")


def shape_is_known(shape):
    if shape is None:
        return False
    return all(s > 0 for s in shape)
