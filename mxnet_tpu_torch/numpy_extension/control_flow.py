"""Control-flow operators: ``npx.foreach``, ``while_loop`` and ``cond``
(the port of ``mxnet_tpu/numpy_extension/control_flow.py``).

They run as Python control flow over NDArrays, step by step: the
reference's eager branches, and MXNet's imperative path. Under
``autograd.record()`` every op a body runs is recorded as it runs, so
gradients flow through the steps op by op. The reference's other
branches lower a hybridized trace to ``lax.scan``/``lax.while_loop``/
``lax.cond``; the port has no ``HybridBlock`` trace to lower (ROADMAP.md
queue 1, item 15), so it has no such branch.
"""
from __future__ import annotations

from ..ndarray.ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stacked(outputs):
    """Step outputs stacked on a new axis 0 (each field of a list of
    outputs on its own)."""
    from ..numpy import stack
    if isinstance(outputs[0], (list, tuple)):
        return type(outputs[0])(stack([o[j] for o in outputs], axis=0)
                                for j in range(len(outputs[0])))
    return stack(outputs, axis=0)


def foreach(body, data, init_states):
    """Run ``body(data_slice, states) -> (out, new_states)`` over axis 0
    of ``data`` (an NDArray or a list of them). Returns the stacked
    outputs and the final states, in the form ``init_states`` was given
    (one array or a list)."""
    single_data = isinstance(data, NDArray)
    datas = [data] if single_data else list(data)
    states_is_list = isinstance(init_states, (list, tuple))
    cur = _as_list(init_states)
    outputs = []
    for i in range(datas[0].shape[0]):
        sl = [d[i] for d in datas]
        out, new_st = body(sl[0] if single_data else sl,
                           cur if states_is_list else cur[0])
        cur = _as_list(new_st)
        outputs.append(out)
    return _stacked(outputs), (cur if states_is_list else cur[0])


def _truth(c):
    return bool(c.item()) if isinstance(c, NDArray) else bool(c)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``func(loop_vars) -> (step_output, new_loop_vars)`` while
    ``cond(loop_vars)`` holds (a bool or a one-element array, read on
    the host each step), at most ``max_iterations`` times. Returns the
    stacked step outputs ([] if there were none) and the final
    variables."""
    vars_is_list = isinstance(loop_vars, (list, tuple))
    cur = _as_list(loop_vars)
    outputs = []
    steps = 0
    while _truth(cond(cur if vars_is_list else cur[0])):
        out, new_vars = func(cur if vars_is_list else cur[0])
        cur = _as_list(new_vars)
        if out is not None and not (isinstance(out, (list, tuple))
                                    and len(out) == 0):
            outputs.append(out)
        steps += 1
        if max_iterations is not None and steps >= max_iterations:
            break
    if outputs and isinstance(outputs[0], (list, tuple)):
        outs = list(_stacked(outputs))
    else:
        outs = _stacked(outputs) if outputs else []
    return outs, (cur if vars_is_list else cur[0])


def cond(pred, then_func, else_func, inputs=None):
    """``then_func(*inputs)`` if ``pred`` (a bool or a one-element array,
    read on the host) holds, else ``else_func(*inputs)``."""
    ins = [] if inputs is None else _as_list(inputs)
    return then_func(*ins) if _truth(pred) else else_func(*ins)
