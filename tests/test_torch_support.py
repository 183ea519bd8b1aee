"""The port's copies of the JAX package's standard-library modules
(telemetry, tracing, _bounded_worker, bucketing) behave as the
originals do: the same calls give the same observable results."""
import pathlib
import queue
import threading

import pytest

import mxnet_tpu._bounded_worker as j_bw
import mxnet_tpu.bucketing as j_bk
import mxnet_tpu.telemetry as j_tm
import mxnet_tpu.tracing as j_tr
import mxnet_tpu_torch._bounded_worker as t_bw
import mxnet_tpu_torch.bucketing as t_bk
import mxnet_tpu_torch.telemetry as t_tm
import mxnet_tpu_torch.tracing as t_tr

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["telemetry.py", "tracing.py",
                                  "_bounded_worker.py"])
def test_stdlib_modules_are_verbatim_copies(name):
    """These three are copied unchanged (they import only the standard
    library and each other), so the port cannot drift from them."""
    assert (ROOT / "mxnet_tpu_torch" / name).read_bytes() == \
        (ROOT / "mxnet_tpu" / name).read_bytes()


POLICIES = [
    ("pow2_min8", dict(mode="pow2", min_size=8)),
    ("pow2", dict(mode="pow2")),
    ("mult8", dict(mode="multiple", multiple=8)),
    ("explicit", dict(buckets=[16, 48, 100])),
    ("pow2_cap", dict(mode="pow2", min_size=8, max_size=100)),
]


@pytest.mark.parametrize("kw", [p[1] for p in POLICIES],
                         ids=[p[0] for p in POLICIES])
def test_bucketing_same_bucket_for_every_length(kw):
    jp, tp = j_bk.BucketingPolicy(**kw), t_bk.BucketingPolicy(**kw)
    assert [tp.bucket(n) for n in range(0, 129)] == \
        [jp.bucket(n) for n in range(0, 129)]
    assert tp.sizes(128) == jp.sizes(128)
    jc, tc = jp.clamped(64), tp.clamped(64)
    assert [tc.bucket(n) for n in range(1, 129)] == \
        [jc.bucket(n) for n in range(1, 129)]
    assert repr(tp) == repr(jp)


def test_bucketing_engine_default_policy():
    """The dense engine's default: pow2, min 8, clamped to the cache."""
    jp = j_bk.BucketingPolicy(mode="pow2", min_size=8).clamped(1024)
    tp = t_bk.BucketingPolicy(mode="pow2", min_size=8).clamped(1024)
    assert [tp.bucket(n) for n in range(1, 1024)] == \
        [jp.bucket(n) for n in range(1, 1024)]
    assert tp.sizes(1023) == jp.sizes(1023) == \
        [8, 16, 32, 64, 128, 256, 512, 1024]


@pytest.mark.parametrize("spec", ["pow2", "mult:16", "16,32,64", "0", "",
                                  "off"])
def test_bucketing_env_specs_and_as_policy(spec):
    jp, tp = j_bk._from_env(spec), t_bk._from_env(spec)
    assert (jp is None) == (tp is None)
    if jp is not None:
        assert repr(tp) == repr(jp)
        assert repr(t_bk.as_policy(spec)) == repr(j_bk.as_policy(spec))
    for bad in (3, 1.5):
        with pytest.raises(TypeError):
            t_bk.as_policy(bad)
    assert t_bk.as_policy(None) is None and t_bk.as_policy(False) is None


def test_bucketing_validation():
    for kw in (dict(buckets=[]), dict(mode="nope"), dict(min_size=0)):
        with pytest.raises(ValueError):
            j_bk.BucketingPolicy(**kw)
        with pytest.raises(ValueError):
            t_bk.BucketingPolicy(**kw)
    prev = t_bk.set_policy("mult:4")
    try:
        with t_bk.policy_scope("pow2") as p:
            assert p.mode == "pow2"
        assert t_bk.get_policy().multiple == 4
    finally:
        t_bk.set_policy(prev)


def _drive_telemetry(tm):
    tm.reset()
    tm.counter("a.count")
    tm.counter("a.count", 4)
    tm.gauge("a.gauge", 3)
    tm.gauge("a.gauge", 1)
    for v in (0.5, 1.0, 2.0, 40.0, 41.0):
        tm.hist("a.lat", v)
    snap = tm.snapshot()
    out = (snap["counters"], snap["gauges"], tm.hist_quantiles("a.lat"),
           tm.counter_value("a.count"), tm.gauge_value("a.gauge", peak=True),
           tm.export_prometheus())
    tm.reset()
    return out


def test_telemetry_same_results():
    assert _drive_telemetry(t_tm) == _drive_telemetry(j_tm)


def _drive_tracing(tr_mod):
    tr = tr_mod.Trace(max_spans=4)
    tr.add("a", tr.clock(), k=1)
    tr.event("b")
    tr.event("c")
    tr.event("d")          # past the bound: dropped
    names = [s["name"] for s in tr.spans()]
    fr = tr_mod.FlightRecorder(capacity=3)
    for i in range(5):
        fr.record("ev", i=i)
    return names, tr.dropped, [e["i"] for e in fr.events()]


def test_tracing_same_results():
    assert _drive_tracing(t_tr) == _drive_tracing(j_tr)


def _drive_worker(bw_mod):
    drained = []

    class W(bw_mod.BoundedQueueWorker):
        def run(self):
            for i in range(100):
                if not self._put(i):
                    return
            self._put(self._DONE)

        def _drained(self, item):
            drained.append(item)

    w = W(depth=2, name="w")
    w.start()
    got = [w._get(), w._get()]
    w.stop(timeout=5.0)
    w.join(timeout=5.0)
    return got, w.is_alive(), all(isinstance(d, int) for d in drained)


def test_bounded_worker_same_results():
    assert _drive_worker(t_bw) == _drive_worker(j_bw) == \
        ([0, 1], False, True)
    assert isinstance(t_bw.BoundedQueueWorker(1, "x")._queue, queue.Queue)
    assert issubclass(t_bw.BoundedQueueWorker, threading.Thread)
