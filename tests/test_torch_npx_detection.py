"""The port's detection ops (``ops/detection.py`` through ``mx.npx``)
against the JAX package's, on the CPU: ``box_iou``, ``box_nms``,
``box_encode``/``box_decode``, ``bipartite_matching``,
``multibox_target``, ``multibox_detection``, ``roi_align``,
``rroi_align``, ``proposal``/``multi_proposal`` and
``deformable_psroi_pooling``, the same seeded inputs through both.

Indices, keeps and matches must be equal; boxes and scores within
1e-5 (``DET``). Scores with exact ties (in ``box_nms``,
``bipartite_matching`` and ``proposal``) show that the tie order is
the reference's: a stable sort, the first minimum, and top-k's lower
index first."""
import numpy as onp
import pytest

import mxnet_tpu_torch as tmx

from test_torch_np_common import check, grads, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DET = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _boxes(n, seed, lead=()):
    rs = onp.random.RandomState(seed)
    xy = rs.uniform(0, 0.7, lead + (n, 2))
    wh = rs.uniform(0.05, 0.4, lead + (n, 2))
    return onp.concatenate([xy, xy + wh], -1).astype("f4")


def _nms_rows(seed, n=12, ties=True):
    """(2, n, 6) rows [class, score, box]: overlapping boxes, three
    classes, scores with exact ties (and a few below the threshold)."""
    rs = onp.random.RandomState(seed)
    cls = rs.randint(0, 3, (2, n, 1)).astype("f4")
    score = rs.choice([0.9, 0.7, 0.5, 0.3, 0.05], (2, n, 1)) if ties \
        else rs.uniform(0, 1, (2, n, 1))
    b = _boxes(n, seed + 1, (2,))
    b[:, 1::3] = b[:, ::3][:, :b[:, 1::3].shape[1]] + 0.01
    return onp.concatenate([cls, score.astype("f4"), b], -1)


def test_box_iou_and_formats():
    a, b = _boxes(5, 1, (2,)), _boxes(4, 2, (2,))
    check("npx.box_iou", (a, b), tol=DET, nojit=True)
    check("npx.box_iou", (a, b), {"format": "center"}, tol=DET, nojit=True)


@pytest.mark.parametrize("kw", [
    {},
    {"id_index": 0, "topk": 5, "background_id": 1, "overlap_thresh": 0.3},
    {"id_index": 0, "force_suppress": True, "valid_thresh": 0.1,
     "in_format": "center"},
], ids=["plain", "per_class_topk_background", "force_center"])
def test_box_nms_with_ties(kw):
    """Scores with exact ties; the second case's rows carry two leading
    dims."""
    rows = _nms_rows(3)
    if "topk" in kw:
        rows = rows.reshape(2, 1, 12, 6)
    t, _ = check("npx.box_nms", (rows,), kw, tol=DET, nojit=True)
    assert (t.asnumpy() == -1).any()


def test_box_encode_decode():
    rs = onp.random.RandomState(5)
    samples = rs.choice([-1.0, 0.0, 1.0], (2, 6)).astype("f4")
    matches = rs.randint(0, 4, (2, 6)).astype("f4")
    anchors, refs = _boxes(6, 6, (2,)), _boxes(4, 7, (2,))
    check("npx.box_encode", (samples, matches, anchors, refs), tol=DET,
          nojit=True)
    deltas = values("float32", (2, 6, 4), lo=-0.5, hi=0.5, seed=8)
    for kw in ({"clip": 0.8}, {"format": "center"}):
        check("npx.box_decode", (deltas, anchors[:1]), kw, tol=DET,
              nojit=True)


@pytest.mark.parametrize("kw", [{"topk": 3},
                                {"is_ascend": True, "threshold": 0.4}],
                         ids=["desc_topk", "asc"])
def test_bipartite_matching_with_ties(kw):
    rs = onp.random.RandomState(9)
    s = rs.choice([0.2, 0.5, 0.8], (2, 5, 4)).astype("f4")
    kw = dict({"threshold": 0.3}, **kw)
    check("npx.bipartite_matching", (s,), kw, nojit=True)


def _multibox_inputs(seed):
    rs = onp.random.RandomState(seed)
    anchor = _boxes(10, seed)[None]
    label = onp.full((2, 3, 5), -1.0, "f4")
    label[0, :2, 0] = [0, 2]
    label[0, :2, 1:] = anchor[0, [1, 6]] + 0.02
    label[1, :3, 0] = [1, 1, 0]
    label[1, :3, 1:] = _boxes(3, seed + 1)
    cls_pred = rs.uniform(0, 1, (2, 4, 10)).astype("f4")
    return anchor, label, cls_pred


def test_multibox_target():
    """With hard negative mining (its stable sort of the hardness)."""
    kw = {"negative_mining_ratio": 2.0, "minimum_negative_samples": 1,
          "overlap_threshold": 0.3}
    check("npx.multibox_target", _multibox_inputs(10), kw, tol=DET)


def test_multibox_detection():
    kw = {"nms_topk": 6, "clip": False, "background_id": 2}
    anchor, _, _ = _multibox_inputs(11)
    rs = onp.random.RandomState(12)
    p = rs.uniform(0, 1, (2, 4, 10)).astype("f4")
    p[:, :, 3] = p[:, :, 5]                       # two anchors tie
    cls_prob = p / p.sum(1, keepdims=True)
    loc = values("float32", (2, 40), lo=-0.3, hi=0.3, seed=13)
    check("npx.multibox_detection", (cls_prob, loc, anchor), kw, tol=DET)


def _rois(seed):
    rs = onp.random.RandomState(seed)
    xy = rs.uniform(0, 8, (5, 2))
    wh = rs.uniform(1, 9, (5, 2))
    r = onp.concatenate([rs.randint(0, 2, (5, 1)), xy, xy + wh], 1)
    return r.astype("f4")


def test_roi_align():
    """The adaptive grid (one for all ROIs, sized for the largest),
    aligned and position-sensitive, at half scale: values and the
    gradient of the data."""
    data = values("float32", (2, 8, 9, 10), seed=14)
    kw = {"pooled_size": (2, 2), "aligned": True, "position_sensitive": True,
          "sample_ratio": -1, "spatial_scale": 0.5}
    t, j = grads("npx.roi_align", (data, _rois(15)), kw, nojit=False)
    same(t, j, DET)


def test_rroi_align():
    """The adaptive grid (sampling_ratio -1)."""
    data = values("float32", (2, 3, 9, 10), seed=16)
    rs = onp.random.RandomState(17)
    rois = onp.concatenate([
        rs.randint(0, 2, (4, 1)), rs.uniform(2, 8, (4, 2)),
        rs.uniform(1, 6, (4, 2)), rs.uniform(-90, 90, (4, 1))], 1)
    check("npx.rroi_align", (data, rois.astype("f4")),
          {"pooled_size": (2, 2), "sampling_ratio": -1}, tol=DET)


def _proposal_inputs(seed, ties):
    rs = onp.random.RandomState(seed)
    A, h, w = 12, 3, 4
    cls = rs.uniform(0, 1, (2, 2 * A, h, w)).astype("f4")
    if ties:
        cls[:, A:] = onp.round(cls[:, A:] * 4) / 4     # many exact ties
    bbox = values("float32", (2, 4 * A, h, w), lo=-0.2, hi=0.2,
                  seed=seed + 1)
    info = onp.array([[60, 70, 1.0], [50, 64, 0.5]], "f4")
    return cls, bbox, info


def test_proposal_with_ties():
    """Objectness scores with many exact ties (top-k keeps the lower
    index first), at a stride of 8 with four scales."""
    kw = dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=12, threshold=0.5,
              rpn_min_size=4, scales=(2.0, 4.0, 8.0, 16.0),
              ratios=(0.5, 1.0, 2.0), feature_stride=8)
    check("npx.multi_proposal", _proposal_inputs(18, True), kw, tol=DET)
    assert tmx.npx.multi_proposal is tmx.npx.proposal


def test_deformable_psroi_pooling():
    kw = dict(trans_std=0.1, sample_per_part=2, part_size=2,
              spatial_scale=0.5, output_dim=2, group_size=3, pooled_size=3)
    data = values("float32", (2, 2 * 9, 8, 9), seed=20)
    rois = _rois(21)
    trans = values("float32", (5, 4, 2, 2), seed=22)
    check("npx.deformable_psroi_pooling", (data, rois, trans), kw, tol=DET)
