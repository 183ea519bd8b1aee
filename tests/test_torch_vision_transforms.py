"""The port's ``gluon.data.vision.transforms`` and ``image`` against the
JAX package's, on the CPU.

Every transform runs on the same seeded uint8 or float HWC images in
both packages, numpy's global RNG seeded the same before each, so the
random crops, flips, factors and angles are the reference's. The
transforms that compute with ``mx.np`` agree within float32 rounding
(2e-5); ``Resize``, ``RandomResizedCrop``, ``CropResize``, ``Rotate``,
``RandomRotation`` and ``RandomHue``, PIL-backed in the reference,
within one uint8 level (the port redoes PIL's arithmetic in torch;
``image.imresize`` and ``image.rotate_bilinear`` are held to PIL itself
the same way, over every filter and several angles).
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimage
from mxnet_tpu.gluon.data.vision import transforms as jtf
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RS = onp.random.RandomState(0)
U8 = RS.randint(0, 256, (21, 26, 3)).astype("u1")
F32 = RS.uniform(0, 255, (21, 26, 3)).astype("f4")
PIL_LEVEL = dict(rtol=0, atol=1)
FP = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


CASES = [
    ("Cast", lambda t: t.Cast("float16"), U8, FP),
    ("ToTensor", lambda t: t.ToTensor(), U8, FP),
    ("Normalize", lambda t: t.Compose([t.ToTensor(), t.Normalize(
        (0.5, 0.4, 0.3), (0.2, 0.25, 0.3))]), U8, FP),
    ("CenterCrop", lambda t: t.CenterCrop(12), U8, FP),
    ("RandomCrop", lambda t: t.RandomCrop(16, pad=4), U8, FP),
    ("RandomFlipLeftRight", lambda t: t.RandomFlipLeftRight(0.5), U8, FP),
    ("RandomFlipTopBottom", lambda t: t.RandomFlipTopBottom(0.5), U8, FP),
    ("RandomBrightness", lambda t: t.RandomBrightness(0.3), F32, FP),
    ("RandomContrast", lambda t: t.RandomContrast(0.3), F32, FP),
    ("RandomSaturation", lambda t: t.RandomSaturation(0.3), F32, FP),
    ("RandomColorJitter", lambda t: t.RandomColorJitter(0.2, 0.2, 0.2),
     F32, FP),
    ("RandomLighting", lambda t: t.RandomLighting(0.1), F32, FP),
    ("RandomGray", lambda t: t.RandomGray(1.0), U8, FP),
    ("RandomApply", lambda t: t.RandomApply(t.RandomGray(1.0), 0.7), U8,
     FP),
    ("HybridCompose", lambda t: t.HybridCompose([t.Cast(), t.ToTensor()]),
     U8, FP),
    ("HybridRandomApply", lambda t: t.HybridRandomApply(t.Cast(), 0.4), U8,
     FP),
    ("Resize", lambda t: t.Resize(11), U8, PIL_LEVEL),
    ("Resize_keep", lambda t: t.Resize(30, keep_ratio=True), U8, PIL_LEVEL),
    ("Resize_float", lambda t: t.Resize((13, 9)), F32, PIL_LEVEL),
    ("RandomResizedCrop", lambda t: t.RandomResizedCrop(14), U8, PIL_LEVEL),
    ("CropResize", lambda t: t.CropResize(2, 3, 15, 12, size=(9, 7)), U8,
     PIL_LEVEL),
    ("Rotate", lambda t: t.Rotate(23.5), U8, PIL_LEVEL),
    ("RandomRotation", lambda t: t.RandomRotation(40), U8, PIL_LEVEL),
    ("RandomHue", lambda t: t.RandomHue(0.3), U8, PIL_LEVEL),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_transform_matches_reference(case):
    _, make, img, tol = case
    outs = []
    for pkg, tf in ((jmx, jtf), (tmx, ttf)):
        onp.random.seed(7)
        t = make(tf)
        outs.append([t(pkg.np.array(img)) for _ in range(3)])
    for got, ref in zip(outs[1], outs[0]):
        assert str(got.dtype) == str(ref.dtype) and got.shape == ref.shape
        onp.testing.assert_allclose(got.asnumpy().astype("f8"),
                                    ref.asnumpy().astype("f8"), **tol)


def test_every_reference_transform_has_a_case():
    names = {c[0].split("_")[0] for c in CASES} | {"Compose"}
    ref = {n for n in dir(jtf) if isinstance(getattr(jtf, n), type)
           and issubclass(getattr(jtf, n), jmx.gluon.Block)
           and n not in ("Block", "HybridBlock", "Sequential",
                         "HybridSequential")}
    assert ref <= names and ref <= set(ttf.__all__)


@pytest.mark.parametrize("interp", [0, 1, 2, 4])
def test_imresize_matches_pil(interp):
    for img in (U8, U8[:, :, :1], U8[:, :, 0]):
        for w, h in ((9, 7), (40, 33), (26, 10), (5, 30)):
            ref = jimage.imresize(jmx.np.array(img), w, h, interp)
            got = timage.imresize(tmx.np.array(img), w, h, interp)
            assert got.shape == ref.shape
            onp.testing.assert_allclose(got.asnumpy(), ref.asnumpy(),
                                        **PIL_LEVEL)


def test_crops_and_rotation_match_reference():
    for size in ((12, 9), (30, 25)):
        (ra, rb), (ga, gb) = (m.center_crop(p.np.array(U8), size)
                              for m, p in ((jimage, jmx), (timage, tmx)))
        assert rb == gb
        onp.testing.assert_allclose(ga.asnumpy(), ra.asnumpy(), **PIL_LEVEL)
    ref = jimage.fixed_crop(jmx.np.array(U8), 3, 2, 10, 8, (20, 16))
    got = timage.fixed_crop(tmx.np.array(U8), 3, 2, 10, 8, (20, 16))
    onp.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **PIL_LEVEL)
    square = U8[:20, :20]
    for deg in (0, 90, 180, 270, -400, 11.25):
        for img in (U8, square):
            ref = jtf.Rotate(deg)(jmx.np.array(img))
            got = timage.rotate_bilinear(tmx.np.array(img), deg)
            onp.testing.assert_allclose(got.asnumpy(), ref.asnumpy(),
                                        **PIL_LEVEL)
    with pytest.raises(tmx.base.NotPortedError, match="17b"):
        timage.imread("x.jpg")


def test_port_never_imports_pil():
    """The card's machine has no PIL: no module of the port imports it."""
    import ast
    import pathlib
    root = pathlib.Path(tmx.__file__).parent
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            assert not any(n.split(".")[0] == "PIL" for n in names), path
