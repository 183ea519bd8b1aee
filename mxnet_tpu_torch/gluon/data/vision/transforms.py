"""Vision transforms (the port of
``mxnet_tpu/gluon/data/vision/transforms.py``).

Transforms take HWC images (uint8 or float NDArrays, the reference's
convention) and compose with ``Dataset.transform_first``. They compute
with the port's ``mx.np`` on the image's own context. Random draws come
from numpy's global RNG, as in the reference, so a seeded run draws the
reference's crops, flips and factors. ``Resize``, ``RandomResizedCrop``,
``CropResize``, ``Rotate``/``RandomRotation`` and ``RandomHue`` go
through PIL in the reference; here through ``mxnet_tpu_torch.image``,
which reproduces PIL's arithmetic in torch (no PIL).
"""
from __future__ import annotations

import numpy as onp

from .... import image as _image
from .... import numpy as np
from ....ndarray.ndarray import NDArray
from ...block import Block, HybridBlock
from ...nn.basic_layers import HybridSequential, Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomCrop", "RandomResizedCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomColorJitter",
           "RandomLighting", "CropResize", "RandomGray", "RandomHue",
           "Rotate", "RandomRotation", "RandomApply", "HybridCompose",
           "HybridRandomApply"]


def _const(values, like):
    """A float32 constant on ``like``'s context."""
    return np.array(onp.asarray(values, onp.float32), ctx=like.ctx)


class Compose(Sequential):
    """Sequentially composed transforms."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1]."""

    def forward(self, x):
        x = x.astype("float32") / 255.0
        if x.ndim == 3:
            return x.transpose(2, 0, 1)
        return x.transpose(0, 3, 1, 2)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype=onp.float32)
        self._std = onp.asarray(std, dtype=onp.float32)

    def forward(self, x):
        mean = _const(self._mean.reshape(-1, 1, 1)
                      if self._mean.ndim else self._mean, x)
        std = _const(self._std.reshape(-1, 1, 1)
                     if self._std.ndim else self._std, x)
        return (x - mean) / std


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        if isinstance(self._size, int):
            h, w = x.shape[0], x.shape[1]
            if self._keep:
                if h < w:
                    new_h, new_w = self._size, int(w * self._size / h)
                else:
                    new_h, new_w = int(h * self._size / w), self._size
            else:
                new_h = new_w = self._size
        else:
            new_w, new_h = self._size
        return _image.imresize(x, new_w, new_h)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return x[y0:y0 + h, x0:x0 + w]


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        w, h = self._size
        if self._pad:
            p = self._pad
            x = np.pad(x, ((p, p), (p, p), (0, 0)), mode="constant")
        H, W = x.shape[0], x.shape[1]
        y0 = onp.random.randint(0, max(H - h, 0) + 1)
        x0 = onp.random.randint(0, max(W - w, 0) + 1)
        return x[y0:y0 + h, x0:x0 + w]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4., 4 / 3.),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = onp.random.uniform(*self._scale) * area
            log_ratio = (onp.log(self._ratio[0]), onp.log(self._ratio[1]))
            aspect = onp.exp(onp.random.uniform(*log_ratio))
            w = int(round(onp.sqrt(target_area * aspect)))
            h = int(round(onp.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = onp.random.randint(0, W - w + 1)
                y0 = onp.random.randint(0, H - h + 1)
                crop = x[y0:y0 + h, x0:x0 + w]
                return _image.imresize(crop, self._size[0], self._size[1])
        return _image.imresize(x, self._size[0], self._size[1])


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if onp.random.rand() < self._p:
            return np.flip(x, axis=1)
        return x


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if onp.random.rand() < self._p:
            return np.flip(x, axis=0)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + onp.random.uniform(-self._b, self._b)
        return x * alpha


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        alpha = 1.0 + onp.random.uniform(-self._c, self._c)
        gray = np.mean(x, axis=tuple(range(x.ndim)))
        return x * alpha + gray * (1 - alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        alpha = 1.0 + onp.random.uniform(-self._s, self._s)
        coef = _const(onp.array([0.299, 0.587, 0.114]).reshape(1, 1, 3), x)
        gray = np.sum(x * coef, axis=2, keepdims=True)
        return x * alpha + gray * (1 - alpha)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))

    def forward(self, x):
        order = onp.random.permutation(len(self._transforms))
        for i in order:
            x = self._transforms[i](x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA lighting noise."""

    _eigval = onp.array([55.46, 4.794, 1.148], dtype=onp.float32)
    _eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], dtype=onp.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = onp.random.normal(0, self._alpha, size=(3,)).astype(onp.float32)
        rgb = (self._eigvec * a * self._eigval).sum(axis=1)
        return x + _const(rgb.reshape(1, 1, 3), x)


class CropResize(HybridBlock):
    """A fixed crop, then an optional resize."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y = x, y
        self._w, self._h = width, height
        self._size = size
        self._interp = interpolation

    def forward(self, img):
        out = img[self._y:self._y + self._h, self._x:self._x + self._w]
        if self._size is not None:
            w, h = (self._size if isinstance(self._size, (tuple, list))
                    else (self._size, self._size))
            out = _image.imresize(out, w, h, self._interp)
        return out


class RandomGray(Block):
    """Randomly convert to 3-channel grayscale."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if onp.random.uniform() >= self._p:
            return x
        w = _const([0.299, 0.587, 0.114], x)
        gray = (x.astype("float32") * w).sum(axis=-1, keepdims=True)
        out = np.concatenate([gray, gray, gray], axis=-1)
        return out.astype(x.dtype)


class RandomHue(Block):
    """A random hue shift in PIL's 8-bit HSV space."""

    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        import torch
        alpha = onp.random.uniform(-self._hue, self._hue)
        t = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
        dtype = t.dtype
        hsv = _image.rgb_to_hsv(_image._as_uint8(t))
        h = (hsv[..., 0].to(torch.int32) + int(alpha * 255)).remainder(256)
        hsv = torch.cat([h.to(torch.uint8).unsqueeze(-1), hsv[..., 1:]], -1)
        out = _image.hsv_to_rgb(hsv).to(dtype)
        return NDArray(out, ctx=x.ctx) if isinstance(x, NDArray) \
            else np.array(out.cpu().numpy())


class Rotate(Block):
    """Rotate by a fixed angle in degrees."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        super().__init__()
        self._deg = rotation_degrees

    def forward(self, x):
        return _image.rotate_bilinear(x, self._deg)


class RandomRotation(Block):
    """A random rotation within the angle limits."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        super().__init__()
        lo, hi = (angle_limits if isinstance(angle_limits, (tuple, list))
                  else (-angle_limits, angle_limits))
        self._lo, self._hi = lo, hi
        self._p = rotate_with_proba

    def forward(self, x):
        if onp.random.uniform() >= self._p:
            return x
        return Rotate(onp.random.uniform(self._lo, self._hi))(x)


class RandomApply(Sequential):
    """Apply the wrapped transform with probability ``p``."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        self.transforms = transforms
        self._p = p

    def forward(self, x):
        if onp.random.uniform() < self._p:
            return self.transforms(x)
        return x


class HybridCompose(HybridSequential):
    """A hybridizable Compose (every member a HybridBlock)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class HybridRandomApply(HybridSequential):
    """A hybridizable RandomApply; the coin is drawn on the host at each
    call."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        self.transforms = transforms
        self._p = p

    def forward(self, x):
        if onp.random.uniform() < self._p:
            return self.transforms(x)
        return x
