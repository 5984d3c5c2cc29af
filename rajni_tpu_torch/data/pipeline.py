"""ImageNet-val data pipeline (port of ``rajni_tpu/data/pipeline.py``):
ImageFolder discovery, the reference's preprocessing, batched loading with a
thread pool, and the synthetic loader.

Stands in for the reference's torchvision stack (``Resize(256, bicubic)``,
``CenterCrop(224)``, ``ToTensor``, ``Normalize(ImageNet)`` and a
``DataLoader(shuffle=False, drop_last=False)``):

  * :class:`ImageFolder`: class subdirectories in sorted order define the
    label indices, files sorted within each class (torchvision's contract).
  * :func:`preprocess`: PIL bicubic resize of the shorter side to 256,
    center crop 224, scale to [0, 1], normalize. Output is NHWC float32.
  * :class:`DataLoader`: thread-pool decode, one task an image, a bounded
    look-ahead, batches in dataset order, the last one partial.

Numpy and PIL only: the numbers are the JAX package's bit for bit.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Iterator

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)


def find_classes(root: str) -> tuple[list[str], dict[str, int]]:
    """Sorted class-subdirectory discovery (torchvision ImageFolder contract)."""
    classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
    if not classes:
        raise FileNotFoundError(f"no class directories found in {root!r}")
    return classes, {c: i for i, c in enumerate(classes)}


class ImageFolder:
    """``root/class_x/*.jpg``-style dataset.

    ``output`` selects how much work stays on the host (:mod:`.device` takes
    the other two tiers):

      * ``"float32"`` (default): normalized NHWC float32, the reference
        protocol; through the C++ library (:mod:`.native`) where
        ``use_native`` is set and it builds, else through PIL
        (:meth:`host_tier` says which);
      * ``"uint8"``: host geometry (resize + crop), the uint8 crop out; the
        device normalizes (:func:`.device.normalize_images`);
      * ``"canvas"``: decode only, each image top-left on a ``canvas x
        canvas`` uint8 canvas with its true ``(h, w)``; resize, crop and
        normalize run on the device (:func:`.device.preprocess_on_device`).
        Images larger than the canvas are PIL-downscaled to fit first.
    """

    def __init__(
        self,
        root: str,
        img_size: int = 224,
        resize: int | None = None,
        use_native: bool = True,
        output: str = "float32",
        canvas: int = 512,
    ):
        if output not in ("float32", "uint8", "canvas"):
            raise ValueError(f"unknown output mode {output!r}")
        self.root = root
        self.img_size = img_size
        self.resize = _default_resize(img_size, resize)
        self.use_native = use_native
        self.output = output
        self.canvas = canvas
        self.classes, self.class_to_idx = find_classes(root)
        self.samples: list[tuple[str, int]] = []
        for cls in self.classes:
            d = os.path.join(root, cls)
            files = sorted(
                os.path.join(d, f)
                for f in os.listdir(d)
                if f.lower().endswith(IMG_EXTENSIONS)
            )
            self.samples += [(f, self.class_to_idx[cls]) for f in files]

    def __len__(self) -> int:
        return len(self.samples)

    def _native(self) -> bool:
        if not (self.use_native and self.output == "float32"):
            return False
        from . import native

        return native.available()

    def host_tier(self) -> str:
        """The host preprocessing that :meth:`load` runs: ``"native"``,
        ``"PIL"`` (float32 output), or the output mode's name."""
        if self.output != "float32":
            return self.output
        return "native" if self._native() else "PIL"

    def load(self, index: int):
        path, label = self.samples[index]
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("RGB")
            if self.output == "uint8":
                return preprocess_u8(im, self.img_size, self.resize), label
            if self.output == "canvas":
                return decode_to_canvas(im, self.canvas), label
            if self._native():
                from . import native

                return native.preprocess_native(
                    np.asarray(im), self.img_size, self.resize, IMAGENET_MEAN, IMAGENET_STD,
                ), label
            return preprocess(im, self.img_size, self.resize), label


def _default_resize(img_size: int, resize: int | None) -> int:
    """Shorter-side target: 256 for 224 crops, scaled proportionally for
    other resolutions (384 -> 438) so the crop never exceeds the resized
    image."""
    return int(img_size * 256 / 224) if resize is None else resize


def resize_crop_geometry(
    w: int, h: int, img_size: int, resize: int
) -> tuple[int, int, int, int]:
    """torchvision's geometry → ``(nw, nh, left, top)``, for every tier:

      * the scaled long side is truncated with ``int()``
        (``_compute_resized_output_size``: ``int(size * long / short)``);
      * the center-crop offsets use Python's ``round()``, round-half-even:
        (257 - 224) / 2 = 16.5 crops at 16.
    """
    if w <= h:
        nw, nh = resize, max(1, int(h * resize / w))
    else:
        nh, nw = resize, max(1, int(w * resize / h))
    left = int(round((nw - img_size) / 2.0))
    top = int(round((nh - img_size) / 2.0))
    return nw, nh, left, top


def _resize_crop(im, img_size: int, resize: int | None):
    from PIL import Image

    resize = _default_resize(img_size, resize)
    nw, nh, left, top = resize_crop_geometry(*im.size, img_size, resize)
    im = im.resize((nw, nh), Image.BICUBIC)
    return im.crop((left, top, left + img_size, top + img_size))


def preprocess(im, img_size: int = 224, resize: int | None = None) -> np.ndarray:
    """Resize the shorter side (PIL bicubic), center crop, scale to [0, 1],
    normalize: NHWC float32 ``[img_size, img_size, 3]``."""
    arr = np.asarray(_resize_crop(im, img_size, resize), np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def preprocess_u8(im, img_size: int = 224, resize: int | None = None) -> np.ndarray:
    """:func:`preprocess` without the normalize: the uint8 ``[img_size,
    img_size, 3]`` crop (``normalize_images(preprocess_u8(im)) ==
    preprocess(im)`` bit for bit)."""
    return np.asarray(_resize_crop(im, img_size, resize), np.uint8)


def decode_to_canvas(im, canvas: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """Decode only: the image top-left on a ``[canvas, canvas, 3]`` uint8
    buffer and its true ``(h, w)`` int32.

    An image that fits the canvas is resampled once, on the device. A larger
    one is PIL-downscaled to fit first: two resamples with a uint8 rounding
    between them, close but outside the ±1/255-per-pass bound of the host
    protocol."""
    from PIL import Image

    w, h = im.size
    if max(h, w) > canvas:
        f = canvas / max(h, w)
        w, h = max(1, int(w * f)), max(1, int(h * f))
        im = im.resize((w, h), Image.BICUBIC)
    buf = np.zeros((canvas, canvas, 3), np.uint8)
    buf[:h, :w] = np.asarray(im, np.uint8)
    return buf, np.array([h, w], np.int32)


class DataLoader:
    """Batched, re-iterable loader with threaded decode.

    Yields ``(images [B, H, W, 3], labels [B] int64)`` numpy batches in
    dataset order, the last one partial; in canvas mode ``images`` is the
    tuple ``(canvas [B, S, S, 3] uint8, sizes [B, 2] int32)``. Each image is
    a task of its own in a pool of ``num_workers`` threads (decode and the
    C++ resampler release the GIL), and the images of at most ``prefetch +
    1`` batches are in flight.
    """

    def __init__(self, dataset, batch_size: int = 256, num_workers: int = 8,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _assemble(self, out):
        labels = np.array([o[1] for o in out], np.int64)
        if isinstance(out[0][0], tuple):  # canvas mode: (canvas, (h, w))
            images = (np.stack([o[0][0] for o in out]), np.stack([o[0][1] for o in out]))
        else:
            images = np.stack([o[0] for o in out])
        return images, labels

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        batches = [range(s, min(s + self.batch_size, n)) for s in range(0, n, self.batch_size)]
        if self.num_workers <= 1:
            for b in batches:
                yield self._assemble([self.dataset.load(i) for i in b])
            return
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            it = iter(batches)

            def submit(b):
                return [pool.submit(self.dataset.load, i) for i in b]

            for _ in range(self.prefetch + 1):
                b = next(it, None)
                if b is not None:
                    pending.append(submit(b))
            while pending:
                futs = pending.pop(0)
                b = next(it, None)
                if b is not None:
                    pending.append(submit(b))
                yield self._assemble([f.result() for f in futs])


class SyntheticLoader:
    """Deterministic in-memory loader of NHWC float32 images and int64
    labels, drawn once from ``seed`` and yielded ``num_batches`` times."""

    def __init__(
        self,
        num_batches: int = 8,
        batch_size: int = 256,
        img_size: int = 224,
        num_classes: int = 1000,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self._images = rng.standard_normal(
            (batch_size, img_size, img_size, 3)
        ).astype(np.float32)
        self._labels = rng.integers(0, num_classes, batch_size).astype(np.int64)
        self.num_batches = num_batches
        self.batch_size = batch_size

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        for _ in range(self.num_batches):
            yield self._images, self._labels
