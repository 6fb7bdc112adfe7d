"""The training and eval dataset and its loader, and the inference sources
(counterparts of yolosomi_tpu/data/datasets.py:40-606, :632-701 and
:824-866, and yolosomi_tpu/losses.py:365 pad_targets).

Images decode and resize with cv2, exactly as the JAX loader does.
Batches collate to fixed shapes: images (B, H, W, 3) uint8 BGR NHWC and
targets (B, max_labels, 5) [cls, xc, yc, w, h] normalized, padded with
cls = -1. The loader pads the last batch by wrapping to the start of the
dataset (or drops it), except under rect, where the last batch stays
short; it shuffles, or draws the images with replacement by
`sample_weights` (--image-weights), with numpy's generator of seed +
epoch.

The training branch (`augment=True`): a 4-image mosaic with probability
`mosaic` (copy-reduce-paste, then the perspective warp that crops the 2s
canvas to s), mixed with a second mosaic with probability `mixup`; else
the letterboxed image and the warp; then the Albumentations plane, the
HSV jitter and the flips. It draws from Python's `random` and numpy's
global `np.random` in the JAX package's order, so with one item thread
(`workers=1`) and no prefetch thread the two loaders give the same bytes
from the same seeds; with several threads the draws interleave, as in
the JAX loader.

The rest of the JAX training recipe's input side:
- `rect`: the images sorted by aspect ratio, each batch letterboxed to its
  own stride-multiple shape (`batch_shapes`), no mosaic;
- `cache_images` (--cache ram): every image decoded and resized once;
- `plan_item` / `collate_plan_batch` (--cache device): the same random
  draws and label geometry as a sample, without pixels, as a plan for
  ops/mosaic_device.py to composite on the device;
- `collate_batch4` (--quad): each group of 4 samples becomes one image of
  twice the size.

The label cache is the port's own file, `<dir>.somi-torch.cache.json`
beside the image directory (or list file): JSON, so loading it runs no
unpickler, and under a name the JAX loader's `.somi.cache.npy` never
collides with.

LoadImages (files, directories, globs and videos) and LoadStreams (camera
and network streams) feed detect. Both letterbox with cv2; the JAX
LoadImages takes its C++ letterbox (native/imgproc.cc) when that builds,
which is only close to cv2's, so their images agree with the port's
exactly only where the JAX package runs without it.
"""

from __future__ import annotations

import glob
import hashlib
import json
import math
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import cv2
import numpy as np

from yolosomi_tpu_torch.data import augment as A
from yolosomi_tpu_torch.data.augment import letterbox
from yolosomi_tpu_torch.parallel.mesh import shard_batch
from yolosomi_tpu_torch.utils.boxes import letterbox_params, xywhn2xyxy, xyxy2xywhn
from yolosomi_tpu_torch.utils.general import LOGGER

IMG_FORMATS = ("bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp")
VID_FORMATS = ("asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv")
CACHE_VERSION = "yolosomi-tpu-torch-0.1"
CACHE_SUFFIX = ".somi-torch.cache.json"
MAX_LABELS = 300  # target rows per image in a batch
PREFETCH = 2  # batches the loader keeps ready
_END = object()  # the prefetch queue's end marker
PLAN_KEYS = ("idx", "center", "offs", "srect", "minv")  # a plan's per-composite arrays, besides mixw


def img2label_paths(img_paths: List[str]) -> List[str]:
    """images/ -> labels/, *.jpg -> *.txt."""
    sa, sb = os.sep + "images" + os.sep, os.sep + "labels" + os.sep
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


def get_hash(paths: List[str]) -> str:
    """md5 of the path names and the total size of the files that exist."""
    size = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h = hashlib.md5(str(size).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


def list_images(path) -> List[str]:
    """Expand a directory, a .txt list of files or a glob (or a list of
    these) into a sorted list of image files."""
    files: List[str] = []
    for p in path if isinstance(path, list) else [path]:
        p = Path(p)
        if p.is_dir():
            files += glob.glob(str(p / "**" / "*.*"), recursive=True)
        elif p.is_file() and p.suffix == ".txt":
            parent = str(p.parent) + os.sep
            with open(p) as f:
                lines = f.read().strip().splitlines()
            files += [x.replace("./", parent) if x.startswith("./") else x for x in lines]
        elif p.is_file():
            files.append(str(p))
        else:
            files += glob.glob(str(p), recursive=True)
    imgs = sorted(x for x in files if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS)
    if not imgs:
        raise FileNotFoundError(f"no images found in {path}")
    return imgs


def verify_image_label(im_file: str, lb_file: str):
    """Validate one image/label pair. Returns (im_file, labels (n, 5),
    shape (w, h), missing, found, empty, corrupt, message); a corrupt pair
    returns None for the first three. Duplicate label rows are dropped."""
    nm = nf = ne = nc = 0
    msg = ""
    try:
        im = cv2.imread(im_file)
        if im is None:
            raise ValueError("unreadable image")
        shape = (im.shape[1], im.shape[0])  # (w, h)
        assert shape[0] > 9 and shape[1] > 9, f"image size {shape} <10 pixels"
        if os.path.isfile(lb_file):
            nf = 1
            with open(lb_file) as f:
                rows = [x.split() for x in f.read().strip().splitlines() if len(x)]
            lb = np.array(rows, dtype=np.float32) if rows else np.zeros((0, 5), np.float32)
            if len(lb):
                assert lb.shape[1] == 5, f"labels require 5 columns, got {lb.shape[1]}"
                assert (lb >= 0).all(), "negative label values"
                assert (lb[:, 1:] <= 1).all(), "non-normalized coordinates"
                _, idx = np.unique(lb, axis=0, return_index=True)
                if len(idx) < len(lb):
                    lb = lb[idx]
                    msg = f"{im_file}: removed {len(rows) - len(idx)} duplicate labels"
            else:
                ne = 1
        else:
            nm = 1
            lb = np.zeros((0, 5), np.float32)
        return im_file, lb, shape, nm, nf, ne, nc, msg
    except Exception as e:  # a bad file is reported and skipped, as the JAX loader does
        nc = 1
        return None, None, None, nm, nf, ne, nc, f"{im_file}: ignoring corrupt image/label: {e}"


class DetectionDataset:
    """An image list, its validated labels, and samples at `img_size`:
    letterboxed (eval), or augmented as the training set (`augment`, with
    the hyp's gains and probabilities). `rect` letterboxes each batch of
    `batch_size` aspect-sorted images to its own shape, a multiple of
    `stride` with `pad` strides to spare; `cache_images` decodes every
    image once and keeps it."""

    def __init__(self, path, img_size: int = 640, augment: bool = False, hyp: Optional[dict] = None,
                 rect: bool = False, max_labels: int = MAX_LABELS, batch_size: int = 16, stride: int = 32,
                 pad: float = 0.0, cache_images: bool = False):
        self.img_size = img_size
        self.augment = augment
        self.hyp = hyp or {}
        self.rect = rect
        self.stride = stride
        self.pad = pad
        self.max_labels = max_labels
        self.mosaic = augment and not rect
        self.mosaic_border = [-img_size // 2, -img_size // 2]
        self.albumentations = A.Albumentations() if augment else None
        self.img_files = list_images(path)
        self.label_files = img2label_paths(self.img_files)
        cache = self._load_or_build_cache(path)
        self.labels = [cache[f][0] for f in self.img_files]
        self.shapes = np.array([cache[f][1] for f in self.img_files], np.float64)  # (n, 2) (w, h)
        self.n = len(self.img_files)
        self.indices = np.arange(self.n)
        self.batch = np.floor(np.arange(self.n) / batch_size).astype(int)
        if rect:
            self._setup_rect()
        self.ims: List[Optional[np.ndarray]] = [None] * self.n
        if cache_images:
            for i in range(self.n):
                self.ims[i], _, _ = self.load_image(i)

    # -- caching --------------------------------------------------------

    @staticmethod
    def _cache_path(path) -> Path:
        p = Path(path if isinstance(path, str) else path[0])
        return (p if p.is_file() else p.parent).with_suffix(CACHE_SUFFIX)

    def _load_or_build_cache(self, path) -> dict:
        """{image file: (labels (n, 5) float32, (w, h))} of the valid pairs,
        read from the cache file when its version and hash match."""
        cache_path = self._cache_path(path)
        h = get_hash(self.label_files + self.img_files)
        if cache_path.exists():
            try:
                stored = json.loads(cache_path.read_text())
            except (OSError, ValueError):
                stored = {}
            if stored.get("version") == CACHE_VERSION and stored.get("hash") == h:
                # corrupt pairs were left out when the cache was built
                self.img_files = [f for f in self.img_files if f in stored["files"]]
                self.label_files = img2label_paths(self.img_files)
                return {f: (np.array(lb, np.float32).reshape(-1, 5), tuple(shape))
                        for f, (lb, shape) in stored["files"].items()}
        cache = {}
        nm = nf = ne = nc = 0
        keep_imgs, keep_lbls = [], []
        for im_file, lb_file in zip(self.img_files, self.label_files):
            f, lb, shape, m, fo, e, c, msg = verify_image_label(im_file, lb_file)
            nm, nf, ne, nc = nm + m, nf + fo, ne + e, nc + c
            if msg:
                LOGGER.warning(msg)
            if f is not None:
                cache[f] = (lb, shape)
                keep_imgs.append(im_file)
                keep_lbls.append(lb_file)
        self.img_files, self.label_files = keep_imgs, keep_lbls
        LOGGER.info(f"dataset: {nf} labels found, {nm} missing, {ne} empty, {nc} corrupt")
        stored = {"version": CACHE_VERSION, "hash": h,
                  "files": {f: (lb.tolist(), list(shape)) for f, (lb, shape) in cache.items()}}
        try:
            cache_path.write_text(json.dumps(stored))
        except OSError as e:  # a read-only dataset directory: run without a cache
            LOGGER.warning(f"cache not written to {cache_path}: {e}")
        return cache

    def _setup_rect(self) -> None:
        """Sort the images by aspect ratio h / w and give each batch the
        shape that holds its images' ratios: [h, w] in pixels, multiples
        of `stride`."""
        nb = self.batch[-1] + 1
        s = self.shapes  # (w, h)
        ar = s[:, 1] / s[:, 0]
        irect = ar.argsort()
        self.img_files = [self.img_files[i] for i in irect]
        self.label_files = [self.label_files[i] for i in irect]
        self.labels = [self.labels[i] for i in irect]
        self.shapes = s[irect]
        ar = ar[irect]
        shapes = [[1.0, 1.0]] * nb
        for i in range(nb):
            ari = ar[self.batch == i]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes[i] = [maxi, 1.0]
            elif mini > 1:
                shapes[i] = [1.0, 1.0 / mini]
        self.batch_shapes = np.ceil(np.array(shapes) * self.img_size / self.stride + self.pad).astype(int) * self.stride

    # -- samples ----------------------------------------------------------

    def load_image(self, i: int):
        """Image i as loaded, its long side resized to img_size (INTER_AREA
        when shrinking an eval image, else INTER_LINEAR), or as cached.
        Returns (image, (h0, w0), (h, w))."""
        im = self.ims[i]
        if im is not None:
            w0, h0 = self.shapes[i]
            return im, (int(h0), int(w0)), im.shape[:2]
        im = cv2.imread(self.img_files[i])
        if im is None:
            raise FileNotFoundError(f"image not found {self.img_files[i]}")
        h0, w0 = im.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            interp = cv2.INTER_AREA if r < 1 and not self.augment else cv2.INTER_LINEAR
            im = cv2.resize(im, (int(w0 * r), int(h0 * r)), interpolation=interp)
        return im, (h0, w0), im.shape[:2]

    @staticmethod
    def _mosaic_tile_rects(i: int, xc: int, yc: int, w: int, h: int, s: int):
        """Canvas and source rectangles of mosaic tile i (top left, top
        right, bottom left, bottom right) around the centre (xc, yc)."""
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        return (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b)

    def _perspective(self, img, labels, border=(0, 0)):
        hyp = self.hyp
        return A.random_perspective(img, labels, degrees=hyp.get("degrees", 0.0), translate=hyp.get("translate", 0.1),
                                    scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
                                    perspective=hyp.get("perspective", 0.0), border=border)

    def load_mosaic(self, index: int):
        """Image `index` and three drawn at random on a 2s x 2s canvas
        around a random centre; copy-reduce-paste, then the warp crops to
        s x s. Returns (image, (n, 5) [cls, x1, y1, x2, y2] pixels)."""
        s = self.img_size
        labels4 = []
        yc, xc = (int(random.uniform(-x, 2 * s + x)) for x in self.mosaic_border)
        indices = [index] + random.choices(list(self.indices), k=3)
        random.shuffle(indices)
        img4 = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
        for i, idx in enumerate(indices):
            img, _, (h, w) = self.load_image(idx)
            (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b) = self._mosaic_tile_rects(i, xc, yc, w, h, s)
            img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b
            labels = self.labels[idx].copy()
            if labels.size:
                labels[:, 1:] = xywhn2xyxy(labels[:, 1:], w, h, padw, padh)
            labels4.append(labels)
        labels4 = np.concatenate(labels4, 0)
        labels4[:, 1:] = labels4[:, 1:].clip(0, 2 * s)
        img4, labels4 = A.copy_reduce_paste(img4, labels4, p=self.hyp.get("copy_paste", 0.0))
        return self._perspective(img4, labels4, border=self.mosaic_border)

    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        """(image HWC uint8 BGR, labels (n, 5) [cls, xc, yc, w, h]
        normalized to the image, path, shapes). For a letterboxed image
        shapes is ((h0, w0), ((h / h0, w / w0), (padw, padh))) for
        scale_coords; for a mosaic it is None."""
        hyp = self.hyp
        if self.mosaic and random.random() < hyp.get("mosaic", 0.0):
            img, labels = self.load_mosaic(index)
            shapes = None
            if random.random() < hyp.get("mixup", 0.0):
                img, labels = A.mixup(img, labels, *self.load_mosaic(random.randint(0, self.n - 1)))
        else:
            img, (h0, w0), (h, w) = self.load_image(index)
            shape = self.batch_shapes[self.batch[index]] if self.rect else self.img_size
            img, ratio, pad = letterbox(img, shape, auto=False, scaleup=self.augment)
            shapes = (h0, w0), ((h / h0, w / w0), pad)
            labels = self.labels[index].copy()
            if labels.size:
                labels[:, 1:] = xywhn2xyxy(labels[:, 1:], ratio[0] * w, ratio[1] * h, padw=pad[0], padh=pad[1])
            if self.augment:
                img, labels = self._perspective(img, labels)
        nl = len(labels)
        if nl:
            labels[:, 1:5] = xyxy2xywhn(labels[:, 1:5], w=img.shape[1], h=img.shape[0], clip=True, eps=1e-3)
        if self.augment:
            img, labels = self.albumentations(img, labels)
            nl = len(labels)
            img = A.augment_hsv(img, hgain=hyp.get("hsv_h", 0.0), sgain=hyp.get("hsv_s", 0.0),
                                vgain=hyp.get("hsv_v", 0.0))
            if random.random() < hyp.get("flipud", 0.0):
                img = np.flipud(img)
                if nl:
                    labels[:, 2] = 1 - labels[:, 2]
            if random.random() < hyp.get("fliplr", 0.0):
                img = np.fliplr(img)
                if nl:
                    labels[:, 1] = 1 - labels[:, 1]
        return np.ascontiguousarray(img), labels.astype(np.float32), self.img_files[index], shapes

    # -- device-cache plans -------------------------------------------------

    def resized_hw(self, i: int):
        """(h, w) of image i after load_image's long-side resize, from the
        cached shapes without loading it."""
        w0, h0 = self.shapes[i]
        r = self.img_size / max(h0, w0)
        return (int(h0 * r), int(w0 * r)) if r != 1 else (int(h0), int(w0))

    def _warp_params(self, size: int, border):
        hyp = self.hyp
        return A.perspective_params(size, size, degrees=hyp.get("degrees", 0.0), translate=hyp.get("translate", 0.1),
                                    scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
                                    perspective=hyp.get("perspective", 0.0), border=border)

    def _plan_mosaic(self, index: int):
        """load_mosaic's draws and label geometry without pixels (the same
        draws in the same order). Returns (idx4, center, offs, srect, minv,
        labels xyxy), where offs (4, 2) holds each tile's (padw, padh),
        srect (4, 4) its source rectangle and minv the inverse warp."""
        s = self.img_size
        yc, xc = (int(random.uniform(-x, 2 * s + x)) for x in self.mosaic_border)
        indices = [index] + random.choices(list(self.indices), k=3)
        random.shuffle(indices)
        labels4 = []
        offs = np.zeros((4, 2), np.float32)
        srect = np.zeros((4, 4), np.float32)
        for i, idx in enumerate(indices):
            h, w = self.resized_hw(idx)
            (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b) = self._mosaic_tile_rects(i, xc, yc, w, h, s)
            padw, padh = x1a - x1b, y1a - y1b
            offs[i] = (padw, padh)
            srect[i] = (x1b, y1b, x2b, y2b)
            labels = self.labels[idx].copy()
            if labels.size:
                labels[:, 1:] = xywhn2xyxy(labels[:, 1:], w, h, padw, padh)
            labels4.append(labels)
        labels4 = np.concatenate(labels4, 0)
        labels4[:, 1:] = labels4[:, 1:].clip(0, 2 * s)
        M, sc, width, height = self._warp_params(2 * s, self.mosaic_border)
        labels4 = A.warp_labels(labels4, M, sc, width, height, self.hyp.get("perspective", 0.0))
        return (np.asarray(indices, np.int32), np.asarray([xc, yc], np.float32), offs, srect,
                np.linalg.inv(M).astype(np.float32), labels4)

    def _plan_letterbox(self, index: int):
        """The letterbox branch as a one-tile plan. The letterbox's resize
        (a ratio of S / (S - 1) where load_image truncated the long side)
        and pad are folded into the plan's matrix, so the pixels line up
        with the labels, which keep the host's ratio-based formula."""
        h, w = self.resized_hw(index)
        ratio, new_unpad, (dw, dh) = letterbox_params((h, w), self.img_size, scaleup=self.augment, auto=False)
        top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
        labels = self.labels[index].copy()
        if labels.size:
            labels[:, 1:] = xywhn2xyxy(labels[:, 1:], ratio[0] * w, ratio[1] * h, padw=dw, padh=dh)
        M, sc, width, height = self._warp_params(self.img_size, (0, 0))
        labels = A.warp_labels(labels, M, sc, width, height, self.hyp.get("perspective", 0.0))
        # cv2.resize to the rounded new_unpad maps centre-aligned pixels (dst = s * src + 0.5 * s - 0.5)
        sx, sy = new_unpad[0] / w, new_unpad[1] / h
        L = np.asarray([[sx, 0.0, 0.5 * sx - 0.5 + left], [0.0, sy, 0.5 * sy - 0.5 + top], [0.0, 0.0, 1.0]],
                       np.float64)
        center = np.asarray([1e9, 1e9], np.float32)  # tile 0 owns every pixel
        offs = np.zeros((4, 2), np.float32)
        srect = np.zeros((4, 4), np.float32)
        srect[0] = (0, 0, w, h)
        return (np.full(4, index, np.int32), center, offs, srect, np.linalg.inv(M @ L).astype(np.float32),
                labels)

    def plan_item(self, index: int):
        """__getitem__ for --cache device: every random draw and the label
        geometry on the host, in __getitem__'s order, and no pixels; the
        HSV jitter and the flips are drawn on the device. Returns (plan,
        labels xywhn, path, None); the plan's arrays have a leading pair
        axis, the second mosaic that mixup blends in (mixw 1: none)."""
        use_mosaic = self.mosaic and random.random() < self.hyp.get("mosaic", 0.0)
        first = self._plan_mosaic(index) if use_mosaic else self._plan_letterbox(index)
        labels, second, mixw = first[5], first[:5], 1.0
        if use_mosaic and random.random() < self.hyp.get("mixup", 0.0):
            *second, labels2 = self._plan_mosaic(random.randint(0, self.n - 1))
            mixw = float(np.random.beta(32.0, 32.0))
            labels = np.concatenate([labels, labels2], 0)
        if len(labels):
            labels = labels.copy()
            labels[:, 1:5] = xyxy2xywhn(labels[:, 1:5], w=self.img_size, h=self.img_size, clip=True, eps=1e-3)
        plan = {key: np.stack([a, b], 0) for key, a, b in zip(PLAN_KEYS, first[:5], second)}
        plan["mixw"] = np.float32(mixw)
        return plan, labels.astype(np.float32), self.img_files[index], None


def pad_targets(label_list, max_labels: int = MAX_LABELS) -> np.ndarray:
    """Per-image (n, 5) [cls, x, y, w, h] arrays -> (B, max_labels, 5),
    padded with rows of cls = -1 and zero boxes."""
    out = np.full((len(label_list), max_labels, 5), -1.0, np.float32)
    out[:, :, 1:] = 0.0
    for i, lab in enumerate(label_list):
        n = min(len(lab), max_labels)
        if n:
            out[i, :n] = lab[:n, :5]
    return out


def collate_batch(samples, max_labels: int = MAX_LABELS):
    """Samples -> (images (B, H, W, 3) uint8, targets (B, max_labels, 5),
    paths, shapes)."""
    imgs, labels, paths, shapes = zip(*samples)
    return np.stack(imgs, 0), pad_targets(list(labels), max_labels), list(paths), list(shapes)


def collate_plan_batch(samples, max_labels: int = MAX_LABELS):
    """Plan samples -> (plan of (B, 2, ...) arrays and mixw (B,), targets
    (B, max_labels, 5), paths, shapes)."""
    plans, labels, paths, shapes = zip(*samples)
    plan = {k: np.stack([p[k] for p in plans], 0) for k in plans[0]}
    return plan, pad_targets(list(labels), max_labels), list(paths), list(shapes)


def collate_batch4(samples, max_labels: int = MAX_LABELS, *, coins: np.ndarray):
    """The quad collate: each group of 4 samples becomes one image of twice
    the size, with probability 1/2 (`coins[g]` < 0.5, the caller's draw per
    group) the first image upscaled 2x (INTER_LINEAR), else the four pasted
    2 x 2 (i top left, i + 1 below it, i + 2 right, i + 3 diagonal), the
    labels shifted and halved. Returns images (B / 4, 2H, 2W, 3) uint8,
    targets (B / 4, 4 max_labels, 5), and the first B / 4 paths and
    shapes."""
    imgs, labels, paths, shapes = zip(*samples)
    n = len(imgs) // 4
    imgs4, labels4 = [], []
    for g in range(n):
        i = g * 4
        if coins[g] < 0.5:
            h, w = imgs[i].shape[:2]
            imgs4.append(cv2.resize(imgs[i], (2 * w, 2 * h), interpolation=cv2.INTER_LINEAR))
            labels4.append(labels[i])
        else:
            imgs4.append(np.concatenate([np.concatenate([imgs[i], imgs[i + 1]], 0),
                                         np.concatenate([imgs[i + 2], imgs[i + 3]], 0)], 1))
            merged = []
            for k, (ox, oy) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                lk = np.asarray(labels[i + k], np.float32).reshape(-1, 5).copy()
                lk[:, 1] = (lk[:, 1] + ox) * 0.5
                lk[:, 2] = (lk[:, 2] + oy) * 0.5
                lk[:, 3:5] *= 0.5
                merged.append(lk)
            labels4.append(np.concatenate(merged, 0))
    return np.stack(imgs4, 0), pad_targets(labels4, 4 * max_labels), list(paths[:n]), list(shapes[:n])


class DataLoader:
    """Batches of a DetectionDataset: in order, shuffled, or, where
    `sample_weights` is set (--image-weights), drawn with replacement by
    those weights, by numpy's generator of seed + epoch (the epoch counts
    the loader's iterations, from 1). Items load on a pool of `workers`
    threads (cv2 releases the GIL while it decodes and warps; default up
    to 8; 1 loads them in order on the batch thread) and a prefetch thread
    keeps `prefetch` batches ready (0: the batches are made in the
    consumer's thread). The last batch is filled up by wrapping to the
    start (a rect dataset's stays short), or dropped with `drop_last`.
    `quad` (with a batch size that 4 divides) collates each batch by
    collate_batch4 with coins from the same generator; `plan` yields the dataset's
    plans (plan_item, on the batch thread, whose draws stay in order).

    Data parallelism (`rank` of `world`): `batch_size` is the global
    batch. Every rank draws the same order (or image-weight draw) from seed
    + epoch and the same quad coins, and loads only its slice of each
    global batch, rows [rank B / world, (rank + 1) B / world) (quad: whole
    groups of 4, so the rank's quad images are those rows of the global
    quad batch); a rect batch keeps the global batch's shape. A plan
    loader yields the global batch's plans and targets on every rank (they
    carry no pixels, and planning all of them keeps every rank's host
    draws in the one-process order); the train step takes its rows."""

    def __init__(self, dataset: DetectionDataset, batch_size: int, shuffle: bool = False, prefetch: int = PREFETCH,
                 drop_last: bool = False, seed: int = 0, workers: Optional[int] = None, quad: bool = False,
                 plan: bool = False, rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"the global batch {batch_size} does not split over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle, self.prefetch, self.drop_last, self.seed = shuffle, prefetch, drop_last, seed
        self.workers = workers if workers is not None else min(8, os.cpu_count() or 1)
        self.quad = quad and batch_size % (4 * world) == 0
        self.plan = plan
        self.rank, self.world = rank, world
        self.sample_weights = None
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def _batches(self):
        n = len(self.dataset)
        idx = np.arange(n)
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.sample_weights is not None:
            w = np.asarray(self.sample_weights, np.float64)
            idx = rng.choice(n, size=n, p=w / w.sum())
        elif self.shuffle:
            rng.shuffle(idx)
        max_labels = getattr(self.dataset, "max_labels", MAX_LABELS)
        rect = getattr(self.dataset, "rect", False)
        pool = ThreadPoolExecutor(max_workers=self.workers) if self.workers > 1 and not self.plan else None
        getter = self.dataset.plan_item if self.plan else self.dataset.__getitem__
        try:
            for b in range(len(self)):
                sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                if len(sel) < self.batch_size and not rect:
                    sel = np.concatenate([sel, idx[: self.batch_size - len(sel)]])
                coins = rng.random(len(sel) // 4) if self.quad else None  # the global batch's, in group order
                if self.world > 1 and not self.plan:
                    sel = shard_batch(sel, self.rank, self.world)
                    coins = shard_batch(coins, self.rank, self.world) if coins is not None else None
                sel = [int(i) for i in sel]
                items = list(pool.map(getter, sel)) if pool else [getter(i) for i in sel]
                if self.plan:
                    yield collate_plan_batch(items, max_labels)
                elif self.quad:
                    yield collate_batch4(items, max_labels, coins=coins)
                else:
                    yield collate_batch(items, max_labels)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)

    def __iter__(self):
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        closed = threading.Event()  # set when the consumer is done, early or not

        def put(item) -> None:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def worker():
            try:
                for b in self._batches():
                    put(b)
                    if closed.is_set():
                        return
                put(_END)
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            closed.set()
            t.join()


class LoadImages:
    """Inference source of image files, a directory, a glob or videos.
    Yields (path, letterboxed HWC uint8 BGR, original image, the video
    capture or None) in file order, images before videos."""

    def __init__(self, path, img_size: int = 640, stride: int = 32, auto: bool = False):
        p = str(Path(path).resolve())
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "*.*")))
        elif os.path.isfile(p):
            files = [p]
        else:
            raise FileNotFoundError(f"{p} does not exist")
        images = [x for x in files if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS]
        videos = [x for x in files if x.rsplit(".", 1)[-1].lower() in VID_FORMATS]
        self.files = images + videos
        self.video_flag = [False] * len(images) + [True] * len(videos)
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        self.nf = len(self.files)
        self.mode = "image"
        self.cap = None
        if self.nf == 0:
            raise FileNotFoundError(f"no images or videos in {p}")
        if videos:
            self.cap = cv2.VideoCapture(videos[0])

    def __iter__(self):
        self.count = 0
        return self

    def __len__(self):
        return self.nf

    def __next__(self):
        if self.count == self.nf:
            raise StopIteration
        path = self.files[self.count]
        if self.video_flag[self.count]:
            self.mode = "video"
            ret, im0 = self.cap.read()
            if not ret:  # this video is done: on to the next file
                self.count += 1
                self.cap.release()
                if self.count == self.nf:
                    raise StopIteration
                path = self.files[self.count]
                self.cap = cv2.VideoCapture(path)
                ret, im0 = self.cap.read()
        else:
            self.count += 1
            im0 = cv2.imread(path)
            if im0 is None:
                raise FileNotFoundError(f"image not found {path}")
        img = letterbox(im0, self.img_size, stride=self.stride, auto=self.auto)[0]
        return path, np.ascontiguousarray(img), im0, self.cap


class LoadStreams:
    """Inference source of camera indices or stream URLs (one, a list, or a
    .txt of them), one reader thread per stream keeping its newest frame.
    Each step yields (sources, letterboxed batch (N, H, W, 3) uint8, the
    frames, None). `close()` stops the readers and releases the streams."""

    def __init__(self, sources, img_size: int = 640, stride: int = 32):
        if isinstance(sources, str) and os.path.isfile(sources) and sources.endswith(".txt"):
            with open(sources) as f:
                sources = [s.strip() for s in f.read().splitlines() if s.strip()]
        elif isinstance(sources, str):
            sources = [sources]
        self.sources = sources
        self.img_size = img_size
        self.stride = stride
        self.imgs = [None] * len(sources)
        self.caps = []
        self.threads = []
        self.running = threading.Event()
        self.running.set()
        for i, s in enumerate(sources):
            cap = cv2.VideoCapture(int(s) if s.isdigit() else s)
            self.caps.append(cap)
            ok = cap.isOpened()
            if ok:
                ok, self.imgs[i] = cap.read()
            if not ok:
                self.close()
                raise OSError(f"failed to read from stream {s}")
        for i, cap in enumerate(self.caps):
            t = threading.Thread(target=self._reader, args=(i, cap), daemon=True)
            t.start()
            self.threads.append(t)

    def _reader(self, i: int, cap):
        while self.running.is_set() and cap.isOpened():
            ok, frame = cap.read()
            if not ok:
                break
            self.imgs[i] = frame

    def __iter__(self):
        return self

    def __next__(self):
        frames = [im.copy() for im in self.imgs]
        batch = np.stack([letterbox(f, self.img_size, stride=self.stride, auto=False)[0] for f in frames])
        return self.sources, batch, frames, None

    def close(self):
        self.running.clear()
        for t in self.threads:
            t.join(timeout=5)
        for cap in self.caps:
            cap.release()
