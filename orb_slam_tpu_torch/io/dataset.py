"""Datasets: image-directory and video sources with background prefetch.

Port of orb_slam_tpu/io/dataset.py:17-109 (`ImageDirDataset`,
`VideoDataset`, `PrefetchIterator`, `_load_gray`, `open_dataset`),
copied: it replaces the reference's ROS image subscription
(src/Tracking.cc:160-166) with a host-side reader thread that decodes
frames ahead of the device. `_load_gray` reads binary 8-bit PGM (`P5`)
with numpy (`read_pgm`, the same pixels as cv2 and PIL), so that a PGM
directory needs neither library; `write_pgm` writes one. Any other file
goes, as in JAX, to cv2 first, then PIL, and without either it raises,
naming both.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np


class ImageDirDataset:
    """Sorted image files in a directory (png/jpg/pgm), grayscale float32."""

    EXTS = (".png", ".jpg", ".jpeg", ".pgm", ".bmp", ".tif", ".tiff")

    def __init__(self, path: str, timestamps: str | None = None):
        self.files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.lower().endswith(self.EXTS)
        )
        self.timestamps = None
        if timestamps and os.path.exists(timestamps):
            self.timestamps = np.loadtxt(timestamps, usecols=0)

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for i, f in enumerate(self.files):
            img = _load_gray(f)
            ts = (
                float(self.timestamps[i])
                if self.timestamps is not None and i < len(self.timestamps)
                else i / 30.0
            )
            yield ts, img


class VideoDataset:
    """Video file via cv2."""

    def __init__(self, path: str, fps: float = 30.0):
        import cv2

        self.cap = cv2.VideoCapture(path)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or fps

    def __iter__(self):
        import cv2

        i = 0
        while True:
            ok, frame = self.cap.read()
            if not ok:
                break
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)
            yield i / self.fps, gray
            i += 1


class PrefetchIterator:
    """Wrap any (ts, img) iterable with an N-deep background decode thread."""

    def __init__(self, source, depth: int = 4):
        self.q = queue.Queue(maxsize=depth)
        self.thread = threading.Thread(
            target=self._worker, args=(source,), daemon=True
        )
        self.thread.start()

    def _worker(self, source):
        for item in source:
            self.q.put(item)
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item


def read_pgm(path: str) -> np.ndarray:
    """[H, W] uint8 pixels of a binary 8-bit PGM (`P5`, maxval < 256;
    `#` comments allowed in the header)."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P5":
        raise ValueError(f"{path}: not a binary PGM (magic {fields[0]!r})")
    w, h, maxval = (int(x) for x in fields[1:])
    if maxval >= 256:
        raise ValueError(f"{path}: 16-bit PGM (maxval {maxval}) is not read")
    pos += 1  # the single whitespace after maxval
    return np.frombuffer(data, np.uint8, count=w * h, offset=pos).reshape(h, w)


def write_pgm(path: str, img):
    """Write [H, W] values in [0, 255] as a binary 8-bit PGM."""
    a = np.clip(np.rint(np.asarray(img, np.float64)), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        f.write(a.tobytes())


def _load_gray(path: str) -> np.ndarray:
    if path.lower().endswith(".pgm"):
        try:
            return read_pgm(path).astype(np.float32)
        except ValueError:
            pass  # an ASCII or 16-bit PGM: cv2 or PIL reads it
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is not None:
            return img.astype(np.float32)
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path}: reading this format needs cv2 (opencv-python) "
                          f"or PIL (pillow); without them only binary PGM is read")
    return np.asarray(Image.open(path).convert("L"), np.float32)


def open_dataset(path: str, **kw):
    if os.path.isdir(path):
        return ImageDirDataset(path, **kw)
    if path.lower().endswith((".mp4", ".avi", ".mov", ".mkv")):
        return VideoDataset(path)
    raise ValueError(f"unsupported dataset path: {path}")
