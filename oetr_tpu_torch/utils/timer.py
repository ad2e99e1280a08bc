"""Timing and frame sources (port of ``oetr_tpu/utils/timer.py``):
``AverageTimer``, an exponential moving average of per-stage wall times
with an FPS print, and ``VideoStreamer``, grayscale frames from an image
directory, a video file or a camera (cv2, imported where a source is
opened or read).
"""
from __future__ import annotations

import glob
import os
import time

import numpy as np


class AverageTimer:
    """Exponential-moving-average stage timer."""

    def __init__(self, smoothing: float = 0.3, newline: bool = False):
        self.smoothing = smoothing
        self.newline = newline
        self.times: dict[str, float] = {}
        self.will_print: dict[str, bool] = {}
        self.reset()

    def reset(self):
        now = time.time()
        self.start = now
        self.last_time = now
        for name in self.will_print:
            self.will_print[name] = False

    def update(self, name: str = "default"):
        now = time.time()
        dt = now - self.last_time
        if name in self.times:
            dt = self.smoothing * dt + (1 - self.smoothing) * self.times[name]
        self.times[name] = dt
        self.will_print[name] = True
        self.last_time = now

    def print(self, text: str = "Timer"):
        total = 0.0
        msg = f"[{text}]"
        for key in self.times:
            if self.will_print.get(key):
                msg += f" {key}={self.times[key]:.3f}"
                total += self.times[key]
        msg += f" total={total:.3f} sec {1.0 / max(total, 1e-9):.1f} FPS"
        print(msg, end="\n" if self.newline else "\r", flush=True)
        self.reset()


class VideoStreamer:
    """Frames from an image glob in a directory, a video file or a camera
    id, as float32 grayscale in [0, 1] (resized to ``resize`` (h, w))."""

    def __init__(self, basedir: str, resize: tuple[int, int] | None = None,
                 image_glob: str = "*.jpg", max_length: int = 1_000_000):
        self.resize = resize
        self.max_length = max_length
        self.i = 0
        self.cap = None
        self.listing: list[str] = []
        if isinstance(basedir, int) or basedir.isdigit():
            import cv2
            self.cap = cv2.VideoCapture(int(basedir))
        elif os.path.isdir(basedir):
            self.listing = sorted(glob.glob(os.path.join(basedir,
                                                         image_glob)))
            self.listing = self.listing[:max_length]
        elif os.path.isfile(basedir):
            import cv2
            self.cap = cv2.VideoCapture(basedir)
        else:
            raise ValueError(f"no such source: {basedir}")

    def _process(self, frame):
        import cv2

        if frame is None:
            return None
        if frame.ndim == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        if self.resize is not None:
            frame = cv2.resize(frame, self.resize[::-1])
        return frame.astype(np.float32) / 255.0

    def next_frame(self):
        """(frame or None, ok)."""
        if self.cap is not None:
            if self.i >= self.max_length:
                return None, False
            ok, frame = self.cap.read()
            self.i += 1
            return (self._process(frame), True) if ok else (None, False)
        if self.i >= len(self.listing):
            return None, False
        import cv2

        frame = cv2.imread(self.listing[self.i], cv2.IMREAD_GRAYSCALE)
        self.i += 1
        return self._process(frame), True
