"""Video decoding: the ctypes binding of native/decoder/libmofo_decoder.so
(FFmpeg), with OpenCV as the fallback.

The counterpart of mofo_tpu/data/video_reader.py (the same C signatures,
backends and errors), which replaces the reference's decord usage
(kinetics.py:485-490): open -> len / fps -> get_batch(frame_ids) -> (N, H,
W, 3) uint8 RGB. As with decord's width / height arguments, an output size
may be asked for, and the native code scales while it decodes.

The library is loaded where it lies in the repository (native/decoder/,
built by `make -C native/decoder`); it needs FFmpeg's shared libraries
(libavformat, libavcodec, libswscale). If it is missing or does not load,
native_available() is False and backend "auto" opens the file with cv2,
which is imported only then.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "native", "decoder", "libmofo_decoder.so")

_lib = None
_lib_checked = False


def _load_library():
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:  # missing, or FFmpeg's libraries do not resolve
        return None
    lib.mofo_open.restype = ctypes.c_void_p
    lib.mofo_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.mofo_num_frames.restype = ctypes.c_int
    lib.mofo_num_frames.argtypes = [ctypes.c_void_p]
    lib.mofo_fps.restype = ctypes.c_double
    lib.mofo_fps.argtypes = [ctypes.c_void_p]
    lib.mofo_width.restype = ctypes.c_int
    lib.mofo_width.argtypes = [ctypes.c_void_p]
    lib.mofo_height.restype = ctypes.c_int
    lib.mofo_height.argtypes = [ctypes.c_void_p]
    lib.mofo_get_batch.restype = ctypes.c_int
    lib.mofo_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte)]
    lib.mofo_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_library() is not None


class VideoReader:
    """Decodes frames of one video file.

    backend: 'auto' (native if available, else opencv), 'native', 'opencv'.
    width / height: decode-time scaling (0 = the source size).
    """

    def __init__(self, path: str, width: int = 0, height: int = 0,
                 backend: str = "auto"):
        self.path = path
        self._handle = None
        self._cap = None
        self._backend = None
        if not os.path.exists(path):
            raise FileNotFoundError(path)

        if backend in ("auto", "native"):
            lib = _load_library()
            if lib is not None:
                handle = lib.mofo_open(path.encode(), int(width), int(height))
                if handle:
                    self._handle = handle
                    self._backend = "native"
                elif backend == "native":
                    raise RuntimeError(f"native decoder failed on {path}")
        if self._backend is None:
            if backend == "native":
                raise RuntimeError("native decoder library unavailable")
            import cv2

            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise RuntimeError(f"opencv failed to open {path}")
            self._backend = "opencv"
            self._out_w = int(width) or int(
                self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self._out_h = int(height) or int(
                self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
            self._fps = float(self._cap.get(cv2.CAP_PROP_FPS))

    @property
    def backend(self) -> str:
        return self._backend

    def __len__(self) -> int:
        if self._backend == "native":
            return _lib.mofo_num_frames(self._handle)
        return self._n

    def get_avg_fps(self) -> float:
        if self._backend == "native":
            return _lib.mofo_fps(self._handle)
        return self._fps

    @property
    def frame_size(self):
        if self._backend == "native":
            return (_lib.mofo_height(self._handle),
                    _lib.mofo_width(self._handle))
        return (self._out_h, self._out_w)

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """(N, H, W, 3) uint8 RGB frames at the given indices."""
        indices = np.asarray(indices, dtype=np.int64)
        if self._backend == "native":
            h, w = self.frame_size
            out = np.empty((len(indices), h, w, 3), dtype=np.uint8)
            idx_arr = indices.astype(ctypes.c_long)
            ret = _lib.mofo_get_batch(
                self._handle,
                idx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                len(indices),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
            if ret != 0:
                raise RuntimeError(
                    f"native decode failed ({ret}) on {self.path} "
                    f"indices {indices[:8]}...")
            return out
        return self._opencv_batch(indices)

    def _opencv_batch(self, indices: np.ndarray) -> np.ndarray:
        import cv2

        order = np.argsort(indices)
        frames = {}
        pos = -1
        for i in order:
            idx = int(indices[i])
            if idx in frames:
                continue
            if idx != pos + 1:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = self._cap.read()
            if not ok:
                raise RuntimeError(
                    f"opencv decode failed on {self.path} frame {idx}")
            pos = idx
            if (frame.shape[0], frame.shape[1]) != (self._out_h,
                                                    self._out_w):
                frame = cv2.resize(frame, (self._out_w, self._out_h))
            frames[idx] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return np.stack([frames[int(i)] for i in indices])

    def close(self):
        if self._backend == "native" and self._handle:
            _lib.mofo_close(self._handle)
            self._handle = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
