"""The native AP matcher (``ap_matcher.cpp``): build with g++ and bind with
ctypes.

The library goes into ``pqdet_tpu_torch/_build/`` (git-ignored), named by
a hash of its source; each process compiles to a temporary name of its own
and moves it into place with ``os.replace``, so processes building at once
never write one file. A failed build raises: the evaluator's Python
matcher runs only when its caller asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'ap_matcher.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
CXX_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']

_LOCK = threading.Lock()
_LIB = []


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + ' '.join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'libap_matcher_{tag}.so'


def build() -> Path:
    """The library's path, compiled first if it is not there."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    res = subprocess.run(['g++', *CXX_FLAGS, str(SOURCE), '-o', str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f'g++ could not build {SOURCE.name} '
                           f'(exit {res.returncode}):\n{res.stderr[:2000]}')
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    with _LOCK:
        if not _LIB:
            lib = ctypes.CDLL(str(build()))
            lib.match_class.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.match_class.restype = None
            _LIB.append(lib)
        return _LIB[0]


def match_class(det_boxes: np.ndarray, det_set: np.ndarray,
                gt_boxes: np.ndarray, gt_diff: np.ndarray,
                set_offsets: np.ndarray, thresholds: np.ndarray):
    """Run the greedy matcher; returns (tp, fp), each (n_iou, n_det)
    float64. Inputs follow the layout documented in ap_matcher.cpp."""
    lib = _lib()
    n_det = len(det_boxes)
    n_iou = len(thresholds)
    total_gt = len(gt_boxes)
    if len(det_set) != n_det or len(gt_diff) != total_gt \
            or (len(set_offsets) and set_offsets[-1] != total_gt):
        raise ValueError('match_class: inconsistent detection or GT table sizes')
    det_boxes = np.ascontiguousarray(det_boxes, np.float32).reshape(-1, 4)
    det_set = np.ascontiguousarray(det_set, np.int32)
    gt_boxes = np.ascontiguousarray(gt_boxes.reshape(-1, 4), np.float32) \
        if total_gt else np.zeros((1, 4), np.float32)
    gt_diff_c = np.ascontiguousarray(gt_diff, np.uint8) if total_gt \
        else np.zeros(1, np.uint8)
    set_offsets = np.ascontiguousarray(set_offsets, np.int32)
    thresholds = np.ascontiguousarray(thresholds, np.float64)
    seen = np.zeros((n_iou, max(total_gt, 1)), np.uint8)
    tp = np.zeros((n_iou, max(n_det, 1)), np.uint8)
    fp = np.zeros((n_iou, max(n_det, 1)), np.uint8)

    def ptr(arr, ct):
        return arr.ctypes.data_as(ctypes.POINTER(ct))

    lib.match_class(
        ptr(det_boxes, ctypes.c_float), ptr(det_set, ctypes.c_int32), n_det,
        ptr(gt_boxes, ctypes.c_float), ptr(gt_diff_c, ctypes.c_uint8),
        ptr(set_offsets, ctypes.c_int32),
        ptr(thresholds, ctypes.c_double), n_iou, total_gt,
        ptr(seen, ctypes.c_uint8), ptr(tp, ctypes.c_uint8), ptr(fp, ctypes.c_uint8))
    return tp[:, :n_det].astype(np.float64), fp[:, :n_det].astype(np.float64)
