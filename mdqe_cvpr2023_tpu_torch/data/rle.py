"""COCO-style RLE mask codec (column-major run lengths with the LEB-style
string encoding), the port's own copy of ``mdqe_cvpr2023_tpu/data/rle.py``:
encode, decode, area, merge and IoU over the standard COCO ``counts`` format,
interoperable with YTVIS/OVIS annotation and result files.

Run extraction and the boolean ops are numpy interval sweeps. The
counts <-> string codec has a C++ fast path, ``native/rle_codec.cc``, built at
first use by ``ops/_build.build_host`` with the host C++ compiler and bound
with ``ctypes``; without a compiler the pure-Python codec
(``counts_to_string_py``, ``string_to_counts_py``) serves. Both give the same
strings and counts.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence

import numpy as np

from ..ops import _build

# ---------------------------------------------------------------------------
# counts <-> string codec (COCO LEB-style, 5 data bits + continuation per char)
# ---------------------------------------------------------------------------

_LIB = None  # the loaded codec library, False when it cannot be built
_LIB_LOCK = threading.Lock()  # loader worker threads decode concurrently


def load_native():
    """The native codec library, built on first use; None where the host has
    no C++ compiler or the build fails."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            try:
                lib = ctypes.CDLL(str(_build.build_host("rle_codec")))
            except (RuntimeError, OSError):
                _LIB = False
            else:
                i64p = ctypes.POINTER(ctypes.c_int64)
                lib.rle_to_string.argtypes = [i64p, ctypes.c_long, ctypes.c_char_p]
                lib.rle_to_string.restype = ctypes.c_long
                lib.rle_from_string.argtypes = [ctypes.c_char_p, ctypes.c_long, i64p]
                lib.rle_from_string.restype = ctypes.c_long
                _LIB = lib
    return _LIB or None


def counts_to_string_py(counts: Sequence[int]) -> str:
    chars = []
    counts = [int(c) for c in counts]
    for i in range(len(counts)):
        x = counts[i]
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            chars.append(chr(c + 48))
    return "".join(chars)


def string_to_counts_py(s: str) -> np.ndarray:
    counts: List[int] = []
    pos = 0
    while pos < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[pos]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            pos += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.int64)


def counts_to_string(counts: Sequence[int]) -> str:
    lib = load_native()
    if not lib:
        return counts_to_string_py(counts)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    out = ctypes.create_string_buffer(len(counts) * 13 + 16)  # 13 chars hold 64 bits
    n = lib.rle_to_string(counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                          len(counts), out)
    return out.raw[:n].decode("ascii")


def string_to_counts(s: str) -> np.ndarray:
    lib = load_native()
    if not lib:
        return string_to_counts_py(s)
    b = s.encode("ascii")
    out = np.empty(len(b) + 1, dtype=np.int64)
    n = lib.rle_from_string(b, len(b), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out[:n]


# ---------------------------------------------------------------------------
# core run-length ops (numpy boundary formulation)
# ---------------------------------------------------------------------------

def encode(mask: np.ndarray) -> Dict:
    """mask (H, W) bool/uint8 -> {'size': [H, W], 'counts': str} (column-major)."""
    H, W = mask.shape
    flat = np.asfortranarray(mask.astype(bool)).reshape(-1, order="F")
    return {"size": [int(H), int(W)], "counts": counts_to_string(_runs(flat))}


def _runs(flat: np.ndarray) -> np.ndarray:
    """bool (N,) -> run lengths starting with a 0-run (possibly length 0)."""
    n = flat.size
    if n == 0:
        return np.zeros(1, np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [n]])
    runs = np.diff(bounds).astype(np.int64)
    if flat[0]:
        runs = np.concatenate([[0], runs])
    return runs


def _counts(rle: Dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    if isinstance(counts, str):
        counts = string_to_counts(counts)
    return np.asarray(counts, np.int64)


def decode(rle: Dict) -> np.ndarray:
    """{'size', 'counts'} -> (H, W) uint8 mask."""
    H, W = rle["size"]
    counts = _counts(rle)
    runs = np.repeat((np.arange(len(counts)) % 2).astype(np.uint8), counts)  # odd: foreground
    flat = np.zeros(H * W, np.uint8)
    flat[:runs.size] = runs[:H * W]  # counts that miss or pass H * W, as the JAX codec
    return flat.reshape(H, W, order="F")


def _to_bounds(counts: np.ndarray):
    """Run lengths -> (starts, ends) of foreground intervals."""
    ends = np.cumsum(counts)
    starts = ends - counts
    return starts[1::2], ends[1::2]


def area(rle: Dict) -> int:
    return int(_counts(rle)[1::2].sum())


def _interval_intersection(s1, e1, s2, e2) -> int:
    """Total overlap length of two sorted disjoint lists of half-open
    intervals, by one sweep over their sorted end points: between two
    consecutive points the coverage is the running sum of +1 (start) and -1
    (end), and the overlap is where it is 2."""
    if len(s1) == 0 or len(s2) == 0:
        return 0
    pos = np.concatenate([s1, e1, s2, e2])
    step = np.concatenate([np.ones(len(s1), np.int64), -np.ones(len(e1), np.int64),
                           np.ones(len(s2), np.int64), -np.ones(len(e2), np.int64)])
    order = np.argsort(pos, kind="stable")
    pos, cover = pos[order], np.cumsum(step[order])
    return int(np.diff(pos)[cover[:-1] == 2].sum())


def intersection_area(rle1: Dict, rle2: Dict) -> int:
    s1, e1 = _to_bounds(_counts(rle1))
    s2, e2 = _to_bounds(_counts(rle2))
    return _interval_intersection(s1, e1, s2, e2)


def iou(rle1: Dict, rle2: Dict, iscrowd: bool = False) -> float:
    a1 = area(rle1)
    a2 = area(rle2)
    inter = intersection_area(rle1, rle2)
    denom = a1 if iscrowd else a1 + a2 - inter
    return inter / denom if denom > 0 else 0.0


def video_iou(dt_rles: Sequence[Dict], gt_rles: Sequence[Dict],
              iscrowd: bool = False) -> float:
    """Video-level IoU: per-frame intersections and unions summed over the
    track, then divided. None entries are absent in that frame."""
    inter_sum = 0
    union_sum = 0
    for d, g in zip(dt_rles, gt_rles):
        da = area(d) if d is not None else 0
        ga = area(g) if g is not None else 0
        inter = intersection_area(d, g) if (d is not None and g is not None) else 0
        inter_sum += inter
        union_sum += (ga if iscrowd else da + ga - inter)
    return inter_sum / union_sum if union_sum > 0 else 0.0


def merge(rles: Sequence[Dict], intersect: bool = False) -> Dict:
    """Union (or intersection) of RLE masks, by rasterizing."""
    if not rles:
        raise ValueError("merge needs at least one mask")
    acc = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = decode(r).astype(bool)
        acc = acc & m if intersect else acc | m
    return encode(acc)


def encode_mask_batch(masks: np.ndarray) -> List[Dict]:
    """(N, H, W) bool -> list of RLE dicts."""
    return [encode(m) for m in masks]
