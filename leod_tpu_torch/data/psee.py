"""Raw Prophesee recording readers (.dat Event2D / .npy events+boxes): a
copy of `leod_tpu/data/psee.py`.

The published Gen1/1Mpx releases ship events as binary ``.dat``
(Event2D: a ``%``-comment text header, two bytes of event type/size,
then packed 8-byte records of ``t:u4`` + a bit-packed word with
x in bits 0-13, y in bits 14-27, p in bit 28) or as structured ``.npy``
arrays, and labels as structured ``.npy`` box arrays.  The reference
reads these with a stateful file-handle streamer and an on-disk binary
search (utils/evaluation/prophesee/io/{dat_events_tools.py:23-117,
npy_events_tools.py:16-62, psee_loader.py:16-252, box_loading.py:27-44}).

Here the data region is ``np.memmap``-ed once, so time seeks are a
single ``np.searchsorted`` over the (strided) timestamp view and slices
decode lazily.  The stateful cursor API the reference exposes
(``load_n_events`` / ``load_delta_t`` / ``seek_time``) is kept, with
identical semantics, as a thin layer over the memmap.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .labels import PROPH_DTYPE

# decoded event record (matches psee_loader._decode_dtype for .dat)
EVENT_DTYPE = np.dtype([("t", "<u4"), ("x", "<u2"), ("y", "<u2"),
                        ("p", "u1")])
_DAT_RAW = np.dtype([("t", "<u4"), ("_", "<i4")])

_X_MASK = (1 << 14) - 1            # bits 0-13
_Y_MASK = ((1 << 14) - 1) << 14    # bits 14-27
_P_MASK = 1 << 28                  # bit 28


def parse_dat_header(f) -> Tuple[int, int, Tuple[Optional[int], Optional[int]]]:
    """Parse a .dat header: '%'-prefixed comment lines (may carry Height/
    Width), then one event-type byte and one event-size byte.  Returns
    (data offset, event size in bytes, (height, width))."""
    f.seek(0)
    height = width = None
    pos = 0
    saw_comment = False
    while True:
        pos = f.tell()
        line = f.readline()
        if not line.startswith(b"% "):
            break
        saw_comment = True
        words = line.split()
        if len(words) > 2 and words[1] == b"Height":
            height = int(words[2])
        if len(words) > 2 and words[1] == b"Width":
            width = int(words[2])
    f.seek(pos)
    if saw_comment:
        type_size = np.frombuffer(f.read(2), dtype=np.uint8)
        ev_size = int(type_size[1])
        pos = f.tell()
    else:  # headerless legacy files: Event2D assumed
        ev_size = _DAT_RAW.itemsize
    return pos, ev_size, (height, width)


def _decode_dat(raw: np.ndarray) -> np.ndarray:
    out = np.empty(raw.shape[0], dtype=EVENT_DTYPE)
    out["t"] = raw["t"]
    packed = raw["_"]
    out["x"] = (packed & _X_MASK).astype(np.uint16)
    out["y"] = ((packed & _Y_MASK) >> 14).astype(np.uint16)
    out["p"] = ((packed & _P_MASK) >> 28).astype(np.uint8)
    return out


def write_dat(path: str, events: np.ndarray, height: int = 240,
              width: int = 320) -> None:
    """Write EVENT_DTYPE-like events as a versioned Event2D .dat file
    (inverse of the reader; format per dat_events_tools.py:178-227)."""
    if max(height, width) > _X_MASK:
        raise ValueError("coordinates exceed the 14-bit .dat range")
    raw = np.empty(len(events), dtype=_DAT_RAW)
    raw["t"] = events["t"]
    raw["_"] = (events["x"].astype(np.int32)
                | (events["y"].astype(np.int32) << 14)
                | ((events["p"].astype(np.int32) != 0).astype(np.int32) << 28))
    with open(path, "wb") as f:
        f.write(b"% Data file containing Event2D events.\n% Version 2\n")
        f.write(f"% Height {height:d}\n% Width {width:d}\n".encode())
        np.array([0, _DAT_RAW.itemsize], dtype=np.uint8).tofile(f)
        raw.tofile(f)


def _npy_memmap(path: str) -> np.ndarray:
    arr = np.load(path, mmap_mode="r")
    if arr.dtype.fields is None:
        raise ValueError(f"{path}: expected a structured event array")
    # imerit back-compat renames (npy_events_tools.py:56-58)
    names = [{"ts": "t", "confidence": "class_confidence"}.get(n, n)
             for n in arr.dtype.names]
    if names != list(arr.dtype.names):
        arr = arr.view(np.dtype({
            "names": names,
            "formats": [arr.dtype.fields[n][0] for n in arr.dtype.names],
            "offsets": [arr.dtype.fields[n][1] for n in arr.dtype.names],
            "itemsize": arr.dtype.itemsize}))
    return arr


def load_boxes(path: str) -> np.ndarray:
    """Load a Prophesee label .npy into PROPH_DTYPE (box_loading.py:27-44);
    missing fields (track_id on Gen1) stay zero."""
    raw = _npy_memmap(path)
    out = np.zeros(len(raw), dtype=PROPH_DTYPE)
    for name in PROPH_DTYPE.names:
        if name in raw.dtype.names:
            out[name] = raw[name]
    return out


class RawEventReader:
    """Streams a raw .dat/.npy event recording with the PSEELoader cursor
    semantics (psee_loader.py:16-252): ``current_time`` is the timestamp
    at-or-after which the next event will be loaded; ``load_delta_t``
    returns events in ``[current_time, current_time + dt)``; ``done``
    flips once the cursor passes the last event."""

    def __init__(self, path: str):
        ext = os.path.splitext(path)[1]
        if ext == ".dat":
            with open(path, "rb") as f:
                offset, ev_size, self.size = parse_dat_header(f)
            if ev_size != _DAT_RAW.itemsize:
                raise ValueError(f"{path}: unsupported event size {ev_size}")
            nbytes = os.path.getsize(path) - offset
            if nbytes % ev_size:
                raise ValueError(f"{path}: truncated event data")
            self._raw = np.memmap(path, dtype=_DAT_RAW, mode="r",
                                  offset=offset, shape=(nbytes // ev_size,))
            self._decode = _decode_dat
        elif ext == ".npy":
            self._raw = _npy_memmap(path)
            self.size = (None, None)
            self._decode = lambda raw: np.asarray(raw)
        else:
            raise ValueError(f"{path}: expected .dat or .npy")
        self._cursor = 0          # index of the first not-yet-loaded event
        self.current_time = 0
        self.done = len(self._raw) == 0

    def __len__(self) -> int:
        return len(self._raw)

    @property
    def times(self) -> np.ndarray:
        """Timestamp view over the whole file (no copy for .npy; strided
        field view for .dat)."""
        return self._raw["t"]

    def total_time(self) -> int:
        return int(self.times[-1]) if len(self._raw) else 0

    def reset(self) -> None:
        self._cursor, self.current_time, self.done = 0, 0, len(self._raw) == 0

    def load_n_events(self, n: int) -> np.ndarray:
        start = self._cursor
        stop = min(start + n, len(self._raw))
        out = self._decode(self._raw[start:stop])
        self._cursor = stop
        if stop == len(self._raw):
            self.done = True
            self.current_time = self.total_time() + 1 if stop > start \
                else self.current_time
        else:
            self.current_time = int(self.times[stop])
        return out

    def load_delta_t(self, delta_t: int) -> np.ndarray:
        if delta_t < 1:
            raise ValueError("delta_t must be >= 1 us")
        if self.done:
            return self._decode(self._raw[0:0])
        final = self.current_time + delta_t
        stop = int(np.searchsorted(self.times, final, side="left"))
        out = self._decode(self._raw[self._cursor:stop])
        self._cursor = stop
        self.current_time = final
        self.done = stop >= len(self._raw)
        return out

    def seek_event(self, n: int) -> None:
        self._cursor = int(np.clip(n, 0, len(self._raw)))
        if n <= 0:
            self.current_time = 0
        elif self._cursor == len(self._raw):
            self.current_time = self.total_time() + 1
        else:
            self.current_time = int(self.times[self._cursor])
        self.done = self._cursor >= len(self._raw)

    def seek_time(self, t: int) -> None:
        if t > self.total_time():
            self._cursor = len(self._raw)
            self.current_time = self.total_time() + 1
            self.done = True
            return
        if t <= 0:
            self.reset()
            return
        self._cursor = int(np.searchsorted(self.times, t, side="left"))
        self.current_time = t
        self.done = self._cursor >= len(self._raw)
