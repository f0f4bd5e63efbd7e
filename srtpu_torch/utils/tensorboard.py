"""TensorBoard event files written by hand (srtpu's ``TBLogger``, which
writes through tensorboardX).

Neither tensorboard nor tensorboardX is a dependency of the port (where
they are installed, importing tensorboard can pull in TensorFlow and with
it JAX), so :class:`EventWriter` writes the file itself: TFRecord
framing (a little-endian u64 length, its masked CRC32C, the payload, the
payload's masked CRC32C) around ``Event`` protocol buffers encoded here
field by field, with ``Summary`` values of three kinds as tensorboardX
makes them:

* scalars: ``simple_value`` (f32), as ``add_scalar``;
* images: a PNG (:func:`~srtpu_torch.utils.logging.encode_png`) of
  ``uint8(clip(img, 0, 1) * 255)``, as ``add_image(..., dataformats='HWC')``;
* histograms: tensorboardX's ``make_histogram`` over its default
  ``bins='tensorflow'`` bucket limits (:func:`default_bins`).

The file is ``events.out.tfevents.<time>.<host>`` in the log directory
(``<root>/tensorboard_logs`` under the Trainer, as srtpu's) and starts
with the ``brain.Event:2`` version event. Writes are synchronous.
:func:`read_events` reads such a file back, checking every record's
CRCs.
"""

from __future__ import annotations

import re
import socket
import struct
import time
from pathlib import Path

import numpy as np

from .logging import encode_png

_CASTAGNOLI = 0x82F63B78        # CRC32C, reflected
_INVALID_TAG = re.compile(r'[^-/\w\.]')


def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_CASTAGNOLI if c & 1 else 0)
        table[i] = c
    return table


_TABLE = _crc_table()
_TABLE_LIST = [int(v) for v in _TABLE]


def _shift_one() -> np.ndarray:
    """The CRC register's linear map for one zero byte, as its 32 columns
    (column j: the image of bit j)."""
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return _TABLE[basis & 0xFF] ^ (basis >> np.uint32(8))


def _apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The GF(2) map with columns ``cols`` applied to every u32 in v."""
    out = np.zeros_like(v)
    for j in range(32):
        out ^= np.where((v >> np.uint32(j)) & np.uint32(1), cols[j],
                        np.uint32(0))
    return out


def _shift(n: int) -> np.ndarray:
    """The map for n zero bytes (square and multiply)."""
    result = np.uint32(1) << np.arange(32, dtype=np.uint32)    # identity
    power = _shift_one()
    while n:
        if n & 1:
            result = _apply(power, result)
        n >>= 1
        if n:
            power = _apply(power, power)
    return result


def _crc_serial(c: int, data) -> int:
    table = _TABLE_LIST
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of ``data``. Past 16 KB the bytes run as up
    to 4096 lanes in numpy, each lane's register from 0, and the lanes are
    joined pairwise by the zero-byte shift (the register is linear in the
    bytes and in its start value)."""
    n = len(data)
    lanes = 1 << max(0, min(12, (n // 64).bit_length() - 1))
    if n < 16384:
        return _crc_serial(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    width = n // lanes
    body = np.frombuffer(data, np.uint8, lanes * width).reshape(lanes,
                                                                  width)
    c = np.zeros(lanes, np.uint32)
    for j in range(width):
        c = _TABLE[(c ^ body[:, j]) & np.uint32(0xFF)] ^ (c >> np.uint32(8))
    shift = _shift(width)   # over one lane's bytes, then doubled
    while c.size > 1:       # (A, B) -> shift(A, |B|) ^ B
        c = _apply(shift, c[0::2]) ^ c[1::2]
        shift = _apply(shift, shift)
    start = _apply(shift, np.array([0xFFFFFFFF], np.uint32))    # over all
    c = int(start[0] ^ c[0])
    return _crc_serial(c, data[lanes * (n // lanes):]) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask of the CRC32C."""
    x = crc32c(data)
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(payload: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, payload, its masked CRC."""
    head = struct.pack('<Q', len(payload))
    return (head + struct.pack('<I', masked_crc32c(head)) + payload
            + struct.pack('<I', masked_crc32c(payload)))


# ------------------------------------------------------ protobuf, by hand

def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack('<d', v) if v else b''


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack('<f', v) if v else b''


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v)) if v else b''


def _packed_doubles(field: int, values) -> bytes:
    values = np.asarray(values, '<f8')
    return _bytes(field, values.tobytes()) if values.size else b''


def event(wall_time: float, step: int = 0, summary: bytes | None = None,
          file_version: str | None = None) -> bytes:
    """An ``Event``: wall_time (1), step (2), file_version (3), summary
    (5)."""
    out = _double(1, wall_time) + _int(2, step)
    if file_version is not None:
        out += _bytes(3, file_version.encode())
    if summary is not None:
        out += _bytes(5, summary)
    return out


def _value(tag: str, body: bytes) -> bytes:
    """A ``Summary`` holding one ``Summary.Value`` (tag, 1) with ``body``."""
    return _bytes(1, _bytes(1, clean_tag(tag).encode()) + body)


def clean_tag(tag: str) -> str:
    """tensorboardX's ``_clean_tag``: characters outside ``[-/\\w.]``
    become ``_``, leading slashes go."""
    return _INVALID_TAG.sub('_', tag).lstrip('/')


def scalar_summary(tag: str, value: float) -> bytes:
    return _value(tag, _float(2, float(value)))


def image_summary(tag: str, img_hwc) -> bytes:
    """Summary.Image (4): height, width, colorspace, the PNG of
    ``uint8(clip(img, 0, 1) * 255)`` (tensorboardX's truncation)."""
    arr = np.asarray(img_hwc)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255.0).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    h, w, c = arr.shape
    body = (_int(1, h) + _int(2, w) + _int(3, c)
            + _bytes(4, encode_png(np.ascontiguousarray(arr))))
    return _value(tag, _bytes(4, body))


def default_bins() -> list[float]:
    """tensorboardX's ``bins='tensorflow'``: +-1e-12 growing by 1.1 up to
    1e20, and 0."""
    v, buckets = 1e-12, []
    while v < 1e20:
        buckets.append(v)
        v *= 1.1
    return [-b for b in buckets[::-1]] + [0] + buckets


_BINS = default_bins()


def histogram_fields(values) -> dict:
    """tensorboardX's ``make_histogram`` over :func:`default_bins`: the
    support's counts with one empty bucket on its left, and min, max, num,
    sum, sum of squares in f64."""
    values = np.asarray(values, np.float64).reshape(-1)
    if values.size == 0:
        raise ValueError('The input has no element.')
    counts, limits = np.histogram(values, bins=_BINS)
    cum = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side='right')
    start, end = int(start), int(end) + 1
    counts = (counts[start - 1:end] if start > 0
              else np.concatenate([[0], counts[:end]]))
    limits = limits[start:end + 1]
    return dict(min=float(values.min()), max=float(values.max()),
                num=float(values.size), sum=float(values.sum()),
                sum_squares=float(values.dot(values)),
                bucket_limit=limits, bucket=counts.astype(np.float64))


def histogram_summary(tag: str, values) -> bytes:
    f = histogram_fields(values)
    body = (_double(1, f['min']) + _double(2, f['max'])
            + _double(3, f['num']) + _double(4, f['sum'])
            + _double(5, f['sum_squares'])
            + _packed_doubles(6, f['bucket_limit'])
            + _packed_doubles(7, f['bucket']))
    return _value(tag, _bytes(5, body))


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, i
        shift += 7


def _fields(buf: bytes) -> list[tuple[int, object]]:
    """A protobuf message's (field, value) pairs: varints as ints, fixed64
    as f64, fixed32 as f32, length-delimited as bytes."""
    out, i = [], 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = struct.unpack_from('<d', buf, i)[0], i + 8
        elif wire == 5:
            v, i = struct.unpack_from('<f', buf, i)[0], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f'protobuf wire type {wire} at byte {i}')
        out.append((field, v))
    return out


def _value_dict(buf: bytes) -> dict:
    out: dict = {}
    for field, v in _fields(buf):
        if field == 1:
            out['tag'] = v.decode()
        elif field == 2:
            out['simple_value'] = v
        elif field == 4:
            img = dict(_fields(v))
            out['image'] = {'height': img.get(1, 0), 'width': img.get(2, 0),
                            'colorspace': img.get(3, 0), 'png': img.get(4)}
        elif field == 5:
            h = dict(_fields(v))
            out['histo'] = {
                **{k: h.get(f, 0.0) for f, k in enumerate(
                    ('min', 'max', 'num', 'sum', 'sum_squares'), 1)},
                'bucket_limit': np.frombuffer(h.get(6, b''), '<f8'),
                'bucket': np.frombuffer(h.get(7, b''), '<f8')}
    return out


def read_events(path) -> list[dict]:
    """The events of an event file, each record's CRCs checked (raises on a
    mismatch): ``{'wall_time', 'step', 'file_version', 'values'}``, each
    value ``{'tag'}`` and one of ``simple_value``, ``image`` (height,
    width, colorspace, png) and ``histo`` (min, max, num, sum,
    sum_squares, bucket_limit, bucket)."""
    data, events, i = Path(path).read_bytes(), [], 0
    while i < len(data):
        head = data[i:i + 8]
        n, = struct.unpack('<Q', head)
        body = data[i + 12:i + 12 + n]
        if (struct.unpack('<I', data[i + 8:i + 12])[0] != masked_crc32c(head)
                or struct.unpack('<I', data[i + 12 + n:i + 16 + n])[0]
                != masked_crc32c(body)):
            raise ValueError(f'{path}: record at byte {i} fails its CRC')
        ev = {'wall_time': 0.0, 'step': 0, 'file_version': None,
              'values': []}
        for field, v in _fields(body):
            if field == 1:
                ev['wall_time'] = v
            elif field == 2:
                ev['step'] = v
            elif field == 3:
                ev['file_version'] = v.decode()
            elif field == 5:
                ev['values'] += [_value_dict(val)
                                 for f, val in _fields(v) if f == 1]
        events.append(ev)
        i += 16 + n
    return events


class EventWriter:
    """An event file in ``log_dir``: srtpu's ``TBLogger`` (scalars, images)
    and its weight histograms."""

    def __init__(self, log_dir: str | Path):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.path = log_dir / (f'events.out.tfevents.{str(time.time())[:10]}'
                               f'.{socket.gethostname()}')
        self._fh = open(self.path, 'ab')
        self._write(event(time.time(), file_version='brain.Event:2'))

    def _write(self, payload: bytes) -> None:
        self._fh.write(record(payload))

    def _summary(self, summary: bytes, step: int) -> None:
        self._write(event(time.time(), int(step), summary))

    def scalars(self, values: dict, step: int) -> None:
        for tag, v in values.items():
            self._summary(scalar_summary(tag, float(v)), step)

    def image(self, tag: str, img, step: int) -> None:
        self._summary(image_summary(tag, img), step)

    def histogram(self, tag: str, values, step: int) -> None:
        self._summary(histogram_summary(tag, values), step)

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
