"""Minimal OpenEXR codec (CoFusion depth ingest); the port's own copy of
`nice_slam_tpu/io/exr.py`.

CoFusion ships its depth maps as EXR, read through the 'Y' channel; no EXR
library is needed.  The subset of the format implemented:

  * single-part scanline images, little-endian;
  * pixel types HALF and FLOAT;
  * compression NONE, ZIPS (1 line/chunk) and ZIP (16 lines/chunk) -- ZIP
    is what CoFusion ships;
  * the reader returns every channel; `read_exr_depth` the 'Y' channel if
    present, else the alphabetically first one.

The ZIP codec is zlib deflate over delta-predicted, two-way interleaved
bytes (OpenEXR ImfZip.cpp): uncompress = inflate -> integrate the byte
deltas -> interleave the two buffer halves; compress is the reverse.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPE = {1: np.dtype('<f2'), 2: np.dtype('<f4')}  # HALF, FLOAT
# supported compressions only: NONE / ZIPS / ZIP (RLE=1, PIZ=4... are
# rejected with an IOError at the header check)
_LINES_PER_CHUNK = {0: 1, 2: 1, 3: 16}


def _unpredict_and_interleave(data: bytes) -> np.ndarray:
    d = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    d[1:] -= 128
    s = np.cumsum(d) % 256
    out = np.empty_like(s)
    half = (len(s) + 1) // 2
    out[0::2] = s[:half]
    out[1::2] = s[half:]
    return out.astype(np.uint8)


def _deinterleave_and_predict(raw: np.ndarray) -> bytes:
    half = (len(raw) + 1) // 2
    t = np.empty_like(raw)
    t[:half] = raw[0::2]
    t[half:] = raw[1::2]
    d = t.astype(np.int64)
    d[1:] = d[1:] - d[:-1] + 128
    return (d % 256).astype(np.uint8).tobytes()


def _read_attrs(f):
    attrs = {}
    while True:
        name = _read_cstr(f)
        if name == '':
            return attrs
        typ = _read_cstr(f)
        size = struct.unpack('<i', f.read(4))[0]
        attrs[name] = (typ, f.read(size))


def _read_cstr(f) -> str:
    out = b''
    while True:
        c = f.read(1)
        if c in (b'', b'\x00'):
            return out.decode('latin-1')
        out += c


def _parse_chlist(data: bytes):
    """-> [(name, pixel_type)] in file (alphabetical) order."""
    chans = []
    i = 0
    while data[i] != 0:
        j = data.index(b'\x00', i)
        name = data[i:j].decode('latin-1')
        ptype = struct.unpack_from('<i', data, j + 1)[0]
        chans.append((name, ptype))
        i = j + 1 + 16   # type(4) + pLinear+fill(4) + xSampling(4) + ySampling(4)
    return chans


def read_exr(path: str) -> dict[str, np.ndarray]:
    """Read all channels of a scanline EXR -> {name: [H, W] float32}."""
    with open(path, 'rb') as f:
        magic, version = struct.unpack('<ii', f.read(8))
        if magic != _MAGIC:
            raise IOError(f'{path}: not an EXR file')
        if version & 0x200:
            raise IOError(f'{path}: tiled EXR not supported')
        attrs = _read_attrs(f)
        chans = _parse_chlist(attrs['channels'][1])
        comp = attrs['compression'][1][0]
        if comp not in _LINES_PER_CHUNK:
            raise IOError(f'{path}: unsupported EXR compression {comp}')
        xmin, ymin, xmax, ymax = struct.unpack('<4i', attrs['dataWindow'][1])
        w, h = xmax - xmin + 1, ymax - ymin + 1
        lpc = _LINES_PER_CHUNK[comp]
        n_chunks = -(-h // lpc)
        f.read(8 * n_chunks)   # line offset table (we read sequentially)

        out = {name: np.empty((h, w), dtype=np.float32)
               for name, _ in chans}
        line_bytes = sum(w * _PIXEL_DTYPE[pt].itemsize for _, pt in chans)
        for _ in range(n_chunks):
            y, size = struct.unpack('<ii', f.read(8))
            payload = f.read(size)
            rows = min(lpc, ymax - y + 1)
            if comp in (2, 3) and size != rows * line_bytes:
                raw = zlib.decompress(payload)
                if len(raw) != rows * line_bytes:
                    raise IOError(f'{path}: bad chunk size')
                buf = _unpredict_and_interleave(raw).tobytes()
            else:
                # NONE, or a ZIP chunk stored raw because deflate didn't
                # shrink it (OpenEXR stores whichever is smaller)
                buf = payload
            off = 0
            for r in range(rows):
                for name, pt in chans:
                    dt = _PIXEL_DTYPE[pt]
                    n = w * dt.itemsize
                    row = np.frombuffer(buf, dtype=dt, count=w, offset=off)
                    out[name][y - ymin + r] = row.astype(np.float32)
                    off += n
        return out


def read_exr_depth(path: str) -> np.ndarray:
    """The depth channel: 'Y', falling back to the first channel."""
    chans = read_exr(path)
    if 'Y' in chans:
        return chans['Y']
    return chans[sorted(chans)[0]]


def write_exr(path: str, channels: dict[str, np.ndarray],
              compression: str = 'zip', half: bool = False) -> None:
    """Write channels as a scanline EXR (ZIP or NONE; FLOAT or HALF)."""
    names = sorted(channels)
    h, w = channels[names[0]].shape
    comp = {'none': 0, 'zips': 2, 'zip': 3}[compression]
    lpc = _LINES_PER_CHUNK[comp]
    ptype, pdt = (1, '<f2') if half else (2, '<f4')

    def attr(name, typ, data):
        return (name.encode() + b'\x00' + typ.encode() + b'\x00'
                + struct.pack('<i', len(data)) + data)

    chlist = b''
    for name in names:
        chlist += (name.encode() + b'\x00' + struct.pack('<i', ptype)
                   + b'\x00\x00\x00\x00' + struct.pack('<ii', 1, 1))
    chlist += b'\x00'
    box = struct.pack('<4i', 0, 0, w - 1, h - 1)
    header = (attr('channels', 'chlist', chlist)
              + attr('compression', 'compression', bytes([comp]))
              + attr('dataWindow', 'box2i', box)
              + attr('displayWindow', 'box2i', box)
              + attr('lineOrder', 'lineOrder', b'\x00')
              + attr('pixelAspectRatio', 'float', struct.pack('<f', 1.0))
              + attr('screenWindowCenter', 'v2f', struct.pack('<ff', 0, 0))
              + attr('screenWindowWidth', 'float', struct.pack('<f', 1.0))
              + b'\x00')

    chunks = []
    for y0 in range(0, h, lpc):
        rows = min(lpc, h - y0)
        raw = b''.join(
            channels[name][y0 + r].astype(pdt).tobytes()
            for r in range(rows) for name in names)
        if comp in (2, 3):
            payload = zlib.compress(
                _deinterleave_and_predict(
                    np.frombuffer(raw, dtype=np.uint8)))
            if len(payload) >= len(raw):   # EXR stores raw if not smaller
                payload = raw
        else:
            payload = raw
        chunks.append(struct.pack('<ii', y0, len(payload)) + payload)

    with open(path, 'wb') as f:
        f.write(struct.pack('<ii', _MAGIC, 2))
        f.write(header)
        offset = 8 + len(header) + 8 * len(chunks)
        for c in chunks:
            f.write(struct.pack('<q', offset))
            offset += len(c)
        for c in chunks:
            f.write(c)
