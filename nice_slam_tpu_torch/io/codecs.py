"""Image codecs of the dataset loaders, with no image library: PNG and
baseline JPEG decoding as `cv2.imread` returns them, and the PNG and JPEG
writers of the port's fixture tool.

The row work runs in `csrc/imageio.cpp`, compiled with g++ at first use
into the checkout's `build/` (ops/build.py) and loaded with ctypes; a ctypes
call releases the interpreter lock, so the Prefetcher's threads decode
while the main thread drives the card.  PNG chunks are parsed and inflated
here (the standard library's zlib).

What each reader returns:
  * `read_color(path)`: uint8 [H, W, 3] RGB, as `cv2.imread(path,
    IMREAD_COLOR)` then BGR -> RGB: gray replicated to three channels,
    alpha dropped, 16-bit samples >> 8; a JPEG through the integer
    decoder of csrc/imageio.cpp, which computes libjpeg-turbo's islow IDCT,
    fancy upsampling and YCbCr tables.
  * `read_png(path)`: the samples as stored, as `cv2.imread(path,
    IMREAD_UNCHANGED)` (uint8 or uint16, [H, W] or [H, W, C], channels in
    file order).
A file the codecs do not support (an interlaced or palette PNG; a
progressive, arithmetic-coded, 12-bit, CMYK or Adobe-RGB JPEG; an EXIF
orientation other than 1) raises ValueError naming the file.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np

from nice_slam_tpu_torch.ops.build import (
    BUILD_DIR, CSRC, compile_cpp, is_stale)

SOURCE = os.path.join(CSRC, 'imageio.cpp')
LIBRARY = os.path.join(BUILD_DIR, 'libnst_imageio.so')

_PNG_MAGIC = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # gray, RGB, gray+alpha, RGBA
_ERRLEN = 256

_lib = None
_lib_lock = threading.Lock()
_u8p = ctypes.POINTER(ctypes.c_uint8)


def build_library() -> str:
    """Compile csrc/imageio.cpp into build/."""
    return compile_cpp(SOURCE, LIBRARY)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:   # the Prefetcher's threads may arrive together
        if _lib is not None:
            return _lib
        if is_stale(SOURCE, LIBRARY):
            build_library()
        lib = ctypes.CDLL(LIBRARY)
        lib.nst_free.argtypes = [ctypes.c_void_p]
        lib.nst_free.restype = None
        lib.nst_png_unfilter.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.nst_png_unfilter.restype = ctypes.c_int
        lib.nst_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_u8p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        lib.nst_jpeg_decode.restype = ctypes.c_int
        lib.nst_jpeg_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(_u8p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int]
        lib.nst_jpeg_encode.restype = ctypes.c_int
        _lib = lib
        return lib


def _read(path: str) -> bytes:
    with open(path, 'rb') as f:
        return f.read()


# ---------------------------------------------------------------- PNG

def decode_png(data: bytes, name: str = '<memory>') -> np.ndarray:
    """A PNG's samples as stored: uint8 or uint16 (native byte order),
    [H, W] for gray, else [H, W, C] in file order."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f'{name}: not a PNG file')
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise ValueError(f'{name}: truncated {kind!r} chunk')
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body[:13])
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None or not idat:
        raise ValueError(f'{name}: no IHDR or no IDAT chunk')
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f'{name}: interlaced PNG is not supported')
    if ctype not in _PNG_CHANNELS or depth not in (8, 16):
        raise ValueError(f'{name}: PNG color type {ctype} at bit depth '
                         f'{depth} is not supported (8- or 16-bit gray, '
                         'gray+alpha, RGB, RGBA only)')
    channels = _PNG_CHANNELS[ctype]
    bpp = channels * depth // 8
    rowbytes = w * bpp
    try:
        raw = zlib.decompress(b''.join(idat))
    except zlib.error as e:
        raise ValueError(f'{name}: corrupt image data ({e})') from None
    out = np.empty(h * rowbytes, dtype=np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = get_lib().nst_png_unfilter(raw, len(raw), h, rowbytes, bpp,
                                    out.ctypes.data, err, _ERRLEN)
    if rc:
        raise ValueError(f'{name}: {err.value.decode()}')
    if depth == 16:
        out = out.view('>u2').astype(np.uint16)
    shape = (h, w) if channels == 1 else (h, w, channels)
    return out.reshape(shape)


def read_png(path: str) -> np.ndarray:
    """`cv2.imread(path, IMREAD_UNCHANGED)` of a PNG, channels in file
    order (RGB, not BGR)."""
    return decode_png(_read(path), path)


def _color_of(samples: np.ndarray) -> np.ndarray:
    """IMREAD_COLOR of decoded samples: uint8 RGB, gray replicated, alpha
    dropped, 16-bit >> 8."""
    if samples.dtype == np.uint16:
        samples = (samples >> 8).astype(np.uint8)
    if samples.ndim == 2:
        samples = samples[..., None]
    if samples.shape[-1] in (1, 2):          # gray (+ alpha)
        return np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


# ---------------------------------------------------------------- JPEG

def decode_jpeg(data: bytes, name: str = '<memory>') -> np.ndarray:
    """A baseline JPEG's pixels: uint8 [H, W, 3] RGB, or [H, W] for a
    grayscale file."""
    lib = get_lib()
    out = _u8p()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.nst_jpeg_decode(data, len(data), ctypes.byref(out),
                             ctypes.byref(h), ctypes.byref(w),
                             ctypes.byref(c), err, _ERRLEN)
    if rc:
        raise ValueError(f'{name}: {err.value.decode()}')
    try:
        pix = np.ctypeslib.as_array(
            out, shape=(h.value * w.value * c.value,)).copy()
    finally:
        lib.nst_free(out)
    return pix.reshape((h.value, w.value) if c.value == 1
                       else (h.value, w.value, c.value))


def encode_jpeg(pixels: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JPEG of uint8 RGB [H, W, 3] (4:2:0) or gray [H, W], IJG
    quality scaling of the standard tables; the same bytes for the same
    pixels."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8 or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3)):
        raise ValueError('encode_jpeg: uint8 [H, W] or [H, W, 3] expected, '
                         f'got {pixels.dtype} {pixels.shape}')
    lib = get_lib()
    c = 1 if pixels.ndim == 2 else 3
    out = _u8p()
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.nst_jpeg_encode(pixels.ctypes.data, pixels.shape[0],
                             pixels.shape[1], c, int(quality),
                             ctypes.byref(out), ctypes.byref(n), err,
                             _ERRLEN)
    if rc:
        raise ValueError(f'encode_jpeg: {err.value.decode()}')
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.nst_free(out)


def encode_png(pixels: np.ndarray, level: int = 6) -> bytes:
    """PNG of uint8 or uint16 [H, W] (gray) or [H, W, 3] (RGB), every row
    filter 0, deflated by the standard library's zlib."""
    pixels = np.asarray(pixels)
    if pixels.dtype not in (np.uint8, np.uint16) or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3)):
        raise ValueError('encode_png: uint8 / uint16 [H, W] or [H, W, 3] '
                         f'expected, got {pixels.dtype} {pixels.shape}')
    h, w = pixels.shape[:2]
    depth = 8 * pixels.dtype.itemsize
    ctype = 0 if pixels.ndim == 2 else 2
    rows = pixels.astype(pixels.dtype.newbyteorder('>')).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8).reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_MAGIC
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b'IDAT', zlib.compress(raw.tobytes(), level))
            + chunk(b'IEND', b''))


# ---------------------------------------------------------------- files

def read_color(path: str) -> np.ndarray:
    """`cv2.imread(path)` converted to RGB: uint8 [H, W, 3]."""
    data = _read(path)
    if data[:8] == _PNG_MAGIC:
        return _color_of(decode_png(data, path))
    if data[:2] == b'\xff\xd8':
        return _color_of(decode_jpeg(data, path))
    raise ValueError(f'{path}: neither a PNG nor a JPEG file')


def write_png(path: str, pixels: np.ndarray) -> None:
    with open(path, 'wb') as f:
        f.write(encode_png(pixels))


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    with open(path, 'wb') as f:
        f.write(encode_jpeg(rgb, quality))
