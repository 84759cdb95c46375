"""The port's host image codecs and image operations (nice_slam_tpu_torch/
io/codecs.py, csrc/imageio.cpp, io/exr.py, io/datasets.undistort and
resize_linear) against the libraries the JAX package reads with: cv2's
PNG and JPEG decoders (libpng, libjpeg-turbo), cv2.undistort, cv2.resize
and the JAX package's EXR reader, on files cv2 and the JAX package write.

Tolerances: PNG, JPEG, EXR and undistort bit-equal (the JPEG target is
bit-equal, the stated bound 2 levels, reached: 0; undistort's stated
bound 1 level, reached: 0); resize within 1e-6 (float32 sums in another
order)."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from nice_slam_tpu_torch.io import codecs

H, W = 60, 80
FR1_DESK = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])
SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _image(h, w, c=3, seed=0):
    """Smooth color plus noise, uint8 [h, w, c] (RGB)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + k) * np.cos(yy / 5.0 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0,
                   255).astype(np.uint8)


def _bgr(rgb):
    return np.ascontiguousarray(rgb[..., ::-1]) if rgb.ndim == 3 else rgb


def _cv2_rgb(buf, flag):
    out = cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
    if out.ndim == 3:
        out = out[..., [2, 1, 0, 3][:out.shape[2]]]
    return out


# ---------------------------------------------------------------- PNG

PNG_KINDS = {
    'depth16': lambda: np.random.default_rng(1).integers(
        0, 65536, (H, W), dtype=np.uint16),
    'gray8': lambda: _image(H, W)[..., 0],
    'rgb8': lambda: _image(H, W),
    'rgba8': lambda: np.concatenate([_image(H, W), _image(H, W, 1, 2)], -1),
}


@pytest.mark.parametrize('level', [0, 3, 9])
@pytest.mark.parametrize('kind', sorted(PNG_KINDS))
def test_png_matches_cv2(kind, level, tmp_path):
    """cv2-written PNGs: IMREAD_UNCHANGED and IMREAD_COLOR, bit-equal."""
    pix = PNG_KINDS[kind]()
    stored = pix if pix.ndim == 2 else pix[..., [2, 1, 0, 3][:pix.shape[2]]]
    path = str(tmp_path / f'{kind}.png')
    assert cv2.imwrite(path, stored, [cv2.IMWRITE_PNG_COMPRESSION, level])
    data = open(path, 'rb').read()
    got = codecs.read_png(path)
    want = _cv2_rgb(data, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(codecs.read_color(path),
                                  _cv2_rgb(data, cv2.IMREAD_COLOR))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_with_filters(pix, filters):
    """A PNG of uint8 / uint16 [h, w] or [h, w, 3] whose row y is filtered
    with filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth)."""
    h, w = pix.shape[:2]
    depth = 8 * pix.dtype.itemsize
    ctype = 0 if pix.ndim == 2 else 2
    raw = pix.astype(pix.dtype.newbyteorder('>')).reshape(h, -1).view(
        np.uint8).reshape(h, -1).astype(np.int64)
    bpp = (1 if pix.ndim == 2 else 3) * pix.dtype.itemsize
    rows = []
    for y in range(h):
        x = raw[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        b = raw[y - 1] if y else np.zeros_like(x)
        c = (np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]]) if y
             else np.zeros_like(x))
        f = filters[y % len(filters)]
        pred = [0 * x, a, b, (a + b) // 2, _paeth(a, b, c)][f]
        rows.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))

    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('filters', [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=['none', 'sub', 'up', 'average', 'paeth',
                              'mixed'])
def test_png_row_filters_match_cv2(filters):
    """One file per filter type, written with an explicit filter byte, in
    8-bit RGB and 16-bit gray: bit-equal to cv2.imdecode."""
    for pix in (_image(H, W), PNG_KINDS['depth16']()):
        data = _png_with_filters(pix, filters)
        want = _cv2_rgb(data, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(want, pix)     # the writer is right
        np.testing.assert_array_equal(codecs.decode_png(data), pix)


def test_png_writer_round_trips_through_cv2(tmp_path):
    for pix in (_image(H, W), _image(H, W)[..., 0], PNG_KINDS['depth16']()):
        path = str(tmp_path / 'w.png')
        codecs.write_png(path, pix)
        np.testing.assert_array_equal(
            _cv2_rgb(open(path, 'rb').read(), cv2.IMREAD_UNCHANGED), pix)


def test_unsupported_png_raises_naming_the_file(tmp_path):
    data = bytearray(_png_with_filters(_image(8, 8), [0]))
    data[8 + 8 + 12] = 1                      # IHDR interlace byte
    path = tmp_path / 'interlaced.png'
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match='interlaced.png: interlaced'):
        codecs.read_png(str(path))
    (tmp_path / 'junk.png').write_bytes(b'not an image')
    with pytest.raises(ValueError, match='junk.png'):
        codecs.read_color(str(tmp_path / 'junk.png'))


# ---------------------------------------------------------------- JPEG

JPEG_CASES = (
    [(q, s, (61, 83), 0) for q in (75, 97) for s in ('444', '422', '420')]
    + [(97, '420', (H, W), 2), (75, '422', (H, W), 5)])


@pytest.mark.parametrize('quality, sampling, size, restart', JPEG_CASES)
def test_jpeg_matches_cv2(quality, sampling, size, restart, tmp_path):
    """cv2-written JPEGs at two qualities, three chroma samplings, a size
    that is not a multiple of the MCU and restart intervals: bit-equal to
    cv2.imread (libjpeg-turbo)."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    path = str(tmp_path / 'c.jpg')
    assert cv2.imwrite(path, _bgr(_image(*size)), params)
    got = codecs.read_color(path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_gray_jpeg_matches_cv2(tmp_path):
    path = str(tmp_path / 'g.jpg')
    assert cv2.imwrite(path, _image(61, 83)[..., 0],
                       [cv2.IMWRITE_JPEG_QUALITY, 90])
    data = open(path, 'rb').read()
    np.testing.assert_array_equal(codecs.decode_jpeg(data),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(codecs.read_color(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


def test_progressive_jpeg_raises_naming_the_file(tmp_path):
    path = str(tmp_path / 'prog.jpg')
    assert cv2.imwrite(path, _bgr(_image(H, W)),
                       [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match='prog.jpg: progressive'):
        codecs.read_color(path)


@pytest.mark.parametrize('gray', [False, True])
def test_jpeg_encoder_decodes_alike_and_is_deterministic(gray):
    """The port's encoder: cv2.imdecode of its bytes equals the port's
    decoder on the same bytes (bit-equal), the bytes are the same on two
    calls, and at quality 97 the image is close to its source."""
    pix = _image(61, 83)
    if gray:
        pix = pix[..., 0]
    data = codecs.encode_jpeg(pix, 97)
    assert data == codecs.encode_jpeg(pix, 97)
    got = codecs.decode_jpeg(data)
    want = _cv2_rgb(data, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got, want)
    # the same pixels as cv2's own encoder at the same quality (the
    # quantization tables and the 4:2:0 downsampling are libjpeg's)
    ok, ref = cv2.imencode('.jpg', _bgr(pix), [cv2.IMWRITE_JPEG_QUALITY, 97])
    np.testing.assert_array_equal(got, _cv2_rgb(ref.tobytes(),
                                  cv2.IMREAD_GRAYSCALE if gray
                                  else cv2.IMREAD_COLOR))


# ---------------------------------------------------------------- EXR

@pytest.mark.parametrize('compression, half', [
    ('zip', False), ('zips', False), ('none', False), ('zip', True)])
def test_exr_reader_matches_the_jax_reader(compression, half, tmp_path):
    from nice_slam_tpu.io import exr as jexr
    from nice_slam_tpu_torch.io import exr
    rng = np.random.default_rng(0)
    img = (rng.random((37, 53)) * 8).astype(np.float32)
    path = str(tmp_path / 'd.exr')
    jexr.write_exr(path, {'Y': img, 'A': img * 2}, compression=compression,
                   half=half)
    got, want = exr.read_exr(path), jexr.read_exr(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(exr.read_exr_depth(path),
                                  jexr.read_exr_depth(path))
    # and the port's writer is read back by the JAX reader
    other = str(tmp_path / 'p.exr')
    exr.write_exr(other, {'Y': img}, compression=compression, half=half)
    np.testing.assert_array_equal(jexr.read_exr_depth(other),
                                  exr.read_exr_depth(path))


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize('size', [(H, W), (61, 83)])
def test_undistort_matches_cv2(size):
    """freiburg1_desk's coefficients at the fixture's intrinsics, and a
    stronger distortion: at most 1 level off cv2.undistort (reached: 0)."""
    from nice_slam_tpu_torch.io.datasets import _intrinsics_matrix, undistort
    h, w = size
    k = _intrinsics_matrix(0.5 * w, 0.5 * w, 0.5 * w - 0.5, 0.5 * h - 0.5)
    img = _image(h, w)
    for dist in (FR1_DESK, np.array([0.3, -0.5, 0.01, -0.02, 0.4])):
        got = undistort(img, k, dist)
        want = cv2.undistort(img, k, dist)
        assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize('src, dst', [
    ((H, W), (H // 2, W // 2)), ((H // 2, W // 2), (H, W)),
    # real ScanNet's 1296x968 color to 640x480 depth, cut to test size
    ((121, 162), (H, W)), ((H, W), (61, 83))])
def test_resize_matches_cv2(src, dst):
    from nice_slam_tpu_torch.io.datasets import resize_linear
    img = np.random.default_rng(3).random(src + (3,)).astype(np.float32)
    got = resize_linear(img, *dst)
    want = cv2.resize(img, dst[::-1])
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6
