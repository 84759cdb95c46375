"""Drawing on the host, in numpy: what matplotlib draws for the JAX
package's render panels, live dashboard, replay and ATE plot, done here
without it (the machine with the card has no matplotlib).

* `colormap(x, vmin, vmax)`: matplotlib's `plasma` (its listed-colormap
  data, CC0, as the 256x3 table `PLASMA`) by matplotlib's rule:
  `Normalize(vmin, vmax)` (its dtype handling included), then `x * N`, `N`
  to `N - 1`, below 0 to the first colour, from `N` on to the last, NaN to
  black, and the table's bytes as `(table * 255).astype(uint8)`: the same
  bytes as `cmap(Normalize(vmin, vmax)(x), bytes=True)[..., :3]`.
* `compose(tiles, titles, ncols)`: tiles laid out in a grid on white, with
  gaps and a title strip over each tile, in the 5x8 bitmap font `FONT`
  (printable ASCII).
* `plot(series, h, w)`: polylines and point markers on an equal-aspect
  canvas, with a frame and a legend (the trajectory views).
* `save(path, image)`: a PNG or JPEG (by the extension) through the
  port's own codecs (io/codecs.py), written to a temporary file and moved
  into place, so a reader never sees half a file.
"""

from __future__ import annotations

import os

import numpy as np

# matplotlib's `_plasma_data`, each value times 1e6 (the data has six
# decimals, so the division gives the same doubles)
_PLASMA_E6 = """
050383 029803 527975 063536 028426 533124 075353 027206 538007 086222 026125
542658 096379 025165 547103 105980 024309 551368 115124 023556 555468 123903
022878 559423 132381 022258 563250 140603 021687 566959 148607 021154 570562
156421 020651 574065 164070 020171 577478 171574 019706 580806 178950 019252
584054 186213 018803 587228 193374 018354 590330 200445 017902 593364 207435
017442 596333 214350 016973 599239 221197 016497 602083 227983 016007 604867
234715 015502 607592 241396 014979 610259 248032 014439 612868 254627 013882
615419 261183 013308 617911 267703 012716 620346 274191 012109 622722 280648
011488 625038 287076 010855 627295 293478 010213 629490 299855 009561 631624
306210 008902 633694 312543 008239 635700 318856 007576 637640 325150 006915
639512 331426 006261 641316 337683 005618 643049 343925 004991 644710 350150
004382 646298 356359 003798 647810 362553 003243 649245 368733 002724 650601
374897 002245 651876 381047 001814 653068 387183 001434 654177 393304 001114
655199 399411 000859 656133 405503 000678 656977 411580 000577 657730 417642
000564 658390 423689 000646 658956 429719 000831 659425 435734 001127 659797
441732 001540 660069 447714 002080 660240 453677 002755 660310 459623 003574
660277 465550 004545 660139 471457 005678 659897 477344 006980 659549 483210
008460 659095 489055 010127 658534 494877 011990 657865 500678 014055 657088
506454 016333 656202 512206 018833 655209 517933 021563 654109 523633 024532
652901 529306 027747 651586 534952 031217 650165 540570 034950 648640 546157
038954 647010 551715 043136 645277 557243 047331 643443 562738 051545 641509
568201 055778 639477 573632 060028 637349 579029 064296 635126 584391 068579
632812 589719 072878 630408 595011 077190 627917 600266 081516 625342 605485
085854 622686 610667 090204 619951 615812 094564 617140 620919 098934 614257
625987 103312 611305 631017 107699 608287 636008 112092 605205 640959 116492
602065 645872 120898 598867 650746 125309 595617 655580 129725 592317 660374
134144 588971 665129 138566 585582 669845 142992 582154 674522 147419 578688
679160 151848 575189 683758 156278 571660 688318 160709 568103 692840 165141
564522 697324 169573 560919 701769 174005 557296 706178 178437 553657 710549
182868 550004 714883 187299 546338 719181 191729 542663 723444 196158 538981
727670 200586 535293 731862 205013 531601 736019 209439 527908 740143 213864
524216 744232 218288 520524 748289 222711 516834 752312 227133 513149 756304
231555 509468 760264 235976 505794 764193 240396 502126 768090 244817 498465
771958 249237 494813 775796 253658 491171 779604 258078 487539 783383 262500
483918 787133 266922 480307 790855 271345 476706 794549 275770 473117 798216
280197 469538 801855 284626 465971 805467 289057 462415 809052 293491 458870
812612 297928 455338 816144 302368 451816 819651 306812 448306 823132 311261
444806 826588 315714 441316 830018 320172 437836 833422 324635 434366 836801
329105 430905 840155 333580 427455 843484 338062 424013 846788 342551 420579
850066 347048 417153 853319 351553 413734 856547 356066 410322 859750 360588
406917 862927 365119 403519 866078 369660 400126 869203 374212 396738 872303
378774 393355 875376 383347 389976 878423 387932 386600 881443 392529 383229
884436 397139 379860 887402 401762 376494 890340 406398 373130 893250 411048
369768 896131 415712 366407 898984 420392 363047 901807 425087 359688 904601
429797 356329 907365 434524 352970 910098 439268 349610 912800 444029 346251
915471 448807 342890 918109 453603 339529 920714 458417 336166 923287 463251
332801 925825 468103 329435 928329 472975 326067 930798 477867 322697 933232
482780 319325 935630 487712 315952 937990 492667 312575 940313 497642 309197
942598 502639 305816 944844 507658 302433 947051 512699 299049 949217 517763
295662 951344 522850 292275 953428 527960 288883 955470 533093 285490 957469
538250 282096 959424 543431 278701 961336 548636 275305 963203 553865 271909
965024 559118 268513 966798 564396 265118 968526 569700 261721 970205 575028
258325 971835 580382 254931 973416 585761 251540 974947 591165 248151 976428
596595 244767 977856 602051 241387 979233 607532 238013 980556 613039 234646
981826 618572 231287 983041 624131 227937 984199 629718 224595 985301 635330
221265 986345 640969 217948 987332 646633 214648 988260 652325 211364 989128
658043 208100 989935 663787 204859 990681 669558 201642 991365 675355 198453
991985 681179 195295 992541 687030 192170 993032 692907 189084 993456 698810
186041 993814 704741 183043 994103 710698 180097 994324 716681 177208 994474
722691 174381 994553 728728 171622 994561 734791 168938 994495 740880 166335
994355 746995 163821 994141 753137 161404 993851 759304 159092 993482 765499
156891 993033 771720 154808 992505 777967 152855 991897 784239 151042 991209
790537 149377 990439 796859 147870 989587 803205 146529 988648 809579 145357
987621 815978 144363 986509 822401 143557 985314 828846 142945 984031 835315
142528 982653 841812 142303 981190 848329 142279 979644 854866 142453 977995
861432 142808 976265 868016 143351 974443 874622 144061 972530 881250 144923
970533 887896 145919 968443 894564 147014 966271 901249 148180 964021 907950
149370 961681 914672 150520 959276 921407 151566 956808 928152 152409 954287
934908 152921 951726 941671 152925 949151 948435 152178 946602 955190 150328
944152 961916 146861 941896 968590 140956 940015 975158 131326
"""
PLASMA = np.array(_PLASMA_E6.split(), dtype=np.float64).reshape(256, 3) / 1e6
_PLASMA_BYTES = (PLASMA * 255).astype(np.uint8)

# the glyphs of ' ' .. '~' in ASCII order, 5 bytes each: one a column,
# bit 0 the top row of 8 (rows 7-8 hold the descenders)
_FONT_HEX = """
000000000000005f00000007000700147f147f14242a7f2a1223130864623649562050
0000070000001c2241000041221c0014083e081408083e080800806030000808080808
000060600020100804023e5149453e00427f400042615149462141454b311814127f10
27454545393c4a49493001710905033649494936064949291e00363600000056360000
00081422411414141414412214080002015109063e415d594e7c1211127c7f49494936
3e414141227f4141413e7f494949417f090909013e414151737f0808087f00417f4100
2040413f017f081422417f404040407f020c027f7f0408107f3e4141413e7f09090906
3e4151215e7f09192946264949493201017f01013f4040403f1f2040201f3f4038403f
631408146307087008076151494543007f41410002040810200041417f000402010204
8080808080000102040020545454787f484444383844444420384444487f3854545418
087e09010218a4a4a47c7f0804047800447d40004080847d007f1028440000417f4000
7c041804787c080404783844444438fc2424241818242418fc7c080404084854545420
043f4440203c4040207c1c2040201c3c4030403c44281028441ca0a0a07c4464544c44
000836410000007f000000413608000201020402
""".replace('\n', '')
FONT = {chr(32 + i): bytes.fromhex(_FONT_HEX[10 * i:10 * i + 10])
        for i in range(len(_FONT_HEX) // 10)}
GLYPH_W, GLYPH_H = 6, 8     # the advance (5 columns and a space), rows
GAP = 8                     # pixels between and around composed tiles
MARGIN = 12                 # pixels around a plot's data
JPEG_QUALITY = 90

BLACK = (0, 0, 0)
COLORS = {'r': (214, 39, 40), 'g': (44, 160, 44), 'b': (31, 119, 180),
          'k': BLACK}


def _dtype_of(value) -> np.dtype:
    """matplotlib's `Normalize.process_value` dtype: float arrays keep
    theirs, a Python scalar is float64, small integers go to float32,
    larger ones to float64."""
    dtype = np.min_scalar_type(value if np.iterable(value) else [value])
    if np.issubdtype(dtype, np.integer) or dtype.type is np.bool_:
        dtype = np.promote_types(dtype, np.float32)
    return dtype


def normalize(x, vmin, vmax) -> np.ndarray:
    """`matplotlib.colors.Normalize(vmin, vmax)(x)` of unmasked data."""
    out = np.array(x, dtype=_dtype_of(x), copy=True)
    lo = np.asarray(vmin, dtype=_dtype_of(vmin))[()]
    hi = np.asarray(vmax, dtype=_dtype_of(vmax))[()]
    if lo == hi:
        out.fill(0)
    elif lo > hi:
        raise ValueError('vmin must be less than or equal to vmax')
    else:
        out -= lo
        out /= (hi - lo)
    return out


def colormap(x, vmin, vmax) -> np.ndarray:
    """uint8 RGB [..., 3] of the values x under `plasma` over [vmin,
    vmax] (see the module note)."""
    xa = normalize(x, vmin, vmax)
    n = len(PLASMA)
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid='ignore'):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over] = n - 1
    idx[bad] = 0
    out = _PLASMA_BYTES[idx]
    out[bad] = 0
    return out


def rgb_bytes(img) -> np.ndarray:
    """uint8 RGB of a float RGB image, clipped to [0, 1] and scaled as
    matplotlib's `to_rgba(..., bytes=True)` scales it."""
    return (np.clip(np.asarray(img, dtype=np.float64), 0, 1)
            * 255).astype(np.uint8)


# ---------------------------------------------------------------- text

def text_width(s: str, scale: int = 1) -> int:
    """Width in pixels of `s` drawn at `scale`."""
    return max(len(s) * GLYPH_W - 1, 0) * scale


def draw_text(canvas: np.ndarray, y: int, x: int, s: str, color=BLACK,
              scale: int = 1) -> None:
    """Draw `s` with its top-left corner at (y, x), clipped to the
    canvas; a character outside the font draws as '?'."""
    h, w = canvas.shape[:2]
    for k, ch in enumerate(s):
        cols = np.frombuffer(FONT.get(ch, FONT['?']), dtype=np.uint8)
        bits = (cols[None, :] >> np.arange(8)[:, None]) & 1
        bits = np.kron(bits, np.ones((scale, scale), dtype=np.uint8))
        ys, xs = np.nonzero(bits)
        ys, xs = ys + y, xs + x + k * GLYPH_W * scale
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        canvas[ys[keep], xs[keep]] = color


# ---------------------------------------------------------------- layout

def text_scale(tile_w: int) -> int:
    """The titles' scale over tiles `tile_w` pixels wide: 1, and one more
    for every 240 pixels of width beyond the first."""
    return max(1, tile_w // 240)


def _strip(scale: int) -> int:
    """Height of a title strip."""
    return (GLYPH_H + 2) * scale + 2


def grid_size(tile_shapes, ncols: int) -> tuple[int, int]:
    """(height, width) of `compose`'s canvas for tiles of the given
    (h, w) shapes, row-major in `ncols` columns."""
    scale = text_scale(max(w for _, w in tile_shapes))
    rows = [tile_shapes[i:i + ncols]
            for i in range(0, len(tile_shapes), ncols)]
    col_w = [max(r[c][1] for r in rows if c < len(r))
             for c in range(min(ncols, len(tile_shapes)))]
    height = GAP + sum(_strip(scale) + max(h for h, _ in r) + GAP
                       for r in rows)
    return height, GAP + sum(cw + GAP for cw in col_w)


def compose(tiles, titles, ncols: int) -> np.ndarray:
    """uint8 RGB canvas of the uint8 RGB tiles, row-major in `ncols`
    columns on white, GAP pixels apart, each under its title (centred in
    a strip, at `text_scale` of the widest tile); a column is as wide as
    its widest tile, a row as high as its highest."""
    shapes = [t.shape[:2] for t in tiles]
    scale = text_scale(max(w for _, w in shapes))
    height, width = grid_size(shapes, ncols)
    canvas = np.full((height, width, 3), 255, dtype=np.uint8)
    col_w = [max(shapes[i][1] for i in range(c, len(shapes), ncols))
             for c in range(min(ncols, len(shapes)))]
    y = GAP
    for r0 in range(0, len(tiles), ncols):
        x = GAP
        for c, (tile, title) in enumerate(zip(tiles[r0:r0 + ncols],
                                              titles[r0:r0 + ncols])):
            th, tw = tile.shape[:2]
            draw_text(canvas, y + scale + 1,
                      x + (col_w[c] - text_width(title, scale)) // 2,
                      title, BLACK, scale)
            canvas[y + _strip(scale):y + _strip(scale) + th, x:x + tw] = tile
            x += col_w[c] + GAP
        y += _strip(scale) + max(h for h, _ in shapes[r0:r0 + ncols]) + GAP
    return canvas


# ---------------------------------------------------------------- plots

def _dots(canvas, ys, xs, color, width: int) -> None:
    """Squares of `width` pixels at the integer points (ys, xs)."""
    h, w = canvas.shape[:2]
    r = width // 2
    for dy in range(-r, width - r):
        for dx in range(-r, width - r):
            yy, xx = ys + dy, xs + dx
            keep = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            canvas[yy[keep], xx[keep]] = color


def _polyline(canvas, ys, xs, color, width: int) -> None:
    """The segments between consecutive points, a pixel a step along
    each segment's longer axis."""
    for i in range(max(len(ys) - 1, 0) or len(ys)):
        y0, x0 = ys[i], xs[i]
        y1, x1 = (ys[i + 1], xs[i + 1]) if len(ys) > 1 else (y0, x0)
        n = int(max(abs(y1 - y0), abs(x1 - x0))) + 1
        _dots(canvas, np.rint(np.linspace(y0, y1, n)).astype(int),
              np.rint(np.linspace(x0, x1, n)).astype(int), color, width)


def _marker(canvas, y, x, kind: str, color, size: int) -> None:
    """A filled marker `size` pixels across centred at (y, x): '^' a
    triangle with its apex up, 'o' a disc."""
    r = size // 2
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    if kind == 'o':
        inside = yy ** 2 + xx ** 2 <= r * r
    elif kind == '^':
        inside = 2 * np.abs(xx) <= yy + r
    else:
        raise ValueError(f'marker {kind!r}')
    ys, xs = np.nonzero(inside)
    _dots(canvas, ys - r + int(round(y)), xs - r + int(round(x)), color, 1)


def _rgb(color) -> tuple:
    return COLORS[color] if isinstance(color, str) else tuple(color)


def plot(series, h: int, w: int) -> np.ndarray:
    """uint8 RGB [h, w, 3] of the series on white in a frame, with equal
    scales on both axes and the data centred (matplotlib's
    `set_aspect('equal')`), and a legend of the labelled series.  Each
    series is a dict: 'xy' [n, 2] data coordinates (x right, y up),
    'color' (a key of COLORS or an RGB triple), 'kind' '-' (a polyline,
    the default), '^' or 'o' (markers), and optionally 'label', 'width'
    (line pixels, 1) and 'size' (marker pixels, 8)."""
    canvas = np.full((h, w, 3), 255, dtype=np.uint8)
    pts = np.concatenate([np.asarray(s['xy'], np.float64).reshape(-1, 2)
                          for s in series] or [np.zeros((0, 2))])
    pts = pts[np.isfinite(pts).all(axis=1)]
    lo = pts.min(axis=0) if len(pts) else np.zeros(2)
    hi = pts.max(axis=0) if len(pts) else np.ones(2)
    span = np.maximum(hi - lo, 1e-9)
    k = 0.9 * min((w - 2 * MARGIN) / span[0], (h - 2 * MARGIN) / span[1])
    mid = (lo + hi) / 2
    for s in series:
        xy = np.asarray(s['xy'], np.float64).reshape(-1, 2)
        ys = h / 2 - (xy[:, 1] - mid[1]) * k
        xs = w / 2 + (xy[:, 0] - mid[0]) * k
        if s.get('kind', '-') == '-':
            _polyline(canvas, ys, xs, _rgb(s['color']), s.get('width', 1))
        else:
            for y, x in zip(ys, xs):
                _marker(canvas, y, x, s['kind'], _rgb(s['color']),
                        s.get('size', 8))
    e = MARGIN // 2
    canvas[[e, h - 1 - e], e:w - e] = BLACK
    canvas[e:h - e, [e, w - 1 - e]] = BLACK
    y = MARGIN
    for s in series:
        if s.get('label'):
            canvas[y + 3:y + 5, MARGIN:MARGIN + 14] = _rgb(s['color'])
            draw_text(canvas, y, MARGIN + 18, s['label'])
            y += GLYPH_H + 4
    return canvas


# ---------------------------------------------------------------- files

def save(path: str, image: np.ndarray) -> str:
    """Write uint8 RGB `image` as a PNG or a JPEG (by `path`'s extension)
    through io/codecs, atomically: to a temporary file beside it, then
    `os.replace`.  Returns `path`."""
    from nice_slam_tpu_torch.io.codecs import encode_jpeg, encode_png
    ext = os.path.splitext(path)[1].lower()
    if ext == '.png':
        data = encode_png(image)
    elif ext in ('.jpg', '.jpeg'):
        data = encode_jpeg(image, JPEG_QUALITY)
    else:
        raise ValueError(f'{path}: neither .png nor .jpg')
    head, tail = os.path.split(path)
    tmp = os.path.join(head, f'.{tail}.tmp')
    with open(tmp, 'wb') as f:
        f.write(data)
    os.replace(tmp, path)
    return path
