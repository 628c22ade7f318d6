"""Write the real-file fixtures under `tests/fixtures/real_files/`, from a seed.

    JAX_PLATFORMS=cpu python tests/fixtures/make_real_files.py

Needs cv2 (it encodes the JPEGs) and libjpeg (the port's `native/jpegdec.c`
decodes them), so it runs on a CPU machine, not on the card's. It writes:

  jpeg/<name>.jpg          JPEGs encoded by cv2 (quality 90 unless said):
                           s444, s422, s420 (chroma sampling 4:4:4, 4:2:2,
                           4:2:0), gray (one component), progressive,
                           restart (a restart interval of 4 MCUs), odd_37x53
                           (4:2:0 at an odd size), frame_1000 (a 1000x1000
                           4:2:0 frame: the port's synthetic render of
                           example 0) and mask_1000 (its one-component
                           foreground mask)
  jpeg/<name>.rgb.png      the libjpeg pixels of each, colour (RGB) and
  jpeg/<name>.gray.png     gray (libjpeg's luma), as PNGs: the card's
                           machine has no libjpeg to recompute them
  VOCdevkit/VOC2012/       a Pascal VOC layout: JPEGImages/*.jpg and
                           SegmentationObject/*.png, 8-bit palette masks
                           in VOC's colours with objects under 500 pixels,
                           touching the border, under 96 pixels on one side,
                           over 96 on both, exactly 192 x 192 (cv2's integer
                           area path), VOC's void outline (index 255), a
                           mask without its JPEG and one whose JPEG is not a
                           JPEG; JPEGImages/*.rgb.png hold the libjpeg pixels
  backgrounds/             non-square JPEGs (centre squares of 300, 512 and
                           560 pixels) and a PNG (200), with the JPEGs'
                           libjpeg pixels under backgrounds_pixels/

Running it again rewrites the same bytes with the same cv2 and libjpeg.
"""
from __future__ import annotations

import os
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "real_files")
SEED = 14
FRAME_SEED = 0  # the synthetic render behind frame_1000 and mask_1000
FRAME_SHAPE = (1000, 1000)


def voc_palette() -> np.ndarray:
    """Pascal VOC's colour map: index i's bits spread over R, G, B."""
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


def palette_png(index: np.ndarray, palette: np.ndarray) -> bytes:
    """uint8 [H, W] indices as an 8-bit palette PNG (no tRNS, no gamma)."""
    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    h, w = index.shape
    raw = b"".join(b"\x00" + index[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", palette.tobytes()) + chunk(b"IDAT", zlib.compress(raw, 9))
            + chunk(b"IEND", b""))


def scene(rng, h: int, w: int) -> np.ndarray:
    """RGB uint8: a smooth colour field, saturated shapes with sharp edges
    (chroma edges that the upsampling has to get right) and mild noise."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        f = rng.uniform(0.5, 3.0, 2)
        img[..., c] = 110 + 70 * np.sin(2 * np.pi * (f[0] * xs / w + f[1] * ys / h) + c)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(0.05, 0.25) * h, rng.uniform(0.05, 0.25) * w
        inside = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 < 1
        img[inside] = rng.integers(0, 256, 3)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(img: np.ndarray, *params) -> bytes:
    """cv2's JPEG of an RGB (or gray) uint8 image."""
    bgr = img if img.ndim == 2 else img[..., ::-1]
    ok, enc = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 90, *params])
    assert ok
    return enc.tobytes()


def write(path: str, data: bytes):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def write_png(path: str, img: np.ndarray):
    """Pixels as a PNG (cv2 writes it; the port's PNG reader reads it)."""
    ok, enc = cv2.imencode(".png", img if img.ndim == 2 else img[..., ::-1],
                           [cv2.IMWRITE_PNG_COMPRESSION, 9])
    assert ok
    write(path, enc.tobytes())


def jpeg_with_pixels(path: str, data: bytes, gray: bool = True):
    """The JPEG, and beside it its libjpeg pixels (colour, and gray)."""
    from metro_pose3d_tpu_torch.utils import improc

    write(path, data)
    stem = path[: -len(".jpg")]
    write_png(stem + ".rgb.png", improc.decode_jpeg_bytes(data))
    if gray:
        write_png(stem + ".gray.png", improc.decode_jpeg_bytes(data, gray=True))


def ellipse(h, w, cy, cx, ry, rx) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w]
    return ((ys + 0.5 - cy) / ry) ** 2 + ((xs + 0.5 - cx) / rx) ** 2 <= 1


def ring(mask: np.ndarray, width: int = 3) -> np.ndarray:
    """The pixels within `width` of `mask` and outside it (VOC's void outline)."""
    grown = mask.copy()
    for _ in range(width):
        g = grown.copy()
        g[1:] |= grown[:-1]
        g[:-1] |= grown[1:]
        g[:, 1:] |= grown[:, :-1]
        g[:, :-1] |= grown[:, 1:]
        grown = g
    return grown & ~mask


def write_jpegs(rng):
    from metro_pose3d_tpu_torch.data.synthetic import make_example

    base = os.path.join(ROOT, "jpeg")
    sampling = {"s444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "s422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "s420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
    for name, factor in sampling.items():
        jpeg_with_pixels(os.path.join(base, f"{name}.jpg"),
                         encode(scene(rng, 120, 160), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor))
    gray = cv2.cvtColor(scene(rng, 96, 128), cv2.COLOR_RGB2GRAY)
    jpeg_with_pixels(os.path.join(base, "gray.jpg"), encode(gray))
    jpeg_with_pixels(os.path.join(base, "progressive.jpg"),
                     encode(scene(rng, 120, 160), cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    jpeg_with_pixels(os.path.join(base, "restart.jpg"),
                     encode(scene(rng, 120, 160), cv2.IMWRITE_JPEG_RST_INTERVAL, 4))
    jpeg_with_pixels(os.path.join(base, "odd_37x53.jpg"),
                     encode(scene(rng, 37, 53), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420))
    ex = make_example(0, seed=FRAME_SEED, imshape=FRAME_SHAPE)
    jpeg_with_pixels(os.path.join(base, "frame_1000.jpg"),
                     encode(ex.image, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420))
    # the foreground: an ellipse over the joints' box, soft at its edge
    x, y, w, h = ex.bbox
    ys, xs = np.mgrid[0:FRAME_SHAPE[0], 0:FRAME_SHAPE[1]].astype(np.float32)
    r = ((xs - x - w / 2) / (w / 2.4)) ** 2 + ((ys - y - h / 2) / (h / 2.2)) ** 2
    mask = (np.clip((1.2 - r) * 5, 0, 1) * 255).astype(np.uint8)
    jpeg_with_pixels(os.path.join(base, "mask_1000.jpg"), encode(mask))


def write_voc(rng):
    base = os.path.join(ROOT, "VOCdevkit", "VOC2012")
    pal = voc_palette()
    # (name, image h, w, objects as (index, cy, cx, ry, rx)); index 255 is
    # VOC's void outline, drawn around every object
    layouts = [
        ("2008_000001", 220, 280, [(1, 90, 70, 55, 18),      # 36 x 110: grows in x
                                   (2, 120, 190, 60, 65),    # 120 x 130: shrinks
                                   (3, 190, 40, 7, 7)]),     # 14 x 14: under 500 px
        ("2008_000002", 240, 300, [(4, 118, 150, 96, 96),    # 192 x 192: integer area
                                   (5, 30, 5, 25, 30)]),     # touches the border
        ("2008_000003", 120, 160, [(6, 60, 80, 30, 40)]),    # no JPEG
        ("2008_000004", 120, 160, [(7, 60, 80, 30, 40)]),    # a JPEG that is not one
        ("2008_000005", 150, 200, [(8, 75, 100, 40, 70)]),   # 80 x 140
    ]
    for name, h, w, objects in layouts:
        index = np.zeros((h, w), np.uint8)
        void = np.zeros((h, w), bool)
        for i, cy, cx, ry, rx in objects:
            m = ellipse(h, w, cy, cx, ry, rx)
            index[m] = i
            void |= ring(m)
        index[void & (index == 0)] = 255
        write(os.path.join(base, "SegmentationObject", f"{name}.png"), palette_png(index, pal))
        jpg = os.path.join(base, "JPEGImages", f"{name}.jpg")
        if name == "2008_000003":
            continue
        if name == "2008_000004":
            write(jpg, b"not a JPEG: the reference's cv2.imread gives None")
            continue
        img = scene(rng, h, w)
        for i, cy, cx, ry, rx in objects:  # objects in their palette colour, shaded
            m = ellipse(h, w, cy, cx, ry, rx)
            img[m] = (0.6 * pal[i] + 0.4 * img[m]).astype(np.uint8)
        jpeg_with_pixels(jpg, encode(img), gray=False)


def write_backgrounds(rng):
    from metro_pose3d_tpu_torch.utils import improc

    base = os.path.join(ROOT, "backgrounds")
    for name, h, w in (("bg_a.jpg", 300, 420), ("bg_b.jpg", 600, 560), ("bg_d.jpg", 512, 700)):
        data = encode(scene(rng, h, w))
        write(os.path.join(base, name), data)
        write_png(os.path.join(ROOT, "backgrounds_pixels", name[:-4] + ".rgb.png"),
                  improc.decode_jpeg_bytes(data))
    write_png(os.path.join(base, "bg_c.png"), scene(rng, 240, 200))


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from metro_pose3d_tpu_torch.utils import improc

    if improc.jpeg_backend() != "libjpeg":
        print("make_real_files: the fixtures' pixels must come from libjpeg", file=sys.stderr)
        return 1
    shutil.rmtree(ROOT, ignore_errors=True)
    rng = np.random.default_rng(SEED)
    write_jpegs(rng)
    write_voc(rng)
    write_backgrounds(rng)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ROOT) for f in fs)
    print(f"make_real_files: {total} bytes under {ROOT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
