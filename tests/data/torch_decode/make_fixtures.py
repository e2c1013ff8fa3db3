"""Writes the background files that chip_smoke.py's train_pbr phase puts
beside its own (the image kinds a user's COCO folder may hold and that the
port reads without cv2), and digests.json: for each file and each imread
flag, the sha256, shape and dtype of cv2.imread's decode.

    python tests/data/torch_decode/make_fixtures.py

needs cv2 and PIL (the card's machine has neither, hence the committed
files).  tests/test_torch_decode.py checks the digests against cv2, so the
files cannot go stale, and the port's imread against them.

- progressive.jpg: 640x427 (a COCO size), cv2's progressive JPEG, 4:2:0;
- cmyk.jpg: 640x427, PIL's CMYK JPEG (an Adobe marker, transform 0);
- palette_trns.png: 320x240, PIL's palette PNG with a tRNS chunk;
- grey4.png: 320x240, a 4-bit grey PNG;
- adam7.png: 320x240, an Adam7-interlaced RGB PNG;
- bmp24.png: 200x150, cv2's 24-bit BMP under a .png name (cv2 reads a
  file by its signature, and RandomBackground globs *.png)."""

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FLAGS = ("unchanged", "color", "grayscale")


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A photo-like (H, W, 3) uint8 BGR image: colour ramps, a few discs
    and bars, and mild noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([60 + 150 * x / w, 40 + 170 * y / h, 128 + 90 * np.sin((x + 2 * y) / 37)],
                   axis=-1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(h / 12, h / 4)
        disc = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        img[disc] = rng.uniform(0, 255, 3)
    for _ in range(3):
        x0 = int(rng.uniform(0, w - 20))
        img[:, x0:x0 + int(rng.uniform(4, 20))] *= 0.6
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def files() -> dict:
    """{name: bytes} of the six fixtures."""
    import cv2
    from PIL import Image

    sys.path.insert(0, str(HERE.parents[1]))
    from torch_image_writers import write_png

    out = {}
    ok, buf = cv2.imencode(".jpg", scene(427, 640, 0), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    out["progressive.jpg"] = buf.tobytes()
    b = io.BytesIO()
    Image.fromarray(scene(427, 640, 1)[..., ::-1].copy()).convert("CMYK").save(
        b, "JPEG", quality=90)
    out["cmyk.jpg"] = b.getvalue()
    pal = Image.fromarray(scene(240, 320, 2)[..., ::-1].copy()).quantize(colors=64, dither=0)
    b = io.BytesIO()
    pal.save(b, "PNG", transparency=bytes(range(0, 256, 4)))
    out["palette_trns.png"] = b.getvalue()
    grey = scene(240, 320, 3).mean(axis=-1).astype(np.uint8) >> 4
    out["grey4.png"] = write_png(grey, ctype=0, depth=4, seed=3)
    out["adam7.png"] = write_png(scene(240, 320, 4)[..., ::-1], ctype=2, depth=8, interlace=True,
                                 seed=4)
    ok, buf = cv2.imencode(".bmp", scene(150, 200, 5))
    out["bmp24.png"] = buf.tobytes()
    return out


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype)}


def cv2_digests(directory: Path) -> dict:
    """{file: {flag: digest}} of cv2.imread's decodes of the fixtures."""
    import cv2

    codes = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
             "grayscale": cv2.IMREAD_GRAYSCALE}
    return {name: {flag: digest(cv2.imread(str(directory / name), codes[flag]))
                   for flag in FLAGS}
            for name in sorted(files_in(directory))}


def files_in(directory: Path):
    return [p.name for p in directory.iterdir() if p.suffix in (".jpg", ".png")]


def main() -> None:
    for name, data in files().items():
        (HERE / name).write_bytes(data)
    (HERE / "digests.json").write_text(json.dumps(cv2_digests(HERE), indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.is_file())
    print(f"wrote {len(files_in(HERE))} files and digests.json, {total} bytes in all")


if __name__ == "__main__":
    main()
