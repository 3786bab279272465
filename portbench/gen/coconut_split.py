"""A COCONUT-format split written from a seed: JPEG images and
`annotations/coconut_val.json` with compressed-RLE instance masks, laid
out as the port's `get_dataset_paths` expects (`images/val2017/`).

Every seed, and every shard of `shard` images, gets the same set of sizes,
in another order: the image sizes follow the traffic's `aspects` table
and the instance counts its `instances` histogram (largest-remainder
rounding over a shard), the mask areas its `areas` classes. The seed places, shapes and colours
everything and shuffles the order. Each instance is an ellipse of its
class's area, at least `min_height_share` of the image tall and clear of
the border by `margin` pixels, so the port's instance filters keep it.

Parameters (the traffic file): images, shard, aspects [[width, height, share]],
instances {count: share}, areas [[name, low, high, share]],
min_height_share, margin, jpeg_quality.
"""

from __future__ import annotations

import json
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# The 80 COCO "thing" category ids.
COCO_THING_IDS = (list(range(1, 12)) + list(range(13, 26)) + [27, 28] + list(range(31, 45))
                  + list(range(46, 66)) + [67, 70] + list(range(72, 83)) + list(range(84, 91)))


def apportion(shares: list[float], n: int) -> list[int]:
    """Largest-remainder rounding of `shares` (summing to about 1) to `n`."""
    total = sum(shares)
    raw = [s / total * n for s in shares]
    counts = [int(math.floor(r)) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: -(raw[i] - counts[i]))
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    return counts


def rle_counts(mask: np.ndarray) -> list[int]:
    """Run lengths of a bool mask over its column-major pixels, starting
    with a run of zeros (COCO's RLE)."""
    flat = np.asfortranarray(mask).ravel(order="F").astype(np.int8)
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]])).tolist()
    return runs if flat[0] == 0 else [0] + runs


def rle_string(counts: list[int]) -> str:
    """COCO's compressed RLE string (pycocotools' `rleToString`): each
    count after the second as the difference from the count two before,
    in 5-bit groups with a continuation bit, offset by 48."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def plan(params: dict, seed: int) -> list[dict]:
    """The split's images and instances, without pixels: consecutive
    shards of `shard` images, each with the same set of image sizes,
    instance counts and mask-area classes, in its own order."""
    rng = np.random.default_rng(seed)
    n, shard = int(params["images"]), int(params["shard"])
    hist = sorted((int(k), v) for k, v in params["instances"].items())
    classes = params["areas"]
    images = []
    for _ in range(n // shard):
        sizes = [(w, h) for (w, h, _), k in zip(params["aspects"], apportion(
            [a[2] for a in params["aspects"]], shard)) for _ in range(k)]
        counts = [c for (c, _), k in zip(hist, apportion([v for _, v in hist], shard))
                  for _ in range(k)]
        kinds = [i for i, k in enumerate(apportion([c[3] for c in classes], sum(counts)))
                 for _ in range(k)]
        rng.shuffle(sizes)
        rng.shuffle(counts)
        rng.shuffle(kinds)
        it = iter(kinds)
        for (w, h), c in zip(sizes, counts):
            insts = [_ellipse(rng, w, h, *classes[next(it)][1:3], params) for _ in range(c)]
            idx = len(images) + 1
            images.append({"id": idx, "file_name": f"{idx:012d}.jpg", "width": w, "height": h,
                           "instances": insts})
    return images


def _ellipse(rng, w: int, h: int, lo: float, hi: float, params: dict) -> dict:
    margin = int(params["margin"])
    min_h = math.ceil(params["min_height_share"] * h) + 2
    hi = min(hi, 0.3 * w * h)
    area = math.exp(rng.uniform(math.log(lo), math.log(hi)))
    ratio = math.exp(rng.uniform(math.log(0.5), math.log(2.0)))      # height / width
    eh = max(min_h, math.sqrt(4 * area / math.pi * ratio))
    eh = min(eh, h - 2 * margin - 2)
    ew = min(max(3.0, 4 * area / (math.pi * eh)), w - 2 * margin - 2)
    cy = rng.uniform(margin + eh / 2, h - margin - eh / 2)
    cx = rng.uniform(margin + ew / 2, w - margin - ew / 2)
    return {"cx": cx, "cy": cy, "rx": ew / 2, "ry": eh / 2,
            "category_id": int(rng.choice(COCO_THING_IDS)),
            "colour": rng.integers(0, 256, size=3).tolist()}


def render(image: dict, seed: int) -> tuple[np.ndarray, list[tuple]]:
    """The image's pixels (uint8 HxWx3) and each instance's mask as
    (window mask, row offset, column offset)."""
    rng = np.random.default_rng(seed)
    w, h = image["width"], image["height"]
    base = rng.uniform(60, 190, size=3).astype(np.float32)
    tilt = rng.uniform(-40, 40, size=(2, 3)).astype(np.float32)
    ramp_y = (np.arange(h, dtype=np.float32) / h)[:, None, None] * tilt[0]
    ramp_x = (np.arange(w, dtype=np.float32) / w)[None, :, None] * tilt[1]
    img = base + ramp_y + ramp_x + rng.standard_normal((h, w, 3), dtype=np.float32) * 6.0
    masks = []
    for inst in image["instances"]:
        y0, y1 = int(inst["cy"] - inst["ry"]), int(math.ceil(inst["cy"] + inst["ry"])) + 1
        x0, x1 = int(inst["cx"] - inst["rx"]), int(math.ceil(inst["cx"] + inst["rx"])) + 1
        yy = np.arange(y0, y1, dtype=np.float32)[:, None]
        xx = np.arange(x0, x1, dtype=np.float32)[None, :]
        m = ((xx - inst["cx"]) / inst["rx"]) ** 2 + ((yy - inst["cy"]) / inst["ry"]) ** 2 <= 1.0
        win = img[y0:y1, x0:x1]
        win[m] = np.asarray(inst["colour"], np.float32)
        masks.append((m, y0, x0))
    img += rng.standard_normal((h, w, 3), dtype=np.float32) * 3.0
    return np.clip(img, 0, 255).astype(np.uint8), masks


def write(params: dict, seed: int, root: Path, workers: int = 8) -> dict:
    """Write the split under `root` (`images/val2017/`, `annotations/`);
    returns the plan."""
    from PIL import Image

    images = plan(params, seed)
    img_dir = root / "images" / "val2017"
    ann_dir = root / "annotations"
    img_dir.mkdir(parents=True, exist_ok=True)
    ann_dir.mkdir(parents=True, exist_ok=True)
    def one(image):
        pixels, masks = render(image, seed + image["id"])
        Image.fromarray(pixels).save(img_dir / image["file_name"],
                                     quality=int(params["jpeg_quality"]))
        out = []
        for inst, (m, oy, ox) in zip(image["instances"], masks):
            ys, xs = np.nonzero(m)
            full = np.zeros((image["height"], image["width"]), bool)
            full[oy:oy + m.shape[0], ox:ox + m.shape[1]] = m
            x0, y0 = int(xs.min()) + ox, int(ys.min()) + oy
            out.append({
                "image_id": image["id"], "category_id": inst["category_id"], "iscrowd": 0,
                "area": int(m.sum()),
                "bbox": [float(x0), float(y0), float(xs.max() + ox - x0 + 1),
                         float(ys.max() + oy - y0 + 1)],
                "segmentation": {"size": [image["height"], image["width"]],
                                 "counts": rle_string(rle_counts(full))}})
        return out

    with ThreadPoolExecutor(max_workers=workers) as pool:
        annos = [a for part in pool.map(one, images) for a in part]
    for i, a in enumerate(annos):
        a["id"] = i + 1
    data = {"images": [{k: im[k] for k in ("id", "file_name", "width", "height")}
                       for im in images],
            "annotations": annos,
            "categories": [{"id": i, "name": str(i)} for i in COCO_THING_IDS]}
    with open(ann_dir / "coconut_val.json", "w") as f:
        json.dump(data, f)
    return {"images": images, "root": root, "image_dir": img_dir, "annotation_dir": ann_dir}
