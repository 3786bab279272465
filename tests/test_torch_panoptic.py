"""The panoptic -> instance conversion (`data/panoptic.py`) against the JAX
package, on seeded panoptic masks: exact equality of the id maps and of
every annotation dict (ids, boxes, areas, RLE strings)."""

import numpy as np
import pytest

from labelany3d_tpu.data import panoptic as jpan
from labelany3d_tpu_torch.data import panoptic as tpan


def seeded_panoptic(seed: int, hw=(37, 53), n_segments: int = 9):
    """An RGB-encoded panoptic mask of rectangles with ids above 2^16 (all
    three channels used), its segments_info (things and stuff, one segment
    id absent from the mask), and the id map."""
    rng = np.random.default_rng(seed)
    h, w = hw
    ids = np.zeros(hw, np.int64)
    info = []
    for k in range(n_segments):
        sid = int(rng.integers(1, 1 << 24))
        y0, x0 = int(rng.integers(0, h - 4)), int(rng.integers(0, w - 4))
        y1, x1 = int(rng.integers(y0 + 1, h)), int(rng.integers(x0 + 1, w))
        if k != n_segments - 1:  # the last segment is listed but not drawn
            ids[y0:y1, x0:x1] = sid
        seg = {"id": sid, "category_id": int(rng.integers(1, 200)),
               "isthing": int(k % 3 != 2)}
        if k % 4 == 1:
            seg["iscrowd"] = 1
        info.append(seg)
    rgb = np.stack([ids % 256, (ids // 256) % 256, ids // 65536], axis=-1).astype(np.uint8)
    return rgb, info, ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_rgb_to_ids_matches_jax(seed):
    rgb, _, ids = seeded_panoptic(seed)
    got = tpan.panoptic_rgb_to_ids(rgb)
    want = jpan.panoptic_rgb_to_ids(rgb)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ids)
    flat = ids.astype(np.int32)
    np.testing.assert_array_equal(tpan.panoptic_rgb_to_ids(flat), jpan.panoptic_rgb_to_ids(flat))


@pytest.mark.parametrize("seed,compress", [(0, True), (1, True), (2, False)])
def test_convert_panoptic_item_matches_jax(seed, compress):
    rgb, info, _ = seeded_panoptic(seed)
    got = tpan.convert_panoptic_item(rgb, info, image_id=1000 + seed, start_annotation_id=7,
                                     compress_rle=compress)
    want = jpan.convert_panoptic_item(rgb, info, image_id=1000 + seed, start_annotation_id=7,
                                      compress_rle=compress)
    assert got == want
    assert got and all(a["area"] > 0 for a in got)


def test_output_filenames_match_jax():
    assert tpan.OUTPUT_FILENAMES == jpan.OUTPUT_FILENAMES
