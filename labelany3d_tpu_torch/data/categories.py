"""COCO / COCONUT / Omni3D category tables.

Public dataset constants required for output-format parity:
  * `COCO_CATEGORIES`: COCO panoptic id -> name (reference:
    `src/util.py:419-451`), used to label instances from COCONUT ids.
  * `OMNI3D_CATEGORIES`: the 81-entry Omni3D-style category table with the
    exact ids the reference exports (`src/tools/combine_results.py:18-99`) —
    COCO3D consumers (OVMono3D finetuning) key on these ids.
"""

from __future__ import annotations

# COCO "thing" categories (panoptic ids with gaps).
_COCO_THINGS = {
    1: "person", 2: "bicycle", 3: "car", 4: "motorcycle", 5: "airplane",
    6: "bus", 7: "train", 8: "truck", 9: "boat", 10: "traffic light",
    11: "fire hydrant", 13: "stop sign", 14: "parking meter", 15: "bench",
    16: "bird", 17: "cat", 18: "dog", 19: "horse", 20: "sheep", 21: "cow",
    22: "elephant", 23: "bear", 24: "zebra", 25: "giraffe", 27: "backpack",
    28: "umbrella", 31: "handbag", 32: "tie", 33: "suitcase", 34: "frisbee",
    35: "skis", 36: "snowboard", 37: "sports ball", 38: "kite",
    39: "baseball bat", 40: "baseball glove", 41: "skateboard",
    42: "surfboard", 43: "tennis racket", 44: "bottle", 46: "wine glass",
    47: "cup", 48: "fork", 49: "knife", 50: "spoon", 51: "bowl",
    52: "banana", 53: "apple", 54: "sandwich", 55: "orange", 56: "broccoli",
    57: "carrot", 58: "hot dog", 59: "pizza", 60: "donut", 61: "cake",
    62: "chair", 63: "couch", 64: "potted plant", 65: "bed",
    67: "dining table", 70: "toilet", 72: "tv", 73: "laptop", 74: "mouse",
    75: "remote", 76: "keyboard", 77: "cell phone", 78: "microwave",
    79: "oven", 80: "toaster", 81: "sink", 82: "refrigerator", 84: "book",
    85: "clock", 86: "vase", 87: "scissors", 88: "teddy bear",
    89: "hair drier", 90: "toothbrush",
}

# COCO panoptic "stuff" categories (isthing=0), kept for wild-mode filtering.
_COCO_STUFF = {
    92: "banner", 93: "blanket", 95: "bridge", 100: "cardboard",
    107: "counter", 109: "curtain", 112: "door-stuff", 118: "floor-wood",
    119: "flower", 122: "fruit", 125: "gravel", 128: "house", 130: "light",
    133: "mirror-stuff", 138: "net", 141: "pillow", 144: "platform",
    145: "playingfield", 147: "railroad", 148: "river", 149: "road",
    151: "roof", 154: "sand", 155: "sea", 156: "shelf", 159: "snow",
    161: "stairs", 166: "tent", 168: "towel", 171: "wall-brick",
    175: "wall-stone", 176: "wall-tile", 177: "wall-wood",
    178: "water-other", 180: "window-blind", 181: "window-other",
    184: "tree-merged", 185: "fence-merged", 186: "ceiling-merged",
    187: "sky-other-merged", 188: "cabinet-merged", 189: "table-merged",
    190: "floor-other-merged", 191: "pavement-merged", 192: "mountain-merged",
    193: "grass-merged", 194: "dirt-merged", 195: "paper-merged",
    196: "food-other-merged", 197: "building-other-merged", 198: "rock-merged",
    199: "wall-other-merged", 200: "rug-merged",
}

COCO_CATEGORIES: dict[int, str] = {**_COCO_THINGS, **_COCO_STUFF}

# Omni3D-style export table: (name, omni3d_id, supercategory). Ids follow the
# reference's export exactly (`src/tools/combine_results.py:18-99`).
_OMNI3D_ROWS = [
    ("person", 7, "person"),
    ("bicycle", 11, "vehicle"), ("car", 1, "vehicle"),
    ("motorcycle", 10, "vehicle"), ("airplane", 98, "vehicle"),
    ("bus", 12, "vehicle"), ("train", 99, "vehicle"), ("truck", 5, "vehicle"),
    ("boat", 100, "vehicle"),
    ("traffic light", 101, "outdoor"), ("fire hydrant", 102, "outdoor"),
    ("stop sign", 103, "outdoor"), ("parking meter", 104, "outdoor"),
    ("bench", 105, "outdoor"),
    ("bird", 106, "animal"), ("cat", 107, "animal"), ("dog", 108, "animal"),
    ("horse", 109, "animal"), ("sheep", 110, "animal"), ("cow", 111, "animal"),
    ("elephant", 112, "animal"), ("bear", 113, "animal"),
    ("zebra", 114, "animal"), ("giraffe", 115, "animal"),
    ("backpack", 116, "accessory"), ("umbrella", 117, "accessory"),
    ("handbag", 118, "accessory"), ("tie", 119, "accessory"),
    ("suitcase", 120, "accessory"),
    ("frisbee", 121, "sports"), ("skis", 122, "sports"),
    ("snowboard", 123, "sports"), ("sports ball", 124, "sports"),
    ("kite", 125, "sports"), ("baseball bat", 126, "sports"),
    ("baseball glove", 127, "sports"), ("skateboard", 128, "sports"),
    ("surfboard", 129, "sports"), ("tennis racket", 130, "sports"),
    ("bottle", 15, "kitchen"), ("wine glass", 131, "kitchen"),
    ("cup", 19, "kitchen"), ("fork", 132, "kitchen"),
    ("knife", 133, "kitchen"), ("spoon", 134, "kitchen"),
    ("bowl", 56, "kitchen"),
    ("banana", 135, "food"), ("apple", 136, "food"),
    ("sandwich", 137, "food"), ("orange", 138, "food"),
    ("broccoli", 139, "food"), ("carrot", 140, "food"),
    ("hot dog", 141, "food"), ("pizza", 142, "food"),
    ("donut", 143, "food"), ("cake", 144, "food"),
    ("chair", 18, "furniture"), ("couch", 145, "furniture"),
    ("potted plant", 73, "furniture"), ("bed", 39, "furniture"),
    ("dining table", 146, "furniture"), ("toilet", 32, "furniture"),
    ("tv", 147, "electronic"), ("laptop", 20, "electronic"),
    ("mouse", 81, "electronic"), ("remote", 95, "electronic"),
    ("keyboard", 77, "electronic"), ("cell phone", 148, "electronic"),
    ("microwave", 54, "appliance"), ("oven", 57, "appliance"),
    ("toaster", 72, "appliance"), ("sink", 28, "appliance"),
    ("refrigerator", 49, "appliance"),
    ("book", 149, "indoor"), ("clock", 87, "indoor"), ("vase", 58, "indoor"),
    ("scissors", 150, "indoor"), ("teddy bear", 151, "indoor"),
    ("hair drier", 152, "indoor"), ("toothbrush", 153, "indoor"),
]

OMNI3D_CATEGORIES: list[dict] = [
    {"supercategory": sc, "id": cid, "name": name} for name, cid, sc in _OMNI3D_ROWS
]

CATEGORY_NAME_TO_OMNI3D_ID: dict[str, int] = {c["name"]: c["id"] for c in OMNI3D_CATEGORIES}


def category_names(category_ids) -> list[str]:
    """COCO category ids -> names ('unknown' for unmapped ids).

    Parity: `src/util.py:454-462` (`replace_categories_with_supercategories`,
    which despite its name maps ids to plain names).
    """
    return [COCO_CATEGORIES.get(int(cid), "unknown") for cid in category_ids]
