"""Instance providers. Only the COCONUT path is ported; the wild-mode
segmentation source of `labelany3d_tpu/data/sources.py` waits."""

from __future__ import annotations

import numpy as np

from labelany3d_tpu_torch.data.coconut import InstanceSet, read_instances


class CoconutInstanceProvider:
    """Instances from COCONUT annotations (the labeled COCO path)."""

    needs_image = False  # stages skip the image decode when False

    def __init__(self, loader):
        self.loader = loader

    def instances(self, info: dict, image: np.ndarray | None = None) -> InstanceSet:
        annos = self.loader.get_annotations(info["id"])
        return read_instances(annos, (info["width"], info["height"]))
