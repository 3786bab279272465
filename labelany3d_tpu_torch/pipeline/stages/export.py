"""Stage 8: combine per-scene results into the COCO3D Omni3D JSON."""

from __future__ import annotations

import os

from labelany3d_tpu_torch.export.omni3d import combine_results


class ExportStage:
    def __init__(self, results_dir: str, split: str, bbox_filename: str = "3dbbox.json"):
        self.results_dir = results_dir
        self.split = split
        self.bbox_filename = bbox_filename

    def run(self, output_path: str | None = None) -> dict:
        if output_path is None:
            output_path = os.path.join(self.results_dir, f"COCO3D_{self.split}.json")
        return combine_results(self.results_dir, self.split, output_path, self.bbox_filename)
