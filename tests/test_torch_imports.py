"""The port's import rule and device default.

`labelany3d_tpu_torch` imports torch and never JAX, Flax or the JAX package.
The check runs in a subprocess because `tests/conftest.py` imports JAX into
this one. A source scan backs it up for modules the import does not reach.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "labelany3d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "safetensors", "labelany3d_tpu")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import labelany3d_tpu_torch\n"
        "import labelany3d_tpu_torch.pipeline.runner\n"
        "import labelany3d_tpu_torch.pipeline.stages\n"
        "import labelany3d_tpu_torch.pipeline.backends\n"
        "import labelany3d_tpu_torch.models.convert\n"
        "import labelany3d_tpu_torch.models.depth_pro\n"
        "import labelany3d_tpu_torch.models.matcher\n"
        "import labelany3d_tpu_torch.geometry.edges\n"
        "import labelany3d_tpu_torch.pipeline.stages.boxes\n"
        "import labelany3d_tpu_torch.pipeline.stages.generative\n"
        "import labelany3d_tpu_torch.data.meshio\n"
        "import labelany3d_tpu_torch.models.trellis\n"
        "import labelany3d_tpu_torch.models.trellis.bake\n"
        "import labelany3d_tpu_torch.models.convert_trellis\n"
        "import labelany3d_tpu_torch.ops.morton\n"
        "import labelany3d_tpu_torch.ops.sparse_conv\n"
        "import labelany3d_tpu_torch.ops.marching_cubes\n"
        "import labelany3d_tpu_torch.ops.splat\n"
        "import labelany3d_tpu_torch.data.bpe\n"
        "import labelany3d_tpu_torch.models.clip\n"
        "import labelany3d_tpu_torch.models.diffusion\n"
        "import labelany3d_tpu_torch.models.diffusion.convert\n"
        "import labelany3d_tpu_torch.models.saliency\n"
        "import labelany3d_tpu_torch.models.elevation\n"
        "import labelany3d_tpu_torch.models.svrm\n"
        "import labelany3d_tpu_torch.models.spacecarve\n"
        "import labelany3d_tpu_torch.models.diffusion.mvd\n"
        "import labelany3d_tpu_torch.ops.sampling\n"
        "import labelany3d_tpu_torch.ops.knn\n"
        "import labelany3d_tpu_torch.utils.safetensors_io\n"
        "import labelany3d_tpu_torch.models.checkpoints\n"
        "import labelany3d_tpu_torch.models.convert_cli\n"
        "import labelany3d_tpu_torch.export.iou3d\n"
        "import labelany3d_tpu_torch.export.evaluate\n"
        "import labelany3d_tpu_torch.data.panoptic\n"
        "import labelany3d_tpu_torch.geometry.procrustes\n"
        "import labelany3d_tpu_torch.geometry.camera\n"
        "import labelany3d_tpu_torch.geometry.masks\n"
        "import labelany3d_tpu_torch.export.hungarian\n"
        "import labelany3d_tpu_torch.registration.process\n"
        "import labelany3d_tpu_torch.utils.trajectory\n"
        "import labelany3d_tpu_torch.utils.profiling\n"
        "import labelany3d_tpu_torch.native\n"
        "import labelany3d_tpu_torch.parallel\n"
        "import labelany3d_tpu_torch.parallel.mesh\n"
        "import labelany3d_tpu_torch.parallel.sharding\n"
        "import labelany3d_tpu_torch.parallel.sp\n"
        "import labelany3d_tpu_torch.parallel.train\n"
        "import labelany3d_tpu_torch.parallel.launch\n"
        "import labelany3d_tpu_torch.parallel.dryrun\n"
        "from labelany3d_tpu_torch.data import rle\n"
        "rle.rle_decode(rle.rle_encode(__import__('numpy').eye(4, dtype=bool)))\n"
        "assert rle.PATHS['native'] + rle.PATHS['numpy'] == 4\n"
        "from labelany3d_tpu_torch.models.convert_cli import CONVERTERS, _load_state\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_source_scan_finds_no_forbidden_import():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    # The checkpoint models and converters are scanned too.
    assert {"convert.py", "depth_pro.py", "matcher.py", "moge.py", "vit.py"} <= \
        {f.name for f in files if f.parent.name == "models"}
    # The modules of the boxes stage and of stages 2 to 6 are scanned too.
    assert {"boxes.py", "generative.py"} <= {f.name for f in files if f.parent.name == "stages"}
    assert (PKG / "geometry" / "edges.py") in files
    # TRELLIS's modules and ops are scanned too.
    assert {"dit.py", "samplers.py", "sparse_structure.py", "slat.py", "decoders.py", "bake.py",
            "pipeline.py"} <= {f.name for f in files if f.parent.name == "trellis"}
    assert {"convert_trellis.py"} <= {f.name for f in files if f.parent.name == "models"}
    assert {"morton.py", "sparse_conv.py", "marching_cubes.py", "splat.py"} <= \
        {f.name for f in files if f.parent.name == "ops"}
    # The SD-class stack is scanned too.
    assert {"unet.py", "vae.py", "sampler.py", "noise_predictor.py", "pipelines.py",
            "convert.py"} <= {f.name for f in files if f.parent.name == "diffusion"}
    assert {"clip.py", "saliency.py", "elevation.py"} <= \
        {f.name for f in files if f.parent.name == "models"}
    assert (PKG / "data" / "bpe.py") in files
    # The Hunyuan3D path is scanned too.
    assert {"svrm.py", "spacecarve.py"} <= {f.name for f in files if f.parent.name == "models"}
    assert (PKG / "models" / "diffusion" / "mvd.py") in files
    assert {"sampling.py", "knn.py"} <= {f.name for f in files if f.parent.name == "ops"}
    # The store, the convert CLI, scoring and the panoptic conversion too.
    assert {"checkpoints.py", "convert_cli.py"} <= \
        {f.name for f in files if f.parent.name == "models"}
    assert {"iou3d.py", "evaluate.py"} <= {f.name for f in files if f.parent.name == "export"}
    assert (PKG / "data" / "panoptic.py") in files
    assert (PKG / "utils" / "safetensors_io.py") in files
    # The host leftovers, the trajectory video and the native codec's loader.
    assert {"procrustes.py", "camera.py", "masks.py", "transforms.py"} <= \
        {f.name for f in files if f.parent.name == "geometry"}
    assert {"trajectory.py", "profiling.py", "logging.py"} <= \
        {f.name for f in files if f.parent.name == "utils"}
    assert (PKG / "native" / "__init__.py") in files and (PKG / "native" / "rle.cpp").exists()
    # The multi-device modules and the fine-tuning step.
    assert {"__init__.py", "mesh.py", "sharding.py", "sp.py", "train.py", "launch.py",
            "dryrun.py"} <= {f.name for f in files if f.parent.name == "parallel"}
    bad = [(f.name, m) for f in files for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_stages_import_no_pillow_at_module_level():
    """The card's machine has no Pillow: no stage module imports it at its
    top level (only inside the functions that decode other formats)."""
    stages = sorted((PKG / "pipeline" / "stages").glob("*.py"))
    assert len(stages) >= 9
    for f in stages:
        top = [n for n in ast.parse(f.read_text()).body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] == "PIL"], f.name


def test_entry_points_default_to_cuda(monkeypatch):
    from labelany3d_tpu_torch.pipeline.backends import (
        FakeDepthBackend,
        TorchMatcherBackend,
        make_depth,
    )
    from labelany3d_tpu_torch.registration.renderer import OrbitRenderer
    from labelany3d_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_depth("tiny_test")
    with pytest.raises(RuntimeError, match="CUDA"):
        FakeDepthBackend([[[1.0]]], [[1, 0, 0], [0, 1, 0], [0, 0, 1]])
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchMatcherBackend(tiny=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OrbitRenderer()
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.stages import BicubicEnhance, BoxStage

    with pytest.raises(RuntimeError, match="CUDA"):
        BicubicEnhance()
    with pytest.raises(RuntimeError, match="CUDA"):
        BoxStage(PipelineConfig(), None, "", "val", instance_provider=object())
    assert TorchMatcherBackend(device="cpu").cfg.dec_depth == 2  # tiny, as in JAX
    assert TorchMatcherBackend(tiny=False, device="cpu").cfg.dec_depth == 12
    assert resolve_device("cpu").type == "cpu"
    # The checkpoint presets build (their models on first use), on the CPU
    # only when asked.
    with pytest.raises(RuntimeError, match="CUDA"):
        make_depth("vitl_reference")
    ref = make_depth("vitl_reference", device="cpu")
    assert ref.moge is None and ref.moge_cfg.head_style == "reference" and ref._dp35


def test_sd_entry_points_default_to_cuda(monkeypatch):
    """The SD-class backends and their models run on CUDA unless the caller
    passes "cpu"; nothing falls back."""
    from labelany3d_tpu_torch.models.diffusion import (
        AmodalCompletion,
        InvSREnhance,
        TextConditioner,
        Zero123NovelView,
    )
    from labelany3d_tpu_torch.models.clip import CLIPTextConfig
    from labelany3d_tpu_torch.models.saliency import RembgSegmenter
    from labelany3d_tpu_torch.pipeline.backends import (
        make_completion,
        make_elevation,
        make_enhance,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: make_enhance("invsr"), lambda: make_completion("our"),
                 lambda: make_elevation("zero123"), lambda: InvSREnhance(tiny=True),
                 lambda: AmodalCompletion(tiny=True), lambda: Zero123NovelView(tiny=True),
                 lambda: RembgSegmenter(), lambda: TextConditioner(CLIPTextConfig.tiny_test())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert make_elevation("zero123", tiny=True, device="cpu").novel_views.device.type == "cpu"


def test_hunyuan_entry_points_default_to_cuda(monkeypatch):
    """Stage 6's Hunyuan3D backends and their models run on CUDA unless the
    caller passes "cpu"; nothing falls back."""
    from labelany3d_tpu_torch.models.diffusion import MVDStdViews
    from labelany3d_tpu_torch.models.spacecarve import SpaceCarveReconstruction
    from labelany3d_tpu_torch.models.svrm import SVRMReconstruction
    from labelany3d_tpu_torch.pipeline.backends import make_reconstruction

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: make_reconstruction("hunyuan3d", tiny=True),
                 lambda: make_reconstruction("hunyuan3d", tiny=True, views="zero123"),
                 lambda: make_reconstruction("hunyuan3d_carve", tiny=True),
                 lambda: MVDStdViews(tiny=True), lambda: SVRMReconstruction(),
                 lambda: SpaceCarveReconstruction()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    rec = make_reconstruction("hunyuan3d", tiny=True, device="cpu")
    assert rec.device.type == rec.novel_views.device.type == "cpu"


def test_scoring_defaults_to_cuda(monkeypatch, tmp_path):
    """COCO3D scoring runs on CUDA unless the caller passes "cpu" (`main`'s
    `--device` defaults to cuda); nothing falls back."""
    import json

    from labelany3d_tpu_torch.export import evaluate

    empty = {"images": [{"id": 1, "file_path": "a.jpg"}], "annotations": []}
    (tmp_path / "a.json").write_text(json.dumps(empty))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.compare_coco3d(empty, empty)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main([str(tmp_path / "a.json"), str(tmp_path / "a.json")])
    assert evaluate.compare_coco3d(empty, empty, device="cpu")["matched_pairs"] == 0
    assert evaluate.main([str(tmp_path / "a.json"), str(tmp_path / "a.json"),
                          "--device", "cpu"]) == 0


def test_host_leftovers_default_to_cuda(monkeypatch, tmp_path):
    """The camera and procrustes functions, the auction, the mask statistics
    and the trajectory renderer run on CUDA when given numpy arrays, unless
    the caller passes "cpu"; nothing falls back. Given tensors, they compute
    where the tensors live."""
    import numpy as np

    from labelany3d_tpu_torch.export.hungarian import auction_assignment, iou2d_matrix
    from labelany3d_tpu_torch.geometry import camera, masks, procrustes, transforms
    from labelany3d_tpu_torch.pipeline.scene import SceneDir
    from labelany3d_tpu_torch.utils.trajectory import render_trajectory_video

    pts = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    K = np.eye(3, dtype=np.float32)
    calls = {
        "kabsch": lambda **kw: procrustes.kabsch(pts, pts, **kw),
        "umeyama": lambda **kw: procrustes.umeyama(pts, pts, **kw),
        "look_at": lambda **kw: camera.look_at(pts[0], pts[1], **kw),
        "orbit_camera": lambda **kw: camera.orbit_camera(10.0, 20.0, **kw),
        "project_points": lambda **kw: camera.project_points(pts, K, **kw),
        "point_to_plane_distance": lambda **kw: camera.point_to_plane_distance(
            np.float32([0, 0, 1, 0]), pts, **kw),
        "scale_intrinsics": lambda **kw: camera.scale_intrinsics(K, 2.0, 2.0, **kw),
        "normalized_to_pixel_intrinsics": lambda **kw: camera.normalized_to_pixel_intrinsics(
            K, 64, 48, **kw),
        "compose_transform": lambda **kw: transforms.compose_transform(K, pts[0], **kw),
        "auction_assignment": lambda **kw: auction_assignment(np.eye(3), **kw),
        "iou2d_matrix": lambda **kw: iou2d_matrix(np.ones((2, 4)), np.ones((3, 4)), **kw),
        "analyze_mask": lambda **kw: masks.analyze_mask(np.ones((3, 16, 16), bool), **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        out = call(device="cpu")
        first = out[0] if isinstance(out, tuple) else out
        assert first.device.type == "cpu", name
    assert procrustes.kabsch(torch.from_numpy(pts), pts)[0].device.type == "cpu"
    sd = SceneDir(tmp_path)
    (tmp_path / "reconstruction").mkdir()
    from labelany3d_tpu_torch.data.meshio import Mesh, save_glb

    save_glb(tmp_path / "reconstruction" / "full_scene.glb",
             Mesh(pts[:3], np.array([[0, 1, 2]], np.int32)))
    with pytest.raises(RuntimeError, match="CUDA"):
        render_trajectory_video(sd, str(tmp_path / "v.mp4"), frames_per_segment=1)


def test_parallel_entry_points_default_to_cuda(monkeypatch):
    """The dry run, the launcher and the mesh run on CUDA (NCCL) unless
    the caller passes "cpu"; nothing falls back."""
    from labelany3d_tpu_torch.parallel.dryrun import dryrun_multichip, entry
    from labelany3d_tpu_torch.parallel.launch import process_group, run_ranks
    from labelany3d_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: entry(), lambda: dryrun_multichip(1), lambda: make_mesh(1, 1),
                 lambda: run_ranks(print, 1), lambda: process_group().__enter__()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1, device="cpu")
