"""One-command checkpoint conversion: torch or safetensors -> the port's store.

Counterpart of `labelany3d_tpu/models/convert_cli.py`, with the same
arguments, defaults, entries and return value:

    python -m labelany3d_tpu_torch.models.convert_cli moge moge-vitl.pt \
        --out /ckpts            # -> /ckpts/moge/params.safetensors

Each entry runs the port's converter (the JAX package's, copied) at the
production config (the tiny test config with `--tiny`), and
`models/checkpoints.py::save_params` writes the converted Flax-layout tree
under the registry name; the backends read it back with `load_params`
(`models.ckpt_dir`). `.safetensors` files are read with the port's own
codec (`utils/safetensors_io.py`); others with `torch.load`.
"""

from __future__ import annotations

import argparse
import math


def _load_state(path: str) -> dict:
    """torch .pt/.pth/.bin or .safetensors -> {name: np.ndarray}. numpy has
    no bfloat16, so a bfloat16 tensor is widened to float32 (exactly).

    A torch file whose weights sit under 'model' or 'state_dict' (InvSR's
    noise predictor nests them so) gives the nested dict. The JAX CLI means
    to unwrap 'state_dict' too, but its `load_torch_checkpoint` has already
    turned the nested dict into a numpy object array, so its check never
    fires (ROADMAP.md F14); here the unwrap comes before the conversion."""
    import numpy as np
    import torch

    def as_numpy(v):
        if isinstance(v, torch.Tensor):
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return np.asarray(v)

    if path.endswith(".safetensors"):
        from labelany3d_tpu_torch.utils.safetensors_io import load_file

        return {k: as_numpy(v) for k, v in load_file(path).items()}
    state = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(state.get(key), dict):
            state = state[key]
    return {k: as_numpy(v) for k, v in state.items()}


def _moge(state, tiny):
    from labelany3d_tpu_torch.models.convert import convert_moge_checkpoint
    from labelany3d_tpu_torch.models.moge import MoGeConfig

    cfg = MoGeConfig.tiny_reference_test() if tiny else MoGeConfig.vitl()
    grid = (4, 4) if tiny else (37, 37)
    return convert_moge_checkpoint(state, cfg, grid)


def _depth_pro(state, tiny):
    from labelany3d_tpu_torch.models.convert import convert_depth_pro
    from labelany3d_tpu_torch.models.depth_pro import DepthPro35Config

    cfg = DepthPro35Config.tiny_test() if tiny else DepthPro35Config()
    return convert_depth_pro(state, cfg)


def _matcher(state, tiny):
    from labelany3d_tpu_torch.models.convert import convert_mast3r
    from labelany3d_tpu_torch.models.matcher import MatcherConfig

    cfg = MatcherConfig.tiny_test() if tiny else MatcherConfig.mast3r_vitl()
    return convert_mast3r(state, cfg)


def _sd_unet(state, tiny):
    from labelany3d_tpu_torch.models.diffusion import UNetConfig
    from labelany3d_tpu_torch.models.diffusion.convert import convert_sd_unet

    return convert_sd_unet(state, UNetConfig.tiny_test() if tiny else UNetConfig())


def _sd_vae(state, tiny):
    from labelany3d_tpu_torch.models.diffusion import VAEConfig
    from labelany3d_tpu_torch.models.diffusion.convert import convert_sd_vae

    return convert_sd_vae(state, VAEConfig.tiny_test() if tiny else VAEConfig())


def _clip_text(state, tiny):
    from labelany3d_tpu_torch.models.clip import CLIPTextConfig, convert_clip_text

    cfg = CLIPTextConfig.tiny_test() if tiny else CLIPTextConfig.sd15()
    return convert_clip_text(state, cfg)


def _clip_vision(state, tiny):
    from labelany3d_tpu_torch.models.clip import CLIPVisionConfig, convert_clip_vision

    cfg = CLIPVisionConfig.tiny_test() if tiny else CLIPVisionConfig.vitl14()
    return convert_clip_vision(state, cfg)


def _sam(state, tiny):
    from labelany3d_tpu_torch.models.sam import SamConfig, convert_sam

    return convert_sam(state, SamConfig.tiny_test() if tiny else SamConfig.vit_huge())


def _segformer(state, tiny):
    from labelany3d_tpu_torch.models.segformer import SegFormerConfig, convert_segformer

    cfg = SegFormerConfig.tiny_test() if tiny else SegFormerConfig.b2()
    return convert_segformer(state, cfg)


def _isnet(state, tiny):
    from labelany3d_tpu_torch.models.saliency import ISNetConfig, convert_isnet

    cfg = ISNetConfig.tiny_test() if tiny else ISNetConfig.general_use()
    return convert_isnet(state, cfg)


def _noise_predictor(state, tiny):
    from labelany3d_tpu_torch.models.diffusion.noise_predictor import (
        NoisePredictorConfig,
        convert_noise_predictor,
    )

    cfg = NoisePredictorConfig.tiny_test() if tiny else NoisePredictorConfig.sd_turbo()
    return convert_noise_predictor(state, cfg)


def _svrm(state, tiny):
    from labelany3d_tpu_torch.models.svrm import SVRMConfig, convert_svrm

    return convert_svrm(state, SVRMConfig.tiny_test() if tiny else SVRMConfig())


def _zero123(state, tiny):
    """Single-file path converts the UNet only; point `checkpoint` at the
    diffusers snapshot DIRECTORY to convert all four components."""
    from labelany3d_tpu_torch.models.diffusion.convert import convert_zero123

    if isinstance(state, dict) and "components" in state:
        return convert_zero123(**state["components"])
    return convert_zero123(unet_state=state)


def _trellis_cond(state, tiny, cfg_json=None):
    from labelany3d_tpu_torch.models.convert_trellis import convert_trellis_cond
    from labelany3d_tpu_torch.models.vit import ViTConfig

    name = (cfg_json or {}).get("image_cond_model", "dinov2_vitl14_reg")
    if tiny:  # the giant's SwiGLU MLP when pipeline.json names it (JAX ignores the name)
        return convert_trellis_cond(state, ViTConfig.tiny_test(pos_grid=(4, 4),
                                                               swiglu="vitg14" in name))
    return convert_trellis_cond(state, name=name)


def _trellis_ss_flow(state, tiny, cfg_json=None):
    from labelany3d_tpu_torch.models.convert_trellis import (
        convert_trellis_ss_flow,
        ss_flow_config_from_json,
    )
    from labelany3d_tpu_torch.models.trellis import SparseStructureConfig

    if tiny:
        cfg = SparseStructureConfig.tiny_test()
    else:
        cfg = (ss_flow_config_from_json(cfg_json) if cfg_json
               else SparseStructureConfig())
    return convert_trellis_ss_flow(state, cfg)


def _trellis_ss_dec(state, tiny, cfg_json=None):
    from labelany3d_tpu_torch.models.convert_trellis import (
        convert_trellis_ss_decoder,
        ss_decoder_config_from_json,
    )
    from labelany3d_tpu_torch.models.trellis import SSDecoderConfig

    if tiny:
        cfg = SSDecoderConfig.tiny_test()
    else:
        cfg = (ss_decoder_config_from_json(cfg_json) if cfg_json
               else SSDecoderConfig())
    return convert_trellis_ss_decoder(state, cfg)


def _trellis_slat_flow(state, tiny, cfg_json=None):
    from labelany3d_tpu_torch.models.convert_trellis import (
        convert_trellis_slat_flow,
        slat_flow_config_from_json,
    )
    from labelany3d_tpu_torch.models.trellis import SLatConfig

    if tiny:
        cfg = SLatConfig.tiny_test()
    else:
        cfg = slat_flow_config_from_json(cfg_json) if cfg_json else SLatConfig()
    return convert_trellis_slat_flow(state, cfg)


def _trellis_slat_gs(state, tiny, cfg_json=None):
    from labelany3d_tpu_torch.models.convert_trellis import (
        convert_trellis_slat_gs,
        slat_decoder_config_from_json,
    )
    from labelany3d_tpu_torch.models.trellis import SLatDecoderConfig

    if tiny:
        cfg = SLatDecoderConfig.tiny_test()
    else:
        cfg = (slat_decoder_config_from_json(cfg_json) if cfg_json
               else SLatDecoderConfig())
    return convert_trellis_slat_gs(state, cfg)


def _trellis_slat_mesh(state, tiny, cfg_json=None):
    from labelany3d_tpu_torch.models.convert_trellis import (
        convert_trellis_slat_mesh,
        slat_decoder_config_from_json,
    )
    from labelany3d_tpu_torch.models.trellis import SLatDecoderConfig

    if tiny:
        cfg = SLatDecoderConfig.tiny_test()
    else:
        cfg = (slat_decoder_config_from_json(cfg_json) if cfg_json
               else SLatDecoderConfig())
    return convert_trellis_slat_mesh(state, cfg)


# registry name -> converter(state, tiny) with the production config
def _mvd(state, tiny, cfg_json=None):
    """Hunyuan3D `weights/mvd_std` (SDXL + reference attention). `state`
    is either a bare UNet state dict or the dict `_load_mvd_dir` builds
    from the diffusers pipeline directory."""
    from labelany3d_tpu_torch.models.diffusion.convert import convert_mvd

    if "components" in state:
        comp = dict(state["components"])
        if cfg_json:
            comp.setdefault("unet_cfg_json", cfg_json)
        return convert_mvd(**comp)
    from labelany3d_tpu_torch.models.diffusion.mvd import MVDUNetConfig

    cfg = (MVDUNetConfig.from_hf_json(cfg_json) if cfg_json
           else (MVDUNetConfig.tiny_test() if tiny else MVDUNetConfig()))
    return convert_mvd(unet_state=state, unet_cfg=cfg)


CONVERTERS = {
    "moge": _moge,
    "depth_pro": _depth_pro,
    "matcher": _matcher,
    "sd_unet": _sd_unet,
    "sd_vae": _sd_vae,
    "clip_text": _clip_text,
    "clip_vision": _clip_vision,
    "sam": _sam,
    "segformer": _segformer,
    "isnet": _isnet,
    "noise_predictor": _noise_predictor,
    "trellis_cond": _trellis_cond,
    "trellis_ss_flow": _trellis_ss_flow,
    "trellis_ss_dec": _trellis_ss_dec,
    "trellis_slat_flow": _trellis_slat_flow,
    "trellis_slat_gs": _trellis_slat_gs,
    "trellis_slat_mesh": _trellis_slat_mesh,
    "svrm": _svrm,
    "zero123": _zero123,
    "mvd": _mvd,
}


def _load_zero123_dir(root: str) -> dict:
    """diffusers snapshot dir -> component state dicts for convert_zero123."""
    import glob
    import os

    def find(sub):
        for pat in ("*.safetensors", "*.bin", "*.pt"):
            hits = sorted(glob.glob(os.path.join(root, sub, pat)))
            if hits:
                return _load_state(hits[0])
        return None

    comp = {
        "unet_state": find("unet"),
        "vae_state": find("vae"),
        "vision_state": find("image_encoder"),
        "cc_state": find("clip_camera_projection") or find("cc_projection"),
    }
    return {"components": comp}


def _load_mvd_dir(root: str) -> dict:
    """Hunyuan3D `weights/mvd_std` diffusers pipeline dir -> component
    state dicts for `convert_mvd` (`hunyuan3d_mvd_std_pipeline.py:188-204`,
    `:455-472`: unet/, vae/, vision_encoder{,_2}/, uc_text_emb{,_2}.pt,
    ramping_coefficients in model_index.json or config.json)."""
    import glob
    import json
    import os

    def find(*subs):
        for sub in subs:
            for pat in ("*.safetensors", "*.bin", "*.pt"):
                hits = sorted(glob.glob(os.path.join(root, sub, pat)))
                if hits:
                    return _load_state(hits[0])
        return None

    comp: dict = {
        "unet_state": find("unet"),
        "vae_state": find("vae"),
        "vision_state": find("vision_encoder", "image_encoder"),
        "vision2_state": find("vision_encoder_2", "image_encoder_2"),
    }
    ucfg = os.path.join(root, "unet", "config.json")
    if os.path.exists(ucfg):
        with open(ucfg) as f:
            comp["unet_cfg_json"] = json.load(f)
    for key, fname in (("uc_text_emb", "uc_text_emb.pt"),
                       ("uc_text_emb_2", "uc_text_emb_2.pt")):
        p = os.path.join(root, fname)
        if os.path.exists(p):
            # uc_text_emb{,_2}.pt are RAW tensors, not state dicts
            # (`hunyuan3d_mvd_std_pipeline.py:462-472` torch.save/load).
            import numpy as np
            import torch

            t = torch.load(p, map_location="cpu", weights_only=True)
            if isinstance(t, dict):
                t = next(iter(t.values()))
            comp[key] = t.numpy() if hasattr(t, "numpy") else np.asarray(t)
    for cfg_name in ("model_index.json", "config.json"):
        p = os.path.join(root, cfg_name)
        if os.path.exists(p):
            with open(p) as f:
                cfg = json.load(f)
            if "ramping_coefficients" in cfg:
                comp["ramping_coefficients"] = cfg["ramping_coefficients"]
                break
    return {"components": comp}


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="Convert a released torch checkpoint into the store "
        "(<out>/<name>/params.safetensors) the port's backends load directly."
    )
    ap.add_argument("model", choices=sorted(CONVERTERS))
    ap.add_argument("checkpoint", help=".pt/.pth/.bin or .safetensors path")
    ap.add_argument("--out", default="checkpoints", help="checkpoint dir root")
    ap.add_argument("--name", default=None,
                    help="registry name (default: the model argument)")
    ap.add_argument("--tiny", action="store_true",
                    help="use the tiny test config (CI/self-test only)")
    ap.add_argument("--config", default=None,
                    help="HF model config json (TRELLIS models ship one "
                    "next to each safetensors; passes exact hyperparameters)")
    args = ap.parse_args(argv)

    import os

    from labelany3d_tpu_torch.models.checkpoints import flatten_tree, save_params

    if os.path.isdir(args.checkpoint):
        # diffusers pipeline snapshot dirs (multi-component checkpoints)
        dir_loaders = {"zero123": _load_zero123_dir, "mvd": _load_mvd_dir}
        if args.model not in dir_loaders:
            raise SystemExit(
                f"{args.model} expects a checkpoint FILE; directory input "
                f"is supported for {sorted(dir_loaders)}")
        state = dir_loaders[args.model](args.checkpoint)
    else:
        state = _load_state(args.checkpoint)
    fn = CONVERTERS[args.model]
    import inspect

    if "cfg_json" in inspect.signature(fn).parameters:
        cfg_json = None
        if args.config:
            import json

            with open(args.config) as f:
                cfg_json = json.load(f)
        params = fn(state, args.tiny, cfg_json=cfg_json)
    else:
        params = fn(state, args.tiny)

    n_params = sum(math.prod(p.shape) for p in flatten_tree(params).values())
    path = save_params(args.out, args.name or args.model, params)
    print(f"{args.model}: {n_params / 1e6:.1f}M params -> {path}")
    return path


if __name__ == "__main__":
    main()
