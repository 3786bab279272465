"""Latent-diffusion family (PyTorch): UNet, VAE, samplers, task pipelines.

Counterpart of `labelany3d_tpu/models/diffusion/` for three reference model
roles on one SD-1.5-class architecture:

  * InvSR enhancement: SD-turbo partial-inversion super-resolution, with
    its optional learned inversion noise (`NoisePredictor`);
  * amodal completion: InstructPix2Pix-style image-conditioned editing
    with dual CFG (image guidance 1.5, text guidance 8.5, 50 steps);
  * Zero123 novel views: image + relative-camera conditioned generation
    (4 views at +-10 degrees of elevation and azimuth for stage 5);

and, on an SDXL-class UNet, the Hunyuan3D mvd_std multi-view diffusion
(`mvd.py`: six orbit views from one 3x2 grid latent under reference-only
attention), the view source of stage 6's `run.obj_rec=hunyuan3d`.

The modules match the SD-1.5 and SDXL graphs module for module, so released
weights map by name (`convert.py`).
"""

from labelany3d_tpu_torch.models.diffusion.mvd import (
    MVDConfig,
    MVDStdViews,
    MVDTransformer,
    MVDUNet,
    MVDUNetConfig,
    euler_ancestral_schedule,
    euler_ancestral_step,
)
from labelany3d_tpu_torch.models.diffusion.noise_predictor import (
    NoisePredictor,
    NoisePredictorConfig,
    convert_noise_predictor,
)
from labelany3d_tpu_torch.models.diffusion.pipelines import (
    AmodalCompletion,
    InvSREnhance,
    TextConditioner,
    Zero123NovelView,
)
from labelany3d_tpu_torch.models.diffusion.sampler import (
    DDIMConfig,
    add_noise,
    ddim_sample,
    make_alphas,
)
from labelany3d_tpu_torch.models.diffusion.unet import UNet2D, UNetConfig
from labelany3d_tpu_torch.models.diffusion.vae import AutoencoderKL, Decoder, Encoder, VAEConfig

__all__ = [
    "UNetConfig", "UNet2D", "VAEConfig", "Encoder", "Decoder", "AutoencoderKL",
    "DDIMConfig", "ddim_sample", "add_noise", "make_alphas", "InvSREnhance",
    "AmodalCompletion", "Zero123NovelView", "TextConditioner", "NoisePredictor",
    "NoisePredictorConfig", "convert_noise_predictor", "MVDConfig", "MVDStdViews",
    "MVDTransformer", "MVDUNet", "MVDUNetConfig", "euler_ancestral_schedule",
    "euler_ancestral_step",
]
