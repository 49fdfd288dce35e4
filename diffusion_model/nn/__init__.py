from diffusion_model.nn.egnn import EGCL, EquivariantGNN
from diffusion_model.nn.compressor import SpectrumCompressor
from diffusion_model.nn.gamma import GammaNetwork, PositiveLinear
from diffusion_model.nn.denoiser import DiffusionDenoiser
from diffusion_model.nn.cn_mlp import CNPredictor

__all__ = [
    "EGCL",
    "EquivariantGNN",
    "SpectrumCompressor",
    "GammaNetwork",
    "PositiveLinear",
    "DiffusionDenoiser",
    "CNPredictor",
]
