from .unet import UNetModelSwin
from .unet_variants import GlobalAttentionBlock, UNetModel, UNetModelConv
from .vqgan import AutoencoderKL, Decoder, Encoder, IdentityFirstStage, VectorQuantizer, VQModel

__all__ = ["UNetModelSwin", "UNetModel", "UNetModelConv", "GlobalAttentionBlock", "VQModel",
           "AutoencoderKL", "IdentityFirstStage", "Encoder", "Decoder", "VectorQuantizer"]
