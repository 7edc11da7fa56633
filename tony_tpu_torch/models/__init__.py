"""Model forward passes, generation and weight carry-over: the
counterparts of `tony_tpu/models/__init__.py`'s exports."""

from tony_tpu_torch.models.generate import generate, generate_text
from tony_tpu_torch.models.linear import (
    linreg_forward, linreg_init, linreg_loss,
)
from tony_tpu_torch.models.llama import (
    LlamaConfig, llama_forward, llama_init, llama_loss, llama_param_axes,
)
from tony_tpu_torch.models.mnist import mnist_forward, mnist_init, mnist_loss
from tony_tpu_torch.models.moe import (
    MoEConfig, moe_forward, moe_init, moe_loss, moe_param_axes,
)
from tony_tpu_torch.models.resnet import (
    ResNetConfig, resnet_forward, resnet_init, resnet_loss,
)
from tony_tpu_torch.models.vit import (
    ViTConfig, vit_forward, vit_init, vit_loss, vit_param_axes,
)

__all__ = [
    "generate", "generate_text",
    "LlamaConfig", "llama_forward", "llama_init", "llama_loss",
    "llama_param_axes", "mnist_forward", "mnist_init", "mnist_loss",
    "linreg_forward", "linreg_init", "linreg_loss",
    "MoEConfig", "moe_forward", "moe_init", "moe_loss", "moe_param_axes",
    "ResNetConfig", "resnet_forward", "resnet_init", "resnet_loss",
    "ViTConfig", "vit_forward", "vit_init", "vit_loss", "vit_param_axes",
]
