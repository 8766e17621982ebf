"""ResNet-18 — the paper's primary model (He et al. 2015), GroupNorm."""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="resnet18", family="resnet", resnet_blocks=(2, 2, 2, 2),
    num_classes=43, image_size=32, compute_dtype="float32",
)

SMOKE = ModelConfig(
    name="resnet18-smoke", family="resnet", resnet_blocks=(1, 1),
    num_classes=10, image_size=16, compute_dtype="float32",
)

register("resnet18", FULL, SMOKE)
