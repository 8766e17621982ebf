"""ResNet-50 (paper model), bottleneck blocks, GroupNorm.

SMOKE keeps the JAX package's blocks (2, 2, 2, 2): a sum of 8, so it
builds *basic* blocks (a bottleneck ResNet has more than 8 blocks).
"""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="resnet50", family="resnet", resnet_blocks=(3, 4, 6, 3),
    num_classes=43, image_size=32, compute_dtype="float32",
)

SMOKE = ModelConfig(
    name="resnet50-smoke", family="resnet", resnet_blocks=(2, 2, 2, 2),
    num_classes=10, image_size=16, compute_dtype="float32",
)

register("resnet50", FULL, SMOKE)
