"""DenseNet-121 (paper model): blocks (6,12,24,16), growth 32, GroupNorm."""
from repro_torch.config import ModelConfig
from repro_torch.configs import register

FULL = ModelConfig(
    name="densenet121", family="densenet",
    densenet_blocks=(6, 12, 24, 16), growth_rate=32,
    num_classes=43, image_size=32, compute_dtype="float32",
)

SMOKE = ModelConfig(
    name="densenet-smoke", family="densenet",
    densenet_blocks=(2, 2), growth_rate=8,
    num_classes=10, image_size=16, compute_dtype="float32",
)

register("densenet121", FULL, SMOKE)
