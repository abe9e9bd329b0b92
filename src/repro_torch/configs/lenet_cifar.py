"""The paper's own backbone: LeNet-style CNN on 32x32x3 inputs."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="lenet-cifar",
    family="conv",
    source="AdaSplit paper §4.4 (LeNet backbone)",
    is_conv=True,
    image_size=32,
    n_classes=10,
    conv_channels=(6, 16, 32, 64, 64),  # 5 conv blocks -> mu=0.2 splits at 1
    d_model=84,                         # penultimate fc width
    mu=0.2,
))
