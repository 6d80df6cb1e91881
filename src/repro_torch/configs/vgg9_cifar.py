"""Paper's own CIFAR-10 model: VGG-9. [paper §V-A, ref 43]

111.7 Mb fp32 update size in the paper.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="vgg9-cifar",
    family="cnn",
    n_layers=6,          # 6 conv layers (VGG-9 = 6 conv + 3 dense)
    d_model=64,          # first conv channels; doubles per stage
    n_heads=0,
    n_kv_heads=0,
    d_ff=512,            # dense hidden
    vocab_size=10,
    norm="none",
    activation="relu",
    dtype="float32",
    source="Simonyan & Zisserman 2015 VGG adapted to CIFAR (VGG-9); paper "
           "§V-A: 111.7 Mb fp32 update",
)
