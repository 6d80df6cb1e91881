"""Paper's own FMNIST model: small 2-layer CNN (McMahan et al. FedAvg CNN).

53.22 Mb update size in the paper (float32). [paper §V-A, ref 1]
"""
from repro_torch.configs.base import ArchConfig

# CNN family uses the cnn-specific fields re-purposed:
#   d_model -> base conv channels, d_ff -> dense hidden, n_layers -> conv blocks
CONFIG = ArchConfig(
    name="fmnist-cnn",
    family="cnn",
    n_layers=2,          # two 5x5 conv blocks (32, 64 channels)
    d_model=32,          # first conv channels
    n_heads=0,
    n_kv_heads=0,
    d_ff=512,            # dense hidden
    vocab_size=10,       # classes
    norm="none",
    activation="relu",
    dtype="float32",
    source="McMahan et al. 2017 (FedAvg CNN: 2x conv5x5 32/64 + dense 512); "
           "paper §V-A: 53.22 Mb fp32 update",
)
