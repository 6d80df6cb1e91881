"""falcon-mamba-7b — attention-free Mamba-1 SSM LM. [arXiv:2410.05355]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                      # attention-free, no separate MLP (mamba block)
    vocab_size=65024,
    norm="rmsnorm",
    activation="silu",
    ssm=SSMConfig(d_inner=8192, state_dim=16, conv_width=4, dt_rank=256),
    source="arXiv:2410.05355 (Falcon Mamba: 64 layers, d_model 4096, "
           "d_inner 8192, ssm_state 16, vocab 65024)",
)
