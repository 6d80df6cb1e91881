"""granite-moe-1b-a400m — 32-expert top-8 MoE. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                  # per-expert ffn width
    vocab_size=49155,
    rope_theta=10_000.0,
    norm="rmsnorm",
    activation="swiglu",
    moe=MoEConfig(n_experts=32, top_k=8, expert_d_ff=512,
                  capacity_factor=1.25, aux_loss_weight=0.01),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (24L, d 1024, 16H/8KV, "
           "32 experts top-8, expert ff 512, vocab 49155)",
)
