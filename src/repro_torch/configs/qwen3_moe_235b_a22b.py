"""qwen3-moe-235b-a22b — 128-expert top-8 MoE. [hf:Qwen/Qwen3-235B-A22B]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # per-expert ffn width
    vocab_size=151936,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    activation="swiglu",
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=1536,
                  capacity_factor=1.25, aux_loss_weight=0.01),
    source="hf:Qwen/Qwen3-235B-A22B (94L, d 4096, 64H/4KV, 128 experts "
           "top-8, expert ff 1536, vocab 151936)",
)
