"""qwen2-7b — dense GQA decoder with QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    activation="swiglu",
    source="arXiv:2407.10671 (Qwen2-7B: 28L, d 3584, 28H/4KV GQA, QKV bias, "
           "ff 18944, vocab 152064)",
)
