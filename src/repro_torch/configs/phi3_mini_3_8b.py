"""phi3-mini-3.8b — dense decoder, RoPE + SwiGLU + GQA(32kv). [arXiv:2404.14219]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    norm="rmsnorm",
    activation="swiglu",
    source="arXiv:2404.14219 (phi-3-mini: 32L, d 3072, 32H/32KV, ff 8192, "
           "vocab 32064)",
)
