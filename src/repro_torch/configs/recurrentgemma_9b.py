"""recurrentgemma-9b — RG-LRU + local attention hybrid (1 attn : 2 recurrent).
[arXiv:2402.19427 (Griffin) / RecurrentGemma-9B model card]"""
from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                # 38 blocks with pattern (rglru, rglru, attn)
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,               # MQA in the local-attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    norm="rmsnorm",
    activation="geglu",
    hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"),
                        lru_width=4096, attn_window=2048),
    source="arXiv:2402.19427 (RecurrentGemma-9B: 38L, d 4096, 16H MQA "
           "kv=1, ff 12288, vocab 256000, window 2048, 1:2 attn:recurrent)",
)
