"""deepseek-v2-lite — MLA + DeepSeekMoE (64 routed top-6, 2 shared).
[hf:deepseek-ai/DeepSeek-V2-Lite, arXiv:2405.04434]"""
from repro_torch.configs.mla_moe import (DeepSeekMoEConfig, MLAConfig,
                                         MLAMoEConfig, YarnConfig)

CONFIG = MLAMoEConfig(
    name="deepseek-v2-lite",
    family="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,              # qk_nope_head_dim and v_head_dim
    d_ff=10944,                # the dense layer's width
    vocab_size=102400,
    rope_theta=10_000.0,
    norm="rmsnorm",
    activation="swiglu",
    mla=MLAConfig(kv_lora_rank=512, qk_rope_head_dim=64),
    yarn=YarnConfig(factor=40.0, original_max_position_embeddings=4096,
                    beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                    mscale_all_dim=0.707),
    dsmoe=DeepSeekMoEConfig(n_routed_experts=64, top_k=6, expert_d_ff=1408,
                            n_shared_experts=2, first_k_dense=1,
                            routed_scaling_factor=1.0, norm_topk_prob=False,
                            aux_loss_alpha=0.001),
    source="hf:deepseek-ai/DeepSeek-V2-Lite config.json (27L, d 2048, 16H "
           "MLA kv rank 512 nope 128 rope 64 v 128, no q-LoRA; layer 0 dense "
           "ff 10944; 64 routed experts top-6 of ff 1408 + 2 shared; YaRN "
           "x40 from 4096; vocab 102400); aux_loss_alpha 0.001 as recalled",
)
