"""pixtral-12b — VLM: mistral-nemo-style decoder consuming patch embeddings.
[hf:mistralai/Pixtral-12B-2409]

The Pixtral-ViT vision tower is a STUB per the assignment: input_specs
provides precomputed patch embeddings (batch, n_patches, patch_embed_dim)
which the backbone projects into d_model and interleaves with text tokens.
"""
from repro_torch.configs.base import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    activation="swiglu",
    vlm=VLMConfig(n_patches=1024, patch_embed_dim=1024),
    source="hf:mistralai/Pixtral-12B-2409 (40L, d 5120, 32H/8KV, ff 14336, "
           "vocab 131072; vision tower 1024-d patches, stubbed)",
)
