"""seamless-m4t-large-v2 — enc-dec multimodal backbone. [arXiv:2308.11596]

Modality frontend (mel-spectrogram + conv feature extractor) is a STUB per
the assignment: input_specs provides precomputed frame embeddings of shape
(batch, n_frames, d_model). This config describes the transformer backbone
(24 encoder + 24 decoder layers, d 1024, 16 heads, ff 8192, vocab 256206).
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,                  # per side; see EncDecConfig
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    norm="layernorm",
    activation="gelu",
    rope_theta=10_000.0,
    encdec=EncDecConfig(n_enc_layers=24, n_dec_layers=24, n_frames=4096),
    source="arXiv:2308.11596 (SeamlessM4T v2 large: 24L enc/dec, d 1024, "
           "16H, ff 8192, vocab 256206)",
)
