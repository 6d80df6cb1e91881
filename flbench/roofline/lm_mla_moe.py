"""The latent-attention MoE decoder's forward operations
(``reference/lm_mla_moe.py``): two a multiply-add of every product with
a weight matrix that a token computes (MLA's four projections, the
dense layers' MLP, the router, its ``num_experts_per_tok`` routed
experts and the shared experts of a MoE layer, the unembedding; the
embedding is a gather; an expert a token does not choose is not
counted) and the attention's ``2 * S * H * ((head_dim + rope) +
head_dim)`` a token a layer (scores and the value sum over all ``S``
keys, as the causal mask is applied to full score matrices), over
``batch * seq_len`` tokens.  A training step is three times this;
remat's recomputed forward is not counted."""


def forward_flops(model: dict, batch: int, seq_len: int) -> float:
    L, d, V = model["n_layers"], model["d_model"], model["vocab_size"]
    H, hd = model["n_heads"], model["head_dim"]
    r, rope = model["kv_lora_rank"], model["qk_rope_head_dim"]
    n_dense = model["first_k_dense_replace"]
    E, K = model["n_routed_experts"], model["num_experts_per_tok"]
    f, n_sh = model["moe_intermediate_size"], model["n_shared_experts"]
    attn = d * H * (hd + rope) + d * (r + rope) + r * H * 2 * hd + H * hd * d
    dense = attn + 3 * d * model["d_ff"]
    moe = attn + d * E + 3 * d * f * (K + n_sh)
    matrices = n_dense * dense + (L - n_dense) * moe + d * V
    attention = 2 * L * seq_len * H * (2 * hd + rope)
    return float(batch * seq_len * (2 * matrices + attention))
