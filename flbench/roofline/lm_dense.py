"""The dense decoder's forward operations (``reference/lm_dense.py``):
two a multiply-add of every product with a weight matrix (the four
attention projections, the three MLP matrices, the unembedding; the
embedding is a gather) and the attention's ``4 * S * H * head_dim`` a
token a layer (scores and the value sum over all ``S`` keys, as the
causal mask is applied to full score matrices), over ``batch * seq_len``
tokens.  A training step is three times this; remat's recomputed
forward is not counted."""


def forward_flops(model: dict, batch: int, seq_len: int) -> float:
    L, d, ff, V = (model[k] for k in ("n_layers", "d_model", "d_ff",
                                      "vocab_size"))
    hq = model["n_heads"] * model["head_dim"]
    hkv = model["n_kv_heads"] * model["head_dim"]
    matrices = L * (d * hq + 2 * d * hkv + hq * d + 3 * d * ff) + d * V
    attention = 4 * L * seq_len * hq
    return float(batch * seq_len * (2 * matrices + attention))
