"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + 1 shared,
MoE every other layer (interleaved, as the released model), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

24 MoE layers x 128 x 3 x 5120 x 8192 ~= 386B routed params + dense
layers/attention/embeddings ~= 400B total, ~17B active.  The optimizer
(Adafactor) and the 4 gradient-accumulation microbatches are the JAX
reference's choices for its TPU pod, copied unchanged.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4_maverick_400b_a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048,
    pattern=("attn", "attn_moe"),
    n_experts=128, top_k=1, n_shared_experts=1,
    d_ff_expert=8192, d_ff_shared=8192,
    optimizer="adafactor",
    microbatches=4,
))
