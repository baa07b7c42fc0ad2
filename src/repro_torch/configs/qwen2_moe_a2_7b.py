"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared (fused as one
5632-wide shared expert), every layer MoE.  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2_moe_a2_7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=151936,
    pattern=("attn_moe",), qkv_bias=True,
    n_experts=60, top_k=4, n_shared_experts=4,
    d_ff_expert=1408, d_ff_shared=5632,
))
