"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B backbone. [arXiv:2404.16821; hf]

The vision tower is a STUB per the assignment: input_specs() provides 256
precomputed patch embeddings (frontend_dim=1024, InternViT hidden) that a
projection maps into the LM sequence (early fusion).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2_1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab=151655, pattern=("attn",), qkv_bias=True,
    frontend="patch", frontend_dim=1024, n_frontend_tokens=256,
    tie_embeddings=True,
))
