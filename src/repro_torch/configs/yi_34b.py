"""yi-34b [dense] — llama-arch GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="yi_34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000, pattern=("attn",),
))
