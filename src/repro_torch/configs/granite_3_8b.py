"""granite-3-8b [dense] — GQA.  [hf:ibm-granite/granite-3.0-8b-base; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite_3_8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12800, vocab=49155, pattern=("attn",),
))
