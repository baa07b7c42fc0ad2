"""granite-3-2b [dense] — GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite_3_2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab=49155, pattern=("attn",), tie_embeddings=True,
))
