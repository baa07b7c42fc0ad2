"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 ratio.
[arXiv:2402.19427; hf]

26 layers = 8 x (rec, rec, local) + 2 tail rec layers; local attention is
MQA (kv=1) with a 2048 sliding window — a 1-D sequence *stencil*, served
with a window-sized ring cache (sub-quadratic; runs long_500k).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma_2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab=256000,
    pattern=("rec", "rec", "local"), window=2048, lru_width=2560,
    mlp="geglu", sub_quadratic=True, tie_embeddings=True,
))
