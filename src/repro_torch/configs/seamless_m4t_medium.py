"""seamless-m4t-medium [audio] — enc-dec, multimodal.  [arXiv:2308.11596; hf]

The speech frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (frontend_dim=1024) that feed the 12-layer
encoder; the 12-layer decoder cross-attends to it.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless_m4t_medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab=256206,
    pattern=("xattn",), enc_layers=12, enc_pattern=("enc",),
    frontend="frames", frontend_dim=1024,
))
