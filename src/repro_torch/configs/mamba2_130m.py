"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]

d_state=128, headdim=64, expand=2 -> d_inner=1536, 24 heads.  O(1) decode
state (no KV cache): runs long_500k trivially (sub-quadratic).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2_130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_head=64,
    d_ff=0, vocab=50280, pattern=("ssm",),
    ssm_state=128, ssm_headdim=64, ssm_expand=2,
    tie_embeddings=True, sub_quadratic=True,
))
