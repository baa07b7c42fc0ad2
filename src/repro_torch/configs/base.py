"""Architecture configuration schema + registry, PyTorch port.

A copy of ``repro.configs.base`` kept inside the port: the same
:class:`ArchConfig` fields, defaults, estimates and :meth:`reduced`; only
:func:`get` imports the port's own ``repro_torch.configs.<arch>`` modules.

One ``<arch>.py`` per assigned architecture registers an :class:`ArchConfig`
here via :func:`register`.  ``reduced()`` produces the CPU smoke-test
version of the same family (tiny widths/depths, same block structure).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

_REGISTRY: dict[str, "ArchConfig"] = {}

ARCH_IDS = [
    "granite_3_8b", "internlm2_1_8b", "yi_34b", "granite_3_2b",
    "seamless_m4t_medium", "recurrentgemma_2b", "internvl2_1b",
    "mamba2_130m", "llama4_maverick_400b_a17b", "qwen2_moe_a2_7b",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # block structure: kinds cycled over layers ("attn","attn_moe","local",
    # "rec","ssm"); enc-dec uses enc_pattern for the encoder.
    pattern: tuple = ("attn",)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    expert_pad_to: int = 16     # pad expert dim to a multiple (EP over model)
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # --- hybrid / local attention ---
    window: int = 0
    lru_width: int = 0
    # --- encoder-decoder ---
    enc_layers: int = 0
    enc_pattern: tuple = ("enc",)
    # --- modality frontend (STUB: input_specs provides embeddings) ---
    frontend: Optional[str] = None      # "patch" | "frames"
    frontend_dim: int = 0
    n_frontend_tokens: int = 0
    # --- common knobs ---
    rope_theta: float = 10000.0
    rope_on_encoder: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act_dtype: str = "bfloat16"
    mlp: str = "swiglu"
    kv_block: int = 1024
    remat: str = "full"                 # none | dots | full
    scan_layers: bool = True
    sub_quadratic: bool = False         # eligible for long_500k
    optimizer: str = "adamw"            # adamw | adafactor
    microbatches: int = 1               # gradient-accumulation splits

    # ------------------------------------------------------------------
    @property
    def n_experts_padded(self) -> int:
        if not self.n_experts or self.expert_pad_to <= 1:
            return self.n_experts
        m = self.expert_pad_to
        return (self.n_experts + m - 1) // m * m

    @property
    def params_dense_estimate(self) -> float:
        """Rough total parameter count (for 6ND MODEL_FLOPS accounting)."""
        d, f, L_ = self.d_model, self.d_ff, self.n_layers
        attn = d * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
        mlp = 3 * d * f
        per_moe = (3 * self.d_ff_expert * d * self.n_experts
                   + 3 * d * self.d_ff_shared + d * self.n_experts)
        n_moe = sum(1 for i in range(L_)
                    if self.pattern[i % len(self.pattern)].endswith("_moe"))
        n_ssm = sum(1 for i in range(L_)
                    if self.pattern[i % len(self.pattern)] == "ssm")
        n_rec = sum(1 for i in range(L_)
                    if self.pattern[i % len(self.pattern)] == "rec")
        n_attn = L_ - n_ssm - n_rec
        di = self.ssm_expand * d
        ssm = d * (2 * di + 2 * self.ssm_state + di // max(self.ssm_headdim, 1)) + di * d
        w = self.lru_width or d
        rec = 2 * d * w + 2 * w * w + w * d + w * d  # in/gate/wa/wx/out
        total = (n_attn * attn + n_moe * per_moe
                 + (n_attn - n_moe) * mlp
                 + n_ssm * ssm + n_rec * (rec + 3 * d * self.d_ff)
                 + self.vocab * d * (1 if self.tie_embeddings else 2))
        return float(total)

    @property
    def params_active_estimate(self) -> float:
        """Active params per token (MoE: only top_k + shared experts)."""
        if not self.n_experts:
            return self.params_dense_estimate
        d = self.d_model
        per_moe_active = (3 * self.d_ff_expert * d * self.top_k
                          + 3 * d * self.d_ff_shared + d * self.n_experts)
        per_moe_total = (3 * self.d_ff_expert * d * self.n_experts
                         + 3 * d * self.d_ff_shared + d * self.n_experts)
        n_moe = sum(1 for i in range(self.n_layers)
                    if self.pattern[i % len(self.pattern)].endswith("_moe"))
        return (self.params_dense_estimate
                - n_moe * (per_moe_total - per_moe_active))

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        glen = len(self.pattern)
        n_layers = max(2 * glen, glen)  # at least two pattern groups... or one
        if n_layers > 6:
            n_layers = glen if glen >= 3 else 2 * glen
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=8.0,  # tiny smoke batches: avoid router drops
            expert_pad_to=1,
            d_ff_expert=64 if self.n_experts else 0,
            d_ff_shared=64 if self.n_shared_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            window=min(self.window, 16) if self.window else 0,
            lru_width=64 if self.lru_width else 0,
            enc_layers=min(self.enc_layers, 2),
            frontend_dim=32 if self.frontend else 0,
            n_frontend_tokens=8 if self.frontend else 0,
            kv_block=32,
            remat="none",
            act_dtype="float32",
        )


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{key}")
    return _REGISTRY[key]


def all_archs() -> list[str]:
    return list(ARCH_IDS)
