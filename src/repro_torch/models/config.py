"""Unified model configuration covering every assigned architecture family.

One dataclass describes dense / MoE / SSM / hybrid / encoder-only / VLM-backbone
transformers; per-arch files in ``repro_torch.configs`` instantiate it with the exact
published hyper-parameters and register themselves in :data:`REGISTRY`.

A copy of ``repro/models/config.py``: the port imports nothing of the JAX
package, so it keeps its own registry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention ---------------------------------------------------------
    attn_kind: str = "gqa"         # gqa | mla | none
    d_head: Optional[int] = None   # default d_model // n_heads
    rope: bool = True
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # SWA width (Mixtral, Hymba)
    causal: bool = True            # False for encoder-only (HuBERT)

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    v_head_dim: Optional[int] = None

    # --- MLP -----------------------------------------------------------------
    mlp_kind: str = "swiglu"       # swiglu | geglu | relu2 | gelu

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim (d_ff used for shared)
    capacity_factor: float = 1.25

    # --- SSM / RWKV ------------------------------------------------------------
    block_kind: str = "attn"       # attn | rwkv6 | hybrid (attn ∥ mamba)
    ssm_state: int = 0             # Mamba state dim (Hymba)
    ssm_expand: int = 2            # d_inner = expand * d_model

    # --- structure ---------------------------------------------------------
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm
    tie_embeddings: bool = False
    encoder_only: bool = False
    frontend: Optional[str] = None  # audio | vision: input is embeddings, not tokens
    norm_eps: float = 1e-5

    # --- provenance ----------------------------------------------------------
    source: str = ""

    def __post_init__(self):
        if self.attn_kind != "none" and self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
        if self.attn_kind == "mla" and self.v_head_dim is None:
            object.__setattr__(self, "v_head_dim", self.d_head)

    # ---- derived sizes (used by partitioner, roofline, memory model) ---------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head



# ---------------------------------------------------------------------------
# Registry, populated by repro_torch.configs.*
# ---------------------------------------------------------------------------
REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers everything on first use)
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(REGISTRY)
