"""Model configuration for the 10-arch pool (+ reduced smoke variants).

The port's copy of ``repro.models.config``'s ``ModelConfig`` and
``Policy``, with torch dtypes in the policy, and of its dry-run cells
(``ShapeCell``, ``SHAPES``, ``applicable_shapes``)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Numerics / memory policy: parameters in f32, compute and the KV
    cache in bf16 by default."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    moment_dtype: torch.dtype = torch.float32
    cache_dtype: torch.dtype = torch.bfloat16
    remat: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    causal: bool = True             # False => encoder-only (no decode step)
    # sliding-window pattern (gemma3): every `global_every`-th layer is global,
    # the rest use `window`-token local attention.  0 => all layers global.
    window: int = 0
    global_every: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1              # every k-th layer is MoE (llama4: 2)
    first_dense: int = 0            # first N layers dense (deepseek: 1)
    capacity_factor: float = 1.25
    moe_shard_map: bool = True
    # MLA (deepseek)
    mla_absorb: bool = True
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    attn_every: int = 0             # hybrid: every k-th layer is the shared attn block
    # modality frontend stub
    frontend: str = "none"          # none | audio | vision
    d_frontend: int = 0
    n_patch_tokens: int = 0
    # misc
    attn_chunk: int = 1024          # q-block size for memory-efficient attention
    ssd_chunk: int = 256
    policy: Policy = dataclasses.field(default_factory=Policy)

    # ---- derived ----
    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.expand * self.d_model

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    @property
    def is_mla(self) -> bool:
        return self.kv_lora > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k per assignment: SSM / hybrid / windowed."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def layer_kind(self, i: int) -> str:
        """Return block kind for layer index i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            if self.attn_every and (i + 1) % self.attn_every == 0:
                return "attn_shared"
            return "ssm"
        if self.family == "moe" or self.n_experts:
            if i < self.first_dense:
                return "dense"
            if (i - self.first_dense) % self.moe_every == self.moe_every - 1 or self.moe_every == 1:
                return "moe"
            return "dense"
        return "dense"

    def attn_window(self, i: int) -> int:
        """0 => full/global attention at layer i, else local window size."""
        if self.window == 0:
            return 0
        if self.global_every and (i + 1) % self.global_every == 0:
            return 0
        return self.window


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (arch x input-shape) dry-run cell."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeCell, ...]:
    """Shape applicability per assignment (skips documented in DESIGN.md)."""
    out = []
    for s in SHAPES:
        if s.kind == "decode" and not cfg.causal:
            continue                          # encoder-only: no decode step
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue                          # pure full-attention archs skip
        out.append(s)
    return tuple(out)
