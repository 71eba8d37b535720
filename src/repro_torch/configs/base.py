"""Architecture configuration system (a copy of ``src/repro/configs/base.py``:
the port imports nothing of the JAX package, so it keeps its own).

Every assigned architecture is a frozen ``ArchConfig``. A config is pure data:
the model code in ``repro_torch.models`` interprets it. Layer heterogeneity (hybrid
Mamba/attention stacks, MoE interleave, cross-attention interleave) is expressed
as a repeating ``block_pattern`` of ``LayerSpec`` entries scanned ``num_blocks``
times, so every architecture lowers through the same scan-over-blocks path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

# mixer kinds
ATTN = "attn"          # full causal self-attention (GQA)
SWA = "swa"            # sliding-window causal self-attention
XATTN = "xattn"        # cross-attention to stub modality embeddings (+ self-attn)
MAMBA = "mamba"        # Mamba-1 selective SSM
RWKV = "rwkv"          # RWKV-6 linear-attention recurrence

# mlp kinds
DENSE = "dense"        # SwiGLU dense MLP
MOE = "moe"            # top-k routed mixture of experts (SwiGLU experts)
RWKVMIX = "rwkv_mix"   # RWKV-6 channel-mix (squared-relu + receptance gate)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = ATTN
    mlp: str = DENSE


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor for dropless-ish dispatch (tokens routed above capacity
    # are dropped, matching standard TPU MoE implementations)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    n_heads: int                     # query heads (0 for attn-free archs)
    n_kv_heads: int
    d_ff: int                        # dense MLP hidden (or per-expert hidden for MoE)
    vocab_size: int
    block_pattern: Tuple[LayerSpec, ...]
    num_blocks: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    attn_bias: bool = False          # qwen2-style QKV bias
    sliding_window: int = 4096       # window for SWA mixers
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv_head_dim: int = 64
    # modality stub: inputs are precomputed embeddings, not token ids
    embeds_in: bool = False
    # cross-attention context (stub patch/frame embeddings), (n_ctx, d_ctx)
    xattn_ctx_len: int = 0
    xattn_ctx_dim: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def num_layers(self) -> int:
        return self.num_blocks * len(self.block_pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(s.mixer in (MAMBA, RWKV) for s in self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """True for SSM / hybrid / sliding-window archs (assignment rule):
        pure full-attention archs skip long_500k; anything with recurrent
        (O(1)-state) mixers or a bounded attention window runs it. A hybrid
        like Jamba still carries full caches on its sparse attention layers —
        8x fewer of them, which is precisely its long-context design point."""
        if any(s.mixer in (MAMBA, RWKV) for s in self.block_pattern):
            return True
        return all(s.mixer == SWA for s in self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and reports)."""
        d = self.d_model
        total_blocks = self.num_blocks
        per_block = sum(
            self._mixer_params(s.mixer) + self._mlp_params(s.mlp) + 2 * d
            for s in self.block_pattern
        )
        n_embed = 0 if self.embeds_in else self.vocab_size * d
        n = n_embed if self.tie_embeddings else n_embed + self.vocab_size * d
        n += per_block * total_blocks
        n += d                                       # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k instead of num_experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        per_block = 0
        for s in self.block_pattern:
            per_block += self._mixer_params(s.mixer)
            if s.mlp == MOE:
                per_block += 3 * d * self.d_ff * self.moe.top_k
                per_block += d * self.moe.num_experts    # router
            else:
                per_block += self._mlp_params(s.mlp)
            per_block += 2 * d
        n_embed = 0 if self.embeds_in else self.vocab_size * d
        n = n_embed if self.tie_embeddings else n_embed + self.vocab_size * d
        n += per_block * self.num_blocks + d
        return n

    def _mixer_params(self, mixer: str) -> int:
        d = self.d_model
        if mixer in (ATTN, SWA, XATTN):
            hq = self.n_heads * self.head_dim
            hkv = self.n_kv_heads * self.head_dim
            n = d * hq + 2 * d * hkv + hq * d
            if self.attn_bias:
                n += hq + 2 * hkv
            if mixer == XATTN:
                # extra cross-attention projections from ctx dim (+ scalar gate)
                n += d * hq + 2 * self.xattn_ctx_dim * hkv + hq * d + 1
            return n
        if mixer == MAMBA:
            mc = self.mamba or MambaConfig()
            di = mc.expand * d
            dt_rank = max(d // 16, 1)
            n = d * 2 * di                       # in_proj (x and z)
            n += di * mc.d_conv                  # depthwise conv
            n += di * (dt_rank + mc.d_state * 2)  # x_proj -> dt_lowrank, B, C
            n += dt_rank * di + di               # dt_proj + dt bias
            n += di * mc.d_state                 # A_log
            n += di                              # D skip
            n += di * d                          # out_proj
            return n
        if mixer == RWKV:
            hd = self.rwkv_head_dim
            nh = d // hd
            # r, k, v, g, w projections + output + per-head decay/bonus + mix params
            n = 5 * d * d + d * d + 2 * nh * hd + 6 * d
            return n
        raise ValueError(mixer)

    def _mlp_params(self, mlp: str) -> int:
        d = self.d_model
        if mlp == DENSE:
            return 3 * d * self.d_ff
        if mlp == MOE:
            assert self.moe is not None
            return 3 * d * self.d_ff * self.moe.num_experts + d * self.moe.num_experts
        if mlp == RWKVMIX:
            return 2 * d * self.d_ff + d * d + 2 * d
        raise ValueError(mlp)

    # ---- reduced smoke variant ---------------------------------------------
    def smoke(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, num_experts=4,
                                      top_k=min(2, self.moe.top_k))
        mamba = self.mamba and dataclasses.replace(self.mamba, d_state=4, d_conv=2)
        n_heads = 0 if self.n_heads == 0 else 4
        n_kv = 0 if self.n_kv_heads == 0 else (4 if self.n_kv_heads == self.n_heads else 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=16 if n_heads else 0,
            d_ff=128,
            vocab_size=256,
            num_blocks=min(self.num_blocks, 2),
            sliding_window=16,
            moe=moe,
            mamba=mamba,
            rwkv_head_dim=16,
            xattn_ctx_len=8 if self.xattn_ctx_len else 0,
            xattn_ctx_dim=32 if self.xattn_ctx_dim else 0,
        )


# ---------------------------------------------------------------------------
# Input shapes (assignment: 4 shapes shared by all LM archs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k only runs on bounded-state archs (SSM / hybrid / SWA)."""
    if shape.name == "long_500k":
        return arch.supports_long_context
    return True
