"""Config system of the port: the ``ModelConfig`` fields the LeNet path
and the LM path (dense, MoE, SSM, hybrid, vision-text and
encoder-decoder) read, and the registry.

A copy of the reference's ``configs/base.py`` without the table of the
assigned input shapes, which only the dry run reads.  The hybrid
interleave (``attn_layer_period``) is jamba's: attention on one layer
of each period, mamba on the rest.  ``mrope_sections`` split the RoPE
half-dim into qwen2-vl's (t, h, w) sections; an encoder-decoder
(seamless) has ``n_encoder_layers`` encoder layers and ``n_layers``
decoder layers, and its client holds the bottom of the encoder.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# Sliding window of full-attention archs in the long_500k decode variant
LONG_CONTEXT_WINDOW = 8_192


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    source: str

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) dims
    sliding_window: int = 0  # 0 = full attention
    norm: str = "rms"
    tie_embeddings: bool = False  # metadata: the LM head is server-owned

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1  # MoE on layers where (i % period) == offset
    moe_layer_offset: int = 0
    first_k_dense: int = 0  # deepseek: first layer(s) dense
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (mamba2 / jamba mamba layers)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    # hybrid: attention on layers where (i % period) == offset; 0 = all attn
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    # encoder-decoder (seamless)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # modality frontend stub: embeddings of this many frames / patches
    # come in precomputed
    modality: str = "text"  # text | audio | vision_text
    frontend_frames: int = 0  # audio frames / vision patches (per sequence)

    # conv/classification backbone (the paper's own model)
    is_conv: bool = False
    image_size: int = 32
    n_classes: int = 10
    conv_channels: Tuple[int, ...] = ()

    # AdaSplit split point: fraction of layers on the client
    mu: float = 0.2

    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # number of client layers (bottom of the stack / of the encoder)
    @property
    def split_layer(self) -> int:
        n = self.n_encoder_layers if self.is_encoder_decoder \
            else self.n_layers
        s = max(1, int(round(self.mu * n)))
        if self.attn_layer_period:
            s = max(self.attn_layer_period,
                    (s // self.attn_layer_period) * self.attn_layer_period)
        return min(s, n - 1)

    def is_moe_layer(self, i: int) -> bool:
        if not self.n_experts or i < self.first_k_dense:
            return False
        return (i % self.moe_layer_period) == self.moe_layer_offset

    def is_attn_layer(self, i: int) -> bool:
        if self.ssm_state and self.attn_layer_period == 0 and self.n_heads == 0:
            return False  # pure SSM
        if self.attn_layer_period == 0:
            return True
        return (i % self.attn_layer_period) == self.attn_layer_offset

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    # padded vocab so a sharded vocab axis always divides it
    def padded_vocab(self, multiple: int = 256) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def supports_long_context(self) -> str:
        """'native' (a pure SSM stack: sub-quadratic), 'windowed' (needs
        a sliding window at long_500k), 'n/a' (the conv backbone)."""
        if self.is_conv:
            return "n/a"
        if self.ssm_state and self.attn_layer_period == 0 and self.n_heads == 0:
            return "native"
        return "windowed"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers (a hybrid: 4, one ``m a m a``
        pattern; an encoder-decoder <=2 of each), d_model<=256, <=4
        heads, <=4 experts, SSM state <=16, SSM head dim <=32, SSM chunk
        32, <=16 frontend frames, M-RoPE sections of the new head dim."""
        d_model = min(self.d_model, 256) or 64
        n_heads = min(self.n_heads, 4)
        head_dim = max(16, d_model // max(n_heads, 1)) if n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) or (1 if n_heads else 0)
        kw: Dict[str, Any] = dict(
            n_layers=min(self.n_layers, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512) or self.vocab_size,
            moe_d_ff=min(self.moe_d_ff, 128),
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2),
            first_k_dense=min(self.first_k_dense, 0),
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=(min(self.ssm_headdim, 32) if self.ssm_state
                         else self.ssm_headdim),
            ssm_chunk=32,
            frontend_frames=min(self.frontend_frames, 16),
            conv_channels=tuple(min(c, 16) for c in self.conv_channels),
        )
        if self.is_encoder_decoder:
            kw["n_encoder_layers"] = min(self.n_encoder_layers, 2)
        if self.attn_layer_period:
            kw.update(attn_layer_period=2, attn_layer_offset=1,
                      moe_layer_period=2, moe_layer_offset=1, n_layers=4)
        if self.mrope_sections:
            kw["mrope_sections"] = _mrope_sections_for(head_dim)
        return replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once): the
        reference's conv, dense, MoE, SSM and encoder-decoder branches (a
        mamba layer counts its projections and conv weights, as the
        reference's does; an encoder-decoder adds its encoder layers and
        a cross-attention per decoder layer)."""
        if self.is_conv:
            # rough lenet-style count
            total, cin = 0, 3
            for c in self.conv_channels:
                total += cin * c * 25 + c
                cin = c
            total += cin * 16 * 120 + 120 * 84 + 84 * self.n_classes
            return total
        d = self.d_model
        emb = self.vocab_size * d
        per_attn = (self.n_heads + 2 * self.n_kv_heads) * self.head_dim * d \
            + self.n_heads * self.head_dim * d
        total = emb + (0 if self.tie_embeddings else emb)
        for i in range(self.n_layers):
            if self.ssm_state and not self.is_attn_layer(i):
                din, gn = self.d_inner, self.ssm_ngroups * self.ssm_state
                total += d * (2 * din + 2 * gn + self.ssm_nheads)
                total += (din + 2 * gn) * self.ssm_conv_kernel
                total += din * d
            elif self.n_heads:
                total += per_attn
            if self.is_moe_layer(i):
                total += self.n_experts * 3 * d * self.moe_d_ff
                total += self.n_shared_experts * 3 * d * self.moe_d_ff
                total += d * self.n_experts  # router
            elif self.d_ff:
                total += 3 * d * self.d_ff
        if self.is_encoder_decoder:
            total += self.n_encoder_layers * (per_attn + 3 * d * self.d_ff)
            total += self.n_layers * per_attn  # cross-attention
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the routed top-k)."""
        inactive = sum((self.n_experts - self.experts_per_token)
                       * 3 * self.d_model * self.moe_d_ff
                       for i in range(self.n_layers) if self.is_moe_layer(i))
        return self.param_count() - inactive


def _mrope_sections_for(head_dim: int) -> Tuple[int, ...]:
    """(t, h, w) sections of a head dim's half: t a half of it, h and w
    the rest split evenly (w takes the odd one)."""
    half = head_dim // 2
    t = half // 2
    h = (half - t) // 2
    return (t, h, half - t - h)


_REGISTRY: Dict[str, ModelConfig] = {}

ARCH_MODULES = ["lenet_cifar", "qwen2_0_5b", "olmo_1b", "granite_3_8b",
                "phi3_mini_3_8b", "deepseek_moe_16b", "qwen3_moe_30b_a3b",
                "mamba2_370m", "jamba_v0_1_52b", "qwen2_vl_72b",
                "seamless_m4t_large_v2"]


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def load_all() -> Dict[str, ModelConfig]:
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    return dict(_REGISTRY)


def list_archs(include_paper: bool = False):
    """The registered LM archs, sorted (``lenet-cifar`` only with
    ``include_paper``)."""
    load_all()
    return sorted(n for n in _REGISTRY if n != "lenet-cifar" or include_paper)
