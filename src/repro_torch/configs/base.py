"""Config dataclasses: model architecture, run/parallelism, input shapes.

A copy of the JAX package's ``configs/base.py``, so that configurations
carry across unchanged.  The per-arch files in this package hold the EXACT
assigned configurations; physical padding for tensor parallelism (vocab to a
multiple of 256*TP, Q-heads to a multiple of TP, KV-head replication up to
TP) is derived here and is an implementation artifact, not a config change.
The port runs on one device, so ``tp`` is 1 and nothing is padded.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq: int = 524_288
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- hybrid (RG-LRU / Griffin) ---
    attn_period: int = 0             # every `period`-th layer is local attention
    window: int = 0                  # sliding-window size for local attention
    lru_width: int = 0
    conv_width: int = 4
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 1500             # stub frontend: precomputed frame embeddings
    # --- VLM (llama-3.2-vision) ---
    cross_period: int = 0            # every `period`-th layer is cross-attention
    n_vision_tokens: int = 1601      # stub frontend: precomputed patch embeddings
    # --- shape-cell notes ---
    subquadratic: bool = False       # may run long_500k
    has_decoder: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def padded_vocab(self, tp: int) -> int:
        if self.vocab % tp == 0 and tp == 1:
            return self.vocab
        return pad_to(self.vocab, 256 * tp if self.vocab % tp else tp)

    def padded_heads(self, tp: int) -> tuple[int, int]:
        """(physical q heads, physical kv heads) under tensor parallelism."""
        hq = pad_to(self.n_heads, tp)
        hkv = self.n_kv_heads if self.n_kv_heads % tp == 0 else pad_to(self.n_kv_heads, tp)
        hkv = min(hkv, hq)
        return hq, hkv


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution-time knobs: parallelism, dtypes, remat.  The fields the port
    does not read stay so that configs carry across, held to their defaults
    by ``__post_init__``."""
    tp: int = 1                      # size of the "model" mesh axis
    dp: int = 1                      # size of the "data" (x pod) axes
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    use_flash_kernel: bool = False   # kept so configs carry across: the port
    #                                  always calls its kernels' wrappers,
    #                                  which launch on CUDA (ROADMAP.md §3)
    scan_layers: bool = True         # False: unroll stacks (cost-faithful HLO
    #                                  for dry-run analysis; DESIGN.md §8)
    ce_chunk: int = 0                # >0: sequence-chunked fused LM-head+CE —
    #                                  the (B,S,V) logits tensor never fully
    #                                  materializes (§Perf hillclimb lever)
    sp: bool = False                 # sequence-parallel activation sharding
    #                                  (reduce-scatter/all-gather TP boundary)
    moe_dispatch_groups: int = 0     # >1: per-group (shard-local) MoE dispatch
    #                                  instead of one global token sort
    cast_params_early: bool = False  # cast fp32 masters to compute dtype at
    #                                  the top of the loss: FSDP all-gathers
    #                                  and grad reductions run in bf16 (§Perf)
    gradient_compression: str = "none"   # none | pca_ef | gae
    grad_comp_rank: int = 32
    grad_comp_tau: float = 0.0

    def __post_init__(self):
        """The port reads ``tp`` and ``compute_dtype`` and accepts either
        ``use_flash_kernel``; every other field must keep its default, so a
        config carried across fails here instead of running something else."""
        for f in dataclasses.fields(self):
            if f.name in _HONOURED or getattr(self, f.name) == f.default:
                continue
            raise NotImplementedError(
                f"RunConfig.{f.name}={getattr(self, f.name)!r}: the port "
                f"honours only the default {f.default!r} (ROADMAP.md)")


_HONOURED = ("tp", "compute_dtype", "use_flash_kernel")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


LM_SHAPES: tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch x shape) cell runs; reason string when skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full-attention arch — O(n^2) attention and a "
                       ">HBM KV cache at 524288 tokens (DESIGN.md §5)")
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "skipped: encoder-only arch has no decode step"
    return True, ""
