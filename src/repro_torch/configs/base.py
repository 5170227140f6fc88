"""Config dataclasses, field for field the reference's: ``BMOConfig`` (so the
``cfg`` dict in an index's metadata loads unchanged in either package),
``ModelConfig``, ``ParallelPlan`` (so a reference model config does),
``TrainConfig``, and the dry run's ``ShapeConfig`` and ``SHAPES``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BMOConfig:
    """Paper-technique hyper-parameters (Alg. 1/2 + §IV + App. D-A)."""

    k: int = 5                       # number of nearest neighbours
    delta: float = 0.01              # failure probability
    block: int = 128                 # coordinate-block width of one pull
    batch_arms: int = 32             # arms raced per round (paper App. D-A: 32)
    pulls_per_round: int = 2         # blocks pulled per selected arm per round
    init_pulls: int = 2              # initial blocks pulled on every arm
    metric: str = "l2"               # l2 | l1
    rotate: bool = False             # §IV-B randomized Hadamard pre-rotation
    sparse: bool = False             # §IV-A sparse Monte-Carlo box
    epsilon: float = 0.0             # >0 → PAC variant (Thm 2)
    sigma: Optional[float] = None    # sub-Gaussian bound; None = empirical (App. D-A)
    max_rounds: int = 0              # 0 = derived from d/block
    epoch_rounds: int = 4            # racing rounds fused per kernel launch
                                     # (grows as the survivor frontier shrinks)
    frontier_floor: int = 0          # smallest survivor-bucket width the
                                     # frontier may shrink to (0 = derived
                                     # from batch_arms/k)
    kernel_buffers: int = 2          # pulls the fused pull kernel may load
                                     # ahead (2 = double buffering)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A language model's architecture, field for field the reference's
    ``ModelConfig`` so a reference config loads unchanged. The port runs
    every family of the reference (``models/registry.py``)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default: d_model // n_heads
    # --- MLP / attention flavor ---
    mlp_act: str = "swiglu"          # swiglu | gelu | sq_relu
    qkv_bias: bool = False
    # --- position encoding ---
    rope_theta: float = 1.0e4
    rope_type: str = "rope"          # rope | mrope | sinusoidal | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    router_type: str = "softmax"     # softmax | sigmoid (deepseek-v3)
    moe_capacity_factor: float = 1.25  # expert capacity = tokens·k/E·factor;
                                     # ≥ E/k makes dispatch dropless
    moe_seq_chunk: int = 8192        # dispatch ≤ this many tokens/shard at once
    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0               # multi-token-prediction extra depth
    # --- SSM / xLSTM ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    slstm_every: int = 0             # xlstm: every k-th layer is sLSTM (0 = none)
    # --- hybrid (zamba2) ---
    attn_every: int = 0              # shared attention block period (0 = never)
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    dec_layers: int = 0
    dec_seq_div: int = 8             # decoder seq = seq_len // dec_seq_div
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_chunk: int = 1024           # q-block size for chunked attention (S > 8k)
    kv_quant: bool = False           # int8 KV cache (+per-token-head scales)
    attn_impl: str = "auto"          # auto | xla: the plain ``sdpa``;
                                     # pallas: the fused flash-attention op
                                     # (the CUDA kernel on the card, its
                                     # plain version on the CPU)

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An input shape of the dry run, the reference's: the sequence length,
    the global batch and the step it feeds (train | prefill | decode)."""

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


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The reference's parallelism plan, field for field. The port runs on
    one card so far: the plan is carried, not applied."""

    fsdp: bool = False
    tp: bool = True
    sp: bool = False
    ep: bool = False
    grad_accum: int = 1
    remat: str = "full"              # none | full | dots
    optimizer: str = "adamw"         # adamw | adafactor
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_len_shard: bool = False       # shard KV caches along seq (decode perf)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's training hyper-parameters, field for field: the peak
    learning rate of ``warmup_cosine``, its warm-up and total steps,
    AdamW's decay and moments, the global-norm clip and the init seed."""

    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0
