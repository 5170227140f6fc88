"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

The reference's config, copied: the published
widths at full depth, its parallelism plan, and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                 # dense FFN of the first_dense_layers
    vocab_size=129280,
    # MoE
    n_experts=256,
    n_experts_active=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    router_type="sigmoid",
    # MLA
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,               # qk_nope + qk_rope
    mtp_depth=1,
)

PLAN = ParallelPlan(fsdp=True, tp=True, sp=True, ep=True,
                    grad_accum=16, optimizer="adafactor", param_dtype="bfloat16")

# DeepSeek-V3 routes droplessly (aux-loss-free balancing, "no token
# dropping", §4.2 of the tech report); at smoke scale droplessness is
# realized exactly with factor = E/k, so prefill/decode/full-pass logits are
# bit-consistent (test_decode_consistency). The real config keeps the
# capacity approximation — factor E/k = 32 would blow the dispatch buffer to
# E×T×d at 32k prefill.
SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    n_experts=8, n_experts_active=2, moe_d_ff=32, first_dense_layers=1,
    q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16,
    v_head_dim=16, head_dim=24, mtp_depth=1, moe_capacity_factor=4.0)
