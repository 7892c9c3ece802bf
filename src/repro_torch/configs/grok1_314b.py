"""grok-1-314b [hf:xai-org/grok-1; unverified] — MoE:
64L d_model=6144 48H (GQA kv=8) expert d_ff=32768, 8 experts top-2,
vocab=131072."""
from .lm_family import make_lm_arch

ARCH = make_lm_arch(
    "grok-1-314b",
    "[hf:xai-org/grok-1; unverified]",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_head=128,
    d_ff=32768, vocab=131072, mlp_kind="swiglu",
    moe=dict(n_experts=8, top_k=2, n_shared=0, d_ff=32768),
    rope_theta=1e4,
    fsdp=True,   # 314B params: expert weights shard over data×model (ZeRO-3)
)
