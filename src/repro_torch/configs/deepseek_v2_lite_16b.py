"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] — MoE + MLA:
27L d_model=2048 16H, MLA kv_lora_rank=512 (d_nope=128, d_rope=64,
d_v=128), 64 routed experts top-6 + 2 shared, expert d_ff=1408,
vocab=102400.

Spec-sheet discrepancy ("2 shared + 160 routed" belongs to full V2) is
resolved to the Lite config per hf:DeepSeek-V2-Lite — see DESIGN.md §6.
"""
from .lm_family import make_lm_arch

ARCH = make_lm_arch(
    "deepseek-v2-lite-16b",
    "[arXiv:2405.04434; hf]",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=1408, vocab=102400, mlp_kind="swiglu",
    moe=dict(n_experts=64, top_k=6, n_shared=2, d_ff=1408),
    mla=dict(kv_lora_rank=512, d_nope=128, d_rope=64, d_v=128),
    rope_theta=1e4,
)
