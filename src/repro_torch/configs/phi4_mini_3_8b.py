"""phi4-mini-3.8b [arXiv:2412.08905; hf] — dense, 32L d_model=3072 24H
(GQA kv=8) d_ff=8192 vocab=200064, RoPE + SwiGLU."""
from .lm_family import make_lm_arch

ARCH = make_lm_arch(
    "phi4-mini-3.8b",
    "[arXiv:2412.08905; hf]",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_head=128,
    d_ff=8192, vocab=200064, mlp_kind="swiglu", rope_theta=1e4,
)
