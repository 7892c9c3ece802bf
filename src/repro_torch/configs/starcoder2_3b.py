"""starcoder2-3b [arXiv:2402.19173; hf] — dense, 30L d_model=3072 24H
(GQA kv=2) d_ff=12288 vocab=49152, RoPE, plain-GELU MLP."""
from .lm_family import make_lm_arch

ARCH = make_lm_arch(
    "starcoder2-3b",
    "[arXiv:2402.19173; hf]",
    n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_head=128,
    d_ff=12288, vocab=49152, mlp_kind="gelu", rope_theta=1e5,
)
