"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407; hf] — dense,
40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072,
128k context (rope_theta=1e6)."""
from .lm_family import make_lm_arch

ARCH = make_lm_arch(
    "mistral-nemo-12b",
    "[hf:mistralai/Mistral-Nemo-Base-2407; hf]",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_head=128,
    d_ff=14336, vocab=131072, mlp_kind="swiglu", rope_theta=1e6,
    notes="head_dim=128 explicit (5120/32=160 is NOT the head dim in Nemo).",
)
