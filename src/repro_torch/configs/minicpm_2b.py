"""minicpm-2b: dense 40L, MHA (kv=36), WSD schedule (arch llama-like).

Source: arXiv:2404.06395 [hf]
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, d_ff=5760, vocab_size=122753,
    num_heads=36, num_kv_heads=36,
    source="arXiv:2404.06395",
)

SMOKE = ArchConfig(
    name="minicpm-2b-smoke", family="dense",
    num_layers=2, d_model=72, d_ff=144, vocab_size=256,
    num_heads=4, num_kv_heads=4,
    dtype="float32", remat=False,
)
