"""llama3-405b: dense 126L, GQA kv=8, 128k vocab.

Source: arXiv:2407.21783 [unverified]
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, d_ff=53248, vocab_size=128256,
    num_heads=128, num_kv_heads=8, rope_theta=500000.0,
    param_dtype="bfloat16",   # §Perf iter 3: halves FSDP gather + grad bytes
    source="arXiv:2407.21783",
)

SMOKE = ArchConfig(
    name="llama3-405b-smoke", family="dense",
    num_layers=2, d_model=64, d_ff=192, vocab_size=256,
    num_heads=8, num_kv_heads=2, rope_theta=500000.0,
    dtype="float32", remat=False,
)
