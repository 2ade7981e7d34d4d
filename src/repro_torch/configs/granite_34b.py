"""granite-34b: dense 88L code model, MQA (kv=1).

Source: arXiv:2405.04324 [hf]
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, d_ff=24576, vocab_size=49152,
    num_heads=48, num_kv_heads=1, mlp_type="gelu",   # GPTBigCode 2-mat MLP
    source="arXiv:2405.04324",
)

SMOKE = ArchConfig(
    name="granite-34b-smoke", family="dense",
    num_layers=3, d_model=64, d_ff=128, vocab_size=256,
    num_heads=4, num_kv_heads=1, mlp_type="gelu",
    dtype="float32", remat=False,
)
