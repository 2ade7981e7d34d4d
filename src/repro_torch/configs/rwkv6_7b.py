"""rwkv6-7b (Finch): attention-free, data-dependent decay
(``repro/configs/rwkv6_7b.py``).

Source: arXiv:2404.05892 [hf]
d=4096, head size 64 -> 64 wkv heads; O(1) decode state.
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, d_ff=14336, vocab_size=65536,
    rwkv_head_size=64,
    source="arXiv:2404.05892",
)

SMOKE = ArchConfig(
    name="rwkv6-7b-smoke", family="ssm",
    num_layers=2, d_model=64, d_ff=128, vocab_size=256,
    rwkv_head_size=16,
    dtype="float32", remat=False,
)
