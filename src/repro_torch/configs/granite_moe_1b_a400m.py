"""granite-moe-1b-a400m: 24L MoE, 32 experts top-8, GQA kv=8
(``repro/configs/granite_moe_1b_a400m.py``).

Source: hf:ibm-granite/granite-3.0-1b-a400m-base [hf]
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, d_ff=512, vocab_size=49155,
    num_heads=16, num_kv_heads=8,
    num_experts=32, experts_per_token=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE = ArchConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    num_layers=2, d_model=64, d_ff=32, vocab_size=256,
    num_heads=4, num_kv_heads=2,
    num_experts=4, experts_per_token=2, capacity_factor=8.0,
    dtype="float32", remat=False,
)
