"""moonshot-v1-16b-a3b (Moonlight): 48L MoE, 64 experts top-6, MHA kv=16
(``repro/configs/moonshot_v1_16b_a3b.py``).

Source: hf:moonshotai/Moonlight-16B-A3B [hf]
Moonlight's single dense first layer is modeled as MoE like the rest, as
the reference models it.
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, d_ff=1408, vocab_size=163840,
    num_heads=16, num_kv_heads=16,
    num_experts=64, experts_per_token=6,
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE = ArchConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    num_layers=2, d_model=64, d_ff=48, vocab_size=256,
    num_heads=4, num_kv_heads=4,
    num_experts=8, experts_per_token=2, capacity_factor=8.0,
    dtype="float32", remat=False,
)
