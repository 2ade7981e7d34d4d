"""recurrentgemma-2b (Griffin): RG-LRU + local attention 1:2
(``repro/configs/recurrentgemma_2b.py``).

Source: arXiv:2402.19427 [hf]
26L, pattern (rec, rec, attn), window 2048, MQA kv=1; runs long_500k.
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, d_ff=7680, vocab_size=256000,
    num_heads=10, num_kv_heads=1, head_dim=256,
    window=2048, block_pattern=("rec", "rec", "attn"),
    d_rnn=2560, conv_width=4,
    scan_layers=False,
    source="arXiv:2402.19427",
)

SMOKE = ArchConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    num_layers=3, d_model=64, d_ff=128, vocab_size=256,
    num_heads=4, num_kv_heads=1, head_dim=16,
    window=16, block_pattern=("rec", "rec", "attn"),
    d_rnn=64, conv_width=4,
    scan_layers=False, dtype="float32", remat=False,
)
