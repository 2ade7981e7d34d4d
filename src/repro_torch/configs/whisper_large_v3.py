"""whisper-large-v3: enc-dec, conv frontend STUB (frame embeddings supplied).

Source: arXiv:2212.04356 [unverified]
32 encoder + 32 decoder layers, d=1280, 20 heads, MHA.
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, d_ff=5120, vocab_size=51866,
    num_heads=20, num_kv_heads=20,
    encoder_layers=32, num_frames=1500,
    source="arXiv:2212.04356",
)

SMOKE = ArchConfig(
    name="whisper-large-v3-smoke", family="audio",
    num_layers=2, d_model=64, d_ff=128, vocab_size=256,
    num_heads=4, num_kv_heads=4,
    encoder_layers=2, num_frames=16,
    dtype="float32", remat=False,
)
