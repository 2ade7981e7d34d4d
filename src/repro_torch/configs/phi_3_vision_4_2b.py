"""phi-3-vision-4.2b: phi3-mini backbone + CLIP stub frontend.

Source: hf:microsoft/Phi-3-vision-128k-instruct [hf]
The vision tower is a STUB per assignment: input_specs() provides
precomputed patch embeddings (B, 576, 1024); only the projector and the
language backbone are real compute.
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, d_ff=8192, vocab_size=32064,
    num_heads=32, num_kv_heads=32,
    num_patches=576, d_patch=1024,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = ArchConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm",
    num_layers=2, d_model=64, d_ff=128, vocab_size=256,
    num_heads=4, num_kv_heads=4,
    num_patches=8, d_patch=32,
    dtype="float32", remat=False,
)
