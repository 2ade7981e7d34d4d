"""codeqwen1.5-7b: dense 32L, MHA (kv=32), qwen1.5 arch.

Source: hf:Qwen/CodeQwen1.5-7B [hf]
"""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, d_ff=13440, vocab_size=92416,
    num_heads=32, num_kv_heads=32,
    source="hf:Qwen/CodeQwen1.5-7B",
)

SMOKE = ArchConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    num_layers=2, d_model=64, d_ff=128, vocab_size=256,
    num_heads=4, num_kv_heads=4,
    dtype="float32", remat=False,
)
