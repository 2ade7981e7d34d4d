"""LM serving from the command line on PyTorch (``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --requests 8 --prompt-len 512 --new-tokens 32 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b --smoke \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
        --prompt-len 512 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --smoke \
        --device cpu

Builds the arch (any registered arch: dense, vlm, moe, audio, ssm or
hybrid) with random weights (seed 0) on the CUDA device (``--device cpu``
for the host; ``--smoke`` for the reduced config), queues random prompts
(a vlm request also carries random patch embeddings, an audio request
random frame embeddings), serves them greedily through
``ServeEngine`` and reports requests, tokens, seconds and tokens per
second. It only serves, so the parameters are a serving tree wherever the
model builds one (each matrix held in the compute dtype only: the same
bits in half the bytes, and moonshot-v1-16b-a3b's 28 B parameters fit one
card only so); RWKV-6 reads its mixing and decay parameters in float32 and
builds none.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import get_model
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="rwkv6-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    kwargs = {} if cfg.family == "ssm" else {"serving": True}
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg, **kwargs)
    eng = ServeEngine(model, cfg, params,
                      ServeConfig(max_seq=args.prompt_len + args.new_tokens + 8,
                                  batch_slots=args.slots,
                                  max_new_tokens=args.new_tokens))
    rng = np.random.default_rng(0)
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = rng.normal(
            size=(cfg.num_patches, cfg.d_patch)).astype(np.float32)
    if cfg.family == "audio":
        extras["frames"] = rng.normal(
            size=(cfg.num_frames, cfg.d_model)).astype(np.float32)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab_size, size=args.prompt_len), extras)
    synchronize(dev)
    t0 = time.perf_counter()
    out = eng.run()
    synchronize(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s) on {dev}")
    if out:
        print("sample:", out[min(out)][:10])


if __name__ == "__main__":
    main()
