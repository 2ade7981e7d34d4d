"""Training from the command line on PyTorch (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --smoke \
        --steps 50 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt --device cpu

Runs on the CUDA device unless ``--device cpu``. With ``--ckpt-dir`` it
checkpoints every ``--ckpt-every`` steps (an atomic rename) and, on start,
resumes from the latest checkpoint there. Batch t is a function of (seed,
t) alone (:func:`synth_batch`), so a restarted run sees the batches it
would have seen.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.train import (TrainConfig, latest_step, load_checkpoint, make_train_step,
                               save_checkpoint)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state


def synth_batch(seed: int, step: int, cfg, batch: int, seq: int, device=None) -> dict:
    """Deterministic batch t = f(seed, t): random tokens (and, for vlm,
    patch embeddings; for audio, frame embeddings (B, num_frames,
    d_model)) from a CPU ``torch.Generator`` seeded from (seed, step),
    moved to ``device``. The same on every device; not the reference's
    bits (that one draws with ``jax.random``)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                                   dtype=torch.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.randn((batch, cfg.num_patches, cfg.d_patch), generator=g)
    if cfg.family == "audio":
        out["frames"] = torch.randn((batch, cfg.num_frames, cfg.d_model), generator=g)
    return {k: v.to(dev) for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="minicpm-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(learning_rate=args.lr, warmup_steps=10,
                              total_steps=args.steps),
        microbatches=args.microbatches)
    step_fn = make_train_step(model, cfg, tcfg)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, meta = load_checkpoint(args.ckpt_dir, device=dev)
        params = model.params_from_numpy(state["params"], cfg, dev)
        opt = state["opt"]
        opt["step"] = opt["step"].to(torch.int32)
        start = meta["step"]
        print(f"resumed from step {start}")
    else:
        params, opt = init_train_state(model, cfg, tcfg,
                                       torch.Generator(device=dev).manual_seed(args.seed))

    t0 = time.time()
    for step in range(start, args.steps):
        batch = synth_batch(args.seed, step, cfg, args.batch, args.seq, dev)
        params, opt, metrics = step_fn(params, opt, batch)
        if (step + 1) % args.log_every == 0:
            print(f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['accuracy']):.3f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({(time.time() - t0) / (step - start + 1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, {"params": params, "opt": opt},
                            {"rng_seed": args.seed})
    print(f"done: {args.steps - start} steps in {time.time() - t0:.1f}s on {dev}")


if __name__ == "__main__":
    main()
