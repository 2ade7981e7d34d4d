"""Next-token LM loss with masking and z-loss, float32 throughout
(``repro/train/loss.py``)."""
from __future__ import annotations

import torch

from repro_torch.models.arch import ArchConfig


def make_labels(batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels, mask) aligned with the model's logits sequence.

    * plain LM: position i predicts tokens[i+1]; last position masked, and
      ``batch["loss_mask"]`` (B, S) multiplies the mask when given.
    * vlm: logits run over [patches | text]; only text-token targets count.
    * audio (whisper): teacher-forced decoder tokens, standard shift.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    if cfg.family == "vlm":
        p = cfg.num_patches
        comb = torch.cat([torch.zeros((b, p), dtype=tokens.dtype, device=dev), tokens], 1)
        labels = torch.cat([comb[:, 1:], torch.zeros((b, 1), dtype=tokens.dtype,
                                                     device=dev)], 1)
        pos = torch.arange(p + s, device=dev)
        mask = ((pos >= p - 1) & (pos < p + s - 1)).to(torch.float32)
        return labels, mask.expand(b, p + s)
    labels = torch.cat([tokens[:, 1:], torch.zeros((b, 1), dtype=tokens.dtype, device=dev)], 1)
    mask = torch.cat([torch.ones((b, s - 1), dtype=torch.float32, device=dev),
                      torch.zeros((b, 1), dtype=torch.float32, device=dev)], 1)
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"].to(torch.float32)
    return labels, mask


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                  z_loss: float = 0.0) -> tuple[torch.Tensor, dict]:
    """Masked mean softmax CE. logits (B,S,V); labels/mask (B,S). Returns
    (loss, metrics: ce, tokens, z_loss when asked, accuracy)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = (nll * mask).sum() / denom
    metrics = {"ce": ce, "tokens": denom}
    loss = ce
    if z_loss:
        zl = (lse.square() * mask).sum() / denom
        loss = loss + z_loss * zl
        metrics["z_loss"] = zl
    acc = (logits.argmax(-1) == labels.long()).to(torch.float32)
    metrics["accuracy"] = (acc * mask).sum() / denom
    return loss, metrics
