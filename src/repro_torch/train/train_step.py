"""Train and eval steps over any ModelDef (``repro/train/train_step.py``).

The step is an eager function: ``torch.autograd`` over ``model.forward``
and the loss, then :func:`adamw_update` on the parameters in place. With
``microbatches > 1`` the batch is split along its first axis, and the
gradients (and metrics) are summed in the reference's order, microbatch 0
first and the others added one by one, then scaled by 1/microbatches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import ModelDef
from repro_torch.models import common as C
from repro_torch.models.arch import ArchConfig
from repro_torch.train.loss import cross_entropy, make_labels
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    z_loss: float = 1e-4
    moe_aux_weight: float = 1e-2
    microbatches: int = 1          # grad accumulation (sequential)


def make_grad_fn(model: ModelDef, cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """Returns grad_fn(params, batch) -> (metrics, grads): the loss's
    metrics (``loss`` among them) and its gradient, a tree of the
    parameters' shape. Turns ``requires_grad`` on for every parameter.
    On CUDA tensors the recurrences' gradients are kernels of their own
    (``kernels/ops.py``: ``WKV6Fn``, ``RGLRUScanFn``)."""

    def grad_fn(params, batch):
        tree = params.tree()
        leaves = C.tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            logits, aux = model.forward(params, batch, cfg)
            labels, mask = make_labels(batch, cfg)
            loss, metrics = cross_entropy(logits, labels, mask, tcfg.z_loss)
            if cfg.num_experts:
                loss = loss + tcfg.moe_aux_weight * aux
                metrics["moe_aux"] = aux
            metrics["loss"] = loss
            grads = torch.autograd.grad(loss, leaves)
        return ({k: v.detach() for k, v in metrics.items()},
                C.tree_unflatten(tree, grads))

    return grad_fn


def _microbatch(batch: dict, i: int, n: int) -> dict:
    return {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)] for k, v in batch.items()}


def make_train_step(model: ModelDef, cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics);
    the parameters are updated in place."""
    grad_fn = make_grad_fn(model, cfg, tcfg)

    def train_step(params, opt_state, batch):
        mb = tcfg.microbatches
        if mb > 1:
            metrics, grads = grad_fn(params, _microbatch(batch, 0, mb))
            for i in range(1, mb):
                m_i, g_i = grad_fn(params, _microbatch(batch, i, mb))
                grads = C.tree_map(torch.add, grads, g_i)
                metrics = {k: metrics[k] + m_i[k] for k in metrics}
            inv = 1.0 / mb
            grads = C.tree_map(lambda g: g * inv, grads)
            metrics = {k: v * inv for k, v in metrics.items()}
        else:
            metrics, grads = grad_fn(params, batch)
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state,
                                                      tcfg.optimizer)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: ModelDef, cfg: ArchConfig,
                   tcfg: TrainConfig | None = None) -> Callable:

    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = model.forward(params, batch, cfg)
        labels, mask = make_labels(batch, cfg)
        _, metrics = cross_entropy(logits, labels, mask)
        return metrics

    return eval_step


def init_train_state(model: ModelDef, cfg: ArchConfig, tcfg: TrainConfig,
                     generator: torch.Generator):
    """(params, opt_state) on the generator's device, the parameters
    trainable."""
    params = model.init(generator, cfg)
    params.requires_grad_(True)
    return params, adamw_init(params, tcfg.optimizer)
