"""Hercules as the retrieval layer for an LM, on PyTorch (the port's twin
of ``examples/retrieval_lm.py``; the paper's Deep-embeddings scenario: §4.1
uses CNN embeddings, here they come from the port's own LM):

1. train a tiny causal LM (minicpm-2b's smoke config) for 20 steps,
2. embed a corpus of token sequences with it (mean-pooled logits),
3. build a Hercules index over the z-normalized embeddings,
4. answer exact nearest-neighbour queries for unseen prompts, and verify
   them against brute force.

    PYTHONPATH=src python examples/torch_retrieval_lm.py              # the card
    PYTHONPATH=src python examples/torch_retrieval_lm.py --device cpu

On the card, phase 3 of the index's exact search runs the hand-written
``lb_sax_matrix`` kernel. Tokens are drawn from CPU ``torch.Generator``s
(seeds 0, 1, 2), not the reference's ``jax.random`` bits.
"""
import argparse

import torch

from repro_torch.configs import get_smoke
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.search import SearchConfig, brute_force_knn
from repro_torch.core.summaries import znormalize
from repro_torch.core.tree import BuildConfig
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.train import AdamWConfig, TrainConfig, make_train_step
from repro_torch.train.train_step import init_train_state

CFG = get_smoke("minicpm-2b")
K = 3


def draw_tokens(seed: int, shape, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, shape, generator=g, dtype=torch.int32).to(device)


def train(device, steps: int = 20):
    """``steps`` train steps on one (8, 32) batch. Returns (params, metrics)."""
    model = get_model(CFG)
    tcfg = TrainConfig(optimizer=AdamWConfig(learning_rate=1e-3, warmup_steps=5,
                                             total_steps=50, schedule="constant"))
    params, opt = init_train_state(model, CFG, tcfg,
                                   torch.Generator(device=device).manual_seed(0))
    step = make_train_step(model, CFG, tcfg)
    batch = {"tokens": draw_tokens(0, (8, 32), device)}
    for _ in range(steps):
        params, opt, metrics = step(params, opt, batch)
    return params, metrics


@torch.no_grad()
def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """A cheap text embedding: logit-space mean pool (keeps the example
    tiny; production would pool pre-head hidden states), z-normalized.
    Hercules needs length % 16 == 0 for the iSAX sidecar: vocab 256."""
    logits, _ = get_model(CFG).forward(params, {"tokens": tokens}, CFG)
    return znormalize(logits.mean(dim=1))


def retrieve(vecs: torch.Tensor, qvecs: torch.Tensor):
    """Index ``vecs`` and answer exact k-NN for ``qvecs``. Returns (index,
    result, brute-force dists, brute-force ids)."""
    idx = HerculesIndex.build(vecs, IndexConfig(
        build=BuildConfig(leaf_capacity=64),
        search=SearchConfig(k=K, l_max=8, chunk=256, scan_block=256)), device=vecs.device)
    res = idx.knn(qvecs)
    bf_d, bf_i = brute_force_knn(vecs, qvecs, K)
    return idx, res, bf_d, bf_i


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params, metrics = train(dev)
    print(f"trained 20 steps, loss {float(metrics['loss']):.3f}")
    vecs = embed(params, draw_tokens(1, (2048, 32), dev))
    print(f"corpus embedded: {tuple(vecs.shape)}")
    qvecs = embed(params, draw_tokens(2, (5, 32), dev))
    idx, res, bf_d, bf_i = retrieve(vecs, qvecs)
    print("index:", idx.stats())
    if not torch.allclose(res.dists, bf_d, rtol=1e-3, atol=1e-3):
        raise SystemExit("retrieval is not exact: the index's distances differ from "
                         "brute force")
    print("retrieval exact")
    for i in range(3):
        print(f"prompt {i}: nearest corpus docs {res.ids[i].tolist()} "
              f"(d2 = {[round(v, 2) for v in res.dists[i].tolist()]})")


if __name__ == "__main__":
    main()
