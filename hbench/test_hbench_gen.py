"""The benchmark's own copy of the Synth recipe and the hardness protocol."""
import numpy as np
import pytest
import torch

from hbench import gen


def test_one_seed_one_collection_and_streams_apart():
    a = gen.random_walks(1000, 64, gen.generator(2**31 + 5, "collection", "cpu"), "cpu")
    b = gen.random_walks(1000, 64, gen.generator(2**31 + 5, "collection", "cpu"), "cpu")
    c = gen.random_walks(1000, 64, gen.generator(2**31 + 6, "collection", "cpu"), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert gen.stream_seed(7, "pool") != gen.stream_seed(7, "collection")
    assert 0 <= gen.stream_seed(2**40, "x") < 2**63


def test_walks_are_z_normalized_random_walks(monkeypatch):
    monkeypatch.setattr(gen, "WALK_CHUNK_ROWS", 300)     # several draws
    x = gen.random_walks(1000, 256, gen.generator(3, "collection", "cpu"), "cpu")
    assert torch.allclose(x.mean(1), torch.zeros(1000), atol=1e-5)
    assert torch.allclose(x.std(1, correction=0), torch.ones(1000), atol=1e-5)
    # a walk's steps are far smoother than white noise: neighbours correlate
    corr = (x[:, 1:] * x[:, :-1]).mean()
    assert corr > 0.8


@pytest.mark.parametrize("level,var", [("1%", 0.01), ("5%", 0.05), ("10%", 0.10)])
def test_noisy_queries_have_the_stated_variance(level, var):
    x = gen.random_walks(500, 256, gen.generator(4, "collection", "cpu"), "cpu")
    q = gen.queries(x, [level] * 400, 4, "pool")
    # the nearest series is the one the query was made from
    d = torch.cdist(q.double(), x.double()).square()
    noise = d.min(dim=1).values / 256
    assert float(noise.mean()) == pytest.approx(var, rel=0.05)
    assert gen.noise_variance("rand") is None
    with pytest.raises(ValueError):
        gen.noise_variance("5")


def test_mix_gives_every_seed_the_same_set_in_another_order():
    traffic = {"difficulty": ["1%", "2%", "5%", "10%", "rand"], "k": [1, 10]}
    la, ka = gen.mix(traffic, 4000, 1, "pool")
    lb, kb = gen.mix(traffic, 4000, 2, "pool")
    pairs_a = sorted(zip(la, ka.tolist()))
    assert pairs_a == sorted(zip(lb, kb.tolist()))
    assert list(zip(la, ka.tolist())) != list(zip(lb, kb.tolist()))
    counts = {p: pairs_a.count(p) for p in set(pairs_a)}
    assert len(counts) == 10 and set(counts.values()) == {400}
    assert np.array_equal(gen.mix(traffic, 4000, 1, "pool")[1], ka)
    # every block of ten holds each (level, k) once
    for lo in range(0, 4000, 10):
        assert len(set(zip(la[lo:lo + 10], ka[lo:lo + 10].tolist()))) == 10
    assert len(gen.mix(traffic, 13, 1, "pool")[0]) == 13
