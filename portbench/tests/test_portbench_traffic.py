"""The traffic generators: the same seed gives the same inputs, every seed
the same work in another order."""

import numpy as np
import pytest

from portbench.core import corpus, registry


@pytest.mark.parametrize("name", ["stream_camera", "stream_pages", "backlog128"])
def test_corpus_is_fixed(name):
    tr = registry.load_json(f"{registry.PORTBENCH}/traffic/{name}.json")
    a, b = corpus.paths(tr["corpus"]), corpus.paths(tr["corpus"])
    assert a == b and len(a) == len(set(a))
    assert len(a) == {"stream_camera": 29, "stream_pages": 75, "backlog128": 75}[name]


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**40 + 3, -7, 2**70 + 11])
def test_order_is_deterministic_per_seed(seed):
    n = 75
    a, b = corpus.order(seed, n), corpus.order(seed, n)
    assert np.array_equal(a, b)
    assert sorted(a.tolist()) == list(range(n))  # the same photos, each once a cycle


def test_orders_differ_between_seeds():
    orders = {tuple(corpus.order(s, 29).tolist()) for s in (1, 2, 3, 2**31 + 1, 2**31 + 2)}
    assert len(orders) == 5


def test_sample_streams_are_independent_of_the_order():
    seed = 123456789
    assert not np.array_equal(corpus.rng(seed, 0).permutation(29), corpus.rng(seed, 1).permutation(29))
    assert np.array_equal(corpus.rng(seed, 1).choice(100, 12, replace=False),
                          corpus.rng(seed, 1).choice(100, 12, replace=False))


def test_digests_match_the_recorded_decodes():
    from bbocr_tpu_torch.io import imread_gray, load_gray

    name = "books/1/IMG_0000.jpg"
    gray = imread_gray(f"{registry.ROOT}/{name}")
    assert corpus.digest_mismatches({name: gray}, "cv2_gray") == []
    with open(f"{registry.ROOT}/{name}", "rb") as f:
        luma = load_gray(f.read())
    assert corpus.digest_mismatches({name: luma}, "pil_l") == []
    assert corpus.digest_mismatches({name: gray + 1}, "cv2_gray") == [name]
