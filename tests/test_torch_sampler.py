"""The port's batched sampler against `repro.serve.sampler`: the same
logits and per-lane parameters give the same tokens, on the hand-built
top-k / top-p cases of the reference's own sampling suite and on
random logits at the full vocabulary over a grid of parameters; and a
request's draw is a function of its (seed, position) and its logits
alone."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from repro.serve import sample_tokens as jsample  # noqa: E402
from repro_torch.serve import sampler  # noqa: E402

VOCAB = 16


def _lanes(b, temperature, top_k, top_p, seed, pos):
    full = np.full
    if pos is None:
        pos = np.arange(b, dtype=np.int32)
    return (full(b, temperature, np.float32), full(b, top_k, np.int32),
            full(b, top_p, np.float32), np.asarray(seed, np.uint32)
            * np.ones(b, np.uint32), np.asarray(pos, np.int32))


def _both(logits, temperature=1.0, top_k=0, top_p=1.0, seed=0, pos=None):
    logits = np.asarray(logits, np.float32)
    args = _lanes(logits.shape[0], temperature, top_k, top_p, seed, pos)
    want = np.asarray(jsample(logits, *args))
    got = sampler.sample_tokens(torch.from_numpy(logits), *args)
    assert got.dtype == np.int32 and got.shape == want.shape
    return got, want


def _rand_logits(n, vocab=VOCAB, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, vocab)).astype(np.float32)


def _tiled(probs, n):
    return np.tile(np.log(np.asarray(probs, np.float32)), (n, 1))


# the hand-built cases of tests/test_sampling.py: (logits, kwargs)
HAND_BUILT = {
    "greedy": (_rand_logits(8, seed=3),
               dict(temperature=0.0, top_k=7, top_p=0.5, seed=99)),
    "cold": (_rand_logits(16, seed=7), dict(temperature=0.01, seed=5)),
    "top_k_1": (_rand_logits(16, seed=11),
                dict(temperature=2.0, top_k=1, seed=21)),
    "top_k_3": (_tiled(np.linspace(1.0, 9.0, VOCAB), 512),
                dict(temperature=1.5, top_k=3, seed=2)),
    "top_p_0.45": (_tiled([0.5, 0.25, 0.15, 0.1], 512),
                   dict(temperature=1.0, top_p=0.45, seed=6)),
    "top_p_0.6": (_tiled([0.5, 0.25, 0.15, 0.1], 512),
                  dict(temperature=1.0, top_p=0.6, seed=6)),
    "top_p_0.8": (_tiled([0.5, 0.25, 0.15, 0.1], 512),
                  dict(temperature=1.0, top_p=0.8, seed=6)),
    "top_p_below_top": (_tiled([0.9, 0.06, 0.04], 64),
                        dict(temperature=1.0, top_p=0.05, seed=8)),
    "top_k_then_p": (_tiled([0.4, 0.3, 0.2, 0.1], 256),
                     dict(temperature=1.0, top_k=2, top_p=0.5, seed=9)),
    "top_p_only": (_tiled([0.4, 0.3, 0.2, 0.1], 256),
                   dict(temperature=1.0, top_p=0.5, seed=9)),
    "chi_square": (np.tile(_rand_logits(1, vocab=8, seed=4), (4096, 1)),
                   dict(temperature=1.0, seed=13, pos=np.zeros(4096))),
}


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_hand_built_cases_equal_the_reference(case):
    logits, kw = HAND_BUILT[case]
    got, want = _both(logits, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.3])
@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (50, 0.9), (1000, 0.3),
                                         (1, 1.0)])
def test_full_vocab_random_logits_equal_the_reference(temperature, top_k,
                                                      top_p):
    """(8, 151936) random logits, per-lane seeds and positions."""
    logits = (np.random.default_rng(5).standard_normal((8, 151936))
              * 3).astype(np.float32)
    seed = np.asarray([0, 42, 2**32 - 1, 7, 7, 123456, 1, 2], np.uint32)
    pos = np.asarray([0, 3, 9, 0, 1, 31, 255, 4], np.int32)
    got, want = _both(logits, temperature, top_k, top_p, seed, pos)
    np.testing.assert_array_equal(got, want)


def test_mixed_greedy_and_sampled_lanes_equal_the_reference():
    logits = _rand_logits(6, vocab=512, seed=8)
    temp = np.asarray([0.0, 0.8, 0.0, 1.0, 0.8, 0.0], np.float32)
    top_k = np.asarray([5, 50, 0, 0, 3, 0], np.int32)
    top_p = np.asarray([0.5, 0.9, 1.0, 0.7, 1.0, 1.0], np.float32)
    seed = np.arange(6, dtype=np.uint32) * 11
    pos = np.asarray([4, 0, 2, 8, 1, 0], np.int32)
    args = (temp, top_k, top_p, seed, pos)
    want = np.asarray(jsample(logits, *args))
    got = sampler.sample_tokens(torch.from_numpy(logits), *args)
    np.testing.assert_array_equal(got, want)
    greedy = temp == 0
    np.testing.assert_array_equal(got[greedy],
                                  np.argmax(logits, axis=-1)[greedy])


def test_same_seed_position_replays_same_token():
    """Identical rows with the same (seed, position) draw the same
    token, wherever they sit in the batch; the same row at another
    position or seed may not."""
    row = _rand_logits(1, vocab=64, seed=17)[0]
    logits = np.tile(row, (4, 1))
    seed = np.asarray([3, 3, 3, 4], np.uint32)
    pos = np.asarray([5, 5, 6, 5], np.int32)
    args = (np.full(4, 1.0, np.float32), np.zeros(4, np.int32),
            np.ones(4, np.float32), seed, pos)
    a = sampler.sample_tokens(torch.from_numpy(logits), *args)
    b = sampler.sample_tokens(torch.from_numpy(logits[::-1].copy()),
                              *(x[::-1].copy() for x in args))[::-1]
    assert a[0] == a[1]
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, np.asarray(jsample(logits, *args)))


def test_a_lane_alone_draws_what_it_draws_in_a_batch():
    logits = _rand_logits(5, vocab=128, seed=21)
    args = _lanes(5, 0.9, 20, 0.95, np.arange(5) * 3, None)
    batch = sampler.sample_tokens(torch.from_numpy(logits), *args)
    for i in range(5):
        alone = sampler.sample_tokens(torch.from_numpy(logits[i:i + 1]),
                                      *(a[i:i + 1] for a in args))
        assert alone[0] == batch[i]


def test_lane_key_is_the_reference_key():
    from repro.serve.sampler import lane_key as jlane_key
    for seed, pos in ((0, 0), (42, 7), (2**32 - 1, 31)):
        np.testing.assert_array_equal(
            sampler.lane_key(seed, pos).numpy(),
            np.asarray(jlane_key(seed, pos)).astype(np.int64))
