"""The port's copies of the reference's host modules against their
originals: configs, the traffic generator, the hwsim-priced cost model,
the hwsim baselines and the page allocator / prefix index. Everything here is host
arithmetic, so the bar is exact equality."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro import hwsim as jhwsim  # noqa: E402
from repro.serve import cost as jcost  # noqa: E402
from repro.serve import paged_cache as jcache  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import hwsim as thwsim  # noqa: E402
from repro_torch.serve import cost as tcost  # noqa: E402
from repro_torch.serve import paged_cache as tcache  # noqa: E402
from repro_torch.serve import traffic as ttraffic  # noqa: E402


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_get_config_fields_equal(arch, smoke):
    want = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
    got = dataclasses.asdict(tconfigs.get_config(arch, smoke=smoke))
    assert got == want


def test_config_registry_equal():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.all_cells() == jconfigs.all_cells()


TRAFFIC = [
    dict(n_requests=12, arrival_rate=50.0, seed=0),
    dict(n_requests=9, arrival_rate=1e9, prompt_len_min=128,
         prompt_len_max=256, gen_len_min=32, gen_len_max=32,
         vocab_size=151936, seed=0),
    dict(n_requests=8, arrival_rate=1e6, prompt_len_min=4,
         prompt_len_max=12, seed=1, n_prefix_groups=2, prefix_len=16),
    dict(n_requests=10, arrival_rate=3e3, seed=5, sampled_fraction=0.5,
         temperature=0.7, top_k=20, top_p=0.9),
]


@pytest.mark.parametrize("kw", TRAFFIC)
def test_synth_trace_items_equal(kw):
    want = jtraffic.synth_trace(jtraffic.TrafficConfig(**kw))
    got = ttraffic.synth_trace(ttraffic.TrafficConfig(**kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.arrival_time == w.arrival_time
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.prompt.dtype == w.prompt.dtype
        assert (g.max_new_tokens, g.prefix_group) == \
            (w.max_new_tokens, w.prefix_group)
        assert dataclasses.asdict(g.sampling) == \
            dataclasses.asdict(w.sampling)
    assert ttraffic.trace_stats(got) == jtraffic.trace_stats(want)


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma_2b", "qwen2_moe_a2_7b"])
@pytest.mark.parametrize("scheme", ["token_PP", "layer_PP"])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_cost_model_prices_equal(arch, scheme, n_shards):
    want = jcost.ArtemisCostModel(jconfigs.get_config(arch), scheme=scheme,
                                  n_shards=n_shards)
    got = tcost.ArtemisCostModel(tconfigs.get_config(arch), scheme=scheme,
                                 n_shards=n_shards)
    for n in (1, 2, 3, 7, 8, 31, 32, 33, 100, 256, 257, 1024):
        assert got.price(n) == want.price(n)
        assert got.energy(n) == want.energy(n)


def test_hwsim_paper_models_equal():
    want = jhwsim.paper_models()
    got = thwsim.paper_models()
    assert sorted(got) == sorted(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])
        assert (dataclasses.asdict(thwsim.simulate_model(got[name]))
                == dataclasses.asdict(jhwsim.simulate_model(want[name])))


def test_hwsim_baselines_equal():
    """The published anchors of Figs 9-11 and the abstract's floor."""
    from repro.hwsim import baselines as jbaselines
    from repro_torch.hwsim import baselines as tbaselines
    assert thwsim.BASELINES is tbaselines.BASELINES
    assert sorted(tbaselines.BASELINES) == sorted(jbaselines.BASELINES)
    for name, want in jbaselines.BASELINES.items():
        assert dataclasses.asdict(tbaselines.BASELINES[name]) == \
            dataclasses.asdict(want)
    assert tbaselines.HEADLINE == jbaselines.HEADLINE


def test_allocator_and_prefix_index_replay_equal():
    """One scripted mix of alloc / share / free / register / match /
    forget gives the same answers and page ids in both copies."""
    prompt = np.random.default_rng(0).integers(2, 50, 16).astype(np.int32)
    sides = []
    for mod in (jcache, tcache):
        alloc = mod.PageAllocator(20, 4)
        index = mod.PrefixIndex(4)
        log = []
        a = alloc.alloc(4, owner=1)
        for j in range(4):
            index.register(prompt[:(j + 1) * 4], a[j])
        log.append(index.match(prompt[:10]))
        alloc.share(a[:2], owner=2)
        b = alloc.alloc(3, owner=2)
        log.append(alloc.free(a, owner=1))
        index.forget(log[-1])
        log.append(index.match(prompt))
        log.append(alloc.free(a[:2] + b, owner=2))
        log.append((alloc.n_free, alloc.n_used, alloc.total_allocated,
                    len(index)))
        alloc.check_invariants()
        sides.append(log)
    assert sides[0] == sides[1]
