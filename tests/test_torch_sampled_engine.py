"""Mixed greedy/sampled serving on the dense family: the port's engine
and CLI against the JAX package's.

- A `synth_trace` with half of its requests sampled (temperature 0.8,
  top-k 50, top-p 0.9, per-request RNG lanes) drains through the
  reference `ServeEngine` and the port's (gather and fused cores) on
  the smoke `qwen3_8b`, at float32 on the CPU with the reference's
  weights: the tokens are identical, `metrics()` equal key for key,
  the event logs equal field for field.
- A sampled request replays its tokens through preemption: the same
  trace under cache pressure gives each request the tokens it gets
  with room to spare.
- The CLI's `--mode engine` with the sampling flags and `--trace-json`
  prints the reference CLI's summary lines (wall numbers aside) and
  writes the same Chrome trace; its flag checks are the reference's.
"""
import dataclasses
import functools
import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import configs  # noqa: E402
from repro.launch import serve as jcli  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import TrafficConfig as JTrafficConfig  # noqa: E402
from repro.serve import synth_trace as jsynth_trace  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine, TrafficConfig  # noqa: E402
from repro_torch.serve import synth_trace  # noqa: E402

TRAFFIC = dict(n_requests=6, arrival_rate=2e5, prompt_len_min=3,
               prompt_len_max=20, gen_len_min=3, gen_len_max=8, seed=3,
               sampled_fraction=0.5, temperature=0.8, top_k=50, top_p=0.9)
ENGINE = dict(page_size=8, n_pages=64, max_batch=3, max_pages_per_seq=8,
              prefill_chunk=8, observability="trace")
# the verify recipe's cache-pressure probe, sampled
PRESSURE_TRAFFIC = dict(TRAFFIC, n_requests=8, arrival_rate=1e9,
                        prompt_len_min=6, prompt_len_max=12, gen_len_min=8,
                        gen_len_max=16)
PRESSURE = dict(page_size=4, n_pages=12, max_batch=3, max_pages_per_seq=8,
                prefill_chunk=32)


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = dataclasses.replace(configs.get_config("qwen3_8b", smoke=True),
                              compute_dtype="float32")
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, params, model


def _events(events):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in events]


@functools.lru_cache(maxsize=None)
def _reference():
    cfg, params, _ = _weights()
    eng = JServeEngine(cfg, params=params, ecfg=JEngineConfig(**ENGINE))
    eng.submit_trace(jsynth_trace(JTrafficConfig(vocab_size=cfg.vocab_size,
                                                 **TRAFFIC)))
    eng.drain()
    return eng.results(), eng.metrics(), _events(eng.events)


def _drain_port(attn_impl, traffic=TRAFFIC, **ekw):
    cfg, _, model = _weights()
    eng = ServeEngine(cfg, params=model, ecfg=EngineConfig(
        **{**ENGINE, "attn_impl": attn_impl, **ekw}), device="cpu")
    eng.submit_trace(synth_trace(TrafficConfig(vocab_size=cfg.vocab_size,
                                               **traffic)))
    eng.drain()
    eng.backend.check_invariants()
    return eng


@pytest.mark.parametrize("attn_impl", ["gather", "fused"])
def test_mixed_drain_matches_reference(attn_impl):
    results, metrics, events = _reference()
    eng = _drain_port(attn_impl)
    got = eng.results()
    assert sorted(got) == sorted(results)
    for rid in results:
        np.testing.assert_array_equal(got[rid], results[rid],
                                      err_msg=f"request {rid}")
    assert eng.metrics() == metrics
    assert _events(eng.events) == events
    m = eng.metrics()
    assert 0 < m["n_sampled_tokens"] < m["n_generated_tokens"]


def test_sampled_requests_replay_through_preemption():
    roomy = _drain_port("gather", PRESSURE_TRAFFIC)
    tight = _drain_port("gather", PRESSURE_TRAFFIC, **PRESSURE)
    assert tight.metrics()["n_preemptions"] > 0
    assert tight.metrics()["n_sampled_tokens"] > 0
    for rid, toks in roomy.results().items():
        np.testing.assert_array_equal(tight.results()[rid], toks,
                                      err_msg=f"request {rid}")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SAMPLING_FLAGS = ["--mode", "engine", "--temperature", "0.8", "--top-k",
                  "50", "--top-p", "0.9", "--sampled-fraction", "0.5",
                  "--n-requests", "6", "--prompt-len", "12", "--gen-len", "6"]


def _strip(lines, path):
    return [re.sub(r"[\d.]+ tok/s wall", "", ln).replace(str(path), "PATH")
            for ln in lines]


def test_cli_sampled_trace_json_matches_reference(tmp_path, monkeypatch,
                                                  capsys):
    jpath, tpath = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["serve", *SAMPLING_FLAGS,
                                      "--trace-json", str(jpath)])
    jcli.main()
    want = _strip(capsys.readouterr().out.strip().splitlines(), jpath)
    tcli.main([*SAMPLING_FLAGS, "--trace-json", str(tpath), "--device",
               "cpu"])
    got = _strip(capsys.readouterr().out.strip().splitlines(), tpath)
    assert len(got) == 3 and got == want
    assert re.search(r"\(([1-9]\d*) sampled\)", got[0]), got[0]
    assert json.loads(tpath.read_text()) == json.loads(jpath.read_text())


@pytest.mark.parametrize("flags", [
    ["--sampled-fraction", "0.5"],
    ["--sampled-fraction", "0.5", "--temperature", "0"],
])
def test_cli_sampled_fraction_needs_a_temperature(flags, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--mode", "engine", *flags])
    with pytest.raises(SystemExit) as want:
        jcli.main()
    want_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        tcli.main(["--mode", "engine", *flags, "--device", "cpu"])
    got_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err.split(": ", 1)[1] == want_err.split(": ", 1)[1]
    assert "--sampled-fraction > 0 requires --temperature > 0" in got_err


def test_serve_engine_observability_trace_keeps_the_events():
    out = tcli.serve_engine(n_requests=3, prompt_len=6, gen_len=3,
                            observability="trace", temperature=0.8,
                            sampled_fraction=1.0, device="cpu")
    assert out["events"] and out["events"] == out["engine"].events
    assert out["metrics"]["n_sampled_tokens"] == \
        out["metrics"]["n_generated_tokens"]
