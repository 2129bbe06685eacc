"""repro_torch.serve — the continuous-batching serving engine in
PyTorch (counterpart of `repro.serve`).

Request lifecycle (`request`), the sequence-memory protocol with its
paged-KV and state-slot backends (`backend`), the chunked-prefill and
decode forwards and the whole-prompt reference prefill
(`paged_model`), the paged-cache primitives (`paged_cache`), the
recurrent families' state-slot steps (`state_model`), the ARTEMIS-cost-aware
scheduler (`scheduler` + `cost`, priced by
`repro_torch.hwsim`), the greedy sampler (`sampler`), synthetic
traffic (`traffic`), observability (`obs`) and the engine driver
(`engine`). The host modules are copies of the reference's; the device
work runs on the model's torch device.

Entry point: `python -m repro_torch.launch.serve --mode engine`.
"""
from repro_torch.serve.backend import (
    AdmitPlan,
    BudgetProbe,
    EngineConfig,
    PagedBudget,
    PagedKVBackend,
    SequenceBackend,
    SlotBudget,
    StateSlotBackend,
    make_backend,
)
from repro_torch.serve.cost import ArtemisCostModel
from repro_torch.serve.engine import ServeEngine, percentile
from repro_torch.serve.obs import (
    Event,
    Histogram,
    MetricsRegistry,
    PhaseAttribution,
    RequestTrace,
    Tracer,
    assemble_spans,
    dumps_chrome_trace,
    export_chrome_trace,
    to_chrome_trace,
    validate_chrome_trace,
)
from repro_torch.serve.paged_cache import (
    PageAllocator,
    PagedKVCache,
    PrefixIndex,
    cow_copy_page,
    init_paged_cache,
)
from repro_torch.serve.paged_model import (
    make_paged_chunked_prefill,
    make_paged_decode,
    make_paged_prefill,
)
from repro_torch.serve.request import Request, RequestState, SamplingParams
from repro_torch.serve.sampler import sample_tokens
from repro_torch.serve.scheduler import Action, Scheduler, SchedulerConfig
from repro_torch.serve.state_model import (
    TRASH_SLOT,
    init_slot_pool,
    make_slot_decode,
    make_slot_prefill_chunk,
    reset_slot,
)
from repro_torch.serve.traffic import TraceItem, TrafficConfig, synth_trace

__all__ = [
    "AdmitPlan", "BudgetProbe", "EngineConfig", "PagedBudget",
    "PagedKVBackend", "SequenceBackend", "SlotBudget", "StateSlotBackend",
    "make_backend",
    "ArtemisCostModel", "ServeEngine", "percentile",
    "Event", "Histogram", "MetricsRegistry", "PhaseAttribution",
    "RequestTrace", "Tracer", "assemble_spans", "dumps_chrome_trace",
    "export_chrome_trace", "to_chrome_trace", "validate_chrome_trace",
    "PageAllocator", "PagedKVCache", "PrefixIndex", "cow_copy_page",
    "init_paged_cache",
    "make_paged_chunked_prefill", "make_paged_decode", "make_paged_prefill",
    "Request", "RequestState", "SamplingParams", "sample_tokens",
    "Action", "Scheduler", "SchedulerConfig",
    "TRASH_SLOT", "init_slot_pool", "make_slot_decode",
    "make_slot_prefill_chunk", "reset_slot",
    "TraceItem", "TrafficConfig", "synth_trace",
]
