"""Collective bytes of one rank's step (counterpart of
`repro.roofline.hlo`).

The reference parses the compiled per-device HLO text, since
`cost_analysis()` does not expose collective traffic. The port has no
HLO, and so no HLO-text parser: its collectives are the calls of
`parallel.comm`, and each call writes one record (kind, operand bytes,
group size) while `recording()` is open. An autograd collective's
backward goes through the same calls, so it is recorded too; a gloo
collective split over lanes is one record. The bytes follow the
reference's weights, per kind, from each collective's output and its
group size S:

  op                  operand bytes      ring wire bytes / device
  all-reduce          out                2·(S-1)/S·out
  all-gather          out / S            (S-1)/S·out
  reduce-scatter      out · S            (S-1)/S·out·S
  all-to-all          out                (S-1)/S·out
  collective-permute  out                out

A group of one rank moves nothing and is skipped.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# the open recordings' record lists (`parallel.comm` appends to each)
_RECORDERS: list[list] = []


def recording_open() -> bool:
    return bool(_RECORDERS)


def record(kind: str, operand_bytes: int, group_size: int) -> None:
    """Note one collective of `kind` over a group of `group_size` ranks
    with `operand_bytes` of input on this rank, in every open
    recording."""
    for into in _RECORDERS:
        into.append((kind, int(operand_bytes), int(group_size)))


@contextlib.contextmanager
def recording():
    """Collect the records of the collectives run inside the block; the
    list it yields holds them once the block ends."""
    into: list = []
    _RECORDERS.append(into)
    try:
        yield into
    finally:
        _RECORDERS.remove(into)


@dataclasses.dataclass
class CollectiveStats:
    ops: dict            # kind -> count
    bytes_by_kind: dict  # kind -> operand bytes (per device)
    raw_bytes: int       # total operand bytes
    wire_bytes: float    # ring-algorithm bytes on the wire per device

    def summary(self) -> str:
        parts = [f"{k}:{v} ({self.bytes_by_kind.get(k, 0)/1e6:.1f}MB)"
                 for k, v in sorted(self.ops.items())]
        return ", ".join(parts) or "none"


def _out_bytes(kind: str, operand: int, s: int) -> int:
    if kind == "all-gather":
        return operand * s
    if kind == "reduce-scatter":
        return operand // s
    return operand


def collective_stats(records) -> CollectiveStats:
    """The stats of (kind, operand bytes, group size) records."""
    ops: dict = defaultdict(int)
    by_kind: dict = defaultdict(float)
    wire = 0.0
    for kind, operand_bytes, s in records:
        if kind not in KINDS:
            raise ValueError(f"unknown collective {kind!r}")
        if s <= 1:
            continue  # degenerate group: no traffic
        out_bytes = _out_bytes(kind, operand_bytes, s)
        ops[kind] += 1
        frac = (s - 1) / s
        if kind == "all-reduce":
            operand, w = out_bytes, 2.0 * frac * out_bytes
        elif kind == "all-gather":
            operand, w = out_bytes / s, frac * out_bytes
        elif kind == "reduce-scatter":
            operand, w = out_bytes * s, frac * out_bytes * s
        elif kind == "all-to-all":
            operand, w = out_bytes, frac * out_bytes
        else:  # collective-permute
            operand, w = out_bytes, float(out_bytes)
        by_kind[kind] += operand
        wire += w
    raw = int(sum(by_kind.values()))
    return CollectiveStats(dict(ops), dict(by_kind), raw, wire)
