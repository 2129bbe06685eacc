"""The split plan both attention kernels' rows instances share.

A decode step's grid (one block per (batch, kv head)) holds fewer blocks
than an H100 has SMs, so the rows instance's split path cuts each
block's keys into parts, a block each, and adds the parts after.
`split_plan` picks the number of parts from shapes and host ints alone,
so a decode step never waits on the device; each kernel's wrapper says
which calls its split path takes (`split_takes`).
"""
from __future__ import annotations

# the split path's limits: at most this many query rows per (batch, kv
# head) (8 above head dim 128, its registers' limit), parts of at least
# this many keys, enough of them to give every SM of an H100 a block
SPLIT_MAX_ROWS = 16
SPLIT_MIN_KEYS = 32
CARD_SMS = 132


def split_plan(takes, batch: int, kv_heads: int, rows: int, head_dim: int,
               max_keys: int) -> int:
    """The number of parts the split path cuts the keys into (`max_keys`:
    the keys a block can visit): enough that batch * kv_heads * n blocks
    give every SM a block, each part at least SPLIT_MIN_KEYS keys long;
    1 where the grid already fills the card. 0: `takes(rows, head_dim)`
    is false, the rows instance walks the call as many rows."""
    if not takes(rows, head_dim):
        return 0
    fill = -(-CARD_SMS // (batch * kv_heads))
    return max(1, min(fill, max_keys // SPLIT_MIN_KEYS))
