"""Mamba2 (SSD, state-space duality) layer in PyTorch, chunked-parallel
form (counterpart of `repro.models.mamba2`); the backbone of zamba2.

Per layer:
  in_proj   d -> [z (di), x (di), B (N), C (N), dt (H)]
  conv1d    causal depthwise width-4 over (x | B | C)
  SSD       y_t = C_t . S_t,  S_t = exp(dt_t A) S_{t-1} + B_t (dt_t x_t)^T
  gate      RMSNorm(y * silu(z)) -> out_proj

Only in_proj and out_proj go through the policy (`layers.mm`); the
recurrence, the conv and the gate stay exact, and the SSD and conv
state is f32.

Storage: the projections are stored in the compute dtype (the
reference casts them on use); `conv_w`, `conv_b`, `A_log`, `dt_bias`
and `D` keep the parameter dtype, as the reference reads them: the
conv's products promote the compute-dtype activations to it. A
training model stores the projections in the parameter dtype too
(`zamba2.Zamba2(train=True)`); `mamba2_layer` casts them on use.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.policy import ArithmeticPolicy
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import RMSNorm, torch_dtype

F = torch.nn.functional


class Mamba2Layer(nn.Module):
    """One layer's weights, the reference's leaf names."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_ch = di + 2 * n
        pdt = torch_dtype(cfg.param_dtype)
        self.in_proj = L.param((d, 2 * di + 2 * n + h), dtype, device)
        self.conv_w = L.param((cfg.conv_width, conv_ch), pdt, device)
        self.conv_b = L.param((conv_ch,), pdt, device)
        self.A_log = L.param((h,), pdt, device)
        self.dt_bias = L.param((h,), pdt, device)
        self.D = L.param((h,), pdt, device)
        self.norm = RMSNorm(di, device)
        self.out_proj = L.param((di, d), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        """The reference's `mamba2_init` distributions, rounded to the
        parameter dtype."""
        dev, pdt = self.in_proj.device, torch_dtype(cfg.param_dtype)
        h = cfg.ssm_heads
        for w in (self.in_proj, self.out_proj):
            w.copy_(L.dense_init(generator, *w.shape, dev, pdt))
        self.conv_w.copy_((torch.randn(self.conv_w.shape, generator=generator,
                                       device=dev)
                           * math.sqrt(1.0 / cfg.conv_width)).to(pdt))
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, h, device=dev))
                         .to(pdt))
        self.dt_bias.fill_(-3.0)
        self.D.fill_(1.0)


def init_state(cfg: ModelConfig, batch: int, device,
               dtype=torch.float32) -> dict:
    """Decode carry for ONE layer: SSD state + conv tail."""
    h, n, p = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_ch = cfg.d_inner + 2 * n
    return {"ssd": torch.zeros((batch, h, n, p), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# chunked SSD scan
# ---------------------------------------------------------------------------


def _ssd_chunked(xbar, bmat, cmat, log_a, s0, chunk: int):
    """xbar: (B,S,H,P) = dt*x;  bmat/cmat: (B,S,N);  log_a: (B,S,H) <= 0.

    Returns (y: (B,S,H,P), s_final: (B,H,N,P)). Exact chunked evaluation
    of  S_t = a_t S_{t-1} + B_t xbar_t^T,  y_t = C_t . S_t. The
    reference's three-operand einsums run as two-operand contractions
    after the elementwise factor, with no (B,L,N,H,P) intermediate.
    """
    b, s, h, p = xbar.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    if pad:
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        bmat, cmat = F.pad(bmat, (0, 0, 0, pad)), F.pad(cmat, (0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
    nc = xbar.shape[1] // chunk
    xbar = xbar.reshape(b, nc, chunk, h, p)
    bmat = bmat.reshape(b, nc, chunk, n)
    cmat = cmat.reshape(b, nc, chunk, n)
    cum = torch.cumsum(log_a.reshape(b, nc, chunk, h), dim=2)   # inclusive
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xbar.device))            # s<=t keep
    zero = torch.zeros((), dtype=cum.dtype, device=cum.device)
    state = s0
    ys = []
    for c in range(nc):
        xb, bm, cm, cu = xbar[:, c], bmat[:, c], cmat[:, c], cum[:, c]
        # intra-chunk: W[t,m,h] = (C_t.B_m) exp(cu_t - cu_m), m<=t
        scores = torch.einsum("bln,bmn->blm", cm, bm)
        # the exponent clamped to <= 0: the masked upper triangle would
        # overflow exp
        decay = torch.exp(torch.minimum(
            cu[:, :, None, :] - cu[:, None, :, :], zero))
        w = scores[..., None] * torch.where(tri[None, :, :, None], decay,
                                            zero)
        y = torch.einsum("blmh,bmhp->blhp", w, xb)
        # inter-chunk: y_t += C_t . (exp(cu_t) S0)
        y = y + torch.einsum("bln,bhnp->blhp", cm, state) \
            * torch.exp(cu)[..., None]
        # state update: S' = exp(cu_L) S0 + sum_m exp(cu_L - cu_m) B_m xb_m
        dlast = torch.exp(cu[:, -1, None, :] - cu)           # (B,L,H)
        state = state * torch.exp(cu[:, -1, :])[:, :, None, None] \
            + torch.einsum("bmn,bmhp->bhnp", bm, xb * dlast[..., None])
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, p)
    return y[:, :s], state


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv. x: (B,S,C); w: (W,C); tail: (B,W-1,C).
    The taps are summed in order, from a zero start, as the reference's
    Python `sum`."""
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    new_tail = xp[:, -(width - 1):] if width > 1 else tail
    return F.silu(out + b[None, None, :]), new_tail


# ---------------------------------------------------------------------------
# layer forward
# ---------------------------------------------------------------------------


def mamba2_layer(p: Mamba2Layer, x: torch.Tensor, cfg: ModelConfig,
                 policy: ArithmeticPolicy = ArithmeticPolicy(), state=None,
                 tp=None):
    """x: (B, S, d); state: `init_state` or None. Returns (out (B, S, d),
    new_state or None); the state is not modified. With S == 1 and a
    state this is the O(1) decode step. `tp`: a tensor-parallel rank's
    seams, for a layer holding that rank's SSD heads
    (`parallel.tensor_parallel.placement`): z, x and dt of its heads, B
    and C whole; the gated RMSNorm runs over the whole d_inner, its
    input gathered."""
    b, s, d = x.shape
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    h = p.A_log.shape[0]            # this rank's SSD heads
    di = h * hp
    proj = L.mm(x, p.in_proj, policy) if tp is None else \
        tp.mm(x, p.in_proj, policy)
    z, xi, bm, cm, dt = torch.split(proj, [di, di, n, n, h], dim=-1)

    conv_in = torch.cat([xi, bm, cm], dim=-1)
    tail = state["conv"] if state is not None else None
    conv_out, new_tail = _causal_conv(conv_in, p.conv_w, p.conv_b, tail)
    xi, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)

    # softplus as jax's logaddexp(x, 0)
    dt = dt.float() + p.dt_bias.float()
    dt = torch.logaddexp(dt, torch.zeros_like(dt))              # (B,S,H)
    a = -torch.exp(p.A_log.float())                             # (H,)
    log_decay = dt * a[None, None, :]                           # <= 0
    xh = xi.reshape(b, s, h, hp).float()
    xbar = xh * dt[..., None]

    s0 = (state["ssd"].float() if state is not None
          else torch.zeros((b, h, n, hp), dtype=torch.float32,
                           device=x.device))
    y, s_final = _ssd_chunked(xbar, bm.float(), cm.float(), log_decay, s0,
                              min(cfg.chunk_size, max(s, 1)))
    y = y + xh * p.D.float()[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype) * F.silu(z)

    if tp is None:
        out = L.mm(L.rmsnorm(p.norm.scale, y, cfg.norm_eps), p.out_proj,
                   policy)
    else:
        out = tp.whole_out(L.rmsnorm(p.norm.scale, tp.gather(y),
                                     cfg.norm_eps), p.out_proj, policy)

    new_state = None
    if state is not None:
        new_state = {"ssd": s_final.to(state["ssd"].dtype),
                     "conv": new_tail.to(state["conv"].dtype)}
    return out, new_state
