"""The DCCN receiver (Zhao et al., arXiv:1810.07181, the reference's
`ofdm_dense_rx`), its training loss and Adam, in plain float32 PyTorch.

  x [B, S, P, 2] -> fft_like: complex dense P -> F on each symbol,
    (xr + i xi)(wr + i wi) + (br + i bi)
  -> flatten (s, f, iq) -> Dense_extract (S 2F -> 2D)
  -> each of the D (re, im) pairs: Dense_conv1x1 (2 -> 2^n), leaky 0.2,
     concat with the pair, Dense_llr (2^n + 2 -> 2n), leaky 0.2
  -> logits [B, D, n, 2].

Loss: the mean 2-class cross entropy over every bit, plus BER (held
constant) x reg_coeff x 0.01 x the squared norm of every Dense layer's
weight and bias (the reference's `l2(0.01)` regularizers scaled by its
BER-weighted cost).  Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root)
at the learning rate init * rate ** (count // steps).

Parameters are keyed as `torch.nn.Linear` keys them (`weight` [out, in]);
`fft_like.wr` and `.wi` are [P, F].  `precision` is 'float32' (every
product in float32; TF32 is switched off around the call) or 'fp8' (every
GEMM's two operands, forward and backward, scaled per tensor to the e4m3
range and rounded to float8_e4m3fn: the control).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """fp8 operand in the forward GEMM, fp8 gradient into the backward
    GEMMs."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def _operand(precision: str):
    if precision == "float32":
        return lambda t: t
    if precision == "fp8":
        return _RoundFp8.apply
    raise ValueError(f"precision {precision!r}")


def forward(params: dict, x: torch.Tensor, nbits: int,
            precision: str = "float32") -> torch.Tensor:
    """x [B, S, P, 2] float32 -> logits [B, D, nbits, 2]."""
    q = _operand(precision)
    b, s = x.shape[:2]
    xr, xi = q(x[..., 0]), q(x[..., 1])
    wr, wi = q(params["fft_like.wr"]), q(params["fft_like.wi"])
    fr = xr @ wr - xi @ wi + params["fft_like.br"]
    fi = xr @ wi + xi @ wr + params["fft_like.bi"]
    flat = torch.stack([fr, fi], -1).reshape(b, -1)

    def dense(name, v):
        return q(v) @ q(params[f"{name}.weight"]).T + params[f"{name}.bias"]

    e = dense("Dense_extract", flat).reshape(b, -1, 2)
    h = F.leaky_relu(dense("Dense_conv1x1", e), 0.2)
    h = F.leaky_relu(dense("Dense_llr", torch.cat([h, e], -1)), 0.2)
    return h.reshape(b, -1, nbits, 2)


def l2(params: dict) -> torch.Tensor:
    return 0.01 * sum(torch.sum(v * v) for k, v in params.items()
                      if k.startswith("Dense"))


def loss_terms(params: dict, x: torch.Tensor, bits: torch.Tensor, nbits: int,
               reg_coeff: float, precision: str = "float32"):
    """(loss, ce, ber) of one batch; bits [B, D * nbits] (0/1)."""
    logits = forward(params, x, nbits, precision).reshape(-1, 2)
    y = bits.reshape(-1).to(torch.int64)
    ce = F.cross_entropy(logits, y)
    ber = ((logits[:, 1] > logits[:, 0]).to(torch.int64) != y).to(
        torch.float64).mean().to(torch.float32)
    return ce + ber * reg_coeff * l2(params), ce, ber


def adam_step(params: dict, grads: dict, state: dict, train: dict) -> dict:
    """One Adam update of `params` in place of a new dict; `state` holds
    'count', 'mu', 'nu' and is updated in place."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr = train["init_learning"] * train["lr_decay_rate"] ** (
        state["count"] // train["lr_decay_steps"])
    state["count"] += 1
    t = state["count"]
    out = {}
    for k, p in params.items():
        g = grads[k]
        mu = state["mu"][k] = (1 - b1) * g + b1 * state["mu"][k]
        nu = state["nu"][k] = (1 - b2) * g * g + b2 * state["nu"][k]
        out[k] = p - lr * (mu / (1 - b1 ** t)) / (
            torch.sqrt(nu / (1 - b2 ** t)) + eps)
    return out


def train_steps(params: dict, batches, nbits: int, train: dict,
                precision: str = "float32") -> dict:
    """Adam steps from `params` over `batches` (an iterable of (x, bits)
    made lazily, so that only one batch is held at a time).  Returns
    {'loss': [per step], 'grad1': the first step's gradients,
    'params': the parameters after the last step}."""
    params = {k: v.detach().float().clone() for k, v in params.items()}
    state = {"count": 0, "mu": {k: torch.zeros_like(v)
                                for k, v in params.items()},
             "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    losses, grad1 = [], None
    with full_float32():
        for x, bits in batches:
            leaves = {k: v.requires_grad_() for k, v in params.items()}
            loss, _, _ = loss_terms(leaves, x.float(), bits, nbits,
                                    train["reg_coeff"], precision)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: g.detach() for k, g in grads.items()}
            params = adam_step({k: v.detach() for k, v in params.items()},
                               grads, state, train)
    return {"loss": losses, "grad1": grad1, "params": params}


@torch.no_grad()
def eval_counts(params: dict, x: torch.Tensor, bits: torch.Tensor,
                groups: torch.Tensor, n_groups: int, nbits: int,
                precision: str = "float32", block: int = 256):
    """Per-group bit errors (int64) and summed per-frame CE (float64) of a
    batch, in blocks of frames."""
    errors = torch.zeros(n_groups, dtype=torch.int64, device=x.device)
    ce = torch.zeros(n_groups, dtype=torch.float64, device=x.device)
    with full_float32():
        for i in range(0, x.shape[0], block):
            xb, bb = x[i:i + block].float(), bits[i:i + block]
            gb = groups[i:i + block]
            z = forward(params, xb, nbits, precision)
            z = z.reshape(z.shape[0], -1, 2)
            y = bb.reshape(bb.shape[0], -1).to(torch.int64)
            wrong = ((z[..., 1] > z[..., 0]).to(torch.int64) != y).sum(1)
            frame_ce = -torch.gather(F.log_softmax(z, -1), -1,
                                     y[..., None])[..., 0].mean(1)
            errors.index_add_(0, gb, wrong)
            ce.index_add_(0, gb, frame_ce.to(torch.float64))
    return errors, ce


def lecun_scale(key: str, shape) -> float:
    """flax's lecun_normal std (fan-in variance, truncated at 2 std) of a
    kernel leaf; 0 for a bias."""
    if key.endswith(("bias", "br", "bi")):
        return 0.0
    fan_in = shape[0] if key.startswith("fft_like") else shape[1]
    return math.sqrt(1.0 / fan_in) / 0.87962566
