"""Transfer learning: parameter surgery and the trainable scope.

Port of `dl_ofdm_tpu/train/transfer.py` (reference graph-editor flow,
`dev/py/ofdmreceiver_np_mp.py:264-380`): restore a pretrained AWGN
receiver, splice a fresh equalizer in front of it, and train only the
equalizer's parameters with a fresh Adam state.  Parameters are flat dicts
keyed as a `state_dict()` ('Equalizer.Dense_in.weight', ...), so a scope is
the first component of a key.

  1. `graft_pretrained(params, rx_params)` puts the pretrained receiver's
     parameters under 'receiver';
  2. `scope_mask(params)` marks the 'Equalizer' parameters.

JAX's `masked_optimizer` (`optax.masked` of Adam, the other leaves' zeroed
gradients passed through) has no counterpart: the equalizer trainer takes
gradients of the marked parameters only and runs the plain `Adam` on them,
so the other parameters carry no moments and are never written.
"""
from __future__ import annotations

import torch


def _scope(key: str) -> str:
    return key.split(".", 1)[0]


def graft_pretrained(fresh_params: dict, pretrained_rx_params: dict,
                     rx_scope: str = "receiver") -> dict:
    """Replace the `rx_scope` parameters of `fresh_params` with
    `pretrained_rx_params` (keyed as the receiver's own `state_dict()`),
    each moved to its fresh counterpart's device."""
    if not any(_scope(k) == rx_scope for k in fresh_params):
        raise KeyError(f"{rx_scope!r} not in params: "
                       f"{sorted({_scope(k) for k in fresh_params})}")
    out = {k: v for k, v in fresh_params.items() if _scope(k) != rx_scope}
    dev = next(iter(fresh_params.values())).device
    for k, v in pretrained_rx_params.items():
        out[f"{rx_scope}.{k}"] = torch.as_tensor(v).to(dev)
    return out


def scope_mask(params: dict, scope: str = "Equalizer") -> dict:
    """key -> True for the parameters under the top-level `scope`."""
    return {k: _scope(k) == scope for k in params}
