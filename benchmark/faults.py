"""Faults planted under the timed path, to show that the comparison which
decides `correct` catches them (`tests/test_bench_control.py` on the CPU,
`calibrate.py --fault` on the chip at a cell's own size):

  * `unchanged`: a training step returns its state unchanged;
  * `half_batch`: half of the batch is left out and the mean taken over
    the rest (the fused gradient kernel, a row's loss terms on the
    autograd route, a sweep call);
  * `no_exchange`: the rows' exchange between processes is left out: each
    process combines its own rows only;
  * `altered`: a sweep call's answers for its first two points swapped.
"""
from __future__ import annotations

import contextlib

NAMES = ("unchanged", "half_batch", "no_exchange", "altered")


@contextlib.contextmanager
def planted(name: str | None):
    if name is None:
        yield
        return
    from dl_ofdm_tpu_torch.eval import sweep
    from dl_ofdm_tpu_torch.train import loop
    patches = []

    def patch(obj, attr, new):
        patches.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if name == "unchanged":
        step = loop.Trainer.train_step

        def unchanged(self, state, *a, **k):
            return state, step(self, state, *a, **k)[1]
        patch(loop.Trainer, "train_step", unchanged)
    elif name == "half_batch":
        grads, terms = loop.dccn_fused_grads, loop.Trainer._rank_terms
        call = sweep.eval_batch

        def fused_half(spec, b, params, yr, yi, nr, ni, c, idx):
            h = b // 2
            return grads(spec, h, params, yr[:h], yi[:h], nr[:h], ni[:h], c,
                         idx[:h])

        def terms_half(self, params, bits, rx_in, *a, **k):
            h = bits.shape[0] // 2
            return terms(self, params, bits[:h], rx_in[:h], *a, **k)

        def sweep_half(trainer, snr_vec, onehot, generator=None, bits=None,
                       unit_noise=None, model=None):
            h = snr_vec.shape[0] // 2
            errors, ce = call(trainer, snr_vec[:h], onehot[:h], generator,
                              bits[:h], unit_noise[:h], model)
            return 2 * errors, 2 * ce
        patch(loop, "dccn_fused_grads", fused_half)
        patch(loop.Trainer, "_rank_terms", terms_half)
        patch(sweep, "eval_batch", sweep_half)
    elif name == "no_exchange":
        gather = loop.gather_rows

        def own_rows(mesh, values, device, like=None):
            import torch
            out = gather(mesh, values, device, like=like)
            keep = torch.zeros(mesh.shape["dp"], dtype=torch.bool)
            keep[list(mesh.owned_rows)] = True
            return [torch.where(keep.to(s.device).reshape(
                -1, *[1] * (s.dim() - 1)), s, torch.zeros_like(s))
                for s in out]
        patch(loop, "gather_rows", own_rows)
    elif name == "altered":
        call = sweep.eval_batch

        def altered(*a, **k):
            errors, ce = call(*a, **k)
            order = [1, 0, *range(2, len(errors))]
            return errors[order], ce[order]
        patch(sweep, "eval_batch", altered)
    else:
        raise ValueError(f"fault {name!r}; one of {NAMES}")
    try:
        yield
    finally:
        for obj, attr, old in reversed(patches):
            setattr(obj, attr, old)
