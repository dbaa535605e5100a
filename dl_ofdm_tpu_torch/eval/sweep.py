"""BER-vs-SNR sweep protocols and the CSV result schema.

Port of the single-device protocols of `dl_ofdm_tpu/eval/sweep.py:45-164`
(reference `dev/py/ofdmreceiver_np.py:59-91`: SNR -10:1:30, 20,000 frames
per point, CSV columns SNR,BER,Loss):

  * interleaved (default): all SNR points share each batch through a
    per-frame SNR vector; the input normalization takes its moments per
    SNR group (`batch_frames // n_points` frames), and per-point error and
    CE counts come back through the one-hot group mask;
  * `point_batch=True`: one SNR point per batch, normalization over the
    whole batch (the reference's protocol, `ofdmreceiver_np_mp.py:89`).

`cross_channel_sweep` runs `ber_sweep` of one trained model on each test
channel (reference cross-channel protocol, `ofdmreceiver_np_mp.py:62-104`:
SNR -10:5:30, 30,000 frames a point, one CSV per channel).

Counts accumulate on the device and are read once at the end of the sweep.

With `mesh=` (`parallel/mesh.py`; `sweep.py:71-77`, `:85-146`,
`:167-251`) every batch is split over the dp rows: each row draws and
evaluates its shard on its device with its own generator
(`rank_generators`, drawn once a sweep) and its copy of the model, and the
error and CE counts are summed over the rows.  The model's parameters go
in gathered, as JAX passes them (`P()`) into its `shard_map`
(`sweep.py:136-141`): on a mesh with tp > 1 the sweep is the dp protocol
over the dp rows, bit-identical to the dp-only mesh's from the same
generator.

  * interleaved: `rep = max(batch_frames // n_points, 4 dp)`, rounded up
    to a multiple of dp, in the single-device interleaving order, so every
    rank's contiguous shard covers every SNR point and normalizes per
    point over its own frames;
  * point_batch: the normalization moments are taken over the whole batch
    across the ranks.  Two differences from JAX by design
    (`ADVICE.md`): the moments are two-pass (the global mean, then the
    summed centred squares; JAX takes E[x^2] - mean^2 in float32,
    `sweep.py:222`), and the frame count is exact: a `batch_frames` that
    dp does not divide is refused (JAX rounds it up, `sweep.py:209`), and
    where `frames_per_point` is not a whole number of batches the log says
    how many frames a point were evaluated.

On a mesh over a group of processes (`parallel/distributed.py`) each
process sweeps its own dp rows; every row keeps its own error and CE
sums, and the rows are combined once at the end
(`parallel.mesh.gather_rows`) and summed in row order, as the
one-process mesh sums them, so both give the same counts.  The
point_batch moments take their sums over every row (`global_moments`).
Only process 0 logs and writes CSVs.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from dl_ofdm_tpu_torch.ops.norms import normalize
from dl_ofdm_tpu_torch.parallel import distributed as pd
from dl_ofdm_tpu_torch.parallel.mesh import (Mesh, gather_rows,
                                             module_replicas,
                                             rank_generators)
from dl_ofdm_tpu_torch.train import metrics as M
from dl_ofdm_tpu_torch.train.loop import first_output

CROSS_TEST_CHANNELS = ("ETU", "EVA", "EPA", "Flat", "Custom")


@dataclasses.dataclass
class SweepResult:
    snr: np.ndarray
    ber: np.ndarray
    loss: np.ndarray

    def to_csv(self, path: str) -> str:
        """Reference CSV schema: header SNR,BER,Loss; SNR as index column."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("SNR,BER,Loss\n")
            for s, b, l in zip(self.snr, self.ber, self.loss):
                f.write(f"{s},{b},{l}\n")
        return path


def interleaved_groups(snrs, batch_frames: int, device, dp: int = 1):
    """The interleaved batch layout: (snr_vec [B], onehot [B, n_points]),
    frames ordered repeat-major so every SNR point recurs through the batch
    and through each of `dp` contiguous shards (`sweep.py:88-99`): at
    least 4 frames a point and shard, the repeats a multiple of dp."""
    n_pts = len(snrs)
    rep = max(1, batch_frames // n_pts, 4 * dp)
    rep += (-rep) % dp
    snr_np = np.repeat(np.asarray(snrs, np.float32), rep)
    idx_np = np.repeat(np.arange(n_pts), rep)
    order = np.argsort(np.tile(np.arange(rep), n_pts), kind="stable")
    onehot = np.eye(n_pts, dtype=np.float32)[idx_np[order]]
    return (torch.from_numpy(snr_np[order]).to(device),
            torch.from_numpy(onehot).to(device))


@torch.no_grad()
def eval_batch(trainer, snr_vec: torch.Tensor, onehot: torch.Tensor,
               generator: torch.Generator | None = None,
               bits: torch.Tensor | None = None,
               unit_noise: torch.Tensor | None = None,
               model: torch.nn.Module | None = None):
    """One interleaved batch on `snr_vec`'s device -> (errors [n_points]
    int64, summed per-frame CE [n_points]) (`sweep.py:101-121`), through
    `model` (the trainer's by default)."""
    bits, rx_in, _, _, _ = trainer.synthesize(
        snr_vec.shape[0], snr_vec, generator, norm_groups=onehot, bits=bits,
        unit_noise=unit_noise, device=snr_vec.device)
    logits = first_output((model or trainer.model)(rx_in))
    pred = M.bit_predictions(logits)
    err_per_frame = (pred != bits).sum(dim=(1, 2))
    errors = (err_per_frame[:, None] * onehot.to(torch.int64)).sum(dim=0)
    ce = M.frame_cross_entropy(logits, bits) @ onehot
    return errors, ce


@torch.no_grad()
def ber_sweep(trainer, generator: torch.Generator | None = None,
              snrs: Iterable[int] = range(-10, 31),
              frames_per_point: int = 20000,
              batch_frames: int = 2000,
              log_fn=print,
              point_batch: bool = False, mesh=None) -> SweepResult:
    """Run the BER sweep of `trainer.model` with data made on its device,
    or over the dp rows of a `mesh` (see the module note).

    `generator` (on `trainer.device`) drives every draw; the device's
    default generator when None."""
    snrs = list(snrs)
    if mesh is not None:
        return _ber_sweep_mesh(trainer, generator, snrs, frames_per_point,
                               batch_frames, log_fn, point_batch, mesh)
    n_pts = len(snrs)
    dev = trainer.device
    tot_err = torch.zeros(n_pts, dtype=torch.int64, device=dev)
    tot_ce = torch.zeros(n_pts, dtype=torch.float64, device=dev)
    if point_batch:
        batch_frames = min(batch_frames, frames_per_point)
        n_calls = max(1, frames_per_point // batch_frames)
        frames = n_calls * batch_frames
        for i, snr in enumerate(snrs):
            snr_vec = torch.full((batch_frames,), float(snr), device=dev)
            for _ in range(n_calls):
                bits, rx_in, _, _, _ = trainer.synthesize(
                    batch_frames, snr_vec, generator)
                logits = first_output(trainer.model(rx_in))
                tot_err[i] += (M.bit_predictions(logits) != bits).sum()
                tot_ce[i] += M.frame_cross_entropy(logits, bits).sum()
    else:
        snr_vec, onehot = interleaved_groups(snrs, batch_frames, dev)
        frames = snr_vec.shape[0] // n_pts
        n_calls = max(1, frames_per_point // frames)
        frames *= n_calls
        for _ in range(n_calls):
            errors, ce = eval_batch(trainer, snr_vec, onehot, generator)
            tot_err += errors
            tot_ce += ce
    return _sweep_result(trainer, snrs, tot_err, tot_ce, frames, log_fn)


def _sweep_result(trainer, snrs, tot_err, tot_ce, frames: int,
                  log_fn) -> SweepResult:
    """BER and mean CE a point from the summed counts of `frames` frames a
    point, each point logged."""
    bits_per_frame = trainer.plan.frame_size * trainer.cfg.nbits
    bers = tot_err.cpu().numpy() / (frames * bits_per_frame)
    losses = tot_ce.cpu().numpy() / frames
    for snr, ber, loss in zip(snrs, bers, losses):
        log_fn(f"SNR: {snr:.2f}, BER: {ber:.8f}, Loss: {loss:f}")
    return SweepResult(np.asarray(snrs, dtype=float), np.asarray(bers),
                       np.asarray(losses))


def global_moments(ys: list, device: torch.device, mesh=None):
    """Per-position (mean, population variance) over the concatenation of
    the ranks' batches `ys` (every row of `mesh`: the local rows' batches,
    the other processes' through `gather_rows`; equal shards), on
    `device`, in two passes: the mean from the shards' sums, then the
    variance from the shards' summed centred squares (summed in rank
    order)."""
    if mesh is None:
        grid = np.empty((len(ys), 1), dtype=object)
        grid[:, 0] = [y.device for y in ys]
        mesh = Mesh(grid)
    dp = mesh.shape["dp"]
    n = ys[0].shape[0] * dp
    sums = gather_rows(mesh, [[y.sum(dim=0, keepdim=True)] for y in ys],
                       device)[0]
    mean = sum(sums[r] for r in range(dp)) / n
    sq = gather_rows(mesh, [[((y - mean.to(y.device)) ** 2).sum(
        dim=0, keepdim=True)] for y in ys], device)[0]
    var = sum(sq[r] for r in range(dp)) / n
    return mean, var


@torch.no_grad()
def _ber_sweep_mesh(trainer, generator, snrs, frames_per_point: int,
                    batch_frames: int, log_fn, point_batch: bool,
                    mesh) -> SweepResult:
    """`ber_sweep` over the dp rows of a mesh (see the module note)."""
    devs, rows = mesh.local_dp_devices, mesh.local_rows
    dp, dev0 = mesh.shape["dp"], mesh.home
    if mesh.multiprocess and not pd.is_main_process():
        log_fn = lambda *a: None  # noqa: E731
    models = module_replicas(trainer.model, devs)
    gens = rank_generators(generator, devs, rows)
    n_pts = len(snrs)
    # each local row's sums, on its device
    row_err = [torch.zeros(n_pts, dtype=torch.int64, device=d) for d in devs]
    row_ce = [torch.zeros(n_pts, dtype=torch.float64, device=d)
              for d in devs]
    if point_batch:
        batch_frames = min(batch_frames, frames_per_point)
        if batch_frames % dp:
            raise ValueError(
                f"point_batch on a mesh: batch_frames {batch_frames} is not "
                f"a multiple of dp {dp}, so its frames do not split evenly")
        n_calls = max(1, frames_per_point // batch_frames)
        frames = n_calls * batch_frames
        if frames != frames_per_point:
            log_fn(f"point_batch: {frames} frames a point ({n_calls} calls "
                   f"of {batch_frames}), not {frames_per_point}")
        shard = batch_frames // dp
        for i, snr in enumerate(snrs):
            snr_vecs = [torch.full((shard,), float(snr), device=d)
                        for d in devs]
            for _ in range(n_calls):
                out = [trainer.synthesize(shard, s, g, normalize=False,
                                          device=d)
                       for s, g, d in zip(snr_vecs, gens, devs)]
                mean, var = global_moments([y for _, y, *_ in out], dev0,
                                           mesh)
                for (bits, y, *_), d, err, ce in zip(out, devs, row_err,
                                                     row_ce):
                    logits = first_output(models[d](
                        normalize(y, mean.to(d), var.to(d))))
                    err[i] += (M.bit_predictions(logits) != bits).sum()
                    ce[i] += M.frame_cross_entropy(logits, bits).sum()
    else:
        snr_vec, onehot = interleaved_groups(snrs, batch_frames, "cpu", dp)
        snr_c, onehot_c = torch.chunk(snr_vec, dp), torch.chunk(onehot, dp)
        shards = [(snr_c[r].to(d), onehot_c[r].to(d))
                  for r, d in zip(rows, devs)]
        frames = snr_vec.shape[0] // n_pts
        n_calls = max(1, frames_per_point // frames)
        frames *= n_calls
        for _ in range(n_calls):
            for (s, o), g, d, err, ce in zip(shards, gens, devs, row_err,
                                             row_ce):
                errors, ce_ = eval_batch(trainer, s, o, g, model=models[d])
                err += errors
                ce += ce_
    errs, ces = gather_rows(mesh, [[e, c] for e, c in zip(row_err, row_ce)],
                            dev0)
    return _sweep_result(trainer, snrs, sum(errs[r] for r in range(dp)),
                         sum(ces[r] for r in range(dp)), frames, log_fn)


def cross_channel_sweep(make_trainer: Callable, params: dict,
                        generator: torch.Generator | None, token: str,
                        opt: int, train_channel: str, mobile: bool = False,
                        save_dir: str = ".",
                        snrs: Sequence[int] = tuple(range(-10, 31, 5)),
                        frames_per_point: int = 30000,
                        batch_frames: int = 3000,
                        test_channels: Sequence[str] = CROSS_TEST_CHANNELS,
                        log_fn=print, point_batch: bool = False,
                        mesh=None) -> dict[str, SweepResult]:
    """Sweep one trained model on each test channel
    (`dl_ofdm_tpu/eval/sweep.py:255-285`).

    `make_trainer(channel, mobile)` builds each channel's trainer; `params`
    (keyed as its model's `state_dict()`) are loaded into its model.  Each
    result is written to `save_dir` as
    `Test_DCCN_<token>_Equalizer<opt>_<train_channel>_test_chan_<channel>
    [_mobile].csv`.  `mesh` is passed on to `ber_sweep`."""
    results = {}
    for chan in test_channels:
        trainer = make_trainer(chan, mobile)
        trainer.model.load_state_dict(params)
        log_fn(f"Test in {chan}, mobile: {mobile}")
        res = ber_sweep(trainer, generator, snrs, frames_per_point,
                        batch_frames, log_fn, point_batch=point_batch,
                        mesh=mesh)
        suffix = "_mobile" if mobile else ""
        name = (f"Test_DCCN_{token}_Equalizer{opt}_{train_channel}"
                f"_test_chan_{chan}{suffix}.csv")
        if pd.is_main_process():
            res.to_csv(os.path.join(save_dir, name))
        results[chan] = res
    return results
