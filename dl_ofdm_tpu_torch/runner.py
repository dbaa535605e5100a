"""Experiment sweep orchestrator (`dev/py/run_local_ofdm.py` + `locals.py`).

Port of `dl_ofdm_tpu/runner.py`, with its grid (`run_local_ofdm.py:30-119`):

  phase A (awgn): for longcp in {False, True}: nbits in 4..1, cp in {F, T},
    SNR = 5*nbits dB, 1200*nbits epochs -> basic DCCN training + sweep CSV;
  phase B: nbits=1, channel=mixRayleigh, opt=0, cp in {T, F}, 4000 epochs ->
    equalizer transfer learning + cross-channel sweep CSVs.

A configuration is skipped when its result CSV exists
(`run_local_ofdm.py:82-90,110-118`), so a killed grid resumes where it
stopped; configurations run in one process, one after another, on
`device` (`cuda` unless asked otherwise).  The short-CP arm's tokens end
in `_shortcp` so that both arms share one directory.
"""
from __future__ import annotations

import os
import time


def run_sweep(awgn: bool = True, save_dir: str = "./ofdm_lte_ext_64",
              quick: bool = False, log_fn=print, device=None):
    """Run the full experiment grid.  `quick` shrinks epochs and frames."""
    import torch

    from dl_ofdm_tpu_torch import resolve_device
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep, cross_channel_sweep
    from dl_ofdm_tpu_torch.train import checkpoint as ckpt
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    from dl_ofdm_tpu_torch.train.loop import Trainer

    dev = resolve_device(device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    token = "OFDM_Dense3"
    batchsize = 512
    os.makedirs(save_dir, exist_ok=True)
    result_dir = os.path.join(save_dir, "results")
    os.makedirs(result_dir, exist_ok=True)
    ebno = 5.0

    for longcp in (False, True):
        cp_suffix = "" if longcp else "_shortcp"
        if awgn:
            for nbits in (4, 3, 2, 1):
                snr = ebno * nbits
                epochs = 2 if quick else 1200 * nbits
                for cp in (False, True):
                    token1 = (f"{ckpt.token_name(token, nbits, snr, cp)}"
                              f"{cp_suffix}")
                    csv = os.path.join(result_dir,
                                       f"Test_DCCN_{token1}_AWGN.csv")
                    if os.path.isfile(csv):
                        log_fn(f"skip {csv} (exists)")
                        continue
                    cfg = OFDMConfig(nbits=nbits, cp=cp, longcp=longcp)
                    tc = TrainConfig(snr=snr, batch_size=batchsize,
                                     max_epoch_num=epochs, early_stop=200,
                                     token=token1, save_dir=save_dir)
                    t0 = time.time()
                    tr = Trainer(cfg, tc, channel="AWGN", device=dev)
                    state, info = tr.fit(log_fn=log_fn)
                    ckpt.save(os.path.join(save_dir, token1), state)
                    tr.model.load_state_dict(state.params)
                    frames = 200 if quick else 20000
                    res = ber_sweep(tr, gen(99), frames_per_point=frames,
                                    batch_frames=min(2000, frames),
                                    log_fn=log_fn)
                    res.to_csv(csv)
                    log_fn(f"{token1}: {time.time()-t0:.1f}s -> {csv}")

        # phase B: equalizer stage on mixRayleigh
        nbits, opt = 1, 0
        snr = ebno * nbits
        epochs = 2 if quick else 4000
        for cp in (True, False):
            chan = "mixRayleigh"
            token1 = f"{ckpt.token_name(token, nbits, snr, cp)}{cp_suffix}"
            done_csv = os.path.join(
                result_dir,
                f"Test_DCCN_{token1}_Equalizer{opt}_{chan}_test_chan_Custom.csv")
            if os.path.isfile(done_csv):
                log_fn(f"skip {done_csv} (exists)")
                continue
            cfg = OFDMConfig(nbits=nbits, cp=cp, longcp=longcp)
            tc = TrainConfig(snr=snr, batch_size=batchsize,
                             max_epoch_num=epochs, early_stop=200,
                             token=token1, save_dir=save_dir, opt=opt)
            base_path = os.path.join(save_dir, token1)
            base = Trainer(cfg, tc, channel="AWGN", device=dev)
            if ckpt.has_checkpoint(base_path):
                base_state = ckpt.restore(base_path, base.init_state(gen(0)))
            else:
                log_fn(f"no pretrained {base_path}; training AWGN stage first")
                base_state, _ = base.fit(log_fn=log_fn)
                ckpt.save(base_path, base_state)
            eq = EqualizerTrainer(cfg, tc, channel=chan,
                                  pretrained_rx=base_state.params,
                                  device=dev)
            state, info = eq.fit(log_fn=log_fn)
            ckpt.save(os.path.join(save_dir,
                                   f"{token1}_Equalizer{opt}_{chan}"), state)

            def make_trainer(test_chan, mobile, _cfg=cfg, _tc=tc,
                             _rx=base_state.params):
                return EqualizerTrainer(_cfg, _tc, channel=test_chan,
                                        mobile=mobile, pretrained_rx=_rx,
                                        device=dev)

            frames = 200 if quick else 30000
            cross_channel_sweep(
                make_trainer, state.params, gen(777), token1, opt, chan,
                mobile=False, save_dir=result_dir, frames_per_point=frames,
                batch_frames=min(3000, frames), log_fn=log_fn)
