"""Command-line entry points of the port, with the JAX package's flags.

Port of `dl_ofdm_tpu/cli.py` (flag parity with the reference programs,
`dev/py/ofdmreceiver_np.py:30-53`, `dev/py/ofdmreceiver_np_mp.py:32-59`):

  python -m dl_ofdm_tpu_torch.cli train      ... (ofdmreceiver_np.py)
  python -m dl_ofdm_tpu_torch.cli equalizer  ... (ofdmreceiver_np_mp.py)
  python -m dl_ofdm_tpu_torch.cli sweep      ... (run_local_ofdm.py)
  python -m dl_ofdm_tpu_torch.cli baseline   ... (OFDM_Benchmark_dev.m)

The flags and defaults are the JAX CLI's (`cli.py:23-57`); booleans take
True/False strings the same way.  One flag is the port's own: `--device`
(default `cuda`; `--device cpu` runs the plain PyTorch path, as the tests
do).  Checkpoints are the port's (`train/checkpoint.py`), written under
`<save_dir>/<token>`, with the resume payload of an unfinished run in
`<save_dir>/<token>.wip`; the final sweep's CSV goes to the working
directory, as the JAX CLI writes it.
"""
from __future__ import annotations

import argparse
import os


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "t", "yes")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--nbits", type=int, default=1)
    p.add_argument("--nfft", type=int, default=64)
    p.add_argument("--nsymbol", type=int, default=7)
    p.add_argument("--npilot", type=int, default=8)
    p.add_argument("--nguard", type=int, default=8)
    p.add_argument("--nfilter", type=int, default=64)
    p.add_argument("--pilot", default="lte",
                   choices=["lte", "scattered", "block", "comb"])
    p.add_argument("--cp", type=_bool, default=True)
    p.add_argument("--longcp", type=_bool, default=True)
    p.add_argument("--compute_dtype", default=None,
                   choices=[None, "bfloat16", "float32"])
    p.add_argument("--channel", default="AWGN")
    p.add_argument("--mobile", type=_bool, default=False)
    p.add_argument("--SNR", type=float, default=3.0)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--msg_length", type=int, default=100800)
    p.add_argument("--max_epoch_num", type=int, default=1000)
    p.add_argument("--early_stop", type=int, default=100)
    p.add_argument("--init_learning", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--token", default="OFDM")
    p.add_argument("--save_dir", default="./output/")
    p.add_argument("--opt", type=int, default=0)
    p.add_argument("--test", type=_bool, default=False)
    p.add_argument("--load_model", default="",
                   help="checkpoint directory to warm-start params and "
                        "optimizer state from (reference --load_model, "
                        "ofdmreceiver_np.py:197-203)")
    p.add_argument("--ckpt_every", type=int, default=50,
                   help="epochs between mid-run resume payloads (written "
                        "to <save_dir>/<token>.wip/resume; 0 disables)")
    p.add_argument("--curriculum_tail", type=_bool, default=False,
                   help="equalizer stage: extended-tail SNR curriculum "
                        "(0-33 dB, mass shifted to 27-33; see "
                        "train/curriculum.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device the command runs on ('cpu': the "
                        "plain PyTorch path)")


def _configs(args):
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    cfg = OFDMConfig(nbits=args.nbits, nfft=args.nfft, nsymbol=args.nsymbol,
                     npilot=args.npilot, nguard=args.nguard,
                     nfilter=args.nfilter, pilot=args.pilot, cp=args.cp,
                     longcp=args.longcp, compute_dtype=args.compute_dtype)
    tc = TrainConfig(snr=args.SNR, batch_size=args.batch_size,
                     msg_length=args.msg_length,
                     max_epoch_num=args.max_epoch_num,
                     early_stop=args.early_stop,
                     init_learning=args.init_learning, seed=args.seed,
                     token=args.token, save_dir=args.save_dir, opt=args.opt,
                     curriculum_tail=args.curriculum_tail)
    return cfg, tc


def _generator(device, seed: int):
    import torch
    return torch.Generator(device=device).manual_seed(seed)


def _fit_or_restore(trainer, path: str, args):
    """The params to sweep: restored from `path` with `--test`, else those
    of a `fit` (warm-started from `--load_model`, resumable through
    `<path>.wip`), saved to `path`.  Returns (params, fit info or None)."""
    from dl_ofdm_tpu_torch.train import checkpoint as ckpt
    dev = trainer.device
    if args.test:
        return ckpt.restore(path, trainer.init_state(
            _generator(dev, 0))).params, None
    init_state = None
    if args.load_model:
        init_state = ckpt.restore(args.load_model,
                                  trainer.init_state(_generator(dev, 0)))
    state, info = trainer.fit(
        init_state=init_state,
        ckpt_dir=(path + ".wip") if args.ckpt_every > 0 else None,
        ckpt_every=args.ckpt_every or 50)
    ckpt.save(path, state)
    return state.params, info


def cmd_train(args):
    """Basic DCCN training + final BER sweep (ofdmreceiver_np.py parity,
    `dl_ofdm_tpu/cli.py:71-100`)."""
    from dl_ofdm_tpu_torch import resolve_device
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.train.loop import Trainer

    cfg, tc = _configs(args)
    dev = resolve_device(args.device)
    trainer = Trainer(cfg, tc, channel=args.channel, mobile=args.mobile,
                      device=dev)
    path = os.path.join(tc.save_dir, tc.token)
    params, info = _fit_or_restore(trainer, path, args)
    if info is not None:
        print(f"Training done, best epoch {info['best_epoch']}; saved {path}")
    trainer.model.load_state_dict(params)
    res = ber_sweep(trainer, _generator(dev, tc.seed + 999))
    csv = res.to_csv(f"Test_DCCN_{tc.token}_{args.channel}.csv")
    print(f"wrote {csv}")


def cmd_equalizer(args):
    """Equalizer transfer learning + cross-channel sweep
    (ofdmreceiver_np_mp.py parity, `dl_ofdm_tpu/cli.py:103-150`)."""
    from dl_ofdm_tpu_torch import resolve_device
    from dl_ofdm_tpu_torch.eval.sweep import cross_channel_sweep
    from dl_ofdm_tpu_torch.train import checkpoint as ckpt
    from dl_ofdm_tpu_torch.train.equalizer_loop import EqualizerTrainer
    from dl_ofdm_tpu_torch.train.loop import Trainer

    cfg, tc = _configs(args)
    dev = resolve_device(args.device)
    # the pretrained AWGN receiver
    base = Trainer(cfg, tc, channel="AWGN", device=dev)
    base_params = ckpt.restore(os.path.join(tc.save_dir, tc.token),
                               base.init_state(_generator(dev, 0))).params

    def make_trainer(chan, mobile):
        return EqualizerTrainer(cfg, tc, channel=chan, mobile=mobile,
                                pretrained_rx=base_params, device=dev)

    trainer = make_trainer(args.channel, args.mobile)
    eq_path = os.path.join(tc.save_dir,
                           f"{tc.token}_Equalizer{tc.opt}_{args.channel}")
    params, info = _fit_or_restore(trainer, eq_path, args)
    if info is not None:
        print(f"Equalizer training done, best epoch {info['best_epoch']}")
    cross_channel_sweep(make_trainer, params, _generator(dev, tc.seed + 777),
                        tc.token, tc.opt, args.channel, mobile=args.mobile)


def cmd_baseline(args):
    """Classical estimator benchmark (OFDM_Benchmark_dev.m parity,
    `dl_ofdm_tpu/cli.py:154-163`): the MATLAB-schema CSVs of estimator
    `--opt` (1 when 0) in `--save_dir`."""
    from dl_ofdm_tpu_torch.baselines.classical_rx import run_benchmark
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan

    cfg, _ = _configs(args)
    run_benchmark(build_plan(cfg), args.channel, args.opt or 1,
                  longcp=args.longcp, mobile=args.mobile,
                  n_frames=args.frames, save_dir=args.save_dir,
                  per_sample=args.per_sample, device=args.device)


def cmd_sweep(args):
    from dl_ofdm_tpu_torch.runner import run_sweep
    run_sweep(awgn=args.awgn, save_dir=args.save_dir, quick=args.quick,
              device=args.device)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dl_ofdm_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, fn in (("train", cmd_train), ("equalizer", cmd_equalizer),
                     ("baseline", cmd_baseline), ("sweep", cmd_sweep)):
        p = sub.add_parser(name)
        _add_common(p)
        if name == "baseline":
            p.add_argument("--frames", type=int, default=20000)
            p.add_argument("--per_sample", type=_bool, default=False,
                           help="MATLAB-exact per-sample time-varying "
                                "mobile fading (vs symbol-averaged kernel)")
        if name == "sweep":
            p.add_argument("--awgn", type=_bool, default=True)
            p.add_argument("--quick", type=_bool, default=False)
        p.set_defaults(fn=fn)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
