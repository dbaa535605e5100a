#!/usr/bin/env python3
"""The DNN ablation receiver trained and swept by the port, on one CUDA
card, against the JAX package's committed curve.

    python scripts/torch_dnn_ablation.py [--epochs 300] [--out DIR]

(`--out` defaults to `output/dnn_ablation/` under the checkout.)

The recipe of `runs/run_experiments15.py:212-231`: `DNNReceiver`
(nbits 1, nfft 64, nfilter 64), AWGN at 5 dB, `batch_size=512`, `fit`
with batch growth for up to `--epochs` epochs (early stop 100, seed 1);
then the 41-point AWGN sweep of its best parameters (SNR -10..30 dB,
20,000 frames a point in 2,000-frame batches, the interleaved protocol,
generator seed 999, `runs/run_experiments15.py:236-239`).  Writes
`<out>/Test_DCCN_OFDM_DNN_1mod_snr5_cpTrue_AWGN.csv` (not under `runs/`)
and `<out>/dnn_ablation.json` (the training history and the curve), and
prints the card's name and power limit, each point's BER beside the
committed `runs/Test_DCCN_OFDM_DNN_1mod_snr5_cpTrue_AWGN.csv` and their
ratio, and one JSON line: the points whose reference BER is at least
1e-3 and their ratios against the band [0.8, 1.25].
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TOKEN = "OFDM_DNN_1mod_snr5_cpTrue"
REF_CSV = os.path.join(ROOT, "runs", f"Test_DCCN_{TOKEN}_AWGN.csv")
BAND = (0.8, 1.25)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "dnn_ablation"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_dnn_ablation.py: no CUDA device")
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.eval.sweep import ber_sweep
    from dl_ofdm_tpu_torch.models.dccn import DNNReceiver
    from dl_ofdm_tpu_torch.ofdm.plan import build_plan
    from dl_ofdm_tpu_torch.train.loop import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = OFDMConfig(nbits=1)
    plan = build_plan(cfg)
    tc = TrainConfig(snr=5.0, batch_size=512, max_epoch_num=args.epochs,
                     early_stop=100, token=TOKEN)
    tr = Trainer(cfg, tc, channel="AWGN", model=DNNReceiver(
        nbits=1, nfft=cfg.nfft, cp_len=plan.cp_len, nfilter=cfg.nfilter,
        frame_size=plan.frame_size))
    t = time.time()
    state, info = tr.fit(log_fn=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    fit_s = time.time() - t
    tr.model.load_state_dict(state.params)
    t = time.time()
    res = ber_sweep(tr, torch.Generator(device=tr.device).manual_seed(999),
                    snrs=range(-10, 31), frames_per_point=20000,
                    batch_frames=2000, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    sweep_s = time.time() - t
    os.makedirs(args.out, exist_ok=True)
    csv = res.to_csv(os.path.join(args.out, f"Test_DCCN_{TOKEN}_AWGN.csv"))
    ref = np.loadtxt(REF_CSV, delimiter=",", skiprows=1)[:, 1]
    held = {}
    for snr, b, r in zip(res.snr, res.ber, ref):
        ratio = b / r if r > 0 else float("nan")
        print(f"SNR {snr:+5.1f} dB: BER {b:.6g}  JAX {r:.6g}  ratio "
              f"{ratio:.4f}", flush=True)
        if r >= 1e-3:
            held[int(snr)] = float(ratio)
    inside = all(BAND[0] <= v <= BAND[1] for v in held.values())
    out = {"epochs_run": len(info["history"]),
           "best_epoch": info["best_epoch"], "best_loss": info["best_loss"],
           "fit_seconds": fit_s, "sweep_seconds": sweep_s, "csv": csv,
           "ratio_where_ref_ber_ge_1e-3": held, "band": BAND,
           "all_in_band": inside, "device": torch.cuda.get_device_name(0)}
    with open(os.path.join(args.out, "dnn_ablation.json"), "w") as fh:
        json.dump({**out, "history": info["history"],
                   "ber": [float(b) for b in res.ber],
                   "loss": [float(v) for v in res.loss]}, fh, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
