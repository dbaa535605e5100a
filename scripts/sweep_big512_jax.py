"""BER curve of the committed nfft-512 arm from the JAX package, on CPU.

Runs `dl_ofdm_tpu.eval.sweep.ber_sweep` for `runs/arms/OFDM_Big512_1mod.npz`
(`OFDMConfig(nbits=1, nfft=512, nfilter=512, compute_dtype="bfloat16")`,
AWGN) with the committed CSV's protocol (`scripts/biggrid_e2e.py:137-140`:
interleaved, SNR -10..20 dB, 1,000-frame batches, key 999) and prints one
JSON object: per-point BER and CE, the key, the frames a point and the
wall time.  The CSV `runs/Test_DCCN_OFDM_Big512_1mod_snr5_cpTrue_AWGN.csv`
was made on a TPU with 20,000 frames a point; this is the same sweep with
the JAX package's CPU numerics, against which the PyTorch port's sweep of
the arm (`chip_smoke.py` phase 21) can be told apart from the TPU's.

    python scripts/sweep_big512_jax.py                 # 20,000 frames a point
    python scripts/sweep_big512_jax.py --frames_per_point 640

CPU only: 625 batches of 992 frames at the default, about 3 minutes on 8
cores.  `chip_smoke.py` embeds the default run's curve as
`JAX_BIG512_BER`.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dl_ofdm_tpu.config import OFDMConfig, TrainConfig  # noqa: E402
from dl_ofdm_tpu.eval.sweep import ber_sweep  # noqa: E402
from dl_ofdm_tpu.train.checkpoint import load_params_npz  # noqa: E402
from dl_ofdm_tpu.train.loop import Trainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM = os.path.join(ROOT, "runs", "arms", "OFDM_Big512_1mod.npz")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--frames_per_point", type=int, default=20000)
    ap.add_argument("--batch_frames", type=int, default=1000)
    ap.add_argument("--snr_min", type=int, default=-10)
    ap.add_argument("--snr_max", type=int, default=20)
    args = ap.parse_args()

    cfg = OFDMConfig(nbits=1, nfft=512, nfilter=512,
                     compute_dtype="bfloat16")
    trainer = Trainer(cfg, TrainConfig(snr=5.0), channel="AWGN")
    params = jax.tree.map(jnp.asarray, load_params_npz(ARM))
    snrs = range(args.snr_min, args.snr_max + 1)
    t0 = time.time()
    res = ber_sweep(trainer, params, jax.random.PRNGKey(args.seed),
                    snrs=snrs, frames_per_point=args.frames_per_point,
                    batch_frames=args.batch_frames, log_fn=lambda *a: None)
    print(json.dumps({
        "arm": os.path.relpath(ARM, ROOT), "protocol": "interleaved",
        "seed": args.seed, "frames_per_point": args.frames_per_point,
        "batch_frames": args.batch_frames,
        "seconds": round(time.time() - t0, 1),
        "snr": [float(s) for s in res.snr],
        "ber": [float(b) for b in res.ber],
        "loss": [float(v) for v in np.asarray(res.loss)]}))


if __name__ == "__main__":
    main()
