"""BER curve of the committed 16QAM AWGN arm from the JAX package, on CPU.

Runs `dl_ofdm_tpu.eval.sweep.ber_sweep` for
`runs/arms/OFDM_Dense3_4mod_snr20_cpTrue.npz` on the AWGN channel over
SNR -10..30 dB and prints one JSON object: per-point BER and CE, the
protocol, the key and the wall time.  It is the JAX reference that the
PyTorch port's sweep (`dl_ofdm_tpu_torch.eval.sweep.ber_sweep`, driven by
`chip_smoke.py`) is held against where the committed CSV
(`runs/Test_DCCN_OFDM_Dense3_4mod_snr20_cpTrue_AWGN.csv`) does not apply.

    python scripts/sweep_reference_jax.py --protocol interleaved --seed 999
    python scripts/sweep_reference_jax.py --protocol point_batch --seed 7

Defaults are the committed CSV's sweep arguments (20,000 frames per point,
2,000-frame batches).  CPU only; about two minutes per protocol.
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
ARM = os.path.join(ROOT, "runs", "arms", "OFDM_Dense3_4mod_snr20_cpTrue.npz")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--protocol", choices=("interleaved", "point_batch"),
                    default="interleaved")
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--frames_per_point", type=int, default=20000)
    ap.add_argument("--batch_frames", type=int, default=2000)
    ap.add_argument("--compute_dtype", default=None,
                    help="'bfloat16': receiver GEMM inputs in bf16, as the "
                         "TPU's single-pass 'f32' matmuls round them")
    args = ap.parse_args()

    trainer = Trainer(OFDMConfig(nbits=4, compute_dtype=args.compute_dtype),
                      TrainConfig(), channel="AWGN")
    params = jax.tree.map(jnp.asarray, load_params_npz(ARM))
    t0 = time.time()
    res = ber_sweep(trainer, params, jax.random.PRNGKey(args.seed),
                    snrs=range(-10, 31),
                    frames_per_point=args.frames_per_point,
                    batch_frames=args.batch_frames, log_fn=lambda *a: None,
                    point_batch=args.protocol == "point_batch")
    print(json.dumps({
        "protocol": args.protocol, "seed": args.seed,
        "compute_dtype": args.compute_dtype,
        "frames_per_point": args.frames_per_point,
        "batch_frames": args.batch_frames,
        "seconds": round(time.time() - t0, 1),
        "snr": [float(s) for s in res.snr],
        "ber": [float(b) for b in res.ber],
        "loss": [float(v) for v in np.asarray(res.loss)]}))


if __name__ == "__main__":
    main()
