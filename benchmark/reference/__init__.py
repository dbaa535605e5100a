"""The benchmark's plain reference: what the port computes, written again in
plain PyTorch (float64 for the data plane, float32 for the receiver), from
the published equations and the configuration files alone.

It imports nothing of `dl_ofdm_tpu_torch` and nothing of the JAX package.
Where the port's results depend on its own random words (the training
step's synthesize kernel draws Philox4x32-10 words from two seed words), a
frozen copy of that word layout lives here (`philox.py`), so that both sides
see the same frames.
"""
