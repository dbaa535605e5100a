"""The port's PRNG quality probe (`ops/prng_probe.py`, the counterpart of
`scripts/prng_quality_check.py`): its plain version's words, its checks on
good words, and that the checks catch correlated, colliding and biased
streams."""
import numpy as np
import pytest
import torch

from dl_ofdm_tpu_torch.ops import fused_synth as tfs
from dl_ofdm_tpu_torch.ops import prng_probe as pp


def test_probe_words_follow_the_synth_layout():
    seeds = torch.tensor(pp.SEEDS, dtype=torch.int64)
    w = pp.probe_words(seeds, n_streams=3, rows=4, n_words=12)
    assert w.shape == (3, 4, 12) and w.dtype == np.uint32
    for st in range(3):
        np.testing.assert_array_equal(
            w[st], tfs.philox_words(seeds, torch.arange(4), st, 12).numpy())


def test_main_on_the_cpu_passes_the_checks():
    q = pp.main("cpu")
    assert q["collision_rate_max"] == 0.0
    assert q["cross_bit_agreement_max_dev"] < q["cross_bound"]


@pytest.mark.parametrize("fault", ["copy", "low_bit", "serial"])
def test_checks_catch_bad_words(fault):
    seeds = torch.tensor([1, 2], dtype=torch.int64)
    w = pp.probe_words(seeds, n_streams=4, rows=8, n_words=4096).copy()
    pp.check(pp.quality(w))
    if fault == "copy":
        w[1] = w[0]
    elif fault == "low_bit":
        w[:, :, ::3] |= 1
    else:
        w[:, :, 1::2] = (w[:, :, 1::2] & ~np.uint32(1)) | (w[:, :, ::2] & 1)
    with pytest.raises(AssertionError):
        pp.check(pp.quality(w))
