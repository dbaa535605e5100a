"""The frozen work arithmetic gives the bounds of PERF.md's kernel table
(PR 9-13's `chip_smoke.py` phases) at that table's shapes."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import work  # noqa: E402

ETU64 = work.SynthShape(nsymbol=7, sps=80, nfft=64, frame_size=320, taps=9,
                        fir_u=13)
DCCN64_PARAMS = 584464


def test_synth_bound_static_9362():
    b, f, i, s = work.synth_work(ETU64, 9362)
    ms, by = work.bound_of(b, f, int_ops=i, sfu_ops=s)
    assert round(ms * 1e3, 4) == 0.0432 and by == "operations"


def test_synth_bound_37449():
    b, f, i, s = work.synth_work(ETU64, 37449)
    assert round(work.bound_of(b, f, int_ops=i, sfu_ops=s)[0] * 1e3, 4) \
        == 0.1728


def test_model_bound_9362():
    b, f = work.model_work(7, 80, 64, 320, 1, 9362, DCCN64_PARAMS)
    assert round(work.bound_of(b, f, flop_rate=work.BF16_FLOPS)[0] * 1e3,
                 3) == 0.038


@pytest.mark.parametrize("m, ms", [(6944, 0.0199), (511, 0.0022),
                                   (3584, 0.0106)])
def test_cdense_bf16_bound(m, ms):
    b, f = work.cdense_work(m, 640, 512)
    t, by = work.bound_of(b, f, flop_rate=work.BF16_FLOPS)
    assert round(t * 1e3, 4) == ms and by == "bytes"


@pytest.mark.parametrize("args, flops", [((7, 80, 64, 320, 1), 1441280),
                                         ((7, 640, 512, 2000, 1), 75742080)])
def test_dccn_forward_flops(args, flops):
    assert work.dccn_forward_flops(*args) == flops


def test_peaks_are_the_sxm_data_sheet():
    assert (work.HBM_BPS, work.F32_FLOPS, work.BF16_FLOPS) == (
        3.35e12, 67e12, 989e12)
