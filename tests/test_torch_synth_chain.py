"""The plain data plane's chain (`ops/synth_chain.py`, `csrc/synth_chain.cu`):
its routing, constants and plan, and its plain version against
`Trainer.synthesize`'s modules on the CPU; on a card (marker `cuda`) the
kernels against today's path on the same draws.  This file imports no JAX,
so the card's tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_synth_chain.py
"""
import contextlib

import numpy as np
import pytest
import torch

from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel
from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
from dl_ofdm_tpu_torch.eval.sweep import interleaved_groups
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
from dl_ofdm_tpu_torch.ops import synth_chain as sc
from dl_ofdm_tpu_torch.ops.fused_synth import _sym_table
from dl_ofdm_tpu_torch.train.loop import Trainer

CUDA = torch.device("cuda")


def _trainer(channel, nbits=1, nfft=64, device="cpu", mobile=False):
    return Trainer(OFDMConfig(nbits=nbits, nfft=nfft, nfilter=nfft),
                   TrainConfig(), channel=channel, mobile=mobile,
                   device=device)


def _link(channel, nbits=1, nfft=64, mobile=False):
    """(plan, channel) as a trainer builds them, without its model."""
    plan = build_plan(OFDMConfig(nbits=nbits, nfft=nfft, nfilter=nfft))
    return plan, RayleighChannel(channel, nfft, plan.sample_rate,
                                 mobile=mobile, mix=mobile)


@contextlib.contextmanager
def todays_path():
    """`Trainer.synthesize` through its modules whatever the device."""
    keep = sc.chain_for
    sc.chain_for = lambda *a, **k: None
    try:
        yield
    finally:
        sc.chain_for = keep


def _f64_normalize(v: torch.Tensor, onehot) -> torch.Tensor:
    """`batch_norm_ref` of the noisy waveform v [B, S, sps, 2] in float64,
    two-pass."""
    b = v.shape[0]
    x = v.double().reshape(b, -1)
    g = (torch.zeros(b, dtype=torch.int64, device=v.device)
         if onehot is None else onehot.argmax(1))
    n_g = 1 if onehot is None else onehot.shape[1]
    cnt = torch.zeros(n_g, dtype=torch.float64, device=v.device).index_add_(
        0, g, torch.ones(b, dtype=torch.float64, device=v.device))[:, None]
    mean = torch.zeros(n_g, x.shape[1], dtype=torch.float64,
                       device=v.device).index_add_(0, g, x) / cnt
    d = x - mean[g]
    var = torch.zeros_like(mean).index_add_(0, g, d * d) / cnt
    return (d / torch.sqrt(var[g] + 1e-9) / np.sqrt(2.0)).reshape(v.shape)


def _case(channel, nbits, nfft, frames, groups, device):
    """(trainer, snr [B], onehot [B, G] or None, given bits and float32
    unit noise) of one call."""
    tr = _trainer(channel, nbits, nfft, device)
    if groups:
        snr, onehot = interleaved_groups(list(range(-10, -10 + groups)),
                                         frames, device)
    else:
        snr, onehot = torch.linspace(-10, 30, frames, device=device), None
    b = snr.shape[0]
    g = torch.Generator(device=device).manual_seed(7)
    bits = torch.randint(0, 2, (b, tr.plan.frame_size, nbits), generator=g,
                         device=device, dtype=torch.int32)
    unit = torch.randn(b, tr.plan.nsymbol, tr.plan.samples_per_symbol, 2,
                       generator=g, device=device)
    return tr, snr, onehot, bits, unit


def _compare(got, want, noisy_today, onehot, normalize):
    """Chain against today's path: bits the same tensor values; rx_in
    within 1e-4 of today's beyond today's own float32 error (against a
    float64 normalization of today's noisy waveform, `noisy_today`);
    h_freq, the waveform and the noise power within float32 rounding."""
    assert torch.equal(got[0], want[0])
    err = float((got[1] - want[1]).abs().max())
    own = 0.0
    if normalize:
        own = float((want[1].double() - _f64_normalize(
            noisy_today, onehot)).abs().max())
    assert err <= 1e-4 + own, (err, own)
    for i in (2, 4):
        assert got[i].shape == want[i].shape
        torch.testing.assert_close(got[i], want[i], atol=2e-6, rtol=0)
    torch.testing.assert_close(got[3], want[3], atol=0, rtol=2e-6)
    return err, own


# ---------------------------------------------------------------------------
# the CPU: routing, constants, plan, the plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def card_sms(monkeypatch):
    """`chain_for` on a CUDA device object without a card: the SM count of
    an H100."""
    monkeypatch.setattr(sc, "_sm_count", lambda device: 132)


@pytest.mark.parametrize("channel,mobile,takes", [
    ("ETU", False, True), ("AWGN", False, True), ("mixRayleigh", False, True),
    ("mixAll", False, True), ("ETU", True, False),
    ("mixRayleigh", True, False), ("AWGN", True, True)])
def test_chain_takes_static_cuda_calls_only(card_sms, channel, mobile,
                                            takes):
    """CPU -> today's path, uncounted; a Doppler layout on a card -> today's
    path, counted as a fallback; a static layout on a card -> the chain.
    AWGN with `mobile` has no Doppler frame (fd 0)."""
    args = (*_link(channel, mobile=mobile), 1)
    before = sc.synth_chain_kernel.fallbacks
    assert sc.chain_for(*args, torch.device("cpu"), 40, None, True) is None
    assert sc.synth_chain_kernel.fallbacks == before
    route = sc.chain_for(*args, CUDA, 40, None, True)
    assert (route is not None) == takes
    assert sc.synth_chain_kernel.fallbacks == before + (not takes)
    if takes:
        c, plan = route
        assert c is sc.chain_consts_for(*args)          # built once
        assert plan == sc.chain_plan(c, 40, 0, True, 132)


def test_chain_leaves_what_it_cannot_take(card_sms):
    """Past 16-QAM, groups whose sums exceed a block's shared memory, and
    an empty call go to today's path, counted."""
    plan, ch = _link("ETU")
    assert sc.chain_consts_for(plan, ch, 5) is None
    before = sc.synth_chain_kernel.fallbacks
    many = torch.zeros(40, 20000)
    assert sc.chain_for(plan, ch, 1, CUDA, 40, many, True) is None
    assert sc.chain_for(plan, ch, 1, CUDA, 0, None, True) is None
    assert sc.synth_chain_kernel.fallbacks == before + 2
    # without the normalization the groups need no sums
    assert sc.chain_for(plan, ch, 1, CUDA, 40, many, False) is not None


@pytest.mark.parametrize("channel,nfft,nbits", [
    ("ETU", 64, 1), ("mixRayleigh", 64, 2), ("mixAll", 128, 4),
    ("AWGN", 512, 1)])
def test_chain_constants(channel, nfft, nbits):
    """The grid map places every data symbol once and every pilot; the
    twiddles are e^{+2 pi i k / nfft}; the classes' shifts and lengths put
    each kernel at the unified offset; the table is the fused kernel's."""
    plan, ch = _link(channel, nbits, nfft)
    c = sc.chain_consts_for(plan, ch, nbits)
    assert c.length == plan.nsymbol * plan.samples_per_symbol
    assert 2 ** c.log2n == nfft and c.cp == plan.cp_len
    data = c.gmap[c.gmap >= 0]
    assert sorted(data) == list(range(plan.frame_size))
    assert np.array_equal(np.flatnonzero(c.gmap == -2), plan.pilot_sc)
    assert np.array_equal(c.gmap[plan.data_sc], np.arange(plan.frame_size))
    k = np.arange(nfft // 2)
    np.testing.assert_allclose(c.tw[:, 0] + 1j * c.tw[:, 1],
                               np.exp(2j * np.pi * k / nfft), atol=1e-7)
    assert np.array_equal(c.sym_table, _sym_table(nbits))
    profiles = ch.frame_layout()[0]
    assert list(c.passthrough) == [p is None for p in profiles]
    assert c.fade == any(p is not None for p in profiles)
    for i, p in enumerate(profiles):
        if p is None:
            continue
        s, n = int(c.shift[i]), int(c.nfir[i])
        assert n == p.n_fir and s + p.same_offset == c.off_u
        np.testing.assert_array_equal(c.alpha[i, :p.n_taps, s:s + n],
                                      p.alpha_matrix.astype(np.float32))
        assert not c.alpha[i, :, :s].any() and not c.alpha[i, :, s + n:].any()


@pytest.mark.parametrize("channel,nfft,frames,groups,rows,cols,slices", [
    ("ETU", 64, 1968, 41, 4, 8, 32),      # bpsk64.sweep_etu's call
    ("AWGN", 512, 992, 31, 1, 32, 8),     # big512.sweep_awgn's call
    ("ETU", 64, 1024, 0, 4, 8, 32),       # eval_step of the training cells
    ("AWGN", 512, 256, 0, 1, 32, 8),      # a big512.train_dp4 rank's rows
    ("ETU", 512, 50, 5, 1, 32, 8),
    ("ETU", 2048, 8, 0, None, None, None)])
def test_chain_plan(channel, nfft, frames, groups, rows, cols, slices):
    """Kernel 1: four 64-point rows (2,240 samples) or one 512-point row
    a block, three blocks an SM; a 2,048-point row does not fit a block
    (today's path).  Kernel 2: the widest column tile that gives a block an
    SM, 256 threads; shared bytes as csrc/synth_chain.cu lays them out,
    within a block's."""
    c = sc.chain_consts_for(*_link(channel, 1, nfft), 1)
    if rows is None:
        assert c is None
        return
    p = sc.chain_plan(c, frames, groups, True, 132)
    assert (p.rows, p.cols, p.slices) == (rows, cols, slices)
    assert p.tx_grid == -(-frames // rows)
    assert p.norm_grid == -(-2 * c.length // cols) >= 132
    assert p.tx_smem == sc.tx_smem(c, rows) <= sc.SMEM_THREE
    fp = nfft + nfft // 16
    plane = 16 * ((8 * rows * (c.length + c.fir_u - 1) + 15) // 16)
    assert p.tx_smem == (8 * rows * 7 * fp + plane * c.fade + 16 * (
        (8 * rows * c.fir_u + 15) // 16) + 4 * sc.THREADS + 8 * 16 + 16 * (
        (4 * rows + 15) // 16))
    ge = max(1, groups)
    want = sum(-(-n // 16) * 16 for n in (
        4 * cols * slices, 4 * 128, 8 * slices * ge * cols, 8 * ge * cols,
        4 * ge, 4 * ge))
    assert p.norm_smem == want <= sc.SMEM_MAX - 16
    assert cols * slices == sc.THREADS
    if (nfft, groups) == (512, 31):        # three blocks an SM: one wave
        assert 3 * (p.norm_smem + 1024) <= 233472


def test_chain_plan_halves_slices_for_many_groups():
    c = sc.chain_consts_for(*_link("ETU"), 1)
    p = sc.chain_plan(c, 4000, 200, True, 132)
    assert p.cols * p.slices < sc.THREADS
    assert p.norm_smem <= sc.SMEM_MAX - 16
    assert sc.norm_smem(p.cols, 2 * p.slices, 200, True) > sc.SMEM_MAX - 16


@pytest.mark.parametrize("channel,nbits,nfft,frames,groups,normalize", [
    ("ETU", 1, 64, 41 * 2, 41, True),
    ("ETU", 2, 64, 37, 0, True),
    ("ETU", 4, 64, 30, 0, False),
    ("AWGN", 1, 64, 40, 10, True),
    ("AWGN", 1, 512, 31, 31, True),
    ("AWGN", 4, 512, 9, 0, False),
    ("mixRayleigh", 1, 64, 42, 0, True),
    ("mixRayleigh", 2, 64, 40, 8, True),
    ("mixAll", 4, 128, 21, 0, True),
    ("EVA", 1, 512, 6, 0, True)])
def test_plain_version_matches_synthesize(channel, nbits, nfft, frames,
                                          groups, normalize):
    """`synth_chain.synthesize` (the plain version on the CPU) against
    `Trainer.synthesize`'s modules on the same draws from one seed: the
    generator at the same offset after both; the outputs as `_compare`
    holds them."""
    tr, snr, onehot, _, _ = _case(channel, nbits, nfft, frames, groups,
                                  "cpu")
    b = snr.shape[0]
    c = sc.chain_consts_for(tr.plan, tr.channel, nbits)
    route = (c, sc.chain_plan(c, b, groups, normalize))
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    want = tr.synthesize(b, snr, g1, norm_groups=onehot, normalize=normalize)
    got = sc.synthesize(route, b, snr, g2, onehot, None, None, normalize,
                        torch.device("cpu"), tr.channel.max_taps)
    assert torch.equal(g1.get_state(), g2.get_state())
    noisy = tr.synthesize(b, snr, torch.Generator().manual_seed(11),
                          norm_groups=onehot, normalize=False)[1]
    _compare(got, want, noisy, onehot, normalize)


def test_plain_version_on_given_draws():
    """`bits=` and float32 `unit_noise=` as the benchmark hands them: the
    chain returns the caller's bits tensor, and draws only the tap gains."""
    tr, snr, onehot, bits, unit = _case("ETU", 1, 64, 41, 41, "cpu")
    b = snr.shape[0]
    c = sc.chain_consts_for(tr.plan, tr.channel, 1)
    route = (c, sc.chain_plan(c, b, 41, True))
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    want = tr.synthesize(b, snr, g1, norm_groups=onehot, bits=bits,
                         unit_noise=unit)
    got = sc.synthesize(route, b, snr, g2, onehot, bits, unit, True,
                        torch.device("cpu"), tr.channel.max_taps)
    assert got[0] is bits
    assert torch.equal(g1.get_state(), g2.get_state())
    noisy = tr.synthesize(b, snr, torch.Generator().manual_seed(3),
                          norm_groups=onehot, bits=bits, unit_noise=unit,
                          normalize=False)[1]
    _compare(got, want, noisy, onehot, True)


def test_shifted_group_moments_beat_the_one_pass_float32_sums():
    """At high SNR on AWGN a pilot's mean dwarfs a position's spread: the
    chain's shifted sums stay within 2e-5 of a float64 normalization where
    `batch_norm_ref`'s one-pass float32 sums are ~1e-4 off."""
    g = torch.Generator().manual_seed(0)
    mean = 3.0 * torch.randn(1, 7, 80, 2, generator=g)
    v = mean + 0.05 * torch.randn(64, 7, 80, 2, generator=g)
    onehot = torch.eye(4)[torch.arange(64) % 4]
    ref = _f64_normalize(v, onehot)
    m, var = sc._moments(v.reshape(64, -1), onehot)
    got = ((v.reshape(64, -1) - m) * torch.rsqrt(var + 1e-9)
           * np.sqrt(0.5)).reshape(v.shape)
    from dl_ofdm_tpu_torch.ops.norms import batch_norm_ref
    one_pass = batch_norm_ref(v, group_onehot=onehot)
    assert float((got.double() - ref).abs().max()) < 2e-5
    assert float((one_pass.double() - ref).abs().max()) > 5e-5


def test_cpu_synthesize_keeps_todays_path(monkeypatch):
    """On the CPU `Trainer.synthesize` never enters the chain."""
    def refuse(*a, **k):
        raise AssertionError("the chain ran on the CPU")
    monkeypatch.setattr(sc, "synthesize", refuse)
    tr = _trainer("ETU")
    bits, rx, h, npwr, wf = tr.synthesize(
        8, torch.zeros(8), torch.Generator().manual_seed(0))
    assert rx.shape == wf.shape == (8, 7, 80, 2) and h.shape == (8, 7, 64, 2)


def test_kernel_refuses_cpu_tensors():
    tr, snr, _, bits, unit = _case("ETU", 1, 64, 8, 0, "cpu")
    c = sc.chain_consts_for(tr.plan, tr.channel, 1)
    with pytest.raises(ValueError):
        sc.synth_chain_kernel(c, sc.chain_plan(c, 8, 0, True), bits,
                              torch.zeros(8, 9, 2), snr, None, unit)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return CUDA


def _both_paths(tr, snr, onehot, bits, unit, normalize, seed=11):
    """(the chain's outputs, today's, today's noisy waveform, the
    generators' states after each) on the same draws; the chain's kernel
    launches counted."""
    b = snr.shape[0]
    kw = dict(norm_groups=onehot, bits=bits, unit_noise=unit)
    g1 = torch.Generator(device=snr.device).manual_seed(seed)
    g2 = torch.Generator(device=snr.device).manual_seed(seed)
    k = sc.synth_chain_kernel
    before = (k.launches, k.fallbacks)
    got = tr.synthesize(b, snr, g1, normalize=normalize, **kw)
    torch.cuda.synchronize()
    assert (k.launches, k.fallbacks) == (before[0] + 2, before[1])
    with todays_path():
        want = tr.synthesize(b, snr, g2, normalize=normalize, **kw)
        noisy = tr.synthesize(b, snr, torch.Generator(
            device=snr.device).manual_seed(seed), normalize=False, **kw)[1]
    return got, want, noisy, g1.get_state(), g2.get_state()


@pytest.mark.cuda
@pytest.mark.parametrize("channel,nbits,nfft,frames,groups,normalize,given", [
    ("ETU", 1, 64, 1968, 41, True, True),     # bpsk64.sweep_etu's call
    ("ETU", 1, 64, 1024, 0, True, False),     # the training cells' eval
    ("ETU", 2, 64, 997, 0, False, False),
    ("ETU", 4, 64, 130, 13, True, False),
    ("AWGN", 1, 512, 992, 31, True, True),    # big512.sweep_awgn's call
    ("AWGN", 1, 512, 1024, 0, True, False),   # a big512.train_dp4 rank
    ("AWGN", 4, 512, 100, 0, False, True),
    ("AWGN", 2, 64, 333, 9, True, False),
    ("mixRayleigh", 1, 64, 1001, 0, True, False),
    ("mixRayleigh", 2, 512, 64, 8, True, True),
    ("mixRayleigh", 4, 64, 99, 0, False, False),
    ("ETU", 1, 512, 50, 5, True, False)])
def test_chain_on_card_matches_todays_path(cuda, channel, nbits, nfft,
                                           frames, groups, normalize, given):
    tr, snr, onehot, bits, unit = _case(channel, nbits, nfft, frames,
                                        groups, cuda)
    if not given:
        bits = unit = None
    got, want, noisy, s1, s2 = _both_paths(tr, snr, onehot, bits, unit,
                                           normalize)
    assert torch.equal(s1, s2)
    _compare(got, want, noisy, onehot, normalize)


@pytest.mark.cuda
@pytest.mark.parametrize("channel,nfft,groups", [("ETU", 64, 41),
                                                 ("AWGN", 512, 0)])
def test_chain_on_card_is_bit_identical_twice(cuda, channel, nfft, groups):
    tr, snr, onehot, _, _ = _case(channel, 1, nfft, 41 * 24, groups, cuda)
    runs = [tr.synthesize(snr.shape[0], snr, torch.Generator(
        device=cuda).manual_seed(5), norm_groups=onehot) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_chain_kernel_matches_plain_version_on_card(cuda):
    """The kernels and `synth_chain_ref` on the same tensors on the card,
    with the noise as table indices (the kernel's lookup)."""
    tr, snr, onehot, bits, _ = _case("mixAll", 2, 64, 50, 5, cuda)
    b = snr.shape[0]
    c, plan = sc.chain_for(tr.plan, tr.channel, 2, cuda, b, onehot, True)
    g = torch.Generator(device=cuda).manual_seed(2)
    zck = torch.randn(b, tr.channel.max_taps, 2, generator=g, device=cuda)
    idx = torch.randint(0, 128, (b, 7, 80, 2), generator=g, device=cuda,
                        dtype=torch.int32)
    got = sc.synth_chain_kernel(c, plan, bits, zck, snr, onehot, None, idx)
    from dl_ofdm_tpu_torch.channel.awgn import bf16_normal_table
    unit = bf16_normal_table(cuda)[idx.long()].float()
    want = sc.synth_chain_ref(c, bits, zck, unit, snr, onehot)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
def test_doppler_call_on_card_counts_a_fallback(cuda):
    tr = _trainer("mixRayleigh", device=cuda, mobile=True)
    k = sc.synth_chain_kernel
    before = (k.launches, k.fallbacks)
    tr.synthesize(30, torch.zeros(30, device=cuda),
                  torch.Generator(device=cuda).manual_seed(0))
    assert (k.launches, k.fallbacks) == (before[0], before[1] + 1)
