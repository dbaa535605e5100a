"""The port's fused synthesize chain (`dl_ofdm_tpu_torch/ops/fused_synth.py`)
against the JAX package's: the spec, the plain version on the very words
JAX's `emulate_fused_synthesize` draws, `_combine_stats`, and the Philox
generator that the CUDA kernel shares with the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.channel.rayleigh import RayleighChannel as JChannel
from dl_ofdm_tpu.config import OFDMConfig as JCfg
from dl_ofdm_tpu.ofdm.plan import build_plan as jbuild_plan
from dl_ofdm_tpu.ops import fused_synth as jfs
from dl_ofdm_tpu_torch.channel.rayleigh import RayleighChannel
from dl_ofdm_tpu_torch.config import OFDMConfig
from dl_ofdm_tpu_torch.ofdm.plan import build_plan
from dl_ofdm_tpu_torch.ops import fused_synth as tfs


# jitted: one compile of the whole emulator instead of one per eager op
_emulate = jax.jit(jfs.emulate_fused_synthesize, static_argnums=(0, 1, 4))


def _specs(channel, nbits):
    jplan = jbuild_plan(JCfg(nbits=nbits))
    tplan = build_plan(OFDMConfig(nbits=nbits))
    jch = JChannel(channel=channel, nfft=64, sample_rate=jplan.sample_rate)
    tch = RayleighChannel(channel=channel, nfft=64,
                          sample_rate=tplan.sample_rate)
    jprofs = [None if jch._passthrough[i] else p
              for i, p in enumerate(jch.profiles)]
    tprofs = [None if tch._passthrough[i] else p
              for i, p in enumerate(tch.profiles)]
    return (jfs.build_synth_spec(jplan, jprofs, nbits),
            tfs.build_synth_spec(tplan, tprofs, nbits))


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_known_answers(ctr, key, want):
    """Philox4x32-10's known-answer vectors (Random123's kat_vectors)."""
    t = [torch.tensor(v, dtype=torch.int64) for v in ctr + key]
    assert tuple(int(o) for o in tfs.philox4x32(*t)) == want


def test_philox_words_layout():
    """Word j of (row, stream) is lane j % 4 of the counter (j // 4,
    stream, row, 0): the same whatever rows are asked for together."""
    seeds = torch.tensor([12345, 2**32 - 7], dtype=torch.int64)
    rows = torch.arange(9)
    w = tfs.philox_words(seeds, rows, 3, 10)
    assert w.shape == (9, 10) and w.dtype == torch.int64
    assert int(w.min()) >= 0 and int(w.max()) < 2**32
    out = tfs.philox4x32(torch.tensor(2), torch.tensor(3), torch.tensor(5),
                         torch.tensor(0), seeds[0], seeds[1])
    assert int(w[5, 9]) == int(out[1])
    np.testing.assert_array_equal(
        tfs.philox_words(seeds, rows[4:6], 3, 10).numpy(), w[4:6].numpy())
    assert not torch.equal(tfs.philox_words(seeds, rows, 4, 10), w)


@pytest.mark.parametrize("channel,nbits", [("ETU", 1), ("AWGN", 4),
                                           ("mixAll", 2), ("mixRayleigh", 3)])
def test_spec_matches_jax(channel, nbits):
    js, ts = _specs(channel, nbits)
    for name in ("nbits", "nsymbol", "sps", "frame_size", "counts", "do_fir",
                 "n_classes", "taps", "fir_u", "off_u"):
        assert getattr(ts, name) == getattr(js, name), name
    for name in ("w_r", "w_i", "bias_r", "bias_i", "coeff_cls", "alpha_cls",
                 "gbias_cls"):
        np.testing.assert_allclose(getattr(ts, name), getattr(js, name),
                                   atol=1e-6, err_msg=name)
    idx = jnp.arange(2 ** nbits, dtype=jnp.float32)[None]
    sr, si = jfs._symbols_from_idx(idx, js)
    np.testing.assert_array_equal(ts.sym_table[:, 0], np.asarray(sr)[0])
    np.testing.assert_array_equal(ts.sym_table[:, 1], np.asarray(si)[0])


def _jax_words(js, n, key):
    """The words `emulate_fused_synthesize` draws from `key`."""
    kb, kt1, kt2, kn1, kn2, _, _ = jax.random.split(key, 7)

    def bits(k, shape):
        return np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(
            np.int64)

    words = {"idx": bits(kb, (n, js.frame_size)),
             "noise_u1": bits(kn1, (n, js.length)),
             "noise_u2": bits(kn2, (n, js.length))}
    if js.do_fir:
        words["tap_u1"] = bits(kt1, (n, js.taps))
        words["tap_u2"] = bits(kt2, (n, js.taps))
    return words


@pytest.mark.parametrize("channel,nbits,n", [("ETU", 1, 7), ("AWGN", 4, 5),
                                             ("mixAll", 2, 11)])
def test_plain_version_matches_jax_emulator(channel, nbits, n):
    js, ts = _specs(channel, nbits)
    key = jax.random.PRNGKey(nbits)
    snr = np.linspace(0.0, 12.0, n).astype(np.float32)
    jb, jrx, jnp_pwr, planes = _emulate(js, n, key, jnp.asarray(snr), True)
    words = _jax_words(js, n, key)
    std = tfs.noise_std(torch.from_numpy(snr))
    idx, yr, yi, nr, ni, stats = tfs.fused_synthesize_ref(ts, n, std,
                                                          words=words)
    for got, want in zip((yr, yi, nr, ni), planes):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(tfs._bits_from_idx(idx, nbits).numpy(),
                                  np.asarray(jb))
    # the wrapper's epilogue on the same words
    bits, rx, pwr = tfs.fused_synthesize(ts, n, None, torch.from_numpy(snr),
                                         words=words)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
    assert rx.shape == (n, 7, 80, 2)
    np.testing.assert_allclose(rx.numpy(), np.asarray(jrx), atol=1e-5)
    np.testing.assert_allclose(float(pwr), float(jnp_pwr), rtol=1e-5)


def test_combine_stats_matches_jax(rng):
    l, n = 560, 37
    sums = rng.normal(size=(10, l)).astype(np.float32)
    sums[2:4] = np.abs(sums[2:4]) * n + 5.0          # sums of squares
    sums[6:8] = np.abs(sums[6:8]) * n + 5.0
    ja, jc, jpwr, jsig = jfs._combine_stats(jnp.asarray(sums), n)
    ta, tc, tpwr, tsig = tfs._combine_stats(torch.from_numpy(sums), n)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    for a, b in ((ta, ja), (tpwr, jpwr), (tsig, jsig)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_wrapper_draws_from_generator_and_raw_form():
    _, ts = _specs("mixAll", 1)
    snr = torch.full((13,), 5.0)
    outs = [tfs.fused_synthesize(ts, 13, torch.Generator().manual_seed(3),
                                 snr, raw=True) for _ in range(2)]
    idx, yr, yi, nr, ni, stats = outs[0]
    assert idx.shape == (13, 320) and idx.dtype == torch.int32
    assert yr.shape == nr.shape == (13, 560) and stats.shape == (1, 10, 560)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    torch.testing.assert_close(stats[0, 2], (yr * yr).sum(0))
    torch.testing.assert_close(stats[0, 9], (yi * ni).sum(0))


def test_draw_statistics():
    """Unit noise variance and bit balance of the Philox draws."""
    _, ts = _specs("ETU", 2)
    n = 400
    snr = torch.full((n,), 3.0)
    idx, _, _, nr, ni, _ = tfs.fused_synthesize(
        ts, n, torch.Generator().manual_seed(0), snr, raw=True)
    std = float(tfs.noise_std(snr)[0])
    var = float(torch.cat([nr, ni]).var()) / std ** 2
    assert abs(var - 1.0) < 0.01
    bits = tfs._bits_from_idx(idx, 2).to(torch.float32)
    assert abs(float(bits.mean()) - 0.5) < 0.01


def _train_spec(channel, nbits, mobile=False, **cfg):
    """The spec a `Trainer`'s fused gate builds for this configuration."""
    from dl_ofdm_tpu_torch.config import OFDMConfig, TrainConfig
    from dl_ofdm_tpu_torch.train.loop import Trainer
    return Trainer(OFDMConfig(nbits=nbits, **cfg), TrainConfig(),
                   channel=channel, mobile=mobile,
                   device="cpu")._fused_synth_spec


# nfft 64 static, passthrough and mobile (Doppler rows); nfft 128 with the
# long CP (sps 160) and without (137), static and mobile
PLAN_SPECS = [("ETU", 1, False, {}), ("AWGN", 4, False, {}),
              ("mixRayleigh", 1, True, {}), ("mixAll", 2, True, {}),
              ("ETU", 1, False, {"nfft": 128}),
              ("mixRayleigh", 2, True, {"nfft": 128}),
              ("ETU", 3, False, {"nfft": 128, "longcp": False}),
              ("mixRayleigh", 2, True, {"nfft": 128, "longcp": False})]


@pytest.mark.parametrize("channel,nbits,mobile,cfg", PLAN_SPECS)
@pytest.mark.parametrize("n", [1, 37, 2340, 9362, 37449])
def test_synth_plan_fits_a_block_and_fills_the_card(channel, nbits, mobile,
                                                    cfg, n):
    """The synth kernel's launch plan (`want_h` changes no buffer of it):
    its shared memory fits a block (two a SM at nfft 64), its groups hold
    every row once, stage 4's thread halves cover the frame's column quads
    within the block, and the grid is as many blocks as the card holds or
    the groups there are: a full card at bench.py's batch sizes."""
    spec = _train_spec(channel, nbits, mobile, **cfg)
    assert spec.mobile == mobile
    plan = tfs.synth_plan(spec, n)
    assert plan.smem_bytes == tfs.synth_smem(spec, plan.rows) <= 232448
    if spec.nfft == 64:
        assert plan.rows == 8 and 2 * (plan.smem_bytes + 1024) <= 233472
    assert plan.rows in (8, 4, 2, 1)
    assert (plan.groups - 1) * plan.rows < n <= plan.groups * plan.rows
    l4c = -(-spec.length // 4)
    assert plan.threads % 32 == 0 and plan.threads >= 288
    assert 1 <= plan.halves <= plan.rows
    assert plan.halves * l4c <= plan.threads
    assert plan.grid == min(plan.groups, 132 * 2)
    if n >= 2340:
        assert plan.grid == 264

