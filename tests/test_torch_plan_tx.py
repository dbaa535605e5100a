"""The port's OFDM plan, constellations, DFT helpers and TX against the JAX
package on the same inputs (numpy, from a seed)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu import config as jcfg
from dl_ofdm_tpu.ofdm import constellation as jconst
from dl_ofdm_tpu.ofdm import plan as jplan
from dl_ofdm_tpu.ofdm import tx as jtx
from dl_ofdm_tpu.ops import cfloat as jcf
from dl_ofdm_tpu_torch import config as tcfg
from dl_ofdm_tpu_torch.ofdm import constellation as tconst
from dl_ofdm_tpu_torch.ofdm import plan as tplan
from dl_ofdm_tpu_torch.ofdm import tx as ttx
from dl_ofdm_tpu_torch.ops import cfloat as tcf

PLAN_CASES = [
    dict(),
    dict(nbits=4),
    dict(longcp=False),
    dict(pilot="scattered", npilot=8, nguard=8),
    dict(pilot="block", npilot=8, nguard=8),
    dict(pilot="comb", npilot=8, nguard=8),
    dict(nfft=128),
    dict(nfft=256, nbits=2),
]


def _plans(**kw):
    return (jplan.build_plan(jcfg.OFDMConfig(**kw)),
            tplan.build_plan(tcfg.OFDMConfig(**kw)))


def test_configs_are_copies():
    for name in ("OFDMConfig", "TrainConfig"):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jcfg, name))]
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tcfg, name))]
        assert jf == tf
    assert jplan.lte_dl_cfg(512) == tplan.lte_dl_cfg(512)


@pytest.mark.parametrize("kw", PLAN_CASES)
def test_build_plan_exactly_equal(kw):
    jp, tp = _plans(**kw)
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
def test_constellation_tables_and_bit_maps(nbits, rng):
    np.testing.assert_array_equal(jconst._table_np(nbits),
                                  tconst._table_np(nbits))
    table = np.asarray(jconst.const_table(nbits))
    got = tconst.const_table_iq(nbits).numpy()
    np.testing.assert_array_equal(got[:, 0], table.real)
    np.testing.assert_array_equal(got[:, 1], table.imag)
    bits = rng.integers(0, 2, size=(5, 11, nbits)).astype(np.int32)
    idx_j = np.asarray(jconst.indices_from_bits(jnp.asarray(bits)))
    idx_t = tconst.indices_from_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(idx_j, idx_t)
    np.testing.assert_array_equal(
        np.asarray(jconst.bits_from_indices(jnp.asarray(idx_j), nbits)),
        tconst.bits_from_indices(torch.from_numpy(idx_t), nbits).numpy())
    sym_j = np.asarray(jconst.bits_to_symbols(jnp.asarray(bits)))
    sym_t = tconst.bits_to_symbols(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(sym_t[..., 0], sym_j.real)
    np.testing.assert_array_equal(sym_t[..., 1], sym_j.imag)


@pytest.mark.parametrize("k,n", [(13, 64), (64, 64), (80, 64)])
def test_dft_helpers(k, n, rng):
    for inv in (False, True):
        for a, b in zip(jcf._dft_mats_np(k, n, inv),
                        tcf._dft_mats_np(k, n, inv)):
            np.testing.assert_array_equal(a, b)
    x = rng.normal(size=(3, 4, k, 2)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tcf.dft_iq(xt, n).numpy(),
                               np.asarray(jcf.dft_iq(jnp.asarray(x), n)),
                               atol=1e-4)
    np.testing.assert_allclose(tcf.idft_iq(xt, n).numpy(),
                               np.asarray(jcf.idft_iq(jnp.asarray(x), n)),
                               atol=1e-5)
    y = rng.normal(size=x.shape).astype(np.float32)
    np.testing.assert_allclose(
        tcf.cmul_iq(xt, torch.from_numpy(y)).numpy(),
        np.asarray(jcf.cmul_iq(jnp.asarray(x), jnp.asarray(y))), atol=1e-6)


def test_symbol_tx_operator_equal():
    jp, tp = _plans(nbits=4)
    a, b = jtx._symbol_tx_operator(jp), ttx._symbol_tx_operator(tp)
    assert a[0] == b[0]
    for u, v in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("nbits", [1, 2, 3, 4])
@pytest.mark.parametrize("fused", [None, False])
def test_tx_waveform_matches_jax(nbits, fused, rng):
    jp, tp = _plans(nbits=nbits)
    bits = rng.integers(0, 2, size=(6, jp.frame_size, nbits)).astype(np.int32)
    want = np.asarray(jtx.ofdm_modulate_frames_iq(jnp.asarray(bits), jp,
                                                  fused=fused))
    got = ttx.ofdm_modulate_frames_iq(torch.from_numpy(bits), tp,
                                      fused=fused).numpy()
    assert got.shape == (6, 7, 80, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tx_large_grid_takes_grid_path(rng):
    jp, tp = _plans(nfft=1024, nbits=2)
    assert not ttx._tx_symbol_op_fits(tp)
    assert jtx._fused_tx_profitable(jp) is False
    bits = rng.integers(0, 2, size=(2, jp.frame_size, 2)).astype(np.int32)
    want = np.asarray(jtx.ofdm_modulate_frames_iq(jnp.asarray(bits), jp))
    got = ttx.ofdm_modulate_frames_iq(torch.from_numpy(bits), tp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
