"""The port's DCCN receiver on the committed trained arms against the JAX
package's, and the weight conversion between them."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_ofdm_tpu.config import OFDMConfig as JCfg
from dl_ofdm_tpu.models.dccn import DCCNReceiver as JRx
from dl_ofdm_tpu.ofdm.plan import build_plan
from dl_ofdm_tpu.train import checkpoint as jckpt
from dl_ofdm_tpu_torch.models.dccn import DCCNReceiver as TRx
from dl_ofdm_tpu_torch.train import checkpoint as tckpt

ARMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "runs", "arms")


def _pair(nbits, keep_cp=True, recombine="true"):
    plan = build_plan(JCfg(nbits=nbits))
    kw = dict(nbits=nbits, nfft=64, cp_len=plan.cp_len, nfilter=64,
              frame_size=plan.frame_size, keep_cp=keep_cp,
              recombine=recombine)
    return JRx(**kw), TRx(nsymbol=7, **kw)


def test_load_params_npz_matches_jax():
    path = os.path.join(ARMS, "OFDM_Dense3_4mod_snr20_cpTrue.npz")
    a, b = jckpt.load_params_npz(path), tckpt.load_params_npz(path)
    assert a.keys() == b.keys()
    for scope in a:
        for name in a[scope]:
            np.testing.assert_array_equal(a[scope][name], b[scope][name])


def test_params_from_flax_layouts():
    tree = {"Dense_x": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                        "bias": np.ones(3, np.float32)},
            "fft_like": {"wr": np.zeros((4, 5), np.float32),
                         "br": np.zeros(5, np.float32)}}
    sd = tckpt.params_from_flax(tree)
    assert set(sd) == {"Dense_x.weight", "Dense_x.bias", "fft_like.wr",
                       "fft_like.br"}
    np.testing.assert_array_equal(sd["Dense_x.weight"].numpy(),
                                  tree["Dense_x"]["kernel"].T)
    assert sd["fft_like.wr"].shape == (4, 5)


@pytest.mark.parametrize("arm,nbits", [
    ("OFDM_Dense3_1mod_snr5_cpTrue.npz", 1),
    ("OFDM_Dense3_4mod_snr20_cpTrue.npz", 4)])
def test_logits_on_trained_arms_match_jax(arm, nbits, rng):
    params = tckpt.load_params_npz(os.path.join(ARMS, arm))
    jrx, trx = _pair(nbits)
    trx.load_state_dict(tckpt.params_from_flax(params), strict=True)
    x = (rng.normal(size=(6, 7, 80, 2)) / np.sqrt(2)).astype(np.float32)
    lj, fj = jrx.apply({"params": jax.tree.map(jnp.asarray, params)},
                       jnp.asarray(x))
    with torch.no_grad():
        lt, ft = trx(torch.from_numpy(x))
    assert lt.shape == (6, 320, nbits, 2)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


@pytest.mark.parametrize("keep_cp,recombine", [(False, "true"),
                                               (True, "reference")])
def test_dccn_variants_match_jax(keep_cp, recombine, rng):
    jrx, trx = _pair(2, keep_cp=keep_cp, recombine=recombine)
    x = rng.normal(size=(3, 7, 80, 2)).astype(np.float32)
    params = jrx.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda v: np.asarray(v) + 0.01 * rng.normal(size=v.shape).astype(
            np.float32), params)
    trx.load_state_dict(tckpt.params_from_flax(params), strict=True)
    lj, _ = jrx.apply({"params": jax.tree.map(jnp.asarray, params)},
                      jnp.asarray(x))
    with torch.no_grad():
        lt, _ = trx(torch.from_numpy(x))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
