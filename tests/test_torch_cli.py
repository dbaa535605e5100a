"""The port's entry points against the JAX package's: the CLI's parser
(`dl_ofdm_tpu/cli.py:23-57`), a tiny train -> `--test` round and the
equalizer command on the CPU (`--device cpu`, the JAX skill's budgets),
`baseline` writing JAX's CSV, `run_sweep`'s skip-if-CSV-exists resume
(`tests/test_orchestration.py:91`), `dump_constellation`'s bytes,
`Throughput` and `bench_steps`.

The commands' final sweeps run the port's `ber_sweep` (directly and
through `cross_channel_sweep`) at 20,000 and 30,000 frames a point; these
tests patch only the frames, so that a CPU run takes seconds."""
import argparse
import glob
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dl_ofdm_tpu import cli as jcli
from dl_ofdm_tpu.utils import observability as jobs
from dl_ofdm_tpu_torch import cli
from dl_ofdm_tpu_torch.eval import sweep as tsweep
from dl_ofdm_tpu_torch.runner import run_sweep
from dl_ofdm_tpu_torch.utils import observability as tobs
from dl_ofdm_tpu_torch.train.loop import TrainState
from dl_ofdm_tpu_torch.utils.timing import bench_steps, fence, first_tensor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--max_epoch_num", "2", "--msg_length", "700", "--batch_size", "14"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: these fits are many small operations,
    which torch's thread pool slows down many times over when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parse(mod, argv):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("train", "equalizer", "baseline", "sweep"):
        mod._add_common(sub.add_parser(name))
    return vars(parser.parse_args(argv))


@pytest.mark.parametrize("argv", [
    ["train"],
    ["train", "--cp=False", "--longcp=false", "--mobile=True"],
    ["equalizer", "--nbits=2", "--nfft=128", "--SNR=7.5",
     "--channel=mixRayleigh", "--opt=3", "--token=tok", "--save_dir=x",
     "--max_epoch_num=17", "--curriculum_tail", "t", "--ckpt_every", "0"],
    ["train", "--nfft", "512", "--nfilter", "512", "--compute_dtype",
     "bfloat16", "--test", "True", "--load_model", "ck"],
    ["sweep", "--compute_dtype", "float32", "--seed", "4"]])
def test_parser_matches_jax(argv):
    got, want = _parse(cli, argv), _parse(jcli, argv)
    assert got.pop("device") == "cuda"
    assert got == want
    cfg, tc = cli._configs(argparse.Namespace(**got))
    jcfg, jtc = jcli._configs(argparse.Namespace(**want))
    assert repr(cfg) == repr(jcfg) and repr(tc) == repr(jtc)


@pytest.fixture
def few_frames(monkeypatch):
    """Every `ber_sweep` (the train command's, and each channel's of
    `cross_channel_sweep`) at 96 frames a point in one batch; every other
    argument as the caller passes it."""
    real = tsweep.ber_sweep
    sig = inspect.signature(real)

    def fewer(*args, **kwargs):
        b = sig.bind(*args, **kwargs)
        b.apply_defaults()
        b.arguments.update(frames_per_point=96,
                           batch_frames=96 * len(list(b.arguments["snrs"])))
        return real(*b.args, **b.kwargs)

    monkeypatch.setattr(tsweep, "ber_sweep", fewer)


def test_train_then_test_round_on_cpu(tmp_path, monkeypatch, few_frames,
                                      capsys):
    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "--save_dir", "out", "--token", "T"] + TINY
    cli.main(["train", "--ckpt_every", "1"] + base)
    out = capsys.readouterr().out
    assert "Training done, best epoch" in out
    csv = tmp_path / "Test_DCCN_T_AWGN.csv"
    first = csv.read_bytes()
    table = np.loadtxt(csv, delimiter=",", skiprows=1)
    assert first.startswith(b"SNR,BER,Loss\n") and table.shape == (41, 3)
    assert np.isfinite(table).all()
    assert os.path.isfile(tmp_path / "out" / "T" / "state.npz")
    assert os.path.isfile(tmp_path / "out" / "T.wip" / "resume" /
                          "state.npz")
    # --test restores the checkpoint and sweeps it again: the same draws
    # and the same params give the same CSV
    csv.unlink()
    cli.main(["train", "--test", "True"] + base)
    assert csv.read_bytes() == first
    # the equalizer stage on the trained receiver, and its --test round
    eq = base + ["--channel", "EPA", "--opt", "2", "--max_epoch_num", "1"]
    cli.main(["equalizer"] + eq)
    names = sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "Test_DCCN_T_Equalizer2_EPA_test_chan_*.csv")))
    assert names == [f"Test_DCCN_T_Equalizer2_EPA_test_chan_{c}.csv" for c in
                     sorted(tsweep.CROSS_TEST_CHANNELS)]
    assert os.path.isfile(tmp_path / "out" / "T_Equalizer2_EPA" /
                          "state.npz")
    cli.main(["equalizer", "--test", "True"] + eq)


def test_baseline_writes_jax_csv_and_cuda_is_the_default(tmp_path, capsys):
    """`baseline` (Queue A item 8) runs JAX's command on `--device`: the
    default channel (AWGN) and estimator (`--opt 0`: Perfect) write the
    committed CSV's name, its SER twin and `.mat`, all four modulations
    swept; without `--device cpu` and with no card it raises."""
    cli.main(["baseline", "--device", "cpu", "--frames", "8", "--save_dir",
              str(tmp_path)])
    name = "BER_OFDM_AWGN_Perfect_lte_64_Gray"
    assert os.path.isfile(os.path.join(ROOT, "runs", name + ".csv"))
    assert sorted(os.listdir(tmp_path)) == sorted(
        [name + ".csv", name + ".mat", "SER" + name[3:] + ".csv"])
    table = np.loadtxt(tmp_path / (name + ".csv"), delimiter=",")
    assert table.shape == (5, 9)
    assert np.array_equal(table[0], np.arange(-10, 31, 5))
    assert np.all((table[1:, 0] > 0.1) & (table[1:, 0] < 0.5))
    assert "AWGN/Perfect M=16 SNR=30" in capsys.readouterr().out
    if not torch.cuda.is_available():
        for cmd in (["baseline", "--save_dir", str(tmp_path)],
                    ["train"] + TINY):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cli.main(cmd)


def test_module_entry_point_runs():
    out = subprocess.run([sys.executable, "-m", "dl_ofdm_tpu_torch.cli",
                          "sweep", "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout


def test_run_sweep_skips_existing_csvs(tmp_path):
    """With every result CSV present the grid is a no-op (resume by
    existence, `run_local_ofdm.py:82-90,110-118`), as JAX's runner."""
    result_dir = tmp_path / "results"
    result_dir.mkdir()
    for cp_suffix in ("", "_shortcp"):
        for nbits in (1, 2, 3, 4):
            for cp in (False, True):
                tok = f"OFDM_Dense3_{nbits}mod_snr{5 * nbits}_cp{cp}{cp_suffix}"
                (result_dir / f"Test_DCCN_{tok}_AWGN.csv").write_text("x")
        for cp in (True, False):
            tok = f"OFDM_Dense3_1mod_snr5_cp{cp}{cp_suffix}"
            (result_dir / f"Test_DCCN_{tok}_Equalizer0_mixRayleigh"
                          "_test_chan_Custom.csv").write_text("x")
    logs = []
    run_sweep(awgn=True, save_dir=str(tmp_path), quick=True,
              log_fn=logs.append, device="cpu")
    assert len(logs) == 20 and all("skip" in line for line in logs)
    assert not glob.glob(str(tmp_path / "OFDM_Dense3*"))


def test_dump_constellation_bytes_match_jax(tmp_path, rng):
    tx = rng.normal(size=(3000, 2)).astype(np.float32)
    rx = rng.normal(size=(7, 80, 2)).astype(np.float32) * 3
    a, b = tmp_path / "jax", tmp_path / "torch"
    a.mkdir()
    b.mkdir()
    jp = jobs.dump_constellation("tok", tx, rx, out_dir=str(a), suffix="_mp")
    tp = tobs.dump_constellation("tok", torch.from_numpy(tx),
                                 torch.from_numpy(rx), out_dir=str(b),
                                 suffix="_mp")
    assert [os.path.basename(p) for p in tp] == ["tok_mp_txiq.csv",
                                                 "tok_mp_rxiq.csv"]
    for p, q in zip(jp, tp):
        assert open(p, "rb").read() == open(q, "rb").read()
    assert np.loadtxt(tp[0], delimiter=",").shape == (2048, 2)


def test_throughput_and_bench_steps_on_cpu():
    tp = tobs.Throughput()
    x = torch.ones(64, 64)
    with tp.stage("mm", 64) as s:
        s.fence(x @ x)
    with tp.stage("launch", 64):
        x @ x
    rep = tp.report()
    assert set(rep) == {"mm", "launch(host)"}
    assert all(v > 0 for v in rep.values())
    fence((x, {"y": x}))                     # nothing to wait for on the CPU
    state = TrainState({"w": x}, {"count": 0, "mu": {}, "nu": {}}, 0)
    assert first_tensor(state) is x and first_tensor((None, [state])) is x
    assert first_tensor({"a": 1}) is None
    sec = bench_steps(lambda i: x @ x, iters=3, repeats=2)
    assert 0 < sec < 10
