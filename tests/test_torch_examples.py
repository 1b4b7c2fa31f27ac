"""The port's examples run end to end on the CPU (docs-as-tests): each is
asked for the CPU with ``--device cpu`` (they run on the card by default)
and takes one active step."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env():
    # one thread: the examples' tensors are small, and the suite runs in
    # several worker processes at once
    return {**os.environ, "PYTHONPATH": str(ROOT), "MPLBACKEND": "Agg", "OMP_NUM_THREADS": "1"}


def _run(script, *args):
    env = _env()
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu", *args],
                       capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_torch_active_sampling_example(tmp_path):
    out = _run("torch_active_sampling.py", "--steps", "1", "--n-hyper", "3", "--out", str(tmp_path))
    assert "true Z" in out and "marginalized" in out and "reloaded from" in out
    assert "factor_ok: tl=True l=True" in out
    assert (tmp_path / "bq.npz").exists()


def test_torch_active_sampling_2d_example():
    out = _run("torch_active_sampling_2d.py", "--steps", "1", "--n-hyper", "10")
    assert "rel err" in out


def test_torch_fleet_serving_example(tmp_path):
    out = _run("torch_fleet_serving.py", "--problems", "4", "--steps", "1", "--out", str(tmp_path))
    assert "done:" in out and "moments identical" in out


@pytest.mark.parametrize("script", ("torch_active_sampling.py", "torch_active_sampling_2d.py",
                                    "torch_fleet_serving.py"))
def test_torch_examples_default_to_the_card(script):
    """Without --device they ask for the card, and raise where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--steps", "0"],
                       capture_output=True, text=True, timeout=300, env=_env(), cwd=str(ROOT))
    assert r.returncode != 0 and 'pass device="cpu"' in r.stderr
