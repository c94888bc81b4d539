"""chip_smoke.py's phases at tiny sizes on the CPU (kernels in interpret
mode), and its refusal to run without a GPU. The script itself runs on
the card: `python chip_smoke.py` (README, "Tests")."""

import os
import shutil
import subprocess
import sys

import pytest
import jax

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("phases", [
    ["device"], ["kernels"], ["embed"], ["index", "serve"], ["dedup"],
    ["verifier"],
])
def test_phase_passes_at_tiny_size(phases):
    with jax.default_matmul_precision("highest"):
        failed = chip_smoke.run(phases, chip_smoke.TINY, "pallas_interpret")
    assert failed == []


def test_multi_card_phase_on_virtual_devices():
    """The --chips 4 path over the test session's forced CPU devices."""
    assert len(jax.devices()) > 1
    with jax.default_matmul_precision("highest"):
        failed = chip_smoke.run(["multi"], chip_smoke.TINY,
                                "pallas_interpret")
    assert failed == []


def test_check_topk_rule():
    import numpy as np

    ref_v = np.asarray([[0.9, 0.8, 0.79995, 0.1]])
    ref_i = np.asarray([[4, 7, 2, 9]])
    # the k-th and (k+1)-th reference scores tie within 1e-4: ids may swap
    chip_smoke.check_topk(ref_v[:, :2], np.asarray([[4, 2]]), ref_v, ref_i,
                          1e-4)
    with pytest.raises(AssertionError):
        chip_smoke.check_topk(ref_v[:, :1], np.asarray([[7]]), ref_v, ref_i,
                              1e-4)


def _run_script(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_main_fails_without_gpu():
    out = _run_script(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path), {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.gpu
def test_kernels_compiled_for_the_card():
    """The kernel phase with the kernels compiled for the GPU (Triton), in
    a child process: the test session itself is held to the CPU."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", "device,kernels"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1].startswith('{"ok": true')
