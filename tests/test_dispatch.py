"""The one dispatch rule (ops/dispatch.py), the compile-cache placement
(utils/compile_cache.py) and the PyYAML-free import of the config."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mmrs_tpu.ops import dispatch
from mmrs_tpu.ops.allpairs import first_match
from mmrs_tpu.ops.quant import cosine_topk_quantized, quantize_rows
from mmrs_tpu.ops.topk import cosine_topk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kernel", sorted(dispatch.GPU_CHOICE))
def test_auto_is_xla_on_cpu_and_the_measured_choice_on_gpu(kernel,
                                                          monkeypatch):
    assert dispatch.resolve_impl(kernel, "auto") == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert (dispatch.resolve_impl(kernel, "auto")
            == dispatch.GPU_CHOICE[kernel])
    assert dispatch.resolve_impl(kernel, "pallas") == "pallas"


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_named_forms_pass_through(impl):
    assert dispatch.resolve_impl("topk", impl) == impl


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        dispatch.resolve_impl("topk", "mosaic")


@pytest.mark.parametrize("call", [
    lambda g: cosine_topk(g[:2], g, 3, impl="pallas"),
    lambda g: cosine_topk_quantized(g[:2], *quantize_rows(g), 3,
                                    impl="pallas"),
    lambda g: first_match(g, g, 0.9, intra=True, impl="pallas"),
])
def test_explicit_kernel_raises_on_cpu(call):
    g = jnp.eye(8, 16, dtype=jnp.float32)
    with pytest.raises(ValueError, match="needs a GPU"):
        call(g)


def test_ivf_explicit_kernel_raises_on_cpu():
    from mmrs_tpu.index.ivf import build_ivf, ivf_topk

    rng = np.random.default_rng(0)
    g = rng.standard_normal((200, 32)).astype(np.float32)
    ivf = build_ivf(g, n_clusters=4, iters=2, dtype=jnp.float32)
    with pytest.raises(ValueError, match="needs a GPU"):
        ivf_topk(jnp.asarray(g[:2]), ivf, k=3, impl="pallas")


def _cache_dir_after(env_value):
    """jax_compilation_cache_dir as a fresh process leaves it after
    enable_compile_cache(), with or without the environment variable."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax\n"
            "from mmrs_tpu.utils.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split("\n")[:2]


def test_compile_cache_defaults_to_checkout_root():
    returned, configured = _cache_dir_after(None)
    assert returned == configured == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_env_var_wins(tmp_path):
    returned, configured = _cache_dir_after(str(tmp_path))
    assert returned == configured == str(tmp_path)


def test_config_imports_without_pyyaml():
    """The device path (config, towers, CLI module) needs no PyYAML; only
    loading or saving a config file does."""
    code = ("import sys\n"
            "sys.modules['yaml'] = None  # import yaml -> ImportError\n"
            "import mmrs_tpu.config as c, mmrs_tpu.pipeline, "
            "mmrs_tpu.cli.main\n"
            "cfg = c.Config()\n"
            "try:\n"
            "    c.loads('seed: 1')\n"
            "except ImportError:\n"
            "    print('load-needs-yaml')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "load-needs-yaml"
