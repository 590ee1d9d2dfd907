"""Process set-up for accelerator runs: compile cache, device checks, and
the golden gates shared by bench.py and chip_smoke.py."""
import numpy as np
import pytest

import jax

from madarch_tpu.utils import runtime


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env_var(monkeypatch, tmp_path,
                                       restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets nothing in code."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_dir_in_checkout(monkeypatch,
                                                         restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.enable_compile_cache()
    assert got == runtime.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == got
    # inside the checkout, at a fixed name that .gitignore lists
    assert got.startswith(runtime.REPO_ROOT)
    with open(f"{runtime.REPO_ROOT}/.gitignore") as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_require_gpu_refuses_other_backends(backend):
    with pytest.raises(SystemExit, match="GPU"):
        runtime.require_gpu(backend)


def test_require_gpu_accepts_gpu():
    runtime.require_gpu("gpu")


def test_chip_smoke_refuses_cpu_backend(capsys):
    """The smoke test stops before any phase, and prints no result, when
    JAX has no GPU (the suite runs on the CPU backend)."""
    import chip_smoke

    with pytest.raises(SystemExit, match="GPU"):
        chip_smoke.main([])
    assert capsys.readouterr().out == ""


def test_card_info_is_a_string_without_a_card():
    assert isinstance(runtime.card_info(), str)


@pytest.mark.parametrize("case,breached", [
    ("identical", []),
    ("shifted", ["frac_above_0.05", "mean_absdiff"]),
    ("sparse_flips", []),
])
def test_golden_gates(case, breached):
    """Robust gates: a global shift breaches, a few flipped pixels (the
    near-tie selections that differ between backends) do not."""
    from bench import golden_stats

    rng = np.random.RandomState(0)
    ref = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    img = ref.copy()
    if case == "shifted":
        img = img + 0.06
    elif case == "sparse_flips":
        flat = img.reshape(-1)
        idx = rng.choice(flat.size, flat.size // 200, replace=False)
        flat[idx] += 0.5
    stats = golden_stats(img, ref)
    assert stats["breached"] == breached
