"""chip_smoke.py's phases at tiny sizes on the CPU, through their own
comparison code (the GPU run is `python chip_smoke.py [--chips 4]`), its
platform guard, and the measurement helpers it shares with bench.py."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bench
import chip_smoke


def test_phase_roundtrip_tiny():
    out = chip_smoke.phase_roundtrip("tiny", tol=0.5, iters=2)
    assert out["err"] < 0.5 and len(out["times_s"]) == 2


def test_phase_exact_tiny():
    out = chip_smoke.phase_exact("tiny")
    # the CPU is its own comparison device here: streams agree exactly
    assert out == {"gaussian_n_diff": 0, "gaussian_max_diff": 0}


def test_phase_gl2_tiny():
    out = chip_smoke.phase_gl2("tiny", iters=2)
    assert out["err"] < 2 * out["base_err"] + 0.1
    assert out["streamed"] is False and out["key_bytes"] > 0


def test_phase_ntt_small():
    out = chip_smoke.phase_ntt(log_n=10, limbs=2, batch=4, iters=2)
    assert out["ntt_per_s"] > 0


def test_phase_sharded_roundtrip_four_devices():
    out = chip_smoke.phase_sharded_roundtrip("tiny", n_dev=4, tol=0.5)
    assert len(out["errs"]) == 4


def test_phase_dist_ntt_four_devices():
    chip_smoke.phase_dist_ntt(log_n=12, limbs=2, batch=2, n_dev=4)


def test_phase_sharded_gl2_four_devices():
    chip_smoke.phase_sharded_gl2("tiny", n_dev=4)


@pytest.mark.parametrize("entry", [lambda: chip_smoke.main([]), bench.main],
                         ids=["chip_smoke", "bench"])
def test_entry_points_refuse_cpu(entry, capsys):
    """No GPU: exit non-zero and print no result line."""
    with pytest.raises(SystemExit) as exc:
        entry()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_check_raises():
    chip_smoke.check(True, "fine")
    with pytest.raises(RuntimeError, match="check failed: boom"):
        chip_smoke.check(False, "boom")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env_set):
    import matrix_fhe

    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert matrix_fhe.compile_cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert matrix_fhe.compile_cache_dir() == os.path.join(
            root, ".cache", "xla")


def test_time_calls_fences_every_call():
    from matrix_fhe.utils.timer import benchmark, time_calls

    f = jax.jit(lambda x: x @ x)
    x = jnp.ones((64, 64))
    times = time_calls(f, x, iters=3)
    assert len(times) == 3 and all(t > 0 for t in times)
    assert np.isfinite(benchmark(f, x, iters=2, warmup=1))
