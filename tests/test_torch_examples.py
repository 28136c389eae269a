"""The port's eight examples on the CPU: each imports, each runs at the argv
of tests/test_examples_smoke.py (with ``--device cpu --no-plots`` and the
port's size arguments), large_n's dense logML and gradient at n = 256
against gpx's on the same numpy data, ``posterior-predictive`` resuming
from a chain gpx wrote, and ``profile_gp_stages`` naming gpx's stages."""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx.io
import gpx_torch as gt
from gpx.models import gp as jgp
from gpx_torch.models import gp as tgp
from gpx_torch.utils import profiling

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ["dlm_gp", "large_n", "mnist_classify", "simulated_gp",
            "temperature", "temperature_dlm", "temperature_icm",
            "temperature_kriging"]
CPU = ["--device", "cpu", "--no-plots"]
# one jitted program for gpx's oracle, compiled for compile time
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


def _example(name, monkeypatch, tmp_path):
    mod = importlib.import_module(f"gpx_torch.examples.{name}")
    if hasattr(mod, "OUT"):
        monkeypatch.setattr(mod, "OUT", tmp_path)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports(name):
    mod = importlib.import_module(f"gpx_torch.examples.{name}")
    assert callable(mod.main)


# tests/test_examples_smoke.py's argv, plus the port's size arguments
# (hmc's --warmup and --k, temperature_dlm's --hours, dlm_gp's --steps,
# temperature_icm's and large_n svgp's --steps); temperature_dlm runs once,
# with --forecast 6 (its default run differs in the horizon only, and the
# held-out sensor's Student-t quantiles, 90 bisections of a 48-step
# continued fraction each, take ~2 s a run on the CPU)
SMOKE = {
    "simulated_gp": [["simulate", "--n", "64"], ["replicate", "--n", "64"],
                     ["fit", "--n", "64"], ["parameters", "40", "--n", "64"],
                     ["posterior-predictive", "40", "--n", "64"]],
    "simulated_gp hmc": [["hmc", "10", "--n", "64", "--warmup", "10",
                          "--k", "5"]],
    "temperature": [["8"]],
    "temperature_kriging": [["8", "--nx", "6", "--ny", "6"]],
    "temperature_dlm": [["8", "--forecast", "6", "--hours", "48"]],
    "dlm_gp": [["8", "--steps", "40"]],
    "temperature_icm": [["8", "--steps", "20"]],
    "mnist_classify": [["--n-train", "30", "--n-test", "10"]],
    "large_n dense": [["dense", "256"]],
    "large_n iterative": [["iterative", "320"]],
    "large_n svgp": [["svgp", "256", "--steps", "30"]],
}


def _finite(out):
    """Every floating tensor among the outputs is finite and on the CPU."""
    stack, seen = [out], 0
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            assert node.device.type == "cpu"
            if node.is_floating_point():
                assert bool(torch.isfinite(node).all())
                seen += 1
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return seen


@pytest.mark.parametrize("case", list(SMOKE))
def test_example_smoke(case, monkeypatch, tmp_path):
    """One workflow each; ``posterior-predictive`` re-reads the chain CSV
    that ``parameters`` wrote (SimulatedGp.scala:209-219), so that
    family's order is part of the test."""
    mod = _example(case.split()[0], monkeypatch, tmp_path)
    for argv in SMOKE[case]:
        out = mod.main([*argv, *CPU])
        assert isinstance(out, dict) and _finite(out) > 0
    if case == "simulated_gp":
        assert sorted(p.name for p in tmp_path.glob("gpmcmc_*.csv")) == [
            f"gpmcmc_{i}.csv" for i in range(4)]
        assert out["curves"].shape == (20, 400)
    assert not list(tmp_path.glob("*.png"))


def test_example_needs_the_card_or_cpu(monkeypatch, tmp_path):
    """Without ``--device`` the examples ask for the card: without one
    they raise rather than carry on on the CPU."""
    mod = _example("simulated_gp", monkeypatch, tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        mod.main(["fit", "--n", "64", "--no-plots"])


def test_large_n_dense_matches_gpx(monkeypatch, tmp_path):
    """The example's own logML value and gradient at n = 256 against
    gpx's ``logml_value_and_grad`` on the same numpy data, float64 against
    float64 at rel 1e-9 (the example's data and parameters cast: its
    float32 gradients and gpx's differ by float32 rounding, 1.2e-4 of
    White's here)."""
    mod = _example("large_n", monkeypatch, tmp_path)
    data, params = mod._data, mod._params
    monkeypatch.setattr(mod, "_data", lambda n, device=None: tuple(
        t.double() for t in data(n, device=device)))
    monkeypatch.setattr(mod, "_params", lambda device: gt.params.unflatten(
        params(device), [t.double() for t in gt.params.leaves(
            params(device))]))
    got = mod.main(["dense", "256", *CPU])
    assert got["value"].dtype == torch.float64
    x, y = (jnp.asarray(t.numpy()) for t in (got["x"], got["y"]))
    val, grads = jax.jit(lambda p: jgp.logml_value_and_grad(p, x, y),
                         compiler_options=_FAST_COMPILE)(gpx.Parameters(
                             mean=gpx.zero(),
                             kernel=gpx.se(2.0, 3.0) + gpx.white(0.5)))
    assert val.dtype == jnp.float64
    want = np.array([float(val)] + [float(t) for t in
                                    jax.tree_util.tree_leaves(grads)])
    have = np.array([float(got["value"])] + [
        float(t) for t in gt.params.leaves(got["grads"])])
    np.testing.assert_allclose(have, want, rtol=1e-9, atol=0)
    assert got["mean"].shape == got["variance"].shape == (1024,)


def test_posterior_predictive_resumes_a_gpx_chain(monkeypatch, tmp_path):
    """``posterior-predictive`` reads a ``gpmcmc_0.csv`` that gpx.io wrote
    from numpy draws: the thinned rows bitwise, and 20 finite curves."""
    rng = np.random.default_rng(7)
    draws = np.exp(rng.normal(size=(60, 3)) * 0.2) * [3.0, 5.5, 0.5]
    names = ["kernel.kernels0.h", "kernel.kernels0.sigma",
             "kernel.kernels1.sigma"]
    gpx.io.write_chain_csv(tmp_path / "gpmcmc_0.csv", draws, names)
    mod = _example("simulated_gp", monkeypatch, tmp_path)
    out = mod.main(["posterior-predictive", "40", "--n", "64", *CPU])
    assert out["names"] == names
    np.testing.assert_array_equal(out["flat"].view(np.int64),
                                  draws[::2].view(np.int64))
    assert out["curves"].shape == (20, 400)
    assert bool(torch.isfinite(out["curves"]).all())


def _gpx_stage_names():
    """The stage names gpx's profile_gp_stages times, from its source."""
    tree = ast.parse((ROOT / "gpx" / "utils" / "profiling.py").read_text())
    calls = [n for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "stage"
             and n.args and isinstance(n.args[0], ast.Constant)]
    return [n.args[0].value for n in sorted(calls, key=lambda n: n.lineno)]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused-gate"])
def test_profile_gp_stages_names(monkeypatch, fused):
    """gpx's stages at n = 64 on the CPU, with ``chol_inv`` in place of
    ``pallas_chol_inv`` only where the port's gate takes the fused route
    (forced here: on CPU tensors the fused kernels run their plain
    versions)."""
    monkeypatch.setattr(tgp, "_fused_gate", lambda kernel, x: fused)
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-10, 10, size=(64, 1)), axis=0)
    y = rng.normal(size=64)
    kw = dict(device="cpu", dtype=torch.float64)
    params = gt.Parameters(mean=gt.zero(), kernel=gt.se(3.0, 5.5, **kw)
                           + gt.white(0.5, **kw))
    timer = profiling.profile_gp_stages(params, x, y, reps=2, device="cpu")
    want = _gpx_stage_names()
    assert "pallas_chol_inv" in want
    want = [("chol_inv" if fused else None) if n == "pallas_chol_inv" else n
            for n in want]
    assert list(timer.times) == [n for n in want if n]
    assert all(len(ts) == 2 and min(ts) > 0 for ts in timer.times.values())
    assert timer.report().splitlines()[1].startswith("gram")
