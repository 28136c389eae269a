"""The port's chain IO, checkpoints and utilities against gpx's: the chain
CSV byte for byte on both of the port's paths (the native fastcsv library
and the pure-Python writer), gpx-written chains read back with burn-in and
thinning, checkpoints bitwise (an MH chain resumed from one draws what the
unbroken chain draws), ``utils.config`` on gpx's argv, ``highest_matmuls``
and the pytree helpers."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as torch_pytree

import gpx.io
import gpx.utils.config as gcfg
import gpx_torch as gt
from gpx_torch import io
from gpx_torch.infer import base, mh
from gpx_torch.models import gp
from gpx_torch.utils import config as tcfg
from gpx_torch.utils import pytree_dataclass, tree_replace
from gpx_torch.utils.precision import highest_matmuls

torch.set_num_threads(1)
NAMES = ["kernel.kernels0.h", "kernel.kernels0.sigma", "kernel.kernels1.sigma",
         "a", "b"]


def _chain(rng, rows=40):
    """float64 values over 60 decades, both signs, both zeros, both
    infinities and a NaN of each sign (glibc prints the x86 default NaN,
    sign bit set, as ``-nan``)."""
    flat = rng.normal(size=(rows, 5)) * 10.0 ** rng.integers(-30, 30, (rows, 5))
    flat[0, :4] = [np.inf, -np.inf, 0.0, -0.0]
    flat[1, 0] = np.nan
    flat[1, 1] = -np.nan
    return flat


def _bits(a):
    return np.ascontiguousarray(a).view(np.int64)


@pytest.fixture(params=["native", "python"])
def path_kind(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(io, "load_fastcsv", lambda: None)
    else:
        assert io.load_fastcsv() is not None
    return request.param


def test_chain_csv_bytes_match_gpx(tmp_path, path_kind):
    flat = _chain(np.random.default_rng(0))
    gpx.io.write_chain_csv(tmp_path / "gpx.csv", flat, NAMES)
    io.write_chain_csv(tmp_path / "np.csv", flat, NAMES)
    io.write_chain_csv(tmp_path / "t.csv", torch.as_tensor(flat), NAMES)
    want = (tmp_path / "gpx.csv").read_bytes()
    assert (tmp_path / "np.csv").read_bytes() == want
    assert (tmp_path / "t.csv").read_bytes() == want


def test_gpx_chain_reads_back(tmp_path, path_kind):
    """Bitwise what gpx reads, with its burn-in and thinning."""
    flat = _chain(np.random.default_rng(1), rows=57)
    path = gpx.io.write_chain_csv(tmp_path / "c.csv", flat, NAMES)
    for burn_in, thin in ((0, 1), (7, 3)):
        got, names = io.read_chain_csv(path, burn_in=burn_in, thin=thin)
        want, want_names = gpx.io.read_chain_csv(path, burn_in=burn_in,
                                                 thin=thin)
        assert names == want_names == NAMES
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(flat[burn_in::thin]))


def test_chains_csv_layout_matches_gpx(tmp_path):
    flat = np.random.default_rng(2).normal(size=(3, 11, 5))
    want = gpx.io.write_chains_csv(tmp_path / "g" / "chain.csv", flat, NAMES)
    got = io.write_chains_csv(tmp_path / "t" / "chain.csv",
                              torch.as_tensor(flat), NAMES)
    assert [p.name for p in got] == [p.name for p in want] == [
        "chain_0.csv", "chain_1.csv", "chain_2.csv"]
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(got, want))


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    kw = dict(device="cpu", dtype=torch.float64)
    params = gt.Parameters(mean=gt.plane([1.0, -2.0], **kw),
                           kernel=gt.se(1.3, 0.7, **kw) * gt.matern(
                               2.0, 2.5, 1.1, **kw) + gt.white(0.25, **kw))
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    tensor = torch.randn(4, 3, generator=gen).float()
    state = {"params": params, "generator": gen, "tensor": tensor,
             "mh": mh.MHState(torch.arange(3.0), torch.tensor(-1.5),
                              torch.tensor(2, dtype=torch.int32)),
             "step": 17, "eps": 0.125, "tag": "warmup", "none": None}
    io.save_checkpoint(tmp_path / "c.pt", state)
    got = io.load_checkpoint(tmp_path / "c.pt", device="cpu")
    assert type(got["params"].kernel.kernels[0].kernels[1]) is gt.Matern
    assert got["params"].kernel.kernels[0].kernels[1].nu == 2.5
    assert gt.params.names(got["params"]) == gt.params.names(params)
    for a, b in zip(gt.params.leaves(got["params"]), gt.params.leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got["generator"].get_state(), gen.get_state())
    assert torch.equal(torch.rand(5, generator=got["generator"]),
                       torch.rand(5, generator=gen))
    assert got["tensor"].dtype == torch.float32
    assert torch.equal(got["tensor"], tensor)
    assert isinstance(got["mh"], mh.MHState)
    assert all(torch.equal(a, b) for a, b in zip(got["mh"], state["mh"]))
    assert (got["step"], got["eps"], got["tag"], got["none"]) == (
        17, 0.125, "warmup", None)


def test_checkpoint_mh_resume_is_bitwise(tmp_path):
    """2k MH draws equal k draws, a checkpoint of the final state and the
    generator, and k more draws from the restored ones."""
    k = 15
    gen = torch.Generator().manual_seed(0)
    x = gp.sample_points(gen, -10.0, 10.0, 24)
    truth = gt.Parameters(mean=gt.zero(), kernel=gt.se(
        3.0, 5.5, device="cpu") + gt.white(0.5, device="cpu"))
    y = gp.draw(gen, truth, x)
    template = gt.Parameters(mean=gt.zero(), kernel=gt.se(
        1.0, 1.0, device="cpu") + gt.white(1.0, device="cpu"))
    logpost, flat0, _ = mh.make_unconstrained_log_posterior(
        lambda p: gp.log_marginal_likelihood(p, x, y), template)
    step = mh.kernel(logpost, mh.gaussian_random_walk(0.15))
    init = mh.init(flat0, logpost)

    whole = base.sample(step, init, torch.Generator().manual_seed(1), 2 * k)
    gen = torch.Generator().manual_seed(1)
    first = base.sample(step, init, gen, k)
    io.save_checkpoint(tmp_path / "mh.pt", {"state": first.final_state,
                                            "generator": gen})
    saved = io.load_checkpoint(tmp_path / "mh.pt", device="cpu")
    rest = base.sample(step, saved["state"], saved["generator"], k)
    for a, b in zip(whole.samples, (torch.cat([f, r]) for f, r in
                                    zip(first.samples, rest.samples))):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(whole.final_state,
                                                 rest.final_state))
    assert 0 < int(whole.final_state.accepted) < 2 * k


@dataclasses.dataclass
class _Config:
    n_iters: int = 1000
    lr: float = 0.05
    plots: bool = True
    name: str = "run"


@pytest.mark.parametrize("argv", [
    [], ["--n-iters", "40", "--lr", "0.5"], ["--plots", "no", "--name", "b"],
    ["pos", "--plots", "yes"], ["--n_iters", "3"], ["--bogus", "1"],
    ["--lr"]])
def test_config_matches_gpx(tmp_path, argv):
    """from_cli, replace_typed, save and load as gpx's, SystemExit too."""
    def run(mod):
        try:
            cfg = mod.from_cli(_Config(), argv)
        except SystemExit as e:
            return ("exit", str(e))
        cfg = mod.replace_typed(cfg, {"lr": "0.25"})
        path = mod.save(cfg, tmp_path / mod.__name__ / "c.json")
        return cfg, path.read_text(), mod.load(_Config, path)

    assert run(tcfg) == run(gcfg)


def test_highest_matmuls_restores_flags():
    seen = []

    @highest_matmuls
    def probe(fail):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        if fail:
            raise ValueError
        return 3

    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((True, True), (False, True)):
            torch.backends.cuda.matmul.allow_tf32 = flags[0]
            torch.backends.cudnn.allow_tf32 = flags[1]
            assert probe(False) == 3
            with pytest.raises(ValueError):
                probe(True)
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep[0]
        torch.backends.cudnn.allow_tf32 = keep[1]
    assert seen == [(False, False)] * 4


def test_tree_replace_and_pytree_dataclass():
    kern = gt.se(1.0, 2.0, device="cpu") + gt.white(0.5, device="cpu")
    params = gt.Parameters(mean=gt.zero(), kernel=kern)
    swapped = tree_replace(params, kernel=gt.matern(1.0, 1.5, 3.0,
                                                    device="cpu"))
    assert isinstance(swapped.kernel, gt.Matern) and swapped.kernel.nu == 1.5
    assert isinstance(swapped.mean, gt.Zero)
    se = tree_replace(kern.kernels[0], sigma=torch.tensor(4.0))
    assert [float(t) for t in gt.params.leaves(se)] == [1.0, 4.0]
    assert float(kern.kernels[0].sigma) == 2.0
    kept = tree_replace(kern)
    assert gt.params.names(kept) == gt.params.names(kern)
    with pytest.raises(TypeError):
        tree_replace(kern, h=1.0)

    @pytree_dataclass(meta_fields=("label",))
    class State:
        q: torch.Tensor
        p: torch.Tensor
        label: str = "s"

    s = State(torch.ones(2), torch.zeros(3), "a")
    leaves, spec = torch_pytree.tree_flatten(s)
    assert len(leaves) == 2
    doubled = torch_pytree.tree_unflatten([2 * t for t in leaves], spec)
    assert isinstance(doubled, State) and doubled.label == "a"
    assert torch.equal(doubled.q, 2 * s.q)
    assert tree_replace(s, label="b").label == "b"
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.label = "c"
