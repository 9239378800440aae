"""npz round trips of the port's artifacts (tests/test_serialization.py's
cases), and the same files across the two packages: what either package
saves, the other loads, every array bit for bit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gradus_tpu as jgt
import gradus_tpu_torch as tgt
from gradus_tpu.serialization import load_npz as jax_load
from gradus_tpu.serialization import save_npz as jax_save
from gradus_tpu_torch.camera.pointfns import ConstPointFunctions
from gradus_tpu_torch.camera.render import apply
from gradus_tpu_torch.corona.profiles import RadialDiscProfile
from gradus_tpu_torch.integrate.points import GeodesicPoint
from gradus_tpu_torch.serialization import load_npz, save_npz
from gradus_tpu_torch.transfer.cunningham import TransferBranchGrid

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64)


def _leaves(tree):
    """The arrays of a port or JAX artifact, in field order, as numpy."""
    out = []

    def walk(o):
        if isinstance(o, torch.nn.Module):
            out.extend(b.detach().numpy() for b in o.buffers())
        elif hasattr(o, "__dataclass_fields__"):
            for name in o.__dataclass_fields__:
                walk(getattr(o, name))
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif isinstance(o, torch.Tensor):
            out.append(o.detach().numpy())
        elif o is not None:
            out.append(np.asarray(o))

    walk(tree)
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _grid(rng):
    return dict(
        radii=rng.uniform(2, 50, 5), gmin=rng.uniform(0.2, 0.4, 5), gmax=rng.uniform(0.9, 1.2, 5),
        gstar=np.linspace(0.01, 0.99, 16), lower_f=rng.uniform(0, 1, (5, 16)), upper_f=rng.uniform(0, 1, (5, 16)),
        lower_t=rng.uniform(0, 100, (5, 16)), upper_t=rng.uniform(0, 100, (5, 16)),
    )  # fmt: skip


def test_transfer_grid_roundtrip(tmp_path):
    grid = TransferBranchGrid(**{k: torch.as_tensor(v) for k, v in _grid(np.random.default_rng(0)).items()})
    save_npz(tmp_path / "grid.npz", grid)
    grid2 = load_npz(tmp_path / "grid.npz", device="cpu")
    assert isinstance(grid2, TransferBranchGrid)
    _assert_same(grid, grid2)


def test_radial_profile_roundtrip(tmp_path):
    prof = RadialDiscProfile(
        radii=torch.tensor([2.0, 5.0, 10.0, math.inf], **F64),
        eps=torch.tensor([1.0, 0.1, 0.01, 0.0], **F64),
        t=torch.tensor([3.0, 7.0, 13.0, 0.0], **F64),
        n=torch.tensor(3, dtype=torch.int32),
    )
    save_npz(tmp_path / "prof.npz", prof)
    prof2 = load_npz(tmp_path / "prof.npz", device="cpu")
    _assert_same(prof, prof2)
    q = torch.tensor([3.0, 6.0], **F64)
    assert torch.equal(prof.emissivity_at(q), prof2.emissivity_at(q))


def test_render_cache_roundtrip(tmp_path):
    """A render cache (metric and GeodesicPoint payload) round-trips, and a
    point function applied to it gives the same image without a trace."""
    m = tgt.KerrMetric(1.0, 0.7, device="cpu")
    x = torch.tensor([0.0, 100.0, math.radians(70.0), 0.0], **F64)
    _, _, cache = tgt.prerendergeodesics(
        m, x, lam_max=300.0, image_width=6, image_height=6, alpha_lims=(-10.0, 10.0), beta_lims=(-10.0, 10.0)
    )
    save_npz(tmp_path / "cache.npz", cache)
    cache2 = load_npz(tmp_path / "cache.npz", device="cpu")
    assert type(cache2.m) is tgt.KerrMetric
    _assert_same(cache, cache2)
    img, img2 = (apply(ConstPointFunctions.shadow(), c).numpy() for c in (cache, cache2))
    np.testing.assert_array_equal(img, img2)


def test_analytic_profile_rejected(tmp_path):
    """Callables are not serializable: an explicit error, not a pickle."""
    prof = tgt.AnalyticRadialDiscProfile(lambda r: r**-3.0)
    with pytest.raises(TypeError):
        save_npz(tmp_path / "bad.npz", prof)


def _jax_artifacts(rng):
    """The JAX package's table, GeodesicPoint and metrics, from seeds."""
    from gradus_tpu.integrate.points import GeodesicPoint as JaxPoint
    from gradus_tpu.transfer.cunningham import TransferBranchGrid as JaxGrid

    n = 7
    point = JaxPoint(
        status=jnp.asarray(rng.integers(0, 4, n), jnp.int32), lam_min=jnp.zeros(n), lam_max=jnp.asarray(rng.uniform(0, 9, n)),
        x_init=jnp.asarray(rng.normal(size=(n, 4))), v_init=jnp.asarray(rng.normal(size=(n, 4))),
        x=jnp.asarray(rng.normal(size=(n, 4))), v=jnp.asarray(rng.normal(size=(n, 4))), aux=None,
    )  # fmt: skip
    grid = JaxGrid(**{k: jnp.asarray(v) for k, v in _grid(rng).items()})
    metrics = (jgt.KerrMetric(M=1.0, a=0.6), jgt.JohannsenPsaltisMetric(M=1.0, a=0.3, eps3=0.2), jgt.ThinDisc(0.0, 40.0))
    return dict(point=point, grid=grid, metrics=metrics)


@pytest.mark.parametrize("what", ["point", "grid", "metrics"])
def test_jax_file_loads_in_the_port(tmp_path, what):
    obj = _jax_artifacts(np.random.default_rng(5))[what]
    jax_save(tmp_path / "a.npz", obj)
    got = load_npz(tmp_path / "a.npz", device="cpu")
    if what == "metrics":
        assert [type(g).__name__ for g in got] == [type(o).__name__ for o in obj]
    else:
        assert type(got).__name__ == type(obj).__name__
    _assert_same(got, jax.tree_util.tree_map(np.asarray, obj))


@pytest.mark.parametrize("what", ["point", "grid", "metrics"])
def test_port_file_loads_in_jax(tmp_path, what):
    rng = np.random.default_rng(6)
    n = 7
    obj = dict(
        point=GeodesicPoint(
            status=torch.as_tensor(rng.integers(0, 4, n), dtype=torch.int32), lam_min=torch.zeros(n, **F64),
            lam_max=torch.as_tensor(rng.uniform(0, 9, n)), x_init=torch.as_tensor(rng.normal(size=(n, 4))),
            v_init=torch.as_tensor(rng.normal(size=(n, 4))), x=torch.as_tensor(rng.normal(size=(n, 4))),
            v=torch.as_tensor(rng.normal(size=(n, 4))),
        ),
        grid=TransferBranchGrid(**{k: torch.as_tensor(v) for k, v in _grid(rng).items()}),
        metrics=(
            tgt.KerrMetric(1.0, 0.6, device="cpu"),
            tgt.JohannsenPsaltisMetric(1.0, 0.3, 0.2, device="cpu"),
            tgt.ThinDisc(0.0, 40.0, device="cpu"),
        ),
    )[what]  # fmt: skip
    save_npz(tmp_path / "p.npz", obj)
    got = jax_load(tmp_path / "p.npz")
    if what == "metrics":
        assert [type(g).__name__ for g in got] == [type(o).__name__ for o in obj]
    else:
        assert type(got).__name__ == type(obj).__name__
    _assert_same(jax.tree_util.tree_map(np.asarray, got), obj)
