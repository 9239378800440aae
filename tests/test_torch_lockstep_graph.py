"""The lockstep solver's loop with the tangent carried explicitly, and
replayed as a CUDA graph.

On the CPU, in f64: `trace_geodesics(..., v_dot=...)` (the tangent carried through the
loop, one lifted jvp of the loop body an iteration) against
`torch.func.jvp` around the whole uncaptured `trace_geodesics`, bit for
bit, on 64 flagship rays; and the replay bookkeeping of `_run_loop` (static
buffers, one replay an iteration in blocks of 16, a shorter last block, the
alive check, the events it reports to an observer), with a stand-in for the
captured graph that runs the body it was given.

Marked `cuda` (they skip without a card): the captured loop against the
uncaptured one (`cuda_graphs(False)`), bit for bit, for a primal and a jvp
trace, every metric class and every geometry of the port, the dense
trace and its tangent of `refine_for_target` (and `torch.func.jvp` of its
arrival time, whose traces replay captured within the transform), a
ring's and a disc's fan profiles, and the adaptive sky's trace of 2N rays
with their tangents (each copy's tangent bit for bit that of a trace of
its own); the special traces' right-hand sides (charged, first-order
Mino-time, radiative transfer, windings) and the shaped inner chart; a
`torch.func` transform around a captured loop raises; and
`CompactedIntegrator`, one captured graph a working-set width, against
one `integrate_rays` call.

    python -m pytest --noconftest -m cuda tests/test_torch_lockstep_graph.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gradus_tpu_torch.geometry.discs as td  # noqa: E402
import gradus_tpu_torch.integrate.solver as solver  # noqa: E402
from gradus_tpu_torch import metrics  # noqa: E402
from gradus_tpu_torch.camera import map_impact_parameters  # noqa: E402
from gradus_tpu_torch.geodesics.equation import constrain_all  # noqa: E402
from gradus_tpu_torch.integrate import StatusCodes, cuda_graphs, make_geodesic_rhs, trace_geodesics  # noqa: E402
from gradus_tpu_torch.metrics import KerrMetric  # noqa: E402
from gradus_tpu_torch.utils.jvp import jvp  # noqa: E402

SPAN = (0.0, 2200.0)
X_FLAGSHIP = [0.0, 1000.0, math.radians(75.0), 0.0]


def _flagship(dev, dtype, n, seed=3):
    """``n`` flagship rays (Kerr a = 0.998, r = 1000, i = 75°) at impact
    parameters through ThinDisc(0, 50)'s image, and that disc."""
    rng = np.random.default_rng(seed)
    m = KerrMetric(1.0, 0.998, dtype=dtype, device=dev)
    x = torch.tensor(X_FLAGSHIP, dtype=dtype, device=dev)
    A = torch.as_tensor(rng.uniform(-25.0, 25.0, n), dtype=dtype, device=dev)
    B = torch.as_tensor(rng.uniform(-15.0, 15.0, n), dtype=dtype, device=dev)
    return m, x, A, B, td.ThinDisc(0.0, 50.0, dtype=dtype, device=dev)


def _hit_x(m, x, A, d):
    def of(b):
        v = map_impact_parameters(m, x, A, b)
        return trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d).x

    return of


def test_explicit_tangent_loop_matches_jvp_of_the_whole_loop():
    """64 flagship rays, f64: the endpoints and their tangents ∂x/∂β from
    `trace_geodesics(..., v_dot=...)` equal those of `torch.func.jvp` (lifted) around
    the whole uncaptured trace, bit for bit; the endpoints also equal the
    primal trace's."""
    m, x, A, B, d = _flagship("cpu", torch.float64, 64)
    ones = torch.ones_like(B)
    x_whole, dx_whole = jvp(_hit_x(m, x, A, d), (B,), (ones,))
    v, v_dot = jvp(lambda b: map_impact_parameters(m, x, A, b), (B,), (ones,))
    gp, gp_dot = trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d, v_dot=v_dot)
    assert torch.equal(gp.x, x_whole)
    assert torch.equal(gp_dot.x, dx_whole)
    assert torch.equal(gp.x, _hit_x(m, x, A, d)(B))
    assert torch.isfinite(dx_whole).all() and (gp.status == StatusCodes.IntersectedWithGeometry).sum() > 20


class _Events(list):
    """An observer of the lockstep loops that keeps every event."""

    def __call__(self, event, **info):
        self.append((event, info))


class _Replayed:
    """A stand-in for a captured body on the CPU: replay runs the body and
    writes the carry back; ``replays`` counts the replays of all of them."""

    replays = 0

    def __init__(self, step, static):
        self.step, self.static = step, static

    def replay(self):
        _Replayed.replays += 1
        c = self.step(self.static)
        for k, buf in self.static.items():
            buf.copy_(c[k])


@pytest.mark.parametrize("max_steps", [40000, 70, 16])
def test_replay_bookkeeping_matches_the_uncaptured_loop(monkeypatch, max_steps):
    """`_run_loop`'s replay path (static buffers, blocks of 16 replays, a
    shorter last block when ``max_steps`` is not a multiple of 16) gives
    the uncaptured loop's outputs bit for bit, and counts its replays."""
    m, x, A, B, d = _flagship("cpu", torch.float64, 32, seed=4)
    v = map_impact_parameters(m, x, A, B)
    kw = dict(geometry=d, max_steps=max_steps)
    want = trace_geodesics(m, x.expand_as(v), v, SPAN, **kw)
    monkeypatch.setattr(solver, "_graphed", lambda cf: True)
    monkeypatch.setattr(solver, "_capture", _Replayed)
    monkeypatch.setattr(_Replayed, "replays", 0)
    events = _Events()
    with solver.observe_loops(events):
        got = trace_geodesics(m, x.expand_as(v), v, SPAN, **kw)
    for f in ("status", "x", "v", "lam_max"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert [e for e, _ in events if e == "loop"] == ["loop"]
    assert events[0] == ("loop", dict(tangent=False, graphed=True))
    starts = [i["iterations"] for e, i in events if e == "block"]
    (end,) = [i["iterations"] for e, i in events if e == "end"]
    assert starts == list(range(0, end, 16)) and end <= max_steps
    assert _Replayed.replays == end
    if max_steps == 70:
        assert end == 70


def test_graph_switch_scopes():
    assert solver._CUDA_GRAPHS
    with cuda_graphs(False):
        assert not solver._CUDA_GRAPHS
        with cuda_graphs(True):
            assert solver._CUDA_GRAPHS
        assert not solver._CUDA_GRAPHS
    assert solver._CUDA_GRAPHS


# --- on the card -----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _trace_both(fn):
    """fn() with the loop captured, then uncaptured; the counts of the
    captured run's graph events."""
    events = _Events()
    with solver.observe_loops(events):
        captured = fn()
    stats = dict(
        captures=sum(e == "capture" for e, _ in events),
        replays=sum(i["iterations"] for e, i in events if e == "end"),
    )
    with cuda_graphs(False):
        plain = fn()
    return captured, plain, stats


def _equal(a, b):
    for f in ("status", "x", "v", "lam_max"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_primal_trace_matches_uncaptured(dev, dtype):
    m, x, A, B, d = _flagship(dev, dtype, 1024)
    v = map_impact_parameters(m, x, A, B)
    got, want, stats = _trace_both(lambda: trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d))
    _equal(got, want)
    assert stats["captures"] == 1 and stats["replays"] > 10


@pytest.mark.cuda
def test_captured_jvp_trace_matches_uncaptured(dev):
    m, x, A, B, d = _flagship(dev, torch.float64, 64)
    v, v_dot = jvp(lambda b: map_impact_parameters(m, x, A, b), (B,), (torch.ones_like(B),))
    (got, got_dot), (want, want_dot), stats = _trace_both(
        lambda: trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d, v_dot=v_dot)
    )
    _equal(got, want)
    _equal(got_dot, want_dot)
    assert stats["captures"] == 1


def _metric_cases():
    kw = dict(dtype=torch.float64)
    return {
        "KerrMetric": lambda dev: metrics.KerrMetric(1.0, 0.998, device=dev, **kw),
        "KerrSpacetimeFirstOrder": lambda dev: metrics.KerrSpacetimeFirstOrder(1.0, 0.5, device=dev, **kw),
        "JohannsenMetric": lambda dev: metrics.JohannsenMetric(1.0, 0.6, 0.2, 0.1, 0.0, 0.5, device=dev, **kw),
        "JohannsenPsaltisMetric": lambda dev: metrics.JohannsenPsaltisMetric(1.0, 0.6, 2.0, device=dev, **kw),
        "NoZMetric": lambda dev: metrics.NoZMetric(1.0, 0.5, 0.3, device=dev, **kw),
        "BumblebeeMetric": lambda dev: metrics.BumblebeeMetric(1.0, 0.2, 0.1, device=dev, **kw),
        "DilatonAxion": lambda dev: metrics.DilatonAxion(1.0, 0.5, 0.2, 1.0, device=dev, **kw),
        "KerrNewmanMetric": lambda dev: metrics.KerrNewmanMetric(1.0, 0.5, 0.3, device=dev, **kw),
        "MorrisThorneWormhole": lambda dev: metrics.MorrisThorneWormhole(1.0, device=dev, **kw),
        "KerrRefractive": lambda dev: metrics.KerrRefractive(1.0, 0.9, 1.1, 20.0, device=dev, **kw),
        "KerrDarkMatter": lambda dev: metrics.KerrDarkMatter(1.0, 0.9, 0.1, 10.0, 20.0, device=dev, **kw),
        "SphericalMetric": lambda dev: metrics.SphericalMetric(device=dev, **kw),
        "CartesianMetric": lambda dev: metrics.CartesianMetric(device=dev, **kw),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_metric_cases()))
def test_every_metric_captures(dev, name):
    """Each metric class's right-hand side in a captured loop (no host read
    in it), bit for bit against the uncaptured loop, on 64 rays at r = 100."""
    m = _metric_cases()[name](dev)
    rng = np.random.default_rng(9)
    x = torch.tensor([0.0, 100.0, math.radians(75.0), 0.0], dtype=torch.float64, device=dev)
    A = torch.as_tensor(rng.uniform(-12.0, 12.0, 64), device=dev)
    B = torch.as_tensor(rng.uniform(-8.0, 8.0, 64), device=dev)
    disc = None if name == "CartesianMetric" else td.ThinDisc(0.0, 40.0, device=dev)
    kw = dict(geometry=disc, chart_inner=2.02 if name == "BumblebeeMetric" else None, max_steps=2000)
    if name == "CartesianMetric":
        xs = torch.stack([torch.zeros_like(A), A, B, torch.full_like(A, -100.0)], dim=-1)
        vs = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64, device=dev).expand_as(xs)
    else:
        vs = map_impact_parameters(m, x, A, B)
        xs = x.expand_as(vs)
    got, want, stats = _trace_both(lambda: trace_geodesics(m, xs, vs, (0.0, 300.0), **kw))
    _equal(got, want)
    assert stats["captures"] == 1


def _geometry_cases(dev):
    m = KerrMetric(1.0, 0.998, device=dev)
    thin = td.ThinDisc(0.0, 50.0, device=dev)
    ell = td.EllipticalDisc(3.0, 30.0, 5.0, device=dev)
    return {
        "ThinDisc": thin,
        "WarpedThinDisc": td.WarpedThinDisc(lambda rho: 0.05 * rho * torch.sin(rho / 5.0), 3.0, 45.0, device=dev),
        "DatumPlane": td.DatumPlane(1.5, device=dev),
        "DatumPlane_per_ray": td.DatumPlane(torch.linspace(0.0, 2.0, 256, dtype=torch.float64), device=dev),
        "ThickDisc": td.ThickDisc(lambda rho: 0.2 * rho - 1.0, device=dev),
        "ShakuraSunyaev": td.ShakuraSunyaev.from_metric(m),
        "EllipticalDisc": ell,
        "PrecessingDisc": td.PrecessingDisc(td.ThinDisc(0.0, 50.0, device=dev), 0.3, 0.5, device=dev),
        "PolishDoughnut": td.PolishDoughnut(device=dev),
        "PolishDoughnut_metric": td.PolishDoughnut(ell=4.0, r_cusp=6.0, metric=KerrMetric(1.0, 0.5, device=dev)),
        "PolishDoughnutFW": td.polish_doughnut_fw(m, dt=0.1, newton_iters=10),
        "CompositeGeometry": td.CompositeGeometry([td.ThinDisc(0.0, 20.0, device=dev), ell]),
    }


@pytest.mark.cuda
def test_every_geometry_captures(dev):
    """Each geometry's indicator and hit test in a captured loop, bit for
    bit against the uncaptured loop, on 256 flagship rays."""
    m, x, A, B, _ = _flagship(dev, torch.float64, 256, seed=8)
    v = map_impact_parameters(m, x, A * 0.6, B * 0.3)
    for name, d in _geometry_cases(dev).items():
        got, want, stats = _trace_both(lambda: trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d))
        _equal(got, want)
        assert stats["captures"] == 1, name


@pytest.mark.cuda
def test_transform_around_a_captured_loop_raises(dev):
    """A transform around `integrate_rays`' captured loop raises; around
    `trace_geodesics` it is lifted into the loop (`tracing._LiftedTrace`),
    the bits of the uncaptured jvp."""
    m, x, A, B, d = _flagship(dev, torch.float64, 8)
    v = map_impact_parameters(m, x, A, B)
    y0 = torch.cat([x.expand_as(v), constrain_all(m, x.expand_as(v), v)], dim=-1)
    f = make_geodesic_rhs(m)

    def endpoints(y):
        return solver.integrate_rays(f, y, SPAN, abstol=1e-9, reltol=1e-9, r_inner=1.1, r_outer=1200.0).y

    with pytest.raises(RuntimeError, match="torch.func transform"):
        torch.func.jvp(endpoints, (y0,), (torch.ones_like(y0),))
    got = torch.func.jvp(_hit_x(m, x, A, d), (B,), (torch.ones_like(B),))
    with cuda_graphs(False):
        want = torch.func.jvp(_hit_x(m, x, A, d), (B,), (torch.ones_like(B),))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _branches_equal(a, b):
    for arm in ("left", "right"):
        for f in ("radii", "t", "eps", "n"):
            assert torch.equal(getattr(getattr(a, arm), f), getattr(getattr(b, arm), f)), (arm, f)


@pytest.mark.cuda
def test_captured_dense_tangent_matches_uncaptured(dev):
    """The dense trace (64 saved states) of two rays toward a ring corona's
    source at r = 1000, each with its own tangent (`refine_for_target`'s
    Gauss-Newton step), captured against uncaptured bit for bit."""
    from gradus_tpu_torch.transfer.targets import _dense

    m = KerrMetric(1.0, 0.5, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(45.0), 0.0], dtype=torch.float64, device=dev)
    ab = torch.tensor([0.08, 0.70], dtype=torch.float64, device=dev)
    eye = torch.eye(2, dtype=torch.float64, device=dev)
    (p1, d1), (p2, d2), stats = _trace_both(
        lambda: _dense(m, x, ab[0].repeat(2), ab[1].repeat(2), 2000.0, 64, 0.0, 2000.0, (eye[0], eye[1]))
    )
    _equal(p1[0], p2[0])
    _equal(d1[0], d2[0])
    for a, b in zip(p1[1:] + d1[1:3], p2[1:] + d2[1:3]):
        assert torch.equal(a, b)
    assert stats["captures"] == 1


@pytest.mark.cuda
def test_captured_ring_and_disc_profiles_match_uncaptured(dev):
    """A ring's fan (4 slices × 48 angles, 4 golden-section steps) and a
    two-ring disc stack (3 × 32, 2 steps), Kerr a = 0.5, ThinDisc(0, 100):
    every branch captured against uncaptured bit for bit, one capture a
    trace."""
    from gradus_tpu_torch.corona import DiscCorona, RingCorona, emissivity_profile

    m = KerrMetric(1.0, 0.5, device=dev)
    d = td.ThinDisc(0.0, 100.0, device=dev)
    ring, want, stats = _trace_both(
        lambda: emissivity_profile(m, d, RingCorona(r=3.0, h=4.0), n_beta=4, n_angles=48, n_refine=4, near_field="fan")
    )
    _branches_equal(ring, want)
    assert stats["captures"] == 1 + 2 + 4
    disc, want, stats = _trace_both(
        lambda: emissivity_profile(m, d, DiscCorona(r=6.0, h=4.0), n_rings=2, n_beta=3, n_angles=32, n_refine=2)
    )
    _branches_equal(disc.rings, want.rings)
    assert stats["captures"] == 1 + 2 + 2


@pytest.mark.cuda
def test_corona_sky_two_tangents_in_one_trace_on_the_card(dev):
    """`CoronaSkyTracer`'s trace of 2N rays (N = 24: no multiple of a
    vector's width, as the CPU test needs) gives each copy's tangent bit for
    bit as a trace of its own, captured; and the whole round captured
    against uncaptured."""
    from gradus_tpu_torch.corona import RingCorona
    from gradus_tpu_torch.corona.adaptive import CoronaSkyTracer
    from gradus_tpu_torch.corona.samplers import sky_angles_to_velocity
    from gradus_tpu_torch.integrate import domain_upper_hemisphere

    m = KerrMetric(1.0, 0.5, device=dev)
    d = td.ThinDisc(0.0, 100.0, device=dev)
    tracer = CoronaSkyTracer(m, d, RingCorona(r=3.0, h=4.0))
    rng = np.random.default_rng(2)
    th = torch.as_tensor(np.arccos(rng.uniform(-1, 1, 24)), device=dev)
    ph = torch.as_tensor(rng.uniform(-np.pi, np.pi, 24), device=dev)
    (vals, _), (want, _), stats = _trace_both(lambda: tracer._eval(th, ph))
    for k in vals:
        assert torch.equal(torch.nan_to_num(vals[k]), torch.nan_to_num(want[k])), k
    assert stats["captures"] == 1
    v, v_dot = jvp(
        lambda a, b: sky_angles_to_velocity(m, tracer.x_src, tracer.v_src, a, b),
        (th, ph),
        (torch.zeros_like(th), torch.ones_like(ph)),
    )
    gp, gp_dot = trace_geodesics(
        m, tracer.x_src.expand_as(v), v, (0.0, 1e4), geometry=d, chart_outer=12000.0,
        terminate_fns=(domain_upper_hemisphere(),), constrain=False, v_dot=v_dot,
    )
    hit = gp.status == StatusCodes.IntersectedWithGeometry
    assert int(hit.sum()) >= 8
    assert torch.equal(vals["phi"][hit], gp.x[hit, 3])
    from gradus_tpu_torch.utils import equatorial_project

    _, dr_dph = jvp(equatorial_project, (gp.x,), (gp_dot.x,))
    assert torch.equal(vals["dr_dph"][hit], dr_dph.abs()[hit])


@pytest.mark.cuda
def test_arrival_time_jvp_replays_captured_loops(dev):
    """`torch.func.jvp` of `refine_for_target`'s arrival time with respect
    to the target runs its traces captured (inside its autograd.Function's
    forward, on plain tensors), and gives the uncaptured run's value and
    derivative bit for bit."""
    from gradus_tpu_torch.transfer.targets import refine_for_target

    m = KerrMetric(1.0, 0.5, device=dev)
    x = torch.tensor([0.0, 1000.0, math.radians(45.0), 0.0], dtype=torch.float64, device=dev)
    target = torch.tensor([5.0, math.atan2(3.0, 4.0), 0.0], dtype=torch.float64, device=dev)
    ab0 = torch.tensor([0.08, 0.70], dtype=torch.float64, device=dev)
    e_r = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=dev)
    (t, dt), (t2, dt2), stats = _trace_both(
        lambda: torch.func.jvp(lambda p: refine_for_target(p, m, x, ab0, iters=2)[1], (target,), (e_r,))
    )
    assert torch.equal(t, t2) and torch.equal(dt, dt2)
    assert stats["captures"] == 3 and math.isfinite(float(dt)) and float(dt) < 0


# --- the special traces' right-hand sides and the shaped chart ------------------


@pytest.mark.cuda
def test_captured_charged_trace_matches_uncaptured(dev):
    """The charged right-hand side (the Lorentz force through the batched
    `faraday_tensor`, two forward-mode passes inside the body) on 64
    timelike particles near Kerr-Newman's charged circular orbits."""
    from gradus_tpu_torch.orbits import charged_circular_orbit_omega

    m = metrics.KerrNewmanMetric(1.0, 0.5, 0.3, device=dev)
    r = torch.linspace(6.0, 20.0, 64, dtype=torch.float64, device=dev)
    om = charged_circular_orbit_omega(m, r, q=0.3)
    g = m.components(r, torch.full_like(r, math.pi / 2))
    ut = 1.0 / torch.sqrt(-(g[:, 0] + 2 * om * g[:, 4] + om * om * g[:, 3]))
    z = torch.zeros_like(r)
    x = torch.stack([z, r, torch.full_like(r, math.pi / 2), z], -1)
    v = torch.stack([ut, z + 1e-3, z + 1e-4, om * ut], -1)
    got, want, stats = _trace_both(lambda: trace_geodesics(m, x, v, (0.0, 300.0), mu=1.0, q=0.3))
    _equal(got, want)
    assert stats["captures"] == 1


@pytest.mark.cuda
def test_captured_first_order_trace_matches_uncaptured(dev):
    """The Mino-time right-hand side (7 slots, the λ-limit terminate
    function) on 256 flagship rays against ThinDisc(0, 50)."""
    from gradus_tpu_torch.metrics import trace_geodesics_first_order

    m, x, A, B, d = _flagship(dev, torch.float64, 256, seed=5)
    v = map_impact_parameters(m, x, A, B)
    mfo = metrics.KerrSpacetimeFirstOrder(1.0, 0.998, device=dev)
    got, want, stats = _trace_both(lambda: trace_geodesics_first_order(mfo, x.expand_as(v), v, SPAN, geometry=d))
    _equal(got, want)
    assert stats["captures"] == 1


@pytest.mark.cuda
def test_captured_radiative_transfer_and_windings_match_uncaptured(dev):
    """The radiative-transfer right-hand side (10 slots, the crossing count
    of an optically thick slab) and the winding count (9 slots), each on
    256 flagship rays aimed at the slab, f32."""
    from gradus_tpu_torch.integrate import trace_radiative_transfer, trace_windings

    class Slab(td.AbstractThickAccretionDisc):
        def __init__(self):
            super().__init__()
            self._buffers_from(torch.float32, dev, inner_r=8.0, outer_r=12.0)

        def cross_section(self, rho):
            return torch.where((rho > self.inner_r) & (rho < self.outer_r), 1.0, -1.0)

        def emission_coefficient(self, x4, nu):
            return torch.ones(x4.shape[:-1], dtype=x4.dtype, device=x4.device)

    m, x, _, _, _ = _flagship(dev, torch.float32, 1)
    rng = np.random.default_rng(6)
    rho, phi = rng.uniform(8.0, 13.0, 256), rng.uniform(0, 2 * math.pi, 256)
    A = torch.as_tensor(rho * np.cos(phi), dtype=torch.float32, device=dev)
    B = torch.as_tensor(rho * np.sin(phi) * math.cos(math.radians(75.0)), dtype=torch.float32, device=dev)
    v = map_impact_parameters(m, x, A, B)
    xs = x.expand_as(v)
    got, want, stats = _trace_both(lambda: trace_radiative_transfer(m, xs, v, SPAN, geometry=Slab(), max_steps=3000))
    _equal(got, want)
    assert torch.equal(got.aux, want.aux) and stats["captures"] == 1
    assert bool((got.aux[:, 1] >= 2).any())
    (gw, w), (gw2, w2), stats = _trace_both(lambda: trace_windings(m, xs, v, SPAN))
    _equal(gw, gw2)
    assert torch.equal(w, w2) and stats["captures"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["KerrMetric", "JohannsenPsaltisMetric"])
def test_captured_shaped_chart_matches_uncaptured(dev, name):
    """`event_horizon_chart` as the inner chart (r_min interpolated at each
    ray's θ in the body) on 256 flagship rays across the shadow."""
    from gradus_tpu_torch.integrate import event_horizon_chart

    m = _metric_cases()[name](dev)
    _, x, A, B, d = _flagship(dev, torch.float64, 256, seed=7)
    v = map_impact_parameters(m, x, A * 0.3, B * 0.3)
    chart = event_horizon_chart(m)
    got, want, stats = _trace_both(
        lambda: trace_geodesics(m, x.expand_as(v), v, SPAN, geometry=d, chart_inner=chart, chart_outer=1100.0)
    )
    _equal(got, want)
    assert stats["captures"] == 1 and bool((got.status == StatusCodes.WithinInnerBoundary).any())


def _mean_redshift_64(dev):
    """The redshift of 8×8 rays of tests/test_reverse_mode.py's grid at r =
    100 (λ ≤ 300, ThinDisc(0, 50), f64) as a function of (a, i)."""
    from gradus_tpu_torch.redshift import redshift_pointfunction

    def g(a, incl):
        m = KerrMetric(1.0, a, device=dev)
        d = td.ThinDisc(0.0, 50.0, dtype=torch.float64, device=dev)
        z = torch.zeros((), dtype=torch.float64, device=dev)
        x = torch.stack([z, z + 100.0, incl, z])
        al = torch.linspace(-12.0, 12.0, 8, dtype=torch.float64, device=dev) + 1e-3
        be = torch.linspace(-8.0, 8.0, 8, dtype=torch.float64, device=dev) + 1e-3
        v = map_impact_parameters(m, x, al[:, None].expand(8, 8).reshape(-1), be[None, :].expand(8, 8).reshape(-1))
        gp = trace_geodesics(m, x.expand_as(v), v, (0.0, 300.0), geometry=d)
        return torch.where(gp.status == StatusCodes.IntersectedWithGeometry, redshift_pointfunction(m, x)(m, gp, 300.0), 0.0)

    return g


@pytest.mark.cuda
def test_captured_parameter_tangents_match_uncaptured(dev):
    """The parameters' tangents carried through the captured loop
    (`tracing._LiftedTrace`): `torch.func.jvp` along (a, i) and `jacfwd`
    (both tangents in one pass) on 64 rays at r = 100, λ ≤ 300, bit for
    bit the uncaptured transforms' (`cuda_graphs(False)`)."""
    g = _mean_redshift_64(dev)
    p = (torch.tensor(0.6, dtype=torch.float64, device=dev), torch.tensor(math.radians(70.0), dtype=torch.float64, device=dev))
    t = (torch.tensor(1.0, dtype=torch.float64, device=dev), torch.tensor(0.5, dtype=torch.float64, device=dev))
    events = _Events()
    with solver.observe_loops(events):
        got = torch.func.jvp(g, p, t)
        got_jac = torch.func.jacfwd(g, argnums=(0, 1))(*p)
    with cuda_graphs(False):
        want = torch.func.jvp(g, p, t)
        want_jac = torch.func.jacfwd(g, argnums=(0, 1))(*p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got_jac, want_jac):
        assert torch.equal(a, b)
    assert sum(e == "capture" for e, _ in events) == 4  # a primal and a tangent loop each
    assert float(got[1].abs().max()) > 0


@pytest.mark.cuda
def test_captured_checkpointed_backward_matches_uncaptured(dev):
    """The checkpointed ladder's captured backward against the uncaptured
    `torch.utils.checkpoint` one (`cuda_graphs(False)`), on 8×8 of
    tests/test_checkpointed_adjoint.py's rays, with respect to the 128
    heights and the spin a (a metric buffer that requires grad, so also the
    rays' start and the ladder's NaN-guard floor): the loss bit for bit,
    the gradients within 1e-12 of their largest entry (autograd and
    `torch.func.vjp` may add a gradient's terms in another order)."""
    from gradus_tpu_torch.utils.interp import linear_interp

    class Spline(torch.nn.Module):
        def __init__(self, knots, heights):
            super().__init__()
            self.register_buffer("knots", knots)
            self.register_buffer("heights", heights)

        def crossing_indicator(self, x):
            r, th = x[..., 1], x[..., 2]
            return r * torch.cos(th) - linear_interp(r * torch.sin(th), self.knots, self.heights)

        def is_hit(self, x, gtol=1e-2):
            rho = x[..., 1] * torch.sin(x[..., 2])
            return (rho > 5.0) & (rho < 35.0)

    f64 = dict(dtype=torch.float64, device=dev)
    x = torch.tensor([0.0, 100.0, math.radians(70.0), 0.0], **f64)
    al, be = torch.linspace(-16.0, -8.0, 8, **f64), torch.linspace(-3.0, 3.0, 8, **f64)
    al, be = al[:, None].expand(8, 8).reshape(-1), be[None, :].expand(8, 8).reshape(-1)
    knots = torch.linspace(3.0, 40.0, 128, **f64)

    def loss_and_grad():
        m = KerrMetric(1.0, 0.6, device=dev)
        m.a = torch.tensor(0.6, **f64, requires_grad=True)
        v = map_impact_parameters(m, x, al, be)
        h = (0.5 + 0.3 * torch.sin(knots / 5.0)).requires_grad_(True)
        gp = trace_geodesics(m, x.expand_as(v), v, (0.0, 300.0), geometry=Spline(knots, h), checkpointed=True,
                             n_segments=16, seg_steps=16)  # fmt: skip
        hit = gp.status == StatusCodes.IntersectedWithGeometry
        rho = gp.x[..., 1] * torch.sin(gp.x[..., 2])
        loss = torch.where(hit, rho**2 + 0.1 * gp.x[..., 0], 0.0).sum() / 64
        return loss, torch.autograd.grad(loss, (h, m.a))

    events = _Events()
    with solver.observe_loops(events):
        got = loss_and_grad()
    with cuda_graphs(False):
        want = loss_and_grad()
    assert sum(e == "capture" for e, _ in events) == 2  # the body, and one body's vjp
    assert torch.equal(got[0].detach(), want[0].detach())
    (gh, ga), (wh, wa) = got[1], want[1]
    scale = float(wh.abs().max())
    assert scale > 0 and float((gh - wh).abs().max()) <= 1e-12 * scale
    assert float(wa) != 0.0 and abs(float(ga) - float(wa)) <= 1e-12 * abs(float(wa))


@pytest.mark.cuda
def test_tracer_on_the_card_matches_cuda_tracer(dev):
    """`Tracer` on the CUDA integrator (capped passes, the survivors
    resumed and compacted) gives `CudaTracer`'s single pass bit for bit,
    and reports each segment."""
    from gradus_tpu_torch.integrate import CudaTracer, Tracer

    m, x, A, B, d = _flagship(dev, torch.float64, 4096)
    v = map_impact_parameters(m, x, A, B)
    events = []
    got = Tracer(m, geometry=d, segment_iters=64, min_bucket=256, progress=events.append)(x.expand_as(v), v, SPAN)
    want = CudaTracer(m, geometry=d)(x.expand_as(v), v, SPAN)
    _equal(got, want)
    assert len(events) > 2 and events[-1]["alive"] == 0 and events[-1]["width"] < 4096


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_compacted_integrator_on_the_card_matches_integrate_rays(dev, dtype):
    """`CompactedIntegrator` (``min_bucket=512``) on 8,192 flagship rays
    against one `integrate_rays` call, as `chip_smoke.py`'s `compacted`
    holds it: statuses, steps and failures identical, y and λ bit for bit
    or each ray within 1e-6 relative (f32; 1e-12 in f64); one capture a
    working-set width, none on a second call of the same size."""
    from gradus_tpu_torch.config import default_tols

    m, x, A, B, d = _flagship(dev, dtype, 8192)
    v = map_impact_parameters(m, x, A, B)
    xs = x.expand_as(v)
    y0 = torch.cat([xs, constrain_all(m, xs, v)], dim=-1)
    a_tol, r_tol = default_tols(dtype)
    kw = dict(
        abstol=a_tol, reltol=r_tol, r_inner=m.inner_radius() * 1.01, r_outer=12000.0,
        crossing_fn=lambda y: d.crossing_indicator(y[..., 0:4]), hit_fn=lambda y: d.is_hit(y[..., 0:4], gtol=1e-2),
    )  # fmt: skip
    f = make_geodesic_rhs(m)
    want = solver.integrate_rays(f, y0, SPAN, **kw)
    ci = solver.CompactedIntegrator(f, min_bucket=512, **kw)
    rtol = 1e-6 if dtype == torch.float32 else 1e-12
    for call in range(2):
        events = _Events()
        with solver.observe_loops(events):
            got = ci(y0, SPAN)
        widths = sorted({w for w, _, _ in ci.last_stats}, reverse=True)
        assert len(widths) >= 2 and widths[0] == 8192
        assert [i["width"] for e, i in events if e == "capture"] == (widths if call == 0 else [])
        for field in ("status", "steps", "failed"):
            assert torch.equal(getattr(got, field), getattr(want, field)), field
        for field in ("y", "lam"):
            a, b = getattr(got, field), getattr(want, field)
            a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
            rel = (a - b).abs().amax(-1) / b.abs().amax(-1).clamp(min=1e-30)
            assert float(rel.max()) <= rtol, field
