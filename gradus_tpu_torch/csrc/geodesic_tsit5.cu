// Adaptive Tsit5 geodesic integrator with disc-crossing events: one CUDA
// thread integrates one ray from its initial state to its end. The kernel
// itself is the template in tsit5.cuh; this file holds the library's C entry
// points and Kerr's instantiation for geometry kinds 0-2 (its right-hand side
// is in kerr.cuh; every metric's instantiation for kinds 3-7 is in a
// geodesic_tsit5_generic_*.cu file).
//
// Replaces gradus_tpu/integrate/pallas_solver.py::_make_kernel (the Pallas TPU
// kernel launched by pallas_integrate_rays) in every mode a caller of the JAX
// package reaches with these geometries: cubic-Hermite or sampled events,
// terminate on hit or count the crossings, a fresh start or the resumption
// of a saved carry with a cap on the loop iterations, against a geometry
//   0  none
//   1  ThinDisc(inner_r, outer_r): crossings of theta = pi/2 inside the annulus
//   2  DatumPlane(height): every crossing of the plane r cos(theta) = height
//      (the Cunningham transfer-function solve; one height for all rays)
//   3-7  ShakuraSunyaev, EllipticalDisc, PolishDoughnut, PrecessingDisc,
//      CompositeGeometry of up to four parts (geometry.cuh; the kernel's
//      generic instantiation)
// and for every metric of gradus_tpu/metrics/: Kerr (kind 0, also the
// first-order Kerr class), with the hand-derived components5_jac below, or
// one of eleven metrics whose value and (d_r, d_theta) Jacobian come from one
// forward-mode pass over dual numbers with two tangents (metrics.cuh,
// dual.cuh; kinds 1-11, geodesic_tsit5_{deformed,exotic,minkowski}.cu), where
// the TPU kernel inlines two jax.jvp passes through components5. The rest
// of the TPU kernel's geometries (WarpedThinDisc and ThickDisc, which carry
// a Python callable that the TPU kernel inlines) are not ported.
//
// What bounds it on an H100: compute and instruction issue, and the serial
// chain of one ray's steps. Each accepted or rejected step is 7 evaluations
// of the geodesic right-hand side (sin/cos, the 5-component metric with its
// r- and theta-derivatives, the inverse and the Christoffel contraction),
// the 6-stage Runge-Kutta sums, the error norm, one log and one exp for the
// controller, and on an accepted step the event test. A hit adds its Newton
// polish: newton_iters + 1 Tsit5 sub-steps of 5 right-hand sides each.
// There is no device-memory traffic inside the loop: a ray reads its 8
// initial values once (a resumed ray its carry too, 18 more) and writes 27
// values once. The dual-number right-hand side carries three values through
// every operation of the metric, so it costs more operations and registers
// than Kerr's closed form.
//
// What the design does about it: the whole integrator carry (state, FSAL
// derivative, step size, controller and event state) stays in registers for
// the ray's lifetime, and every thread leaves its loop as soon as its own ray
// is done, so the warp (not a 1024-ray tile) is the unit of early exit. Work
// the TPU's lockstep lanes compute and throw away is skipped per thread: the
// controller computes only the factor of the step's outcome, the event test
// runs on accepted steps only, and the cubic event bisects only a sign
// change it found. A hit is polished where the hit step's start is still in
// registers, as the ray's last loop iterations: each sub-step runs the
// step's own stage code, so a warp's polishing lanes take the same
// instructions as its stepping lanes and the kernel holds one inlined copy
// of the stages (a separate epilogue after the loop, run once all the
// warp's lanes had left it, took 4-20% more kernel time than this form on
// the f32 1024² renders of Kerr, Johannsen-Psaltis and Kerr-Newman on an
// H100, and more registers). No pass over every ray after the kernel
// remains. The kernel is a template over the metric, so each
// instantiation inlines its own right-hand side. Metric and disc
// parameters, tolerances, the affine span and the modes are runtime
// arguments, so one build serves every configuration, and a capped pass and
// its resumption run the same machine code.
//
// Layout: inputs and outputs are state-major, (8, n) and (n,), contiguous,
// so neighbouring threads touch neighbouring addresses.
//
// Built with nvcc for sm_90a without --use_fast_math: the tolerances of the
// comparison with the plain PyTorch version assume IEEE sin/cos/log/exp/sqrt
// and IEEE division.

#include "entry.cuh"
#include "kerr.cuh"

namespace gradus {
namespace {

// The launch for the metric kind: Kerr's here, the others' in their files.
template <typename T>
int launch_metric(int metric, const GenericParams<T>& p, const Launch<T>& l) {
  if (metric == kMetricKerr) return launch<T, Kerr, Params<T>>(p, l);
  if (metric <= kMetricDilatonAxion) return launch_deformed<T>(metric, p, l);
  if (metric <= kMetricKerrDarkMatter) return launch_exotic<T>(metric, p, l);
  return launch_minkowski<T>(metric, p, l);
}

}  // namespace
}  // namespace gradus

GEODESIC_TSIT5_ENTRY(geodesic_tsit5_f32, float, gradus::launch_metric<float>)
GEODESIC_TSIT5_ENTRY(geodesic_tsit5_f64, double, gradus::launch_metric<double>)
