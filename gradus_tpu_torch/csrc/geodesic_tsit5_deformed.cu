// The integrator kernel of tsit5.cuh for the deformed metrics of
// metrics.cuh: the right-hand side evaluates the metric's components5 once
// on dual numbers with two tangents (dual.cuh), which gives the value and the
// (d_r, d_theta) Jacobian that the TPU kernel gets from two jax.jvp passes
// (gradus_tpu/metrics/base.py:100-114), then contracts them into the
// geodesic acceleration (gradus_tpu/geodesics/equation.py:94-134). The
// design note is at the top of geodesic_tsit5.cu.

#include "metrics.cuh"

namespace gradus {
namespace {

// a^mu = -g^{mu rho} [ (v^r d_r g + v^theta d_theta g)_{rho sigma} v^sigma
//                      - 1/2 delta_{rho in {r, theta}} (v d_rho g v) ]
template <typename T>
__device__ __forceinline__ void geodesic_acceleration(const Dual2<T>* g,
                                                      const T* y, T* f) {
  const T vt = y[4], vr = y[5], vth = y[6], vph = y[7];
  const T inv_det = T(1) / (g[0].v * g[3].v - g[4].v * g[4].v);
  const T gi_tt = g[3].v * inv_det;
  const T gi_phph = g[0].v * inv_det;
  const T gi_tph = -g[4].v * inv_det;
  const T gi_rr = T(1) / g[1].v;
  const T gi_thth = T(1) / g[2].v;

  // (J v)_rho for J = d_r g and J = d_theta g
  const T J1v_t = g[0].dr * vt + g[4].dr * vph;
  const T J1v_r = g[1].dr * vr;
  const T J1v_th = g[2].dr * vth;
  const T J1v_ph = g[4].dr * vt + g[3].dr * vph;
  const T q1 = vt * J1v_t + vr * J1v_r + vth * J1v_th + vph * J1v_ph;
  const T J2v_t = g[0].dth * vt + g[4].dth * vph;
  const T J2v_r = g[1].dth * vr;
  const T J2v_th = g[2].dth * vth;
  const T J2v_ph = g[4].dth * vt + g[3].dth * vph;
  const T q2 = vt * J2v_t + vr * J2v_r + vth * J2v_th + vph * J2v_ph;

  const T A_t = vr * J1v_t + vth * J2v_t;
  const T A_r = vr * J1v_r + vth * J2v_r - T(0.5) * q1;
  const T A_th = vr * J1v_th + vth * J2v_th - T(0.5) * q2;
  const T A_ph = vr * J1v_ph + vth * J2v_ph;

  f[0] = vt;
  f[1] = vr;
  f[2] = vth;
  f[3] = vph;
  f[4] = -(gi_tt * A_t + gi_tph * A_ph);
  f[5] = -gi_rr * A_r;
  f[6] = -gi_thth * A_th;
  f[7] = -(gi_tph * A_t + gi_phph * A_ph);
}

template <class Components>
struct DualRhs {
  template <typename T>
  static __device__ __forceinline__ void rhs(const DeformedParams<T>& p,
                                             const T* y, T* f) {
    const Dual2<T> r = {y[1], T(1), T(0)};
    const Dual2<T> th = {y[2], T(0), T(1)};
    Dual2<T> g[5];
    Components::components5(p, r, th, g);
    geodesic_acceleration(g, y, f);
  }
};

}  // namespace

template <typename T>
int launch_deformed(int metric, const DeformedParams<T>& p, const void* y0,
                    int64_t n, void* const* out, void* stream) {
  switch (metric) {
    case kMetricJohannsen:
      return launch<T, DualRhs<Johannsen>>(p, y0, n, out, stream);
    case kMetricJohannsenPsaltis:
      return launch<T, DualRhs<JohannsenPsaltis>>(p, y0, n, out, stream);
    case kMetricNoZ:
      return launch<T, DualRhs<NoZ>>(p, y0, n, out, stream);
    case kMetricBumblebee:
      return launch<T, DualRhs<Bumblebee>>(p, y0, n, out, stream);
    case kMetricDilatonAxion:
      return launch<T, DualRhs<DilatonAxion>>(p, y0, n, out, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template int launch_deformed<float>(int, const DeformedParams<float>&,
                                    const void*, int64_t, void* const*, void*);
template int launch_deformed<double>(int, const DeformedParams<double>&,
                                     const void*, int64_t, void* const*, void*);

}  // namespace gradus
