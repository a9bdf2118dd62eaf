// Contact phase kernel for Hopper (sm_90a): K3.
//
// Replaces the JAX package's engine/contact_kernel.py:phase_batched_bm
// (Pallas body _make_kernel). Computes, per env: contact frames, the
// constraint Jacobian rows J [3 ncon, nv] (robot columns through the signed
// ancestor mask, 6-dof free-body columns on both sides), M^-1 J', the
// impedance model (solimp power 2), aref and R with impratio, diagonal
// preconditioning, 6 power iterations for the step size (1.5x safety),
// Nesterov APGD with adaptive restart and friction-cone projection for
// n_iters, and qfrc = J' f.
//
// Bound on this card: FP32 CUDA-core operations. Per env and call the
// solve does 32 Delassus matvecs (6 power + 1 Rayleigh + 25 APGD) of
// 2 x n x nv multiply-adds (pushing: n = 54, nv = 21, ~72.6 k MACs; ~0.21 M
// flop with the row assembly) while it reads and writes ~1.8 KB (446
// floats). Design: one warp per env. J and M^-1 J'
// (2 x 54 x 21 floats, 9 KB for pushing) live in shared memory; lane c owns
// contact c (its 3 rows), so frames, row assembly, impedance, projection
// and the second half of each matvec are lane-local; the first half
// (t = (M^-1 J')' x, one entry per dof) is lane-strided over dofs; the
// dot products (power-iteration norm, Rayleigh quotient, restart test) are
// __shfl_xor_sync reductions, so the per-env scalars stay uniform across
// the warp. Several envs share a block when their shared memory fits 48 KB.
#include <cuda_runtime.h>

#define K3_ROWC 9  // k, b, mu, d0, dw, width, mid, 1/mid, 1/(1-mid)

struct ContactDims {
  int ncon, nv_r, nf, nv, n_iters;
  float impratio;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Smem {
  float *J, *MJ, *Minv, *ax, *an, *fpos, *Rb, *v, *a, *t, *xs;
  float *fh, *y, *ish, *bh, *R, *sh, *vit, *g, *mus, *act;
};

__host__ __device__ inline int smem_floats(const ContactDims& D) {
  int n = 3 * D.ncon;
  return 2 * n * D.nv + D.nv_r * D.nv_r + 6 * D.nv_r + 12 * D.nf + 3 * D.nv + 9 * n
         + 2 * D.ncon;
}

__device__ inline Smem carve(float* base, const ContactDims& D) {
  int n = 3 * D.ncon;
  Smem s;
  float* p = base;
  s.J = p; p += n * D.nv;
  s.MJ = p; p += n * D.nv;
  s.Minv = p; p += D.nv_r * D.nv_r;
  s.ax = p; p += 3 * D.nv_r;
  s.an = p; p += 3 * D.nv_r;
  s.fpos = p; p += 3 * D.nf;
  s.Rb = p; p += 9 * D.nf;
  s.v = p; p += D.nv;
  s.a = p; p += D.nv;
  s.t = p; p += D.nv;
  s.xs = p; p += n;
  s.fh = p; p += n;
  s.y = p; p += n;
  s.ish = p; p += n;
  s.bh = p; p += n;
  s.R = p; p += n;
  s.sh = p; p += n;
  s.vit = p; p += n;
  s.g = p; p += n;
  s.mus = p; p += D.ncon;
  s.act = p; p += D.ncon;
  return s;
}

// out[r] = ish[r] * ((J (MJ' (ish * in)))[r] + R[r] ish[r] in[r]) for all rows
__device__ void matvec(const Smem& s, const ContactDims& D, int lane, const float* in,
                       float* out) {
  const int ncon = D.ncon, nv = D.nv;
  for (int c = lane; c < ncon; c += 32)
    for (int d = 0; d < 3; ++d) s.xs[3 * c + d] = s.ish[3 * c + d] * in[3 * c + d];
  __syncwarp();
  for (int j = lane; j < nv; j += 32) {
    float acc = 0.0f;
    for (int r = 0; r < 3 * ncon; ++r) acc += s.MJ[r * nv + j] * s.xs[r];
    s.t[j] = acc;
  }
  __syncwarp();
  for (int c = lane; c < ncon; c += 32)
    for (int d = 0; d < 3; ++d) {
      int r = 3 * c + d;
      float u = 0.0f;
      for (int j = 0; j < nv; ++j) u += s.J[r * nv + j] * s.t[j];
      out[r] = s.ish[r] * (u + s.R[r] * s.xs[r]);
    }
  __syncwarp();
}

__device__ __forceinline__ void project(const Smem& s, int c, float* f) {
  float mu = s.mus[c];
  float fn = f[0], f1 = f[1], f2 = f[2];
  float t = sqrtf(f1 * f1 + f2 * f2);
  bool inside = t <= mu * fn;
  bool below = mu * t <= -fn;
  float fn_p = (fn + mu * t) / (1.0f + mu * mu);
  float scale = mu * fn_p / fmaxf(t, 1e-12f);
  float act = s.act[c];
  if (inside) {
    f[0] = fn * act; f[1] = f1 * act; f[2] = f2 * act;
  } else if (below) {
    f[0] = 0.0f; f[1] = 0.0f; f[2] = 0.0f;
  } else {
    f[0] = fn_p * act; f[1] = f1 * scale * act; f[2] = f2 * scale * act;
  }
}

__global__ void contact_phase_kernel(
    ContactDims D, int B, const float* __restrict__ pts, const float* __restrict__ nrm,
    const float* __restrict__ dep, const float* __restrict__ axes,
    const float* __restrict__ anch, const float* __restrict__ minv,
    const float* __restrict__ v_all, const float* __restrict__ a_sm,
    const float* __restrict__ fpos, const float* __restrict__ fquat,
    const float* __restrict__ warm, const float* __restrict__ rowc,
    const float* __restrict__ mask_rob, const float* __restrict__ is_hinge,
    const int* __restrict__ side_a, const int* __restrict__ side_b,
    const float* __restrict__ inv_free, float* __restrict__ f_out,
    float* __restrict__ q_out) {
  extern __shared__ float smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * (blockDim.x >> 5) + warp;
  if (e >= B) return;  // whole warp leaves together
  const int ncon = D.ncon, nv_r = D.nv_r, nf = D.nf, nv = D.nv, n = 3 * ncon;
  Smem s = carve(smem_raw + (size_t)warp * smem_floats(D), D);

  // ---- stage per-env inputs ----
  for (int i = lane; i < nv_r * nv_r; i += 32) s.Minv[i] = minv[(size_t)i * B + e];
  for (int i = lane; i < 3 * nv_r; i += 32) {
    s.ax[i] = axes[(size_t)i * B + e];
    s.an[i] = anch[(size_t)i * B + e];
  }
  for (int i = lane; i < nv; i += 32) {
    s.v[i] = v_all[(size_t)i * B + e];
    s.a[i] = a_sm[(size_t)i * B + e];
  }
  for (int f = lane; f < nf; f += 32) {
    for (int k = 0; k < 3; ++k) s.fpos[3 * f + k] = fpos[(size_t)(3 * f + k) * B + e];
    float w = fquat[(size_t)(4 * f + 0) * B + e], x = fquat[(size_t)(4 * f + 1) * B + e];
    float y = fquat[(size_t)(4 * f + 2) * B + e], z = fquat[(size_t)(4 * f + 3) * B + e];
    float qn = fmaxf(sqrtf(w * w + x * x + y * y + z * z), 1e-12f);
    w /= qn; x /= qn; y /= qn; z /= qn;
    float* R = s.Rb + 9 * f;
    R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
    R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
    R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
  }
  __syncwarp();

  // ---- rows, M^-1 J', impedance, preconditioning (lane-local per contact) ----
  for (int c = lane; c < ncon; c += 32) {
    float p[3], nn[3];
    for (int k = 0; k < 3; ++k) {
      p[k] = pts[(size_t)(3 * c + k) * B + e];
      nn[k] = nrm[(size_t)(3 * c + k) * B + e];
    }
    // frame (n, t1, t2): t1 = n x ref, ref = z unless |n_z| >= 0.9
    bool big = fabsf(nn[2]) < 0.9f;
    float rx = big ? 0.0f : 1.0f, rz = big ? 1.0f : 0.0f;
    float t1[3] = {nn[1] * rz, nn[2] * rx - nn[0] * rz, -nn[1] * rx};
    float t1n = fmaxf(sqrtf(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]), 1e-9f);
    for (int k = 0; k < 3; ++k) t1[k] /= t1n;
    float t2[3] = {nn[1] * t1[2] - nn[2] * t1[1], nn[2] * t1[0] - nn[0] * t1[2],
                   nn[0] * t1[1] - nn[1] * t1[0]};
    const float* fr[3] = {nn, t1, t2};
    // robot columns
    for (int m = 0; m < nv_r; ++m) {
      float mk = mask_rob[c * nv_r + m];
      const float* a = s.ax + 3 * m;
      float base[3];
      if (is_hinge[m] > 0.5f) {
        float dx = p[0] - s.an[3 * m], dy = p[1] - s.an[3 * m + 1], dz = p[2] - s.an[3 * m + 2];
        base[0] = a[1] * dz - a[2] * dy;
        base[1] = a[2] * dx - a[0] * dz;
        base[2] = a[0] * dy - a[1] * dx;
      } else {
        base[0] = a[0]; base[1] = a[1]; base[2] = a[2];
      }
      for (int d = 0; d < 3; ++d)
        s.J[(3 * c + d) * nv + m] =
            mk * (fr[d][0] * base[0] + fr[d][1] * base[1] + fr[d][2] * base[2]);
    }
    // free-body columns: +side A, -side B
    for (int j = nv_r; j < nv; ++j)
      for (int d = 0; d < 3; ++d) s.J[(3 * c + d) * nv + j] = 0.0f;
    for (int sd = 0; sd < 2; ++sd) {
      int fb = sd == 0 ? side_a[c] : side_b[c];
      if (fb < 0) continue;
      float sg = sd == 0 ? 1.0f : -1.0f;
      const float* R = s.Rb + 9 * fb;
      float r[3] = {p[0] - s.fpos[3 * fb], p[1] - s.fpos[3 * fb + 1], p[2] - s.fpos[3 * fb + 2]};
      for (int d = 0; d < 3; ++d) {
        float* row = s.J + (3 * c + d) * nv + nv_r + 6 * fb;
        for (int k = 0; k < 3; ++k) row[k] += sg * fr[d][k];
        for (int jj = 0; jj < 3; ++jj) {
          // omega_body column jj: R[:, jj] x r
          float cx = R[3 + jj] * r[2] - R[6 + jj] * r[1];
          float cy = R[6 + jj] * r[0] - R[0 + jj] * r[2];
          float cz = R[0 + jj] * r[1] - R[3 + jj] * r[0];
          row[3 + jj] += sg * (fr[d][0] * cx + fr[d][1] * cy + fr[d][2] * cz);
        }
      }
    }
    // M^-1 J' rows, velocities, smooth accelerations, Delassus diagonal
    float vel[3], a0[3], diag[3];
    for (int d = 0; d < 3; ++d) {
      int rr = 3 * c + d;
      const float* Jr = s.J + rr * nv;
      float* MJr = s.MJ + rr * nv;
      for (int m = 0; m < nv_r; ++m) {
        float acc = 0.0f;
        for (int k = 0; k < nv_r; ++k) acc += Jr[k] * s.Minv[k * nv_r + m];
        MJr[m] = acc;
      }
      for (int j = nv_r; j < nv; ++j) MJr[j] = Jr[j] * inv_free[j - nv_r];
      float sv = 0.0f, sa = 0.0f, sdg = 0.0f;
      for (int j = 0; j < nv; ++j) {
        sv += Jr[j] * s.v[j];
        sa += Jr[j] * s.a[j];
        sdg += Jr[j] * MJr[j];
      }
      vel[d] = sv; a0[d] = sa; diag[d] = sdg;
    }
    const float* rc = rowc + K3_ROWC * c;
    float depth = dep[(size_t)c * B + e];
    float r_vio = -depth;
    float x = fminf(fmaxf(fabsf(r_vio) / rc[5], 0.0f), 1.0f);
    float om = 1.0f - x;
    float yv = x < rc[6] ? rc[7] * x * x : 1.0f - rc[8] * om * om;
    float d_imp = rc[3] + yv * (rc[4] - rc[3]);
    float aref[3] = {-rc[1] * vel[0] - rc[0] * d_imp * r_vio, -rc[1] * vel[1],
                     -rc[1] * vel[2]};
    float rr = (1.0f - d_imp) / fmaxf(d_imp, 1e-6f);
    float R3[3] = {rr * diag[0], rr * diag[1] / D.impratio, rr * diag[2] / D.impratio};
    float sn = fmaxf(diag[0] + R3[0], 1e-10f);
    float st = fmaxf(0.5f * ((diag[1] + R3[1]) + (diag[2] + R3[2])), 1e-10f);
    float act = depth > 0.0f ? 1.0f : 0.0f;
    s.act[c] = act;
    s.mus[c] = rc[2] * sqrtf(st / sn);
    float sh3[3] = {sqrtf(sn), sqrtf(st), sqrtf(st)};
    float f0[3];
    for (int d = 0; d < 3; ++d) {
      int r = 3 * c + d;
      s.R[r] = R3[d];
      s.sh[r] = sh3[d];
      s.ish[r] = act / sh3[d];
      s.bh[r] = (a0[d] - aref[d]) * s.ish[r];
      f0[d] = warm[(size_t)r * B + e] * sh3[d] * act;
    }
    project(s, c, f0);
    for (int d = 0; d < 3; ++d) {
      s.fh[3 * c + d] = f0[d];
      s.y[3 * c + d] = f0[d];
    }
  }
  __syncwarp();

  // ---- step size: power iteration on the scaled Delassus operator ----
  float* vit = s.vit;
  float* gout = s.g;
  for (int c = lane; c < ncon; c += 32)
    for (int d = 0; d < 3; ++d) vit[3 * c + d] = 1.0f;
  __syncwarp();
  for (int it = 0; it < 6; ++it) {
    matvec(s, D, lane, vit, gout);
    float ss = 0.0f;
    for (int c = lane; c < ncon; c += 32)
      for (int d = 0; d < 3; ++d) ss += gout[3 * c + d] * gout[3 * c + d];
    float nrm_v = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
    for (int c = lane; c < ncon; c += 32)
      for (int d = 0; d < 3; ++d) vit[3 * c + d] = gout[3 * c + d] / nrm_v;
    __syncwarp();
  }
  matvec(s, D, lane, vit, gout);
  float rq = 0.0f;
  for (int c = lane; c < ncon; c += 32)
    for (int d = 0; d < 3; ++d) rq += vit[3 * c + d] * gout[3 * c + d];
  const float step = 1.0f / (1.5f * fmaxf(warp_sum(rq), 1.0f));

  // ---- Nesterov APGD with adaptive restart ----
  float theta = 1.0f;
  for (int it = 0; it < D.n_iters; ++it) {
    matvec(s, D, lane, s.y, gout);
    float gd = 0.0f;
    for (int c = lane; c < ncon; c += 32) {
      float fn[3];
      for (int d = 0; d < 3; ++d) {
        int r = 3 * c + d;
        gout[r] += s.bh[r];
        fn[d] = s.y[r] - step * gout[r];
      }
      project(s, c, fn);
      for (int d = 0; d < 3; ++d) {
        int r = 3 * c + d;
        float df = fn[d] - s.fh[r];
        gd += gout[r] * df;
        vit[r] = df;  // keep df for the momentum update
        s.fh[r] = fn[d];
      }
    }
    bool restart = warp_sum(gd) > 0.0f;
    if (restart) theta = 1.0f;
    float th2 = theta * theta;
    float theta_new = 0.5f * (sqrtf(th2 * th2 + 4.0f * th2) - th2);
    float beta = restart ? 0.0f : theta * (1.0f - theta) / (th2 + theta_new);
    for (int c = lane; c < ncon; c += 32)
      for (int d = 0; d < 3; ++d) {
        int r = 3 * c + d;
        s.y[r] = s.fh[r] + beta * vit[r];
      }
    theta = theta_new;
    __syncwarp();
  }

  // ---- forces and generalized contact forces ----
  for (int c = lane; c < ncon; c += 32)
    for (int d = 0; d < 3; ++d) {
      int r = 3 * c + d;
      float f = s.fh[r] / s.sh[r] * s.act[c];
      s.xs[r] = f;
      f_out[(size_t)r * B + e] = f;
    }
  __syncwarp();
  for (int j = lane; j < nv; j += 32) {
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) acc += s.J[r * nv + j] * s.xs[r];
    q_out[(size_t)j * B + e] = acc;
  }
}

extern "C" int d3il_contact_phase(ContactDims D, int B, const float* pts, const float* nrm,
                                  const float* dep, const float* axes, const float* anch,
                                  const float* minv, const float* v_all, const float* a_sm,
                                  const float* fpos, const float* fquat, const float* warm,
                                  const float* rowc, const float* mask_rob,
                                  const float* is_hinge, const int* side_a, const int* side_b,
                                  const float* inv_free, float* f_out, float* q_out,
                                  void* stream) {
  size_t per_env = (size_t)smem_floats(D) * sizeof(float);
  const size_t kMaxSmem = 232448;  // 227 KB usable by one block on sm_90
  if (per_env > kMaxSmem) return (int)cudaErrorInvalidValue;
  int W = (int)((48 * 1024) / per_env);
  W = W < 1 ? 1 : (W > 4 ? 4 : W);
  size_t bytes = per_env * W;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        contact_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (B + W - 1) / W;
  contact_phase_kernel<<<blocks, 32 * W, bytes, (cudaStream_t)stream>>>(
      D, B, pts, nrm, dep, axes, anch, minv, v_all, a_sm, fpos, fquat, warm, rowc, mask_rob,
      is_hinge, side_a, side_b, inv_free, f_out, q_out);
  return (int)cudaGetLastError();
}
