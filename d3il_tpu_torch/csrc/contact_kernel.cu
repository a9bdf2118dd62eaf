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
// plain version does 32 Delassus matvecs (6 power + 1 Rayleigh + 25 APGD) of
// 2 x n x nv multiply-adds (pushing: n = 54 rows, nv = 21, ~72.6 k MACs;
// ~0.21 M flop with the row assembly) while it reads and writes ~1.8 KB
// (446 floats). The work per env is a chain of small dependent steps, so
// what limits a kernel here is the latency of that chain and how many envs
// hide it, not the FMA rate.
//
// Two variants, one warp per env in both:
//
// * Register variant (n <= 56 rows, nv_r <= 9; pushing, 54 rows). Lane l
//   owns rows l and l + 32, so all 32 lanes work in the row-local parts
//   (frames, rows, impedance, projection). The scaled Delassus matrix
//   A = diag(ish) J M^-1 J' diag(ish) is formed once per call (each lane
//   its two rows, the columns padded to K3_REG_NC = 56) and held in
//   registers; each matvec is then one register-fed pass per lane with x
//   broadcast from shared memory as float4 and four partial sums per row,
//   instead of two serial shared-memory-fed loops. J is kept transposed in
//   shared memory (a lane's own column is conflict-free, a row is a
//   broadcast float4 read): 6.9 KB per env for pushing. The
//   three rows of a contact meet through shared memory for the cone
//   projection, which each of them computes; the restart test, the step
//   size and theta come from __shfl_xor_sync reductions, so they are
//   uniform over the warp. The momentum terms of both restart outcomes are
//   formed while the restart test's reduction runs. Per-env inputs are
//   staged into shared memory before any is used, and the scene's tables
//   once per block. Registers, not shared memory, bound residency: capped
//   at 168 (three 4-warp blocks per SM). Its divisions and square roots
//   sit on the chain and use the approximate forms (div_fast, sqrt_fast).
//   One width serves pushing, the only scene the port runs; a scene that
//   needs another width adds its own instance.
// * General variant (any scene whose per-env working set fits a block's
//   shared memory): J and M^-1 J' in shared memory, lane c owns contact c,
//   the matvec's dof half lane-strided, IEEE division and square root. It
//   serves scenes of more than 56 rows (sorting with 4 or 6 boxes).
//
// The factored form with J and M^-1 J' tiles in registers was not built: a
// row-per-lane matvec in that form needs a cross-lane reduction of the nv
// partial sums of J' x (31 shuffles a matvec, at a quarter of the FMA rate)
// on top of the same 2 x 2 x nv FMAs, against 2 x NC FMAs and NC / 4
// broadcast loads for the formed matrix, whose formation (nv x NC / 4 float4
// loads and 2 x nv x NC FMAs a lane) is paid once for 32 matvecs.
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

// the register variant's division and square root, on its serial chain
// only: PTX div.full.f32 (at most 2 ulp) and sqrt.approx.f32; host code
// takes the IEEE forms
__device__ __forceinline__ float div_fast(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("div.full.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a / b;
#endif
}

__device__ __forceinline__ float sqrt_fast(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return sqrtf(x);
#endif
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

// friction-cone projection of one contact's scaled force (n, t1, t2);
// FAST: the register variant's division and square root
template <bool FAST>
__device__ __forceinline__ void project(float mu, float act, float* f) {
  float fn = f[0], f1 = f[1], f2 = f[2];
  float t = FAST ? sqrt_fast(f1 * f1 + f2 * f2) : sqrtf(f1 * f1 + f2 * f2);
  bool inside = t <= mu * fn;
  bool below = mu * t <= -fn;
  float fn_p = FAST ? div_fast(fn + mu * t, 1.0f + mu * mu) : (fn + mu * t) / (1.0f + mu * mu);
  float scale = FAST ? div_fast(mu * fn_p, fmaxf(t, 1e-12f)) : mu * fn_p / fmaxf(t, 1e-12f);
  if (inside) {
    f[0] = fn * act; f[1] = f1 * act; f[2] = f2 * act;
  } else if (below) {
    f[0] = 0.0f; f[1] = 0.0f; f[2] = 0.0f;
  } else {
    f[0] = fn_p * act; f[1] = f1 * scale * act; f[2] = f2 * scale * act;
  }
}

__global__ void contact_phase_general_kernel(
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
    project<false>(s.mus[c], s.act[c], f0);
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
      project<false>(s.mus[c], s.act[c], fn);
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

// ---------------------------------------------------------------------------
// Register variant: one warp per env, lane l owns rows l and l + 32 (RPL
// rows); the scaled Delassus matrix A = diag(ish) J M^-1 J' diag(ish) is
// formed once, each lane's rows of it in registers, padded to K3_REG_NC
// columns.
// ---------------------------------------------------------------------------
#define K3_MAXVR 9          // robot dofs the register variant takes
#define K3_REG_NC 56        // rows (columns of A) it takes, padded: pushing's 54
#define K3_REG_WARPS 4      // envs (warps) per block
#define K3_REG_MINB 3       // blocks per SM asked of ptxas: caps registers at 168

// per-env shared memory of the register variant, in floats
__host__ __device__ inline int reg_smem_floats(const ContactDims& D) {
  const int nc = K3_REG_NC;
  int f = D.nv * nc + 3 * nc + D.nv_r * D.nv_r + 6 * D.nv_r + 12 * D.nf + 2 * D.nv
          + 10 * D.ncon;
  return (f + 3) / 4 * 4;
}

// the scene's row tables, staged once per block, in floats
__host__ __device__ inline int reg_table_floats(const ContactDims& D) {
  int f = K3_ROWC * D.ncon + D.ncon * D.nv_r + D.nv_r + 2 * D.ncon + 6 * D.nf;
  return (f + 3) / 4 * 4;
}

// out_s = sum_j A[s][j] x[j] (x broadcast from shared memory, four partial
// sums per row) + Rd_s xs_s, for the RPL rows of this lane
template <int NC, int RPL>
__device__ __forceinline__ void reg_matvec(const float (&A)[RPL][NC], const float* x,
                                           const float (&Rd)[RPL], const float (&xs)[RPL],
                                           float (&out)[RPL]) {
  float acc[RPL][4];
#pragma unroll
  for (int s = 0; s < RPL; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[s][i] = 0.0f;
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int q = 0; q < NC / 4; ++q) {
    float4 t = x4[q];
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      acc[s][0] = fmaf(A[s][4 * q + 0], t.x, acc[s][0]);
      acc[s][1] = fmaf(A[s][4 * q + 1], t.y, acc[s][1]);
      acc[s][2] = fmaf(A[s][4 * q + 2], t.z, acc[s][2]);
      acc[s][3] = fmaf(A[s][4 * q + 3], t.w, acc[s][3]);
    }
  }
#pragma unroll
  for (int s = 0; s < RPL; ++s)
    out[s] = ((acc[s][0] + acc[s][1]) + (acc[s][2] + acc[s][3])) + Rd[s] * xs[s];
}

__global__ void __launch_bounds__(32 * K3_REG_WARPS, K3_REG_MINB) contact_phase_reg_kernel(
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
  constexpr int NC = K3_REG_NC, RPL = (NC + 31) / 32;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * K3_REG_WARPS + warp;
  const int ncon = D.ncon, nv_r = D.nv_r, nf = D.nf, nv = D.nv, n = 3 * ncon;
  // the block's copy of the scene tables, then per env: JT [nv][NC] (J
  // transposed: a lane's own column is conflict-free, a row is a broadcast
  // float4 read), Y, Z, ISH [NC], then the env's staged inputs
  float* tab = reinterpret_cast<float*>(smem4);
  float* t_rowc = tab;
  float* t_mask = t_rowc + K3_ROWC * ncon;
  float* t_hinge = t_mask + ncon * nv_r;
  int* t_side = reinterpret_cast<int*>(t_hinge + nv_r);  // side A [ncon], B [ncon]
  float* t_invf = reinterpret_cast<float*>(t_side + 2 * ncon);
  for (int i = threadIdx.x; i < K3_ROWC * ncon; i += 32 * K3_REG_WARPS) t_rowc[i] = rowc[i];
  for (int i = threadIdx.x; i < ncon * nv_r; i += 32 * K3_REG_WARPS) t_mask[i] = mask_rob[i];
  for (int i = threadIdx.x; i < nv_r; i += 32 * K3_REG_WARPS) t_hinge[i] = is_hinge[i];
  for (int i = threadIdx.x; i < ncon; i += 32 * K3_REG_WARPS) {
    t_side[i] = side_a[i];
    t_side[ncon + i] = side_b[i];
  }
  for (int i = threadIdx.x; i < 6 * nf; i += 32 * K3_REG_WARPS) t_invf[i] = inv_free[i];
  __syncthreads();
  if (e >= B) return;  // whole warp leaves together (ragged last block)
  float* JT = tab + reg_table_floats(D) + (size_t)warp * reg_smem_floats(D);
  float* Y = JT + nv * NC;
  float* Z = Y + NC;
  float* ISH = Z + NC;
  float* sMinv = ISH + NC;
  float* sax = sMinv + nv_r * nv_r;
  float* san = sax + 3 * nv_r;
  float* sfpos = san + 3 * nv_r;
  float* sRb = sfpos + 3 * nf;
  float* sv = sRb + 9 * nf;
  float* sa = sv + nv;
  float* spts = sa + nv;
  float* snrm = spts + 3 * ncon;
  float* swarm = snrm + 3 * ncon;
  float* sdep = swarm + 3 * ncon;

  // ---- stage per-env inputs: every load issued before any is used (a
  // block-wide copy with consecutive threads on consecutive envs measured
  // slower: it holds the block's warps at one barrier) ----
  for (int i = lane; i < nv_r * nv_r; i += 32) sMinv[i] = minv[(size_t)i * B + e];
  for (int i = lane; i < 3 * nv_r; i += 32) {
    sax[i] = axes[(size_t)i * B + e];
    san[i] = anch[(size_t)i * B + e];
  }
  for (int i = lane; i < nv; i += 32) {
    sv[i] = v_all[(size_t)i * B + e];
    sa[i] = a_sm[(size_t)i * B + e];
  }
  for (int i = lane; i < 3 * ncon; i += 32) {
    spts[i] = pts[(size_t)i * B + e];
    snrm[i] = nrm[(size_t)i * B + e];
    swarm[i] = warm[(size_t)i * B + e];
  }
  for (int i = lane; i < ncon; i += 32) sdep[i] = dep[(size_t)i * B + e];
  for (int f = lane; f < nf; f += 32) {
    for (int k = 0; k < 3; ++k) sfpos[3 * f + k] = fpos[(size_t)(3 * f + k) * B + e];
    float w = fquat[(size_t)(4 * f + 0) * B + e], x = fquat[(size_t)(4 * f + 1) * B + e];
    float y = fquat[(size_t)(4 * f + 2) * B + e], z = fquat[(size_t)(4 * f + 3) * B + e];
    float qn = fmaxf(sqrt_fast(w * w + x * x + y * y + z * z), 1e-12f);
    w = div_fast(w, qn); x = div_fast(x, qn); y = div_fast(y, qn); z = div_fast(z, qn);
    float* R = sRb + 9 * f;
    R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
    R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
    R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
  }
  __syncwarp();

  // ---- rows (lane-local per row): J column of JT, velocity, smooth
  // acceleration; then M^-1 J' robot part and the Delassus diagonal ----
  float Jr[RPL][K3_MAXVR], MJr[RPL][K3_MAXVR], vel[RPL], a0[RPL], dfree[RPL];
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    const int r = lane + 32 * s;
    vel[s] = 0.0f; a0[s] = 0.0f; dfree[s] = 0.0f;
#pragma unroll
    for (int m = 0; m < K3_MAXVR; ++m) Jr[s][m] = 0.0f;
    if (r >= NC) continue;
    if (r >= n) {  // padding row: zero column, zero scale
      for (int k = 0; k < nv; ++k) JT[k * NC + r] = 0.0f;
      Y[r] = 0.0f; Z[r] = 0.0f; ISH[r] = 0.0f;
      continue;
    }
    const int c = r / 3, d = r - 3 * (r / 3);
    float p[3], nn[3];
    for (int k = 0; k < 3; ++k) {
      p[k] = spts[3 * c + k];
      nn[k] = snrm[3 * c + k];
    }
    // frame (n, t1, t2): t1 = n x ref, ref = z unless |n_z| >= 0.9; this
    // row's direction fd
    bool big = fabsf(nn[2]) < 0.9f;
    float rx = big ? 0.0f : 1.0f, rz = big ? 1.0f : 0.0f;
    float t1[3] = {nn[1] * rz, nn[2] * rx - nn[0] * rz, -nn[1] * rx};
    float t1n = fmaxf(sqrt_fast(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]), 1e-9f);
    for (int k = 0; k < 3; ++k) t1[k] = div_fast(t1[k], t1n);
    float t2[3] = {nn[1] * t1[2] - nn[2] * t1[1], nn[2] * t1[0] - nn[0] * t1[2],
                   nn[0] * t1[1] - nn[1] * t1[0]};
    float fd[3];
    for (int k = 0; k < 3; ++k) fd[k] = d == 0 ? nn[k] : (d == 1 ? t1[k] : t2[k]);
    // robot columns
    float sv_ = 0.0f, sa_ = 0.0f, sdg = 0.0f;
#pragma unroll
    for (int m = 0; m < K3_MAXVR; ++m) {
      if (m >= nv_r) continue;
      float mk = t_mask[c * nv_r + m];
      const float* a = sax + 3 * m;
      float base[3];
      if (t_hinge[m] > 0.5f) {
        float dx = p[0] - san[3 * m], dy = p[1] - san[3 * m + 1], dz = p[2] - san[3 * m + 2];
        base[0] = a[1] * dz - a[2] * dy;
        base[1] = a[2] * dx - a[0] * dz;
        base[2] = a[0] * dy - a[1] * dx;
      } else {
        base[0] = a[0]; base[1] = a[1]; base[2] = a[2];
      }
      Jr[s][m] = mk * (fd[0] * base[0] + fd[1] * base[1] + fd[2] * base[2]);
      JT[m * NC + r] = Jr[s][m];
      sv_ += Jr[s][m] * sv[m];
      sa_ += Jr[s][m] * sa[m];
    }
    // free-body columns: +side A, -side B; per body the 3 linear columns
    // (the direction) and the 3 angular ones (R[:, jj] x r . direction)
    const int fa = t_side[c], fb = t_side[ncon + c];
    float ca[6], cb[6];
    for (int sd = 0; sd < 2; ++sd) {
      int body = sd == 0 ? fa : fb;
      float* cc = sd == 0 ? ca : cb;
      if (body < 0) {
        for (int w = 0; w < 6; ++w) cc[w] = 0.0f;
        continue;
      }
      const float* R = sRb + 9 * body;
      float rv[3] = {p[0] - sfpos[3 * body], p[1] - sfpos[3 * body + 1],
                     p[2] - sfpos[3 * body + 2]};
      for (int k = 0; k < 3; ++k) cc[k] = fd[k];
      for (int jj = 0; jj < 3; ++jj) {
        float cx = R[3 + jj] * rv[2] - R[6 + jj] * rv[1];
        float cy = R[6 + jj] * rv[0] - R[0 + jj] * rv[2];
        float cz = R[0 + jj] * rv[1] - R[3 + jj] * rv[0];
        cc[3 + jj] = fd[0] * cx + fd[1] * cy + fd[2] * cz;
      }
    }
    for (int blk = 0; blk < nf; ++blk) {
#pragma unroll
      for (int w = 0; w < 6; ++w) {
        const int k = nv_r + 6 * blk + w;
        float val = 0.0f;
        if (blk == fa) val += ca[w];
        if (blk == fb) val += -cb[w];
        JT[k * NC + r] = val;
        sv_ += val * sv[k];
        sa_ += val * sa[k];
        sdg += val * (val * t_invf[6 * blk + w]);
      }
    }
    vel[s] = sv_; a0[s] = sa_; dfree[s] = sdg;
  }
  // M^-1 J' robot part for both rows of the lane (each Minv entry read
  // once), the Delassus diagonal into Z for the contact's three rows
#pragma unroll
  for (int m = 0; m < K3_MAXVR; ++m) {
#pragma unroll
    for (int s = 0; s < RPL; ++s) MJr[s][m] = 0.0f;
    if (m >= nv_r) continue;
#pragma unroll
    for (int k = 0; k < K3_MAXVR; ++k) {
      if (k >= nv_r) continue;
      const float mv = sMinv[k * nv_r + m];
#pragma unroll
      for (int s = 0; s < RPL; ++s) MJr[s][m] += Jr[s][k] * mv;
    }
  }
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    const int r = lane + 32 * s;
    float dr = 0.0f;
#pragma unroll
    for (int m = 0; m < K3_MAXVR; ++m) dr += Jr[s][m] * MJr[s][m];
    if (r < n) Z[r] = dr + dfree[s];
  }
  __syncwarp();

  // ---- impedance, regularization, preconditioning, warm start (each row
  // computes its contact's terms from the three diagonals) ----
  float mu[RPL], act[RPL], sh[RPL], ish[RPL], Rd[RPL], bh[RPL], fh[RPL], y[RPL];
  int base3[RPL], dd[RPL];
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    const int r = lane + 32 * s;
    mu[s] = 0.0f; act[s] = 0.0f; sh[s] = 1.0f; ish[s] = 0.0f; Rd[s] = 0.0f;
    bh[s] = 0.0f; fh[s] = 0.0f; y[s] = 0.0f; base3[s] = 0; dd[s] = 0;
    if (r >= n) continue;
    const int c = r / 3, d = r - 3 * (r / 3);
    base3[s] = 3 * c; dd[s] = d;
    const float diag[3] = {Z[3 * c], Z[3 * c + 1], Z[3 * c + 2]};
    const float* rc = t_rowc + K3_ROWC * c;
    float depth = sdep[c];
    float r_vio = -depth;
    float x = fminf(fmaxf(div_fast(fabsf(r_vio), rc[5]), 0.0f), 1.0f);
    float om = 1.0f - x;
    float yv = x < rc[6] ? rc[7] * x * x : 1.0f - rc[8] * om * om;
    float d_imp = rc[3] + yv * (rc[4] - rc[3]);
    float aref = d == 0 ? -rc[1] * vel[s] - rc[0] * d_imp * r_vio : -rc[1] * vel[s];
    float rr = div_fast(1.0f - d_imp, fmaxf(d_imp, 1e-6f));
    float R3[3] = {rr * diag[0], div_fast(rr * diag[1], D.impratio),
                   div_fast(rr * diag[2], D.impratio)};
    float sn = fmaxf(diag[0] + R3[0], 1e-10f);
    float st = fmaxf(0.5f * ((diag[1] + R3[1]) + (diag[2] + R3[2])), 1e-10f);
    act[s] = depth > 0.0f ? 1.0f : 0.0f;
    mu[s] = rc[2] * sqrt_fast(div_fast(st, sn));
    float sh3[3] = {sqrt_fast(sn), sqrt_fast(st), sqrt_fast(st)};
    sh[s] = sh3[d];
    ish[s] = div_fast(act[s], sh3[d]);
    Rd[s] = ish[s] * ish[s] * R3[d];
    bh[s] = (a0[s] - aref) * ish[s];
    float f0[3];
    for (int k = 0; k < 3; ++k) f0[k] = swarm[3 * c + k] * sh3[k] * act[s];
    project<true>(mu[s], act[s], f0);
    fh[s] = f0[d];
    y[s] = f0[d];
    ISH[r] = ish[s];
  }
  __syncwarp();

  // ---- A = diag(ish) J M^-1 J' diag(ish), this lane's rows, in registers:
  // A[s][j] = ish_s ish_j sum_k MJ[r][k] J[j][k] ----
  float A[RPL][NC];
#pragma unroll
  for (int s = 0; s < RPL; ++s)
#pragma unroll
    for (int j = 0; j < NC; ++j) A[s][j] = 0.0f;
  const float4* JT4 = reinterpret_cast<const float4*>(JT);
#pragma unroll
  for (int k = 0; k < K3_MAXVR; ++k) {
    if (k >= nv_r) break;
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      float4 t = JT4[k * (NC / 4) + q];
#pragma unroll
      for (int s = 0; s < RPL; ++s) {
        A[s][4 * q + 0] = fmaf(MJr[s][k], t.x, A[s][4 * q + 0]);
        A[s][4 * q + 1] = fmaf(MJr[s][k], t.y, A[s][4 * q + 1]);
        A[s][4 * q + 2] = fmaf(MJr[s][k], t.z, A[s][4 * q + 2]);
        A[s][4 * q + 3] = fmaf(MJr[s][k], t.w, A[s][4 * q + 3]);
      }
    }
  }
  for (int k = nv_r; k < nv; ++k) {
    float coef[RPL];
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      const int r = lane + 32 * s;
      coef[s] = r < n ? JT[k * NC + r] * t_invf[k - nv_r] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      float4 t = JT4[k * (NC / 4) + q];
#pragma unroll
      for (int s = 0; s < RPL; ++s) {
        A[s][4 * q + 0] = fmaf(coef[s], t.x, A[s][4 * q + 0]);
        A[s][4 * q + 1] = fmaf(coef[s], t.y, A[s][4 * q + 1]);
        A[s][4 * q + 2] = fmaf(coef[s], t.z, A[s][4 * q + 2]);
        A[s][4 * q + 3] = fmaf(coef[s], t.w, A[s][4 * q + 3]);
      }
    }
  }
  {
    const float4* I4 = reinterpret_cast<const float4*>(ISH);
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      float4 t = I4[q];
#pragma unroll
      for (int s = 0; s < RPL; ++s) {
        A[s][4 * q + 0] *= ish[s] * t.x;
        A[s][4 * q + 1] *= ish[s] * t.y;
        A[s][4 * q + 2] *= ish[s] * t.z;
        A[s][4 * q + 3] *= ish[s] * t.w;
      }
    }
  }

  // ---- step size: power iteration on A + diag(Rd) ----
  float v[RPL], g[RPL];
#pragma unroll
  for (int s = 0; s < RPL; ++s) v[s] = lane + 32 * s < n ? 1.0f : 0.0f;
  for (int it = 0; it <= 6; ++it) {
#pragma unroll
    for (int s = 0; s < RPL; ++s)
      if (lane + 32 * s < NC) Y[lane + 32 * s] = v[s];
    __syncwarp();
    reg_matvec<NC, RPL>(A, Y, Rd, v, g);
    __syncwarp();
    if (it == 6) break;
    float ss = 0.0f;
#pragma unroll
    for (int s = 0; s < RPL; ++s) ss += g[s] * g[s];
    float nrm_v = fmaxf(sqrt_fast(warp_sum(ss)), 1e-12f);
#pragma unroll
    for (int s = 0; s < RPL; ++s) v[s] = div_fast(g[s], nrm_v);
  }
  float rq = 0.0f;
#pragma unroll
  for (int s = 0; s < RPL; ++s) rq += v[s] * g[s];
  const float step = div_fast(1.0f, 1.5f * fmaxf(warp_sum(rq), 1.0f));

  // ---- Nesterov APGD with adaptive restart: y in Y for the matvec, the
  // unprojected step in Z for the cone projection ----
#pragma unroll
  for (int s = 0; s < RPL; ++s)
    if (lane + 32 * s < NC) Y[lane + 32 * s] = y[s];
  __syncwarp();
  float theta = 1.0f;
  const float tn_restart = 0.5f * (sqrtf(1.0f + 4.0f) - 1.0f);
  for (int it = 0; it < D.n_iters; ++it) {
    reg_matvec<NC, RPL>(A, Y, Rd, y, g);
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      g[s] += bh[s];
      if (lane + 32 * s < NC) Z[lane + 32 * s] = y[s] - step * g[s];
    }
    __syncwarp();
    float gd = 0.0f, df[RPL];
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      float fz[3] = {Z[base3[s]], Z[base3[s] + 1], Z[base3[s] + 2]};
      project<true>(mu[s], act[s], fz);
      float fn = dd[s] == 0 ? fz[0] : (dd[s] == 1 ? fz[1] : fz[2]);
      if (lane + 32 * s >= n) fn = 0.0f;
      df[s] = fn - fh[s];
      gd += g[s] * df[s];
      fh[s] = fn;
    }
    // the momentum terms of both outcomes are formed while the restart
    // test's reduction runs (a restart sets theta = 1, then beta = 0)
    float th2 = theta * theta;
    float tn_keep = 0.5f * (sqrt_fast(th2 * th2 + 4.0f * th2) - th2);
    float beta_keep = div_fast(theta * (1.0f - theta), th2 + tn_keep);
    bool restart = warp_sum(gd) > 0.0f;
    float theta_new = restart ? tn_restart : tn_keep;
    float beta = restart ? 0.0f : beta_keep;
#pragma unroll
    for (int s = 0; s < RPL; ++s) {
      y[s] = fh[s] + beta * df[s];
      if (lane + 32 * s < NC) Y[lane + 32 * s] = y[s];
    }
    theta = theta_new;
    __syncwarp();
  }

  // ---- forces and generalized contact forces qfrc = J' f ----
#pragma unroll
  for (int s = 0; s < RPL; ++s) {
    const int r = lane + 32 * s;
    if (r >= NC) continue;
    float f = r < n ? div_fast(fh[s], sh[s]) * act[s] : 0.0f;
    Z[r] = f;
    if (r < n) f_out[(size_t)r * B + e] = f;
  }
  __syncwarp();
  const float4* F4 = reinterpret_cast<const float4*>(Z);
  for (int k = lane; k < nv; k += 32) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      float4 t = JT4[k * (NC / 4) + q], fq = F4[q];
      acc[0] = fmaf(t.x, fq.x, acc[0]);
      acc[1] = fmaf(t.y, fq.y, acc[1]);
      acc[2] = fmaf(t.z, fq.z, acc[2]);
      acc[3] = fmaf(t.w, fq.w, acc[3]);
    }
    q_out[(size_t)k * B + e] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

#define K3_ARGS                                                                       \
  D, B, pts, nrm, dep, axes, anch, minv, v_all, a_sm, fpos, fquat, warm, rowc, mask_rob, \
      is_hinge, side_a, side_b, inv_free, f_out, q_out

static int launch_reg(ContactDims D, int B, const float* pts, const float* nrm,
                      const float* dep, const float* axes, const float* anch,
                      const float* minv, const float* v_all, const float* a_sm,
                      const float* fpos, const float* fquat, const float* warm,
                      const float* rowc, const float* mask_rob, const float* is_hinge,
                      const int* side_a, const int* side_b, const float* inv_free,
                      float* f_out, float* q_out, cudaStream_t stream) {
  size_t bytes =
      ((size_t)reg_table_floats(D) + (size_t)reg_smem_floats(D) * K3_REG_WARPS) * sizeof(float);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;  // 227 KB per block
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        contact_phase_reg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (B + K3_REG_WARPS - 1) / K3_REG_WARPS;
  contact_phase_reg_kernel<<<blocks, 32 * K3_REG_WARPS, bytes, stream>>>(K3_ARGS);
  return (int)cudaGetLastError();
}

// variant 1: register variant (n <= K3_REG_NC rows, nv_r <= 9); variant 2:
// the general shared-memory variant
extern "C" int d3il_contact_phase(ContactDims D, int variant, int B, const float* pts,
                                  const float* nrm, const float* dep, const float* axes,
                                  const float* anch, const float* minv, const float* v_all,
                                  const float* a_sm, const float* fpos, const float* fquat,
                                  const float* warm, const float* rowc, const float* mask_rob,
                                  const float* is_hinge, const int* side_a, const int* side_b,
                                  const float* inv_free, float* f_out, float* q_out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    if (D.nv_r > K3_MAXVR || 3 * D.ncon > K3_REG_NC) return (int)cudaErrorInvalidValue;
    return launch_reg(K3_ARGS, st);
  }
  if (variant != 2) return (int)cudaErrorInvalidValue;
  size_t per_env = (size_t)smem_floats(D) * sizeof(float);
  const size_t kMaxSmem = 232448;  // 227 KB usable by one block on sm_90
  if (per_env > kMaxSmem) return (int)cudaErrorInvalidValue;
  int W = (int)((48 * 1024) / per_env);
  W = W < 1 ? 1 : (W > 4 ? 4 : W);
  size_t bytes = per_env * W;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        contact_phase_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = (B + W - 1) / W;
  contact_phase_general_kernel<<<blocks, 32 * W, bytes, st>>>(K3_ARGS);
  return (int)cudaGetLastError();
}
