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
// Two kernels, one warp per env and four envs per block in both:
//
// * Register variant, contact_phase_reg_kernel (scenes of at most 56 rows,
//   nv_r <= 9: pushing's 54, avoiding's 24). Lane l owns rows l and l + 32,
//   so all 32 lanes work in the row-local parts (frames, rows, impedance,
//   projection). The scaled Delassus matrix A = diag(ish) J M^-1 J'
//   diag(ish) is formed once per call (each lane its two rows, the columns
//   padded to K3_REG_NC = 56) and held in registers; each matvec is then one
//   register-fed pass per lane with x broadcast from shared memory as float4
//   and four partial sums per row, instead of two serial shared-memory-fed
//   loops. J is kept transposed in shared memory (a lane's own column is
//   conflict-free, a row is a broadcast float4 read): 6.9 KB per env for
//   pushing. The three rows of a contact meet through shared memory for the
//   cone projection, which each of them computes; the restart test, the
//   step size and theta come from __shfl_xor_sync reductions, so they are
//   uniform over the warp. The momentum terms of both restart outcomes are
//   formed while the restart test's reduction runs. Per-env inputs are
//   staged into shared memory before any is used, and the scene's tables
//   once per block. Registers, not shared memory, bound residency: capped
//   at 168 (three 4-warp blocks per SM). Its divisions and square roots sit
//   on the chain and use the approximate forms (div_fast, sqrt_fast).
// * Compact variant, contact_phase_compact_kernel (every larger scene:
//   aligning, sorting, stacking, inserting). A contact with depth <= 0 adds
//   exact zeros to every product of the solve (its rows are scaled by act =
//   0 from the first matvec on), so the warp first compacts the env's active
//   contacts in row order (__ballot_sync over the depth row, __popc of the
//   lower lanes' bits for each one's place), writes f = 0 on the others and
//   solves only the active ones: 3.5-15x fewer rows on the scenes' held
//   substeps. An env whose active rows fit 56 takes the register variant's
//   solve on them; a larger one the factored form: J and the robot part of
//   M^-1 J' of its active rows, lane c on contact c in the row-local parts,
//   each matvec t = (M^-1 J')' x over lanes on the dofs (four partial sums),
//   then J t over lanes on the rows. Shared memory is sized at launch, with
//   no read of the counts on the host, for `cap` active contacts per env,
//   which the wrapper picks (engine/contact_kernel.py: geometry); an env
//   above the cap runs the same factored solve on its slot of a global
//   workspace that the wrapper allocates.
//   Both forms take the approximate division and square root.
//
// For the register variant, a factored form with J and M^-1 J' tiles in
// registers was not built: a row-per-lane matvec in that form needs a
// cross-lane reduction of the nv partial sums of J' x (31 shuffles a
// matvec, at a quarter of the FMA rate) on top of the same 2 x 2 x nv FMAs,
// against 2 x NC FMAs and NC / 4 broadcast loads for the formed matrix,
// whose formation (nv x NC / 4 float4 loads and 2 x nv x NC FMAs a lane) is
// paid once for 32 matvecs. The compact variant's envs above 56 rows keep
// the factored form in shared memory instead of forming A there: A takes
// n^2 floats (7,056 at sorting_6's 84 rows, beside the n (nv + nv_r) of the
// factored rows) and n^2 nv FMAs to form: n / 2 factored matvecs' worth (42
// at 84 rows), more than the 32 a call runs.
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

// division and square root on the solves' serial chains: PTX div.full.f32
// (at most 2 ulp) and sqrt.approx.f32; host code takes the IEEE forms
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

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// friction-cone projection of one contact's scaled force (n, t1, t2)
__device__ __forceinline__ void project(float mu, float act, float* f) {
  float fn = f[0], f1 = f[1], f2 = f[2];
  float t = sqrt_fast(f1 * f1 + f2 * f2);
  bool inside = t <= mu * fn;
  bool below = mu * t <= -fn;
  float fn_p = div_fast(fn + mu * t, 1.0f + mu * mu);
  float scale = div_fast(mu * fn_p, fmaxf(t, 1e-12f));
  if (inside) {
    f[0] = fn * act; f[1] = f1 * act; f[2] = f2 * act;
  } else if (below) {
    f[0] = 0.0f; f[1] = 0.0f; f[2] = 0.0f;
  } else {
    f[0] = fn_p * act; f[1] = f1 * scale * act; f[2] = f2 * scale * act;
  }
}

#define K3_MAXVR 9          // robot dofs the register form takes
#define K3_REG_NC 56        // rows (columns of A) it takes, padded: pushing's 54
#define K3_REG_WARPS 4      // envs (warps) per block, both kernels
#define K3_REG_MINB 3       // blocks per SM asked of ptxas: caps registers at 168

// the kernels' batch-minor inputs
struct Inputs {
  const float *pts, *nrm, *dep, *axes, *anch, *minv, *v_all, *a_sm, *fpos, *fquat, *warm;
};

// the scene's row tables, indexed by scene contact (a block's shared copy,
// or global memory)
struct Tables {
  const float *rowc, *mask, *hinge, *invf;
  const int *side_a, *side_b;
};

// one env's staged inputs; the per-contact ones in the order of the rows
// being solved
struct Staged {
  float *Minv, *ax, *an, *fpos, *Rb, *v, *a, *pts, *nrm, *warm, *dep;
};

// the scene contact of the c-th contact solved: cidx[c] after compaction,
// c itself in the register variant
template <bool COMPACT>
__device__ __forceinline__ int scene_contact(const int* cidx, int c) {
  return COMPACT ? cidx[c] : c;
}

// lay out one env's staged inputs at p for its nc active contacts (scene
// contacts cidx) and load them, every load issued before any is used. The
// register variant's kernel stages its env the same way, every contact,
// inline: a version of that kernel through this function and the helpers
// below measured 5-6 % slower (more spills at the 168-register cap)
__device__ __forceinline__ Staged stage_env(float* p, const ContactDims& D, int nc,
                                            const int* cidx, int lane, int B, int e,
                                            const Inputs& in) {
  const int nv_r = D.nv_r, nf = D.nf, nv = D.nv;
  Staged S;
  S.Minv = p; p += nv_r * nv_r;
  S.ax = p; p += 3 * nv_r;
  S.an = p; p += 3 * nv_r;
  S.fpos = p; p += 3 * nf;
  S.Rb = p; p += 9 * nf;
  S.v = p; p += nv;
  S.a = p; p += nv;
  S.pts = p; p += 3 * nc;
  S.nrm = p; p += 3 * nc;
  S.warm = p; p += 3 * nc;
  S.dep = p;
  for (int i = lane; i < nv_r * nv_r; i += 32) S.Minv[i] = in.minv[(size_t)i * B + e];
  for (int i = lane; i < 3 * nv_r; i += 32) {
    S.ax[i] = in.axes[(size_t)i * B + e];
    S.an[i] = in.anch[(size_t)i * B + e];
  }
  for (int i = lane; i < nv; i += 32) {
    S.v[i] = in.v_all[(size_t)i * B + e];
    S.a[i] = in.a_sm[(size_t)i * B + e];
  }
  for (int i = lane; i < 3 * nc; i += 32) {
    const int c = i / 3;
    const size_t src = (size_t)(3 * cidx[c] + i - 3 * c) * B + e;
    S.pts[i] = in.pts[src];
    S.nrm[i] = in.nrm[src];
    S.warm[i] = in.warm[src];
  }
  for (int c = lane; c < nc; c += 32) S.dep[c] = in.dep[(size_t)cidx[c] * B + e];
  for (int f = lane; f < nf; f += 32) {
    for (int k = 0; k < 3; ++k) S.fpos[3 * f + k] = in.fpos[(size_t)(3 * f + k) * B + e];
    float w = in.fquat[(size_t)(4 * f + 0) * B + e], x = in.fquat[(size_t)(4 * f + 1) * B + e];
    float y = in.fquat[(size_t)(4 * f + 2) * B + e], z = in.fquat[(size_t)(4 * f + 3) * B + e];
    float qn = fmaxf(sqrt_fast(w * w + x * x + y * y + z * z), 1e-12f);
    w = div_fast(w, qn); x = div_fast(x, qn); y = div_fast(y, qn); z = div_fast(z, qn);
    float* R = S.Rb + 9 * f;
    R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
    R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
    R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
  }
  return S;
}

// the frame (n, t1, t2) of a contact normal: t1 = n x ref, ref = z unless
// |n_z| >= 0.9
__device__ __forceinline__ void contact_frame(const float* nn, float* t1, float* t2) {
  bool big = fabsf(nn[2]) < 0.9f;
  float rx = big ? 0.0f : 1.0f, rz = big ? 1.0f : 0.0f;
  t1[0] = nn[1] * rz; t1[1] = nn[2] * rx - nn[0] * rz; t1[2] = -nn[1] * rx;
  float t1n = fmaxf(sqrt_fast(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]), 1e-9f);
  for (int k = 0; k < 3; ++k) t1[k] = div_fast(t1[k], t1n);
  t2[0] = nn[1] * t1[2] - nn[2] * t1[1];
  t2[1] = nn[2] * t1[0] - nn[0] * t1[2];
  t2[2] = nn[0] * t1[1] - nn[1] * t1[0];
}

// the robot dof m's column base at point p: axis x (p - anchor) for a
// hinge, the axis for a slide
__device__ __forceinline__ void dof_base(const Staged& S, float hinge, int m, const float* p,
                                         float* base) {
  const float* a = S.ax + 3 * m;
  if (hinge > 0.5f) {
    float dx = p[0] - S.an[3 * m], dy = p[1] - S.an[3 * m + 1], dz = p[2] - S.an[3 * m + 2];
    base[0] = a[1] * dz - a[2] * dy;
    base[1] = a[2] * dx - a[0] * dz;
    base[2] = a[0] * dy - a[1] * dx;
  } else {
    base[0] = a[0]; base[1] = a[1]; base[2] = a[2];
  }
}

// a free body's 6 columns of one row, direction fd at point p: the 3
// linear ones (the direction) and the 3 angular ones (R[:, jj] x r . fd)
__device__ __forceinline__ void free_cols(const Staged& S, int body, const float* p,
                                          const float* fd, float* cc) {
  const float* R = S.Rb + 9 * body;
  float rv[3] = {p[0] - S.fpos[3 * body], p[1] - S.fpos[3 * body + 1],
                 p[2] - S.fpos[3 * body + 2]};
  for (int k = 0; k < 3; ++k) cc[k] = fd[k];
  for (int jj = 0; jj < 3; ++jj) {
    float cx = R[3 + jj] * rv[2] - R[6 + jj] * rv[1];
    float cy = R[6 + jj] * rv[0] - R[0 + jj] * rv[2];
    float cz = R[0 + jj] * rv[1] - R[3 + jj] * rv[0];
    cc[3 + jj] = fd[0] * cx + fd[1] * cy + fd[2] * cz;
  }
}

// a contact's impedance terms from its three Delassus diagonals: the
// regularization R3, the preconditioner sh3, mu scaled, and aref of the
// normal row (the tangential rows' aref is -b vel)
struct Impedance {
  float R3[3], sh3[3], mu, aref_k, b;
};

__device__ __forceinline__ Impedance impedance(const float* rc, float depth, const float* diag,
                                               float impratio) {
  Impedance im;
  float r_vio = -depth;
  float x = fminf(fmaxf(div_fast(fabsf(r_vio), rc[5]), 0.0f), 1.0f);
  float om = 1.0f - x;
  float yv = x < rc[6] ? rc[7] * x * x : 1.0f - rc[8] * om * om;
  float d_imp = rc[3] + yv * (rc[4] - rc[3]);
  im.aref_k = -rc[0] * d_imp * r_vio;
  im.b = rc[1];
  float rr = div_fast(1.0f - d_imp, fmaxf(d_imp, 1e-6f));
  im.R3[0] = rr * diag[0];
  im.R3[1] = div_fast(rr * diag[1], impratio);
  im.R3[2] = div_fast(rr * diag[2], impratio);
  float sn = fmaxf(diag[0] + im.R3[0], 1e-10f);
  float st = fmaxf(0.5f * ((diag[1] + im.R3[1]) + (diag[2] + im.R3[2])), 1e-10f);
  im.mu = rc[2] * sqrt_fast(div_fast(st, sn));
  im.sh3[0] = sqrt_fast(sn);
  im.sh3[1] = sqrt_fast(st);
  im.sh3[2] = im.sh3[1];
  return im;
}

// ---------------------------------------------------------------------------
// Register form: one warp per env, lane l owns rows l and l + 32 (RPL rows);
// the scaled Delassus matrix A = diag(ish) J M^-1 J' diag(ish) is formed
// once, each lane's rows of it in registers, padded to K3_REG_NC columns.
// ---------------------------------------------------------------------------

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

// The register form's solve of n <= K3_REG_NC rows (the contacts of S's
// order, scene contact cidx[c] under COMPACT, else c) on JT [nv][NC], Y, Z,
// ISH [NC] in shared memory: rows, impedance, the formed matrix, the step
// size, APGD, then f and qfrc = J' f written for env e. Written as the
// register variant's kernel body, with only the scene contact remapped for
// the tables and f: under COMPACT = false its code, and so its registers,
// spills and time, must stay the register variant's.
template <bool COMPACT>
__device__ __forceinline__ void reg_solve(const ContactDims& D, int n, int lane, int B, int e,
                                          const Tables& T, const int* cidx, const Staged& S,
                                          float* JT, float* __restrict__ f_out,
                                          float* __restrict__ q_out) {
  constexpr int NC = K3_REG_NC, RPL = (NC + 31) / 32;
  const int nv_r = D.nv_r, nf = D.nf, nv = D.nv;
  float* Y = JT + nv * NC;
  float* Z = Y + NC;
  float* ISH = Z + NC;

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
    const int sc = scene_contact<COMPACT>(cidx, c);
    float p[3], nn[3];
    for (int k = 0; k < 3; ++k) {
      p[k] = S.pts[3 * c + k];
      nn[k] = S.nrm[3 * c + k];
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
      float mk = T.mask[sc * nv_r + m];
      const float* a = S.ax + 3 * m;
      float base[3];
      if (T.hinge[m] > 0.5f) {
        float dx = p[0] - S.an[3 * m], dy = p[1] - S.an[3 * m + 1], dz = p[2] - S.an[3 * m + 2];
        base[0] = a[1] * dz - a[2] * dy;
        base[1] = a[2] * dx - a[0] * dz;
        base[2] = a[0] * dy - a[1] * dx;
      } else {
        base[0] = a[0]; base[1] = a[1]; base[2] = a[2];
      }
      Jr[s][m] = mk * (fd[0] * base[0] + fd[1] * base[1] + fd[2] * base[2]);
      JT[m * NC + r] = Jr[s][m];
      sv_ += Jr[s][m] * S.v[m];
      sa_ += Jr[s][m] * S.a[m];
    }
    // free-body columns: +side A, -side B; per body the 3 linear columns
    // (the direction) and the 3 angular ones (R[:, jj] x r . direction)
    const int fa = T.side_a[sc], fb = T.side_b[sc];
    float ca[6], cb[6];
    for (int sd = 0; sd < 2; ++sd) {
      int body = sd == 0 ? fa : fb;
      float* cc = sd == 0 ? ca : cb;
      if (body < 0) {
        for (int w = 0; w < 6; ++w) cc[w] = 0.0f;
        continue;
      }
      const float* R = S.Rb + 9 * body;
      float rv[3] = {p[0] - S.fpos[3 * body], p[1] - S.fpos[3 * body + 1],
                     p[2] - S.fpos[3 * body + 2]};
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
        sv_ += val * S.v[k];
        sa_ += val * S.a[k];
        sdg += val * (val * T.invf[6 * blk + w]);
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
      const float mv = S.Minv[k * nv_r + m];
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
    const float* rc = T.rowc + K3_ROWC * scene_contact<COMPACT>(cidx, c);
    float depth = S.dep[c];
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
    for (int k = 0; k < 3; ++k) f0[k] = S.warm[3 * c + k] * sh3[k] * act[s];
    project(mu[s], act[s], f0);
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
      coef[s] = r < n ? JT[k * NC + r] * T.invf[k - nv_r] : 0.0f;
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
      project(mu[s], act[s], fz);
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
    if (r < n) {
      const int c = r / 3;
      f_out[(size_t)(3 * scene_contact<COMPACT>(cidx, c) + r - 3 * c) * B + e] = f;
    }
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
  constexpr int NC = K3_REG_NC;
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
  float* sMinv = JT + (nv + 3) * NC;  // past JT, Y, Z and ISH
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

  const Staged S{sMinv, sax, san, sfpos, sRb, sv, sa, spts, snrm, swarm, sdep};
  const Tables T{t_rowc, t_mask, t_hinge, t_invf, t_side, t_side + ncon};
  reg_solve<false>(D, n, lane, B, e, T, nullptr, S, JT, f_out, q_out);
}

// ---------------------------------------------------------------------------
// Compact variant: the env's active contacts compacted, then the register
// form's solve (up to K3_REG_NC rows) or the factored one.
// ---------------------------------------------------------------------------

// one env's staged inputs for nc contacts, in floats (a multiple of 4)
__host__ __device__ inline int staged_floats(const ContactDims& D, int nc) {
  return (D.nv_r * D.nv_r + 6 * D.nv_r + 12 * D.nf + 2 * D.nv + 10 * nc + 3) / 4 * 4;
}

// the factored solve's working set for nc contacts: the staged inputs, J
// [3 nc][nv], the robot part of M^-1 J' [3 nc][nv_r], nine row vectors, t
// [nv] and mu [nc]
__host__ __device__ inline int fact_floats(const ContactDims& D, int nc) {
  return staged_floats(D, nc) + 3 * nc * (D.nv + D.nv_r) + 27 * nc + D.nv + nc;
}

// the register form's working set: the staged inputs of K3_REG_NC / 3
// contacts, JT [nv][NC], Y, Z, ISH [NC]
__host__ __device__ inline int compact_reg_floats(const ContactDims& D) {
  return staged_floats(D, K3_REG_NC / 3) + (D.nv + 3) * K3_REG_NC;
}

// per-env shared memory of the compact variant at a cap of `cap` active
// contacts, in floats: the compact index [ncon], then the larger working set
__host__ __device__ inline int compact_smem_floats(const ContactDims& D, int cap) {
  return (D.ncon + 3) / 4 * 4 + (imax(compact_reg_floats(D), fact_floats(D, cap)) + 3) / 4 * 4;
}

// per-env slot of the global workspace, in floats: every contact active
__host__ __device__ inline int compact_ws_floats(const ContactDims& D) {
  return (fact_floats(D, D.ncon) + 3) / 4 * 4;
}

// the factored solve's working set at W (shared memory, or global)
struct Fact {
  float *J, *MJ, *xs, *fh, *y, *ish, *bh, *R, *sh, *vit, *g, *t, *mus;
};

// t[j] = sum_r C[r][j] x[r] over the n rows for every dof j, C = M^-1 J'
// (MINV: the robot columns from MJ, the free ones J times inv_free, M^-1
// being diagonal there) or J: lane l sums dofs l and l + 32 in one pass
// over the rows (nv <= 64 in one pass), four partial sums each
template <bool MINV>
__device__ __forceinline__ void dof_sums(const Fact& s, const ContactDims& D, int n, int lane,
                                         const float* invf, const float* x, float* t) {
  const int nv = D.nv, nv_r = D.nv_r;
  for (int j = lane; j < nv; j += 64) {
    const int j2 = j + 32;  // a free dof (nv_r <= 9)
    const bool has2 = j2 < nv;
    const bool mj = MINV && j < nv_r;
    const float* M = mj ? s.MJ + j : s.J + j;
    const int ld = mj ? nv_r : nv;
    const float* M2 = s.J + (has2 ? j2 : j);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int r = 0;
    for (; r + 3 < n; r += 4)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xr = x[r + i];
        a[i] = fmaf(M[(r + i) * ld], xr, a[i]);
        if (has2) b[i] = fmaf(M2[(r + i) * nv], xr, b[i]);
      }
    for (; r < n; ++r) {
      a[0] = fmaf(M[r * ld], x[r], a[0]);
      if (has2) b[0] = fmaf(M2[r * nv], x[r], b[0]);
    }
    const float ta = (a[0] + a[1]) + (a[2] + a[3]);
    t[j] = MINV && j >= nv_r ? ta * invf[j - nv_r] : ta;
    if (has2) {
      const float tb = (b[0] + b[1]) + (b[2] + b[3]);
      t[j2] = MINV ? tb * invf[j2 - nv_r] : tb;
    }
  }
}

// out[r] = ish[r] ((J (M^-1 J')' (ish in))[r] + R[r] ish[r] in[r]) over the
// n rows: t = (M^-1 J')' (ish in) over lanes on the dofs, then J t with
// lane l on rows l, l + 32, l + 64 and l + 96 in one pass over the dofs
__device__ __forceinline__ void fact_matvec(const Fact& s, const ContactDims& D, int n,
                                            int lane, const float* invf, const float* in,
                                            float* out) {
  const int nv = D.nv;
  for (int r = lane; r < n; r += 32) s.xs[r] = s.ish[r] * in[r];
  __syncwarp();
  dof_sums<true>(s, D, n, lane, invf, s.xs, s.t);
  __syncwarp();
  for (int r0 = lane; r0 < n; r0 += 128) {
    const float* Jr[4];
    bool ok[4];
    float u[4][2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ok[k] = r0 + 32 * k < n;
      Jr[k] = s.J + (ok[k] ? r0 + 32 * k : r0) * nv;
      u[k][0] = 0.0f;
      u[k][1] = 0.0f;
    }
    int j = 0;
    for (; j + 1 < nv; j += 2) {
      const float t0 = s.t[j], t1 = s.t[j + 1];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ok[k]) {
          u[k][0] = fmaf(Jr[k][j], t0, u[k][0]);
          u[k][1] = fmaf(Jr[k][j + 1], t1, u[k][1]);
        }
    }
    if (j < nv) {
      const float t0 = s.t[j];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ok[k]) u[k][0] = fmaf(Jr[k][j], t0, u[k][0]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (ok[k]) {
        const int r = r0 + 32 * k;
        out[r] = s.ish[r] * ((u[k][0] + u[k][1]) + s.R[r] * s.xs[r]);
      }
  }
  __syncwarp();
}

// The factored solve of nc active contacts (S's order, scene contacts
// cidx) on the working set at W past the staged inputs: lane c on contact c
// in the row-local parts; f and qfrc = J' f written for env e.
__device__ __forceinline__ void fact_solve(const ContactDims& D, int nc, int lane, int B,
                                           int e, const Tables& T, const int* cidx,
                                           const Staged& S, float* W,
                                           float* __restrict__ f_out,
                                           float* __restrict__ q_out) {
  const int nv_r = D.nv_r, nv = D.nv, n = 3 * nc;
  Fact s;
  float* p = W;
  s.J = p; p += n * nv;
  s.MJ = p; p += n * nv_r;
  s.xs = p; p += n;
  s.fh = p; p += n;
  s.y = p; p += n;
  s.ish = p; p += n;
  s.bh = p; p += n;
  s.R = p; p += n;
  s.sh = p; p += n;
  s.vit = p; p += n;
  s.g = p; p += n;
  s.t = p; p += nv;
  s.mus = p;

  // ---- rows, M^-1 J', impedance, preconditioning (lane-local per contact) ----
  for (int c = lane; c < nc; c += 32) {
    const int sc = cidx[c];
    float p3[3], nn[3], t1[3], t2[3];
    for (int k = 0; k < 3; ++k) {
      p3[k] = S.pts[3 * c + k];
      nn[k] = S.nrm[3 * c + k];
    }
    contact_frame(nn, t1, t2);
    const float* fr[3] = {nn, t1, t2};
    for (int m = 0; m < nv_r; ++m) {
      float mk = T.mask[sc * nv_r + m];
      float base[3];
      dof_base(S, T.hinge[m], m, p3, base);
      for (int d = 0; d < 3; ++d)
        s.J[(3 * c + d) * nv + m] =
            mk * (fr[d][0] * base[0] + fr[d][1] * base[1] + fr[d][2] * base[2]);
    }
    for (int j = nv_r; j < nv; ++j)
      for (int d = 0; d < 3; ++d) s.J[(3 * c + d) * nv + j] = 0.0f;
    for (int sd = 0; sd < 2; ++sd) {  // free-body columns: +side A, -side B
      const int body = sd == 0 ? T.side_a[sc] : T.side_b[sc];
      if (body < 0) continue;
      const float sg = sd == 0 ? 1.0f : -1.0f;
      for (int d = 0; d < 3; ++d) {
        float cc[6];
        free_cols(S, body, p3, fr[d], cc);
        float* row = s.J + (3 * c + d) * nv + nv_r + 6 * body;
        for (int w = 0; w < 6; ++w) row[w] += sg * cc[w];
      }
    }
    // M^-1 J' robot rows (the row's robot columns in registers, every
    // Minv entry's load issued at once), velocities, smooth accelerations,
    // Delassus diagonal
    float vel[3], a0[3], diag[3];
    for (int d = 0; d < 3; ++d) {
      const int rr = 3 * c + d;
      const float* Jr = s.J + rr * nv;
      float* MJr = s.MJ + rr * nv_r;
      float jr[K3_MAXVR];
#pragma unroll
      for (int k = 0; k < K3_MAXVR; ++k) jr[k] = k < nv_r ? Jr[k] : 0.0f;
      float sdg = 0.0f;
#pragma unroll
      for (int m = 0; m < K3_MAXVR; ++m) {
        if (m >= nv_r) continue;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < K3_MAXVR; ++k)
          if (k < nv_r) acc += jr[k] * S.Minv[k * nv_r + m];
        MJr[m] = acc;
        sdg += jr[m] * acc;
      }
      float sv = 0.0f, sa = 0.0f;
      for (int j = 0; j < nv; ++j) {
        sv += Jr[j] * S.v[j];
        sa += Jr[j] * S.a[j];
      }
      for (int j = nv_r; j < nv; ++j) sdg += Jr[j] * (Jr[j] * T.invf[j - nv_r]);
      vel[d] = sv; a0[d] = sa; diag[d] = sdg;
    }
    const Impedance im = impedance(T.rowc + K3_ROWC * sc, S.dep[c], diag, D.impratio);
    const float aref[3] = {-im.b * vel[0] + im.aref_k, -im.b * vel[1], -im.b * vel[2]};
    s.mus[c] = im.mu;
    float f0[3];
    for (int d = 0; d < 3; ++d) {
      const int r = 3 * c + d;
      s.R[r] = im.R3[d];
      s.sh[r] = im.sh3[d];
      s.ish[r] = div_fast(1.0f, im.sh3[d]);
      s.bh[r] = (a0[d] - aref[d]) * s.ish[r];
      f0[d] = S.warm[r] * im.sh3[d];
    }
    project(im.mu, 1.0f, f0);
    for (int d = 0; d < 3; ++d) {
      s.fh[3 * c + d] = f0[d];
      s.y[3 * c + d] = f0[d];
    }
  }
  __syncwarp();

  // ---- step size: power iteration on the scaled Delassus operator, from
  // ones on the active rows ----
  for (int r = lane; r < n; r += 32) s.vit[r] = 1.0f;
  __syncwarp();
  for (int it = 0; it < 6; ++it) {
    fact_matvec(s, D, n, lane, T.invf, s.vit, s.g);
    float ss = 0.0f;
    for (int r = lane; r < n; r += 32) ss += s.g[r] * s.g[r];
    const float nrm_v = fmaxf(sqrt_fast(warp_sum(ss)), 1e-12f);
    for (int r = lane; r < n; r += 32) s.vit[r] = div_fast(s.g[r], nrm_v);
    __syncwarp();
  }
  fact_matvec(s, D, n, lane, T.invf, s.vit, s.g);
  float rq = 0.0f;
  for (int r = lane; r < n; r += 32) rq += s.vit[r] * s.g[r];
  const float step = div_fast(1.0f, 1.5f * fmaxf(warp_sum(rq), 1.0f));

  // ---- Nesterov APGD with adaptive restart ----
  float theta = 1.0f;
  const float tn_restart = 0.5f * (sqrtf(1.0f + 4.0f) - 1.0f);
  for (int it = 0; it < D.n_iters; ++it) {
    fact_matvec(s, D, n, lane, T.invf, s.y, s.g);
    float gd = 0.0f;
    for (int c = lane; c < nc; c += 32) {
      float fn[3];
      for (int d = 0; d < 3; ++d) {
        const int r = 3 * c + d;
        s.g[r] += s.bh[r];
        fn[d] = s.y[r] - step * s.g[r];
      }
      project(s.mus[c], 1.0f, fn);
      for (int d = 0; d < 3; ++d) {
        const int r = 3 * c + d;
        const float df = fn[d] - s.fh[r];
        gd += s.g[r] * df;
        s.vit[r] = df;  // keep df for the momentum update
        s.fh[r] = fn[d];
      }
    }
    __syncwarp();  // the row loop below reads other lanes' contacts
    float th2 = theta * theta;
    float tn_keep = 0.5f * (sqrt_fast(th2 * th2 + 4.0f * th2) - th2);
    float beta_keep = div_fast(theta * (1.0f - theta), th2 + tn_keep);
    const bool restart = warp_sum(gd) > 0.0f;
    const float beta = restart ? 0.0f : beta_keep;
    theta = restart ? tn_restart : tn_keep;
    for (int r = lane; r < n; r += 32) s.y[r] = s.fh[r] + beta * s.vit[r];
    __syncwarp();
  }

  // ---- forces and generalized contact forces ----
  for (int c = lane; c < nc; c += 32)
    for (int d = 0; d < 3; ++d) {
      const int r = 3 * c + d;
      const float f = div_fast(s.fh[r], s.sh[r]);
      s.xs[r] = f;
      f_out[(size_t)(3 * cidx[c] + d) * B + e] = f;
    }
  __syncwarp();
  dof_sums<false>(s, D, n, lane, T.invf, s.xs, s.t);
  __syncwarp();
  for (int j = lane; j < nv; j += 32) q_out[(size_t)j * B + e] = s.t[j];
}

__global__ void __launch_bounds__(32 * K3_REG_WARPS, K3_REG_MINB) contact_phase_compact_kernel(
    ContactDims D, int B, int cap, float* __restrict__ ws, const float* __restrict__ pts,
    const float* __restrict__ nrm, const float* __restrict__ dep,
    const float* __restrict__ axes, const float* __restrict__ anch,
    const float* __restrict__ minv, const float* __restrict__ v_all,
    const float* __restrict__ a_sm, const float* __restrict__ fpos,
    const float* __restrict__ fquat, const float* __restrict__ warm,
    const float* __restrict__ rowc, const float* __restrict__ mask_rob,
    const float* __restrict__ is_hinge, const int* __restrict__ side_a,
    const int* __restrict__ side_b, const float* __restrict__ inv_free,
    float* __restrict__ f_out, float* __restrict__ q_out) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * K3_REG_WARPS + warp;
  if (e >= B) return;  // whole warp leaves together; no block barrier follows
  const int ncon = D.ncon;
  // per env: the compact index [ncon], then the working set of either form
  int* cidx = reinterpret_cast<int*>(smem4) + (size_t)warp * compact_smem_floats(D, cap);
  float* own = reinterpret_cast<float*>(cidx) + (ncon + 3) / 4 * 4;

  // ---- compact the active contacts (depth > 0) in row order; f = 0 on
  // the others ----
  int nc = 0;
  for (int c0 = 0; c0 < ncon; c0 += 32) {
    const int c = c0 + lane;
    const bool act = c < ncon && dep[(size_t)c * B + e] > 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, act);
    if (act) {
      cidx[nc + __popc(m & ((1u << lane) - 1u))] = c;
    } else if (c < ncon) {
      for (int d = 0; d < 3; ++d) f_out[(size_t)(3 * c + d) * B + e] = 0.0f;
    }
    nc += __popc(m);
  }
  __syncwarp();
  if (nc == 0) {  // the full form's f stays 0: qfrc = J' 0
    for (int j = lane; j < D.nv; j += 32) q_out[(size_t)j * B + e] = 0.0f;
    return;
  }

  const Inputs in{pts, nrm, dep, axes, anch, minv, v_all, a_sm, fpos, fquat, warm};
  const Tables T{rowc, mask_rob, is_hinge, inv_free, side_a, side_b};
  if (3 * nc <= K3_REG_NC) {
    const Staged S = stage_env(own, D, nc, cidx, lane, B, e, in);
    __syncwarp();
    reg_solve<true>(D, 3 * nc, lane, B, e, T, cidx, S, own + staged_floats(D, nc), f_out,
                    q_out);
    return;
  }
  // the factored form: in shared memory up to the cap, above it on the
  // env's slot of the global workspace (two inlined instances, so that the
  // shared one's accesses compile to shared-memory loads and stores)
  if (nc <= cap) {
    const Staged S = stage_env(own, D, nc, cidx, lane, B, e, in);
    __syncwarp();
    fact_solve(D, nc, lane, B, e, T, cidx, S, own + staged_floats(D, nc), f_out, q_out);
  } else {
    float* W = ws + (size_t)e * compact_ws_floats(D);
    const Staged S = stage_env(W, D, nc, cidx, lane, B, e, in);
    __syncwarp();
    fact_solve(D, nc, lane, B, e, T, cidx, S, W + staged_floats(D, nc), f_out, q_out);
  }
}

#define K3_ARGS                                                                       \
  D, B, pts, nrm, dep, axes, anch, minv, v_all, a_sm, fpos, fquat, warm, rowc, mask_rob, \
      is_hinge, side_a, side_b, inv_free, f_out, q_out

// raise the kernel's dynamic shared memory limit where a launch needs more
// than the default 48 KB
template <typename K>
static int allow_smem(K kernel, size_t bytes) {
  if (bytes > 232448) return (int)cudaErrorInvalidValue;  // 227 KB per block
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// variant 1: register variant (n <= K3_REG_NC rows, nv_r <= 9; `cap`
// unread); variant 2: the compact variant, its shared memory sized for
// `cap` active contacts per env (the wrapper picks the cap), envs above it
// on `ws` (compact_ws_floats per env; unread where the cap takes every
// contact)
extern "C" int d3il_contact_phase(ContactDims D, int variant, int B, int cap, const float* pts,
                                  const float* nrm, const float* dep, const float* axes,
                                  const float* anch, const float* minv, const float* v_all,
                                  const float* a_sm, const float* fpos, const float* fquat,
                                  const float* warm, const float* rowc, const float* mask_rob,
                                  const float* is_hinge, const int* side_a, const int* side_b,
                                  const float* inv_free, float* f_out, float* q_out, float* ws,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D.nv_r > K3_MAXVR) return (int)cudaErrorInvalidValue;
  const int blocks = (B + K3_REG_WARPS - 1) / K3_REG_WARPS;
  if (variant == 1) {
    if (3 * D.ncon > K3_REG_NC) return (int)cudaErrorInvalidValue;
    size_t bytes = ((size_t)reg_table_floats(D) + (size_t)reg_smem_floats(D) * K3_REG_WARPS) *
                   sizeof(float);
    int err = allow_smem(contact_phase_reg_kernel, bytes);
    if (err) return err;
    contact_phase_reg_kernel<<<blocks, 32 * K3_REG_WARPS, bytes, st>>>(K3_ARGS);
    return (int)cudaGetLastError();
  }
  if (variant != 2 || cap < 0 || cap > D.ncon) return (int)cudaErrorInvalidValue;
  if (cap < D.ncon && ws == nullptr) return (int)cudaErrorInvalidValue;
  size_t bytes = (size_t)compact_smem_floats(D, cap) * K3_REG_WARPS * sizeof(float);
  int err = allow_smem(contact_phase_compact_kernel, bytes);
  if (err) return err;
  contact_phase_compact_kernel<<<blocks, 32 * K3_REG_WARPS, bytes, st>>>(
      D, B, cap, ws, pts, nrm, dep, axes, anch, minv, v_all, a_sm, fpos, fquat, warm, rowc,
      mask_rob, is_hinge, side_a, side_b, inv_free, f_out, q_out);
  return (int)cudaGetLastError();
}
