// One SSP-RK stage of the DG transport as a grid-wide launch: the
// dg1_rk_stage kernel template, shared by the sources that instantiate it:
// transport.cu (the limited and the advection run's instances, and the
// entry points), transport_tvb.cu (the TVB form's unlimited instances,
// whose stage the dg1_limit pass limits), the periodic sources, and
// transport_spmd.cu and transport_spmd_qv.cu (the halo form of a rank
// block widened by one ring), which nvcc compiles in parallel. The design
// is described in transport.cu.
#pragma once

#include <cstring>

#include "async_copy.cuh"
#include "dg1_body.cuh"

namespace nst {

// -- dg1_rk_stage ---------------------------------------------------------------
constexpr int kStageCols = 32;    // a tile: 32 elements along j (a warp's lanes) ...
constexpr int kStageRows = 4;     // ... by 4 along i
constexpr int kStageTracers = 3;  // hice, cice, hsnow: one warp a tracer and row

// A block of kTracers warps a tile row (3: the coupled step's tracers; 1:
// the advection run's one) at degree kDeg: its threads, and the blocks an
// SM that its launch bound asks for: 48 warps an SM at dG0 and dG1 (at
// most 40 registers a thread), 24 at dG2 (at most 85).
template <int kDeg, int kTracers>
struct StageShape {
  static constexpr int kThreads = kStageCols * kStageRows * kTracers;
  static constexpr int kBlocksPerSm = (kDeg == 2 ? 768 : 1536) / kThreads;
};

// The coefficient window: rows i0 - 1 ... i0 + kStageRows, columns from
// j0 - 4 (16-byte aligned; j0 - 1 is the left apron) to j0 + kStageCols + 3.
constexpr int kPsiPitch = kStageCols + 8;
constexpr int kPsiLead = 4;
// Every other window: rows i0 ... i0 + kStageRows (the x faces below the
// next tile, the nodes' last row), columns j0 ... j0 + kStageCols + 3 (the
// y faces left of the next tile, the nodes' last column).
constexpr int kWinRows = kStageRows + 1;
constexpr int kWinPitch = kStageCols + 4;
constexpr int kMaxWindows = DgQvPlanes<2>::kCount + 2 + 5;

// The windows of a form, in the order of StageArgs::win: the velocity (CG1:
// u, v; qv: vx[kVol], vy[kVol], vn_x[kEdge], vn_y[kEdge]), with kMasks
// face_x and face_y, then with kMetric len_x, len_y, inv_dx, inv_dy,
// inv_area. Without kMasks (the no-limit instance: DGTransport.run takes
// no face masks) every face is open and no mask plane is read.
template <int kDeg, bool kMetric, bool kQv, bool kMasks>
struct StageWindows {
  static constexpr int kVelocity = kQv ? DgQvPlanes<kDeg>::kCount : 2;
  static constexpr int kFaceX = kVelocity, kFaceY = kVelocity + 1;
  static constexpr int kLenX = kVelocity + (kMasks ? 2 : 0), kLenY = kLenX + 1;
  static constexpr int kInv = kLenX + 2;  // inv_dx, inv_dy, inv_area
  static constexpr int kCount = kLenX + (kMetric ? 5 : 0);
};

// Everything a launch takes.
template <int kDeg>
struct StageArgs {
  const float* psi;   // (K, n_tracers, nx, ny)
  const float* base;  // read only with kBlend; may alias out
  float* out;
  const float* win[kMaxWindows];  // StageWindows' planes
  int nx, ny;
  int vector;         // 16-byte copies (every plane 16-byte aligned, ny % 4 == 0)
  float a, b, dt;
  DgTables<kDeg> tb;
  int wrap;  // the periodic instances' axes (kWrapX, kWrapY); last, so that the
             // closed instances read their parameters at the offsets they always had
  // The halo form's global walls (kHalo), in the widened block's indices:
  // the row of the last x wall's element, the row of the first's, then the
  // columns of y's, -1 for none (transport_tiled's g.wall).
  int wall[4];
};

// A tile's windows in shared memory (beyond the domain, zeros), the CG1
// form's sampled volume velocity and the face fluxes.
template <int kDeg, int kTracers, int kWindows, bool kSampled>
struct alignas(16) StageTile {
  static constexpr int kDofs = DgShape<kDeg>::kDofs, kVol = DgShape<kDeg>::kVol,
                       kEdge = DgShape<kDeg>::kEdge;
  float psi[kDofs * kTracers][kStageRows + 2][kPsiPitch];  // plane d * kTracers + t
  float win[kWindows][kWinRows][kWinPitch];
  float vol[kSampled ? 2 * kVol : 1][kStageRows][kStageCols];  // vx, then vy
  float gx[kTracers][kEdge][kStageRows + 1][kStageCols];  // x face i0 + r
  float gy[kTracers][kEdge][kStageRows][kStageCols + 1];  // y face j0 + c
};

// Copies the tile's windows by cp.async, every thread of the block a share
// of each: kVec 4, 16-byte copies (ny % 4 == 0, every plane 16-byte
// aligned), or 4-byte ones. On a periodic axis a window cell beyond the
// domain is copied from its wrapped cell: a 16-byte copy starts at a
// multiple of 4 cells and ny is one, so no copy straddles the seam.
template <int kVec, int kTracers, bool kWrap, int kDeg, class Tile>
__device__ __forceinline__ void copy_tile(const StageArgs<kDeg>& g, Tile& s, int n_windows,
                                          int i0, int j0, int tid) {
  constexpr int kThreads = StageShape<kDeg, kTracers>::kThreads;
  const int nx = g.nx, ny = g.ny, wrap = g.wrap;
  const long plane = static_cast<long>(nx) * ny;
  constexpr int kPsiChunks = kPsiPitch / kVec, kPsiItems = (kStageRows + 2) * kPsiChunks;
  for (int c = tid; c < DgShape<kDeg>::kDofs * kTracers * kPsiItems; c += kThreads) {
    const int k = c / kPsiItems, rem = c - k * kPsiItems;
    const int row = rem / kPsiChunks, col = (rem - row * kPsiChunks) * kVec;
    int a = i0 - 1 + row, b = j0 - kPsiLead + col;
    if (kWrap) wrap_ij(a, b, nx, ny, wrap);
    const bool valid = a >= 0 && a < nx && b >= 0 && b < ny;
    cp_async<kVec>(&s.psi[k][row][col],
                   valid ? g.psi + k * plane + static_cast<long>(a) * ny + b : g.psi, valid);
  }
  constexpr int kWinChunks = kWinPitch / kVec, kWinItems = kWinRows * kWinChunks;
  for (int c = tid; c < n_windows * kWinItems; c += kThreads) {
    const int k = c / kWinItems, rem = c - k * kWinItems;
    const int row = rem / kWinChunks, col = (rem - row * kWinChunks) * kVec;
    int a = i0 + row, b = j0 + col;
    if (kWrap) wrap_ij(a, b, nx, ny, wrap);
    const bool valid = a < nx && b < ny;
    const float* src = g.win[k];
    cp_async<kVec>(&s.win[k][row][col], valid ? src + static_cast<long>(a) * ny + b : src, valid);
  }
  cp_async_commit();
}

// The K coefficients of tracer t at coefficient-window row r, column c.
template <int kTracers, int K, class Tile>
__device__ __forceinline__ void tile_coeffs(const Tile& s, int t, int r, int c, float (&p)[K]) {
#pragma unroll
  for (int d = 0; d < K; ++d) p[d] = s.psi[d * kTracers + t][r][c];
}

// The points of x face i0 + r (between element rows i0 + r - 1 and i0 + r)
// at column j0 + c, for tracer t, into s.gx. Every x face is open on a
// periodic x axis (face nx is face 0). In the halo form (kHalo: tiles from
// the widened block's row and column 1) a face is closed only at a global
// wall: the first wall's element's left face, the last's right face.
template <int kDeg, bool kMetric, bool kQv, bool kMasks, bool kWrap, bool kHalo, class Tile, int K>
__device__ __forceinline__ void x_face(const StageArgs<kDeg>& g, Tile& s, int t, int r, int c,
                                       const float (&lo)[K], const float (&hi)[K]) {
  using W = StageWindows<kDeg, kMetric, kQv, kMasks>;
  constexpr int kVol = DgShape<kDeg>::kVol;
  const int i = blockIdx.y * kStageRows + r + (kHalo ? 1 : 0);
  const bool open = kHalo ? i != g.wall[1] && i != g.wall[0] + 1
                          : (kWrap && (g.wrap & kWrapX)) || (i > 0 && i < g.nx);
#pragma unroll
  for (int e = 0; e < DgShape<kDeg>::kEdge; ++e) {
    const float vn = kQv ? s.win[2 * kVol + e][r][c]
                         : along_face(g.tb.w_edge[e], s.win[0][r][c], s.win[0][r][c + 1]);
    s.gx[t][e][r][c] = dg1_face_flux<kMetric>(g.tb.psi_x1, g.tb.psi_x0, e, vn, lo, hi, open,
                                              kMasks ? s.win[W::kFaceX][r][c] : 1.0f,
                                              kMetric ? s.win[W::kLenX][r][c] : 0.0f);
  }
}

// The points of y face j0 + c (between element columns j0 + c - 1 and
// j0 + c) at row i0 + r, for tracer t, into s.gy.
template <int kDeg, bool kMetric, bool kQv, bool kMasks, bool kWrap, bool kHalo, class Tile, int K>
__device__ __forceinline__ void y_face(const StageArgs<kDeg>& g, Tile& s, int t, int r, int c,
                                       const float (&lo)[K], const float (&hi)[K]) {
  using W = StageWindows<kDeg, kMetric, kQv, kMasks>;
  constexpr int kVol = DgShape<kDeg>::kVol, kEdge = DgShape<kDeg>::kEdge;
  const int j = blockIdx.x * kStageCols + c + (kHalo ? 1 : 0);
  const bool open = kHalo ? j != g.wall[3] && j != g.wall[2] + 1
                          : (kWrap && (g.wrap & kWrapY)) || (j > 0 && j < g.ny);
#pragma unroll
  for (int e = 0; e < kEdge; ++e) {
    const float vn = kQv ? s.win[2 * kVol + kEdge + e][r][c]
                         : along_face(g.tb.w_edge[e], s.win[1][r][c], s.win[1][r + 1][c]);
    s.gy[t][e][r][c] = dg1_face_flux<kMetric>(g.tb.psi_y1, g.tb.psi_y0, e, vn, lo, hi, open,
                                              kMasks ? s.win[W::kFaceY][r][c] : 1.0f,
                                              kMetric ? s.win[W::kLenY][r][c] : 0.0f);
  }
}

// One SSP-RK stage on a tile of kStageRows x kStageCols elements, one
// thread an element and tracer (a warp: one tracer of one row). 1. The
// threads copy the windows by cp.async; each loads its own base. 2. Each
// computes its element's left and bottom face fluxes for its tracer (the
// tile's last row adds the faces below the next tile, the first row's
// lanes the column left of it); in the CG1 form it also samples its share
// of the element's volume velocities. 3. Each updates its element from
// the shared fluxes. kBlend: a != 0 (the base is read); kQv: the velocity
// from the qv planes; kLimit: the positivity limiter. The coupled step's 3
// tracers read the face masks, the advection run's one does not. kWrap: the
// periodic form (the windows wrap on the axes of g.wrap, no face is a
// wall); without it g.wrap is not read and the code is the closed domain's.
// kHalo: the halo form on a rank block widened by one ring (g.nx x g.ny
// the widened shape): the tiles cover the block's own (nx - 2) x (ny - 2)
// elements, whose neighbours' coefficients, velocity, face masks and
// metric are the ring's; base and out are the unwidened block's; a face is
// a wall only at the global walls of g.wall (the ring beyond a closed wall
// is zeros and is never a neighbour's source of flux); 4-byte copies (the
// own block starts one cell into a widened row).
template <int kDeg, int kTracers, bool kMetric, bool kQv, bool kBlend, bool kLimit, bool kWrap,
          bool kHalo = false>
__global__ void __launch_bounds__(StageShape<kDeg, kTracers>::kThreads,
                                  StageShape<kDeg, kTracers>::kBlocksPerSm)
dg1_rk_stage_kernel(const __grid_constant__ StageArgs<kDeg> g) {
  constexpr bool kMasks = kTracers != 1;
  using W = StageWindows<kDeg, kMetric, kQv, kMasks>;
  using Tile = StageTile<kDeg, kTracers, W::kCount, !kQv>;
  constexpr int kDofs = DgShape<kDeg>::kDofs, kVol = DgShape<kDeg>::kVol,
                kEdge = DgShape<kDeg>::kEdge;
  extern __shared__ __align__(16) unsigned char stage_smem[];
  Tile& s = *reinterpret_cast<Tile*>(stage_smem);
  const int lane = threadIdx.x, r = threadIdx.y, t = threadIdx.z;
  const int tid = lane + kStageCols * (r + kStageRows * t);
  constexpr int kRing = kHalo ? 1 : 0;  // the own block's first row and column
  const int i0 = blockIdx.y * kStageRows + kRing, j0 = blockIdx.x * kStageCols + kRing;
  const int i = i0 + r, j = j0 + lane;
  const int nx = g.nx, ny = g.ny;
  // The element's place in base and out: the unwidened block's in the halo form.
  const int out_nx = nx - 2 * kRing, out_ny = ny - 2 * kRing;
  const bool own = i - kRing < out_nx && j - kRing < out_ny;
  const long plane = static_cast<long>(out_nx) * out_ny;
  const long ij = static_cast<long>(i - kRing) * out_ny + (j - kRing);

  if (!kHalo && g.vector) {
    copy_tile<4, kTracers, kWrap>(g, s, W::kCount, i0, j0, tid);
  } else {
    copy_tile<1, kTracers, kWrap>(g, s, W::kCount, i0, j0, tid);
  }
  float p0[kDofs] = {};
  if (kBlend && own) {
#pragma unroll
    for (int d = 0; d < kDofs; ++d) p0[d] = g.base[(d * kTracers + t) * plane + ij];
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. The fluxes of the element's left and bottom faces.
  const int c = lane + kPsiLead;  // the element's column in the coefficient window
  {
    float p[kDofs], lo[kDofs];
    tile_coeffs<kTracers>(s, t, r + 1, c, p);
    tile_coeffs<kTracers>(s, t, r, c, lo);
    x_face<kDeg, kMetric, kQv, kMasks, kWrap, kHalo>(g, s, t, r, lane, lo, p);
    tile_coeffs<kTracers>(s, t, r + 1, c - 1, lo);
    y_face<kDeg, kMetric, kQv, kMasks, kWrap, kHalo>(g, s, t, r, lane, lo, p);
    if (r == kStageRows - 1) {  // the x face below the next tile's first row
      float hi[kDofs];
      tile_coeffs<kTracers>(s, t, r + 2, c, hi);
      x_face<kDeg, kMetric, kQv, kMasks, kWrap, kHalo>(g, s, t, r + 1, lane, p, hi);
    }
    if (r == 0 && lane < kStageRows) {  // the y face left of the next tile, row `lane`
      float hi[kDofs];
      tile_coeffs<kTracers>(s, t, lane + 1, kPsiLead + kStageCols - 1, lo);
      tile_coeffs<kTracers>(s, t, lane + 1, kPsiLead + kStageCols, hi);
      y_face<kDeg, kMetric, kQv, kMasks, kWrap, kHalo>(g, s, t, lane, kStageCols, lo, hi);
    }
  }
  if (!kQv) {
    // The CG1 volume velocity, sampled once an element: value q by tracer
    // q % kTracers.
#pragma unroll
    for (int q = 0; q < 2 * kVol; ++q) {
      if (q % kTracers == t) {
        const auto& f = s.win[q / kVol];  // u, then v
        s.vol[q][r][lane] = bilinear(g.tb.w_vol[q % kVol], f[r][lane], f[r + 1][lane],
                                     f[r][lane + 1], f[r + 1][lane + 1]);
      }
    }
  }
  __syncthreads();

  // 3. The element's update from its four shared face fluxes.
  if (!own) return;
  float p[kDofs], vx[kVol], vy[kVol], val[kDofs];
  tile_coeffs<kTracers>(s, t, r + 1, c, p);
#pragma unroll
  for (int k = 0; k < kVol; ++k) {
    vx[k] = kQv ? s.win[k][r][lane] : s.vol[k][r][lane];
    vy[k] = kQv ? s.win[kVol + k][r][lane] : s.vol[kVol + k][r][lane];
  }
  DgFluxes<kEdge> fl;
#pragma unroll
  for (int e = 0; e < kEdge; ++e) {
    fl.left[e] = s.gx[t][e][r][lane];
    fl.right[e] = s.gx[t][e][r + 1][lane];
    fl.bottom[e] = s.gy[t][e][r][lane];
    fl.top[e] = s.gy[t][e][r][lane + 1];
  }
  Dg1Metric gm = {};
  if (kMetric) {
    gm.inv_dx = s.win[W::kInv][r][lane];
    gm.inv_dy = s.win[W::kInv + 1][r][lane];
    gm.inv_area = s.win[W::kInv + 2][r][lane];
  }
  dg1_stage_update<kDeg, kMetric, kBlend, kLimit>(g.tb, vx, vy, gm, p, fl, p0, g.a, g.b, g.dt,
                                                  val);
#pragma unroll
  for (int d = 0; d < kDofs; ++d) g.out[(d * kTracers + t) * plane + ij] = val[d];
}

// One launch of an instance: its tile in dynamic shared memory.
template <int kDeg, int kTracers, bool kMetric, bool kQv, bool kBlend, bool kLimit,
          bool kWrap = false, bool kHalo = false>
cudaError_t launch_stage(const StageArgs<kDeg>& g, cudaStream_t stream) {
  using W = StageWindows<kDeg, kMetric, kQv, kTracers != 1>;
  constexpr int bytes = static_cast<int>(sizeof(StageTile<kDeg, kTracers, W::kCount, !kQv>));
  const auto kernel = dg1_rk_stage_kernel<kDeg, kTracers, kMetric, kQv, kBlend, kLimit, kWrap, kHalo>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  constexpr int kRing = kHalo ? 1 : 0;  // tiles over the own block
  const int nx = g.nx - 2 * kRing, ny = g.ny - 2 * kRing;
  const dim3 grid((ny + kStageCols - 1) / kStageCols, (nx + kStageRows - 1) / kStageRows);
  kernel<<<grid, dim3(kStageCols, kStageRows, kTracers), bytes, stream>>>(g);
  return cudaGetLastError();
}

// The unlimited 3-tracer instances of the TVB form (transport_tvb.cu): the
// stage writes lim-free a*base + b*(psi + dt*rhs(psi)), which dg1_limit then
// limits. kDeg 1 and 2 (dG0 has no slopes).
template <int kDeg>
cudaError_t run_stage_unlimited(const StageArgs<kDeg>& g, bool metric, bool qv, bool blend,
                                cudaStream_t s);

// The stage modes of nst_dg1_rk_stage.
constexpr int kStageRun = 0;        // the advection run: one tracer, qv form, no masks, no limiter
constexpr int kStageLimited = 1;    // the coupled step: 3 tracers, face masks, positivity limiter
constexpr int kStageUnlimited = 2;  // the TVB form's stage: 3 tracers, face masks, no limiter

// The periodic instances (transport_periodic.cu): every mode, mesh and
// blend of the CG1 velocity, and of the qv form in the advection run's
// mode.
template <int kDeg>
cudaError_t run_stage_periodic(const StageArgs<kDeg>& g, bool metric, bool qv, bool blend, int mode,
                               cudaStream_t s);

// The periodic instances of the HO path's qv form in the coupled step's
// modes (transport_periodic_qv.cu): the limited stage and, at dG1 and dG2,
// the TVB form's unlimited stage; those of a graded or spherical mesh
// (metric) through run_stage_periodic_qv_metric.
template <int kDeg>
cudaError_t run_stage_periodic_qv(const StageArgs<kDeg>& g, bool metric, bool blend, int mode,
                                  cudaStream_t s);

// The same instances with the transport's metric planes
// (transport_periodic_qv_metric.cu).
template <int kDeg>
cudaError_t run_stage_periodic_qv_metric(const StageArgs<kDeg>& g, bool blend, int mode,
                                         cudaStream_t s);

// The halo form's instances (transport_spmd.cu): the coupled step's 3
// tracers with face masks in the limited and (dG1, dG2) the TVB form's
// unlimited mode, on the CG1 velocity, uniform or metric; those of the qv
// form through run_stage_halo_qv.
template <int kDeg>
cudaError_t run_stage_halo(const StageArgs<kDeg>& g, bool metric, bool qv, bool blend, int mode,
                           cudaStream_t s);

// The halo form's instances of the HO path's qv form (transport_spmd_qv.cu).
template <int kDeg>
cudaError_t run_stage_halo_qv(const StageArgs<kDeg>& g, bool metric, bool blend, int mode,
                              cudaStream_t s);

inline bool aligned16(const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 == 0; }

// A launch's arguments (see nst_dg1_rk_stage): the windows in the order of
// StageWindows, and `vector` where every copied plane and its rows are
// 16-byte aligned.
template <int kDeg>
StageArgs<kDeg> stage_args(const float* psi, const float* base, const float* u, const float* v,
                           const float* face_x, const float* face_y, const void* const* metric,
                           const void* const* qv, float* out, int nx, int ny, int mode, int wrap,
                           float a, float b, float dt, const float* tables) {
  StageArgs<kDeg> g = {};
  g.psi = psi;
  g.base = base;
  g.out = out;
  int n = 0;
  if (qv != nullptr) {
    for (int k = 0; k < DgQvPlanes<kDeg>::kCount; ++k) g.win[n++] = static_cast<const float*>(qv[k]);
  } else {
    g.win[n++] = u;
    g.win[n++] = v;
  }
  if (mode != kStageRun) {
    g.win[n++] = face_x;
    g.win[n++] = face_y;
  }
  if (metric != nullptr) {  // Dg1MetricPlanes: inv_dx, inv_dy, len_x, len_y, inv_area
    const int order[5] = {2, 3, 0, 1, 4};
    for (int k : order) g.win[n++] = static_cast<const float*>(metric[k]);
  }
  g.nx = nx;
  g.ny = ny;
  g.wrap = wrap;
  g.a = a;
  g.b = b;
  g.dt = dt;
  std::memcpy(&g.tb, tables, sizeof(g.tb));
  bool vector = ny % 4 == 0 && aligned16(psi);
  for (int k = 0; k < n; ++k) vector = vector && aligned16(g.win[k]);
  g.vector = vector;
  for (int w = 0; w < 4; ++w) g.wall[w] = -1;
  return g;
}

}  // namespace nst
