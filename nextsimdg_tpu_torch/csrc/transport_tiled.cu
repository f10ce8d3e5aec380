// DG tracer transport on Hopper (dG0, dG1, dG2) by ghost-zone tiles: whole
// substeps per launch, on persistent blocks whose window loads overlap
// their compute.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled,
// which runs up to K_CAP limited SSP-RK substeps per round on a halo'd block
// in VMEM, re-sampling the quadrature velocity inside the block, and writes
// back the interior (the TPU's pipeline fetches the next block while it
// computes this one). Here a tile is T x T elements and its window the
// (T + 2H)^2 cells around it, of u and v (nodes) and of the K x group
// coefficient planes of a group of the tracers: all of them at dG0 and dG1,
// one at dG2, whose 6 coefficients a tracer would leave no room for a full
// tile (a work item is a tile and a group, so the velocity is sampled once
// a group). The launch runs as many blocks as fit on the card at once, and
// block b walks the items b, b + G, b + 2G, ... (G blocks; the groups of a
// tile are consecutive items). For each item it runs n_sub substeps of
// rk1, rk2 or rk3 on the window in shared memory, each RK stage followed by
// a barrier, and writes the interior to the output planes (ping-pong on
// the host: blocks run in parallel and in no order, so a launch never
// updates its input in place).
//
// Window loads: with two input buffers, the window of the block's next tile
// is copied into one while the block computes on the other: cp.async
// (async_copy.cuh), each thread starting its share of the copies and
// waiting for them only before the tile that needs them, with the copy's
// zero fill beyond the domain giving the window's zeros there. Where ny is
// a multiple of 4 (and the planes 16-byte aligned) each copy moves 4 cells,
// else 1. A window row starts at the 16-byte boundary at or before the
// window's first column, so a block's window sits `s` = (j0 mod 4) columns
// into its rows, and the rows are padded to a multiple of 4 cells. With
// one buffer the copy of the next tile starts after the current one is
// stored, as a block per tile would, but on persistent blocks. (The Tensor Memory
// Accelerator's tensor copies, which would take the copies off the compute
// threads, fault with an illegal instruction on the H100 machines this was
// measured on, the CUDA toolkit's own libcu++ example included; PERF.md.)
//
// Ring budget: an RK stage at element e reads the coefficients of e - 1 and
// e + 1, and the velocity of element e needs nodes e and e + 1, so each
// stage invalidates one ring on either side. The host runs at most
// K_CAP = (H - 1) // stages substeps per launch, as transport_tiled.py does
// (its extra ring is the block-edge velocity sample; here that ring is
// absorbed by the first stage, so the budget is one ring conservative).
//
// Shared memory: one or two input buffers of u, v and the coefficients, and
// a scratch buffer of the coefficients (two for rk3). rk2's first stage
// writes the scratch buffer from the input; its second stage reads the
// scratch around the element and the input at the element (the step's
// base) and writes the input in place, which is safe because every element
// reads only its own base value. rk3's second stage reads the first scratch
// around the element and the base, and writes the second scratch: its
// neighbours read the first in the same stage, and the third stage needs
// the base again. The third stage reads the second scratch and the base and
// writes the input in place, as rk2's second does. A stage writes zeros at the cells of its region outside the
// domain, so the scratch buffer, which holds the previous tile's values,
// reads as zeros there like the copied window. The face masks, and on a
// graded or spherical mesh the transport's 5 metric planes, are read from
// global memory (read-only, L1/L2), so the metric does not grow the shared
// memory of a block.
//
// The HO path (kQv) passes the precomputed quadrature velocity of
// ho_velocity_to_quad instead of (u, v): 4 + 4 volume planes and 2 + 2 face
// planes (9 + 9 and 3 + 3 at dG2), read from global memory like the metric planes, so the window
// holds the coefficients only and the sampling is skipped. An element's
// right and top faces read the neighbour's vn_x and vn_y, which is the
// plain version's shifted left and bottom face fluxes.
//
// Walls: loads outside the domain are zeros and cells outside the domain
// are never updated, as in transport.cu's load_coeffs and at(). Each element
// runs dg1_stage_cell of dg1_body.cuh with the wall flags of its global
// index, exactly as dg1_rk_stage does (the JAX kernel zeroes the wall
// columns of the face masks instead; both give a zero flux there), so this
// schedule equals dg1_rk_stage's bit for bit. On a periodic axis (the
// periodic instances, on the launch's `wrap` axes) a window cell beyond the
// domain is copied from, and computed as, its wrapped cell, and no face is
// a wall.
//
// The kernel template lives in transport_tiled.cuh; this source compiles
// its closed instances without TVB, transport_tiled_forms.cu the TVB and
// the periodic forms (template arguments, kTvb and kWrap, so that the
// closed instances keep their code), and transport_tiled_spmd.cu the TVB
// form of a rank block widened by ghost cells (kWalls): there the global
// walls sit inside the launch's domain, at rows and columns the host
// passes, and the edges of the widened block are no walls to the limiter
// (the ring beyond them is discarded), as the JAX kernel's wall-delta
// masks have it; transport_tiled_spmd_qv.cu the same form in the HO path's
// qv form (the samples widened with the block).
//
// The TVB form (kTvb, dG1 and dG2 on a uniform mesh, whose tolerance is one
// number an axis): each stage writes its unlimited values, and after a
// barrier the TVB and positivity limiter (dg_tvb_limit, as dg1_limit runs
// it) limits them in place one ring further in, reading the neighbours'
// means; so each stage spoils two rings, and the host runs at most
// (H - 1) // (2 stages) substeps a launch.
//
// What bounds it on the H100 (dG1): a grid-wide dg1_rk_stage launch reads
// 13 planes and writes 9 per stage. Here the tracers are read and written once
// per launch (the window's ring ~1.4x more reads, mostly from L2), and the
// stage math, ~800 float operations per element and stage, runs on the
// window out of shared memory at ((T + 2H)/T)^2 redundant work in the first
// stage. With the loads behind the compute, the arithmetic and the
// shared-memory reads of the stages set the time.
#include <cstdint>
#include <cstring>

#include "transport_tiled.cuh"

namespace nst {

// The instance of a launch as an untyped function pointer (for the
// attribute and occupancy queries); null where there is none.
const void* transport_tiled_ptr(int degree, bool metric, bool qv, bool vec, bool tvb, int wrap,
                                bool walls) {
  switch (degree) {
    case 0: return reinterpret_cast<const void*>(transport_tiled_of<0>(metric, qv, vec, tvb, wrap, walls));
    case 1: return reinterpret_cast<const void*>(transport_tiled_of<1>(metric, qv, vec, tvb, wrap, walls));
    default: return reinterpret_cast<const void*>(transport_tiled_of<2>(metric, qv, vec, tvb, wrap, walls));
  }
}

// The launch's arguments at degree kDeg (see nst_transport_tiled), then the
// launch of `grid` blocks with `bytes` of shared memory.
template <int kDeg>
int tiled_call(const float* psi_in, float* psi_out, const float* u, const float* v,
               const float* face_x, const float* face_y, const void* const* metric,
               const void* const* qv, int nx, int ny, int n_tracers, int group, int tile,
               int halo, int n_sub, int n_stages, int threads, int n_buffers, int vec,
               int blocks, int compute, int wrap, const float* tvb, const int* walls,
               const float* weights, float dt, const float* tables, int bytes,
               cudaStream_t stream) {
  TransportTiledArgs<kDeg> g = {};
  g.psi_in = psi_in;
  g.psi_out = psi_out;
  g.u = u;
  g.v = v;
  g.face_x = face_x;
  g.face_y = face_y;
  if (metric != nullptr) std::memcpy(&g.m, metric, sizeof(g.m));
  if (qv != nullptr) std::memcpy(&g.qv, qv, sizeof(g.qv));
  g.nx = nx;
  g.ny = ny;
  g.n_tracers = n_tracers;
  g.group = group;
  g.n_groups = n_tracers / group;
  g.tile = tile;
  g.halo = halo;
  g.tiles_j = (ny + tile - 1) / tile;
  g.n_items = (nx + tile - 1) / tile * g.tiles_j * g.n_groups;
  g.n_buffers = n_buffers;
  g.n_sub = n_sub;
  g.n_stages = n_stages;
  g.compute = compute;
  g.wrap = wrap;
  if (tvb != nullptr) {
    g.tol_x = tvb[0];
    g.tol_y = tvb[1];
  }
  for (int w = 0; w < 4; ++w) g.wall[w] = walls != nullptr ? walls[w] : -1;
  for (int s = 0; s < kTransportMaxStages; ++s) {
    g.a[s] = weights[s];
    g.b[s] = weights[kTransportMaxStages + s];
  }
  g.dt = dt;
  std::memcpy(&g.tb, tables, sizeof(g.tb));
  const auto kernel = transport_tiled_of<kDeg>(metric != nullptr, qv != nullptr, vec != 0,
                                               tvb != nullptr, wrap, walls != nullptr);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported by a later launch
    return static_cast<int>(err);
  }
  const int grid = blocks < g.n_items ? blocks : g.n_items;
  kernel<<<grid, threads, bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nst

extern "C" {

// Dynamic shared memory of one block (tile, halo, n_coeff coefficient
// planes in a window: K x the tracers of a group, n_buffers input buffers;
// qv: the HO path's window, without u and v; n_stages 3 takes a second
// scratch buffer).
int nst_transport_tiled_shared_bytes(int tile, int halo, int n_coeff, int n_buffers, int qv,
                                     int n_stages) {
  return nst::TransportLayout(tile, halo, n_coeff, qv != 0, n_stages).bytes(n_buffers);
}

// Blocks of `threads` threads with `bytes` of shared memory that one SM
// holds at once (the kernel of the degree, metric, qv, copy width and TVB
// form given: tvb 1, the TVB form, 2 its rank grid form with the walls
// given), or minus a CUDA error code.
int nst_transport_tiled_blocks_per_sm(int degree, int metric, int qv, int vec, int tvb,
                                      int threads, int bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
  const void* kernel =
      nst::transport_tiled_ptr(degree, metric != 0, qv != 0, vec != 0, tvb != 0, 0, tvb == 2);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return per_sm;
}

// One round at `degree` (0, 1 or 2; tables: its DgTables), by blocks of
// `threads` threads (at most 768, 384 at dG2): n_sub substeps of an
// n_stages-stage SSP-RK scheme (1: rk1, 2: rk2, 3: rk3; weights: a[3] then
// b[3], stage s computing lim(a[s] base + b[s] (psi + dt rhs(psi))), a[0]
// = 0) from psi_in into psi_out, both (K, n_tracers, nx, ny), which must
// not alias; n_sub * n_stages <= halo - 1. A block's window holds `group`
// tracers (n_tracers a multiple of it). Tiles of `tile`; n_buffers 1 or 2
// input buffers a block; vec: copy 16 bytes at a time (ny a multiple of 4
// and 16-byte aligned planes), else 4; blocks: the grid (each block walks
// the items, a tile and a group each; at most one per item is launched: as
// many as the card holds at once for persistent blocks,
// nst_transport_tiled_blocks_per_sm); compute 0 only loads and stores the
// windows. metric: null on a uniform mesh, else the 5 plane pointers in
// the order of Dg1MetricPlanes. qv: null on the CG1 path (velocity sampled
// from u, v), else the quadrature-velocity plane pointers in the order of
// DgQvPlanes (12, or 24 at dG2; u and v are then not read). wrap: the
// periodic axes (kWrapX, kWrapY): window loads wrap, no face is a wall; a
// periodic axis at least `halo` long. tvb: null, or the TVB form's two
// tolerances (dG1 and dG2 on a uniform mesh; each stage then spoils two
// rings: n_sub * n_stages * 2 <= halo - 1). walls: null, or with tvb (a
// closed launch) the rank grid's form: 4 ints, the rows of the zeroed
// forward and backward x mean differences, then the columns of y's, -1
// for none (the global walls inside a widened block). Launches on
// `stream`, returns cudaGetLastError() (or the error of the shared-memory
// attribute); does not synchronise.
int nst_transport_tiled(const float* psi_in, float* psi_out, const float* u, const float* v,
                        const float* face_x, const float* face_y, const void* const* metric,
                        const void* const* qv, int nx, int ny, int n_tracers, int group,
                        int degree, int tile, int halo, int n_sub, int n_stages, int threads,
                        int n_buffers, int vec, int blocks, int compute, int wrap,
                        const float* tvb, const int* walls, const float* weights, float dt,
                        const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int max_threads =
      degree == 2 ? nst::TransportShape<2>::kMaxThreads : nst::TransportShape<1>::kMaxThreads;
  if (nx < 1 || ny < 1 || n_tracers < 1 || group < 1 || n_tracers % group != 0 || degree < 0 ||
      degree > 2 || tile < 1 || n_sub < 1 || n_stages < 1 ||
      n_stages > nst::kTransportMaxStages ||
      n_sub * n_stages * (tvb != nullptr ? 2 : 1) > halo - 1 || threads < 32 || wrap < 0 ||
      wrap > (nst::kWrapX | nst::kWrapY) || ((wrap & nst::kWrapX) && halo > nx) ||
      ((wrap & nst::kWrapY) && halo > ny) ||
      threads > max_threads || tile + 2 * halo > 1000 || n_buffers < 1 ||
      n_buffers > nst::kTransportMaxBuffers || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (vec && (ny % 4 != 0 || !aligned(psi_in) || (qv == nullptr && (!aligned(u) || !aligned(v))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_coeff = (degree == 0 ? 1 : degree == 1 ? 3 : 6) * group;
  const int bytes =
      nst_transport_tiled_shared_bytes(tile, halo, n_coeff, n_buffers, qv != nullptr, n_stages);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0:
      return nst::tiled_call<0>(psi_in, psi_out, u, v, face_x, face_y, metric, qv, nx, ny,
                                n_tracers, group, tile, halo, n_sub, n_stages, threads,
                                n_buffers, vec, blocks, compute, wrap, tvb, walls, weights, dt, tables,
                                bytes,
                                s);
    case 1:
      return nst::tiled_call<1>(psi_in, psi_out, u, v, face_x, face_y, metric, qv, nx, ny,
                                n_tracers, group, tile, halo, n_sub, n_stages, threads,
                                n_buffers, vec, blocks, compute, wrap, tvb, walls, weights, dt, tables,
                                bytes,
                                s);
    default:
      return nst::tiled_call<2>(psi_in, psi_out, u, v, face_x, face_y, metric, qv, nx, ny,
                                n_tracers, group, tile, halo, n_sub, n_stages, threads,
                                n_buffers, vec, blocks, compute, wrap, tvb, walls, weights, dt, tables,
                                bytes,
                                s);
  }
}

}  // extern "C"
