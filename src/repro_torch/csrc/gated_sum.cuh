// The gated patch-row contraction shared by the conv-delta kernels
// (itp_stdp_conv.cu: ITP register reads; itp_counter.cu: counter windows).
//
// For M patch rows (batch x output positions), K patch elements and C output
// channels, with per-element magnitudes pre_mag (M, K) and post_mag (M, C):
//
//   dw[k, c] = sum_m (1 - pre[m, k]) * pre_mag[m, k] * post[m, c]
//            - sum_m pre[m, k] * (1 - post[m, c]) * post_mag[m, c]
//
// (potentiate where post fired alone, depress where pre fired alone).  The
// kernels differ only in how an element's magnitude is read; each builds a
// functor with pre(at, plane) / post(at, plane) in its kernel body and hands
// it to contract().
//
// What bounds it.  The bytes are few (the DCSNN conv1 call moves 1.7 MB, half
// a microsecond at the card's memory rate) and the double adds are few
// (5.5 M): the kernel is bound by latency, by how long one block's chain of
// loads, syncs, magnitude reads and dependent adds takes, and by how many SMs
// share the rows.  The design keeps that chain short and every SM busy.
//
// Design: one cooperative launch per call.
//   * Grid.  Blocks of 256 threads, as many as are co-resident on the card
//     (occupancy x SMs, at most MAX_BLOCKS), cut into `splits` contiguous row
//     ranges times output-tile slots.  The split is chosen from M, K and C:
//     at least MIN_ROWS rows per block, all blocks of the card when M allows.
//   * Output tile.  Each thread owns a 4 x 4 block of (k, c) outputs, so it
//     keeps 16 independent double accumulators.  A tile is up to 256 such
//     micro-tiles (all K x C outputs of the paper nets' conv layers, so each
//     element's magnitude is read once in the whole grid); threads left over
//     become row lanes (at most MAX_LANES) that walk the tile's rows in
//     parallel.
//   * Rows.  A block stages tm rows at a time: cp.async copies the next tile's
//     raw spikes and history words into one shared buffer while the current
//     one is summed from the other.  Each element's gated magnitude,
//     (1-pre)*pre_mag and (1-post)*post_mag, is computed once per tile into
//     shared memory beside its spike.  Each lane then sums RPT rows per pass,
//     a fixed unrolled trip count; rows past M, and k, c past K, C, are
//     zero-filled in shared memory, so the ragged tail adds nothing and the
//     wrapper pads nothing.  The shared layouts put the threads of a warp on
//     neighbouring words (no bank conflicts: a layout with a 128-byte stride
//     between threads cost more than the whole contraction).
//   * Sums across lanes and blocks, in one kernel.  The lanes' accumulators
//     go through shared memory once and are added in a fixed pairwise tree in
//     registers; each block writes its partials to a (K*C, splits) float64
//     scratch tensor the wrapper allocates per call (torch.empty: every used
//     slot is written before it is read); the grid syncs (cooperative_groups);
//     then every output is summed over its splits by one warp, each lane over
//     a fixed stride, then a fixed shuffle tree, and rounded to float32 once.
//     No atomics, no state kept across calls on the card, no second launch.
//     M = 0 gives a zero delta.
//
// Arithmetic: no tensor cores.  The gated magnitudes are float32, written
// with __fmul_rn/__fsub_rn so nvcc does not contract them into FMAs.  Spikes
// are {0,1}, so every product term is an exact float32 value; each is added
// to a double accumulator with one fma (the product of a float32 value and a
// {0,1} spike is exact, so the fma rounds once, as an add of the term does).
// The (K, C) delta is rounded to float32 once.  Where the magnitudes span few
// binades (a double holds their sum over millions of rows exactly) the
// result is the correctly rounded exact sum, whatever the order, and equals
// the plain version's float64 contraction bit for bit; otherwise the fixed
// order (the split depends only on the shape and the card) keeps it equal run
// to run.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace gated {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;      // per SM: __launch_bounds__ holds registers to 128
constexpr int WARPS = THREADS / 32;
constexpr int RK = 4;              // patch elements per thread
constexpr int RC = 4;              // output channels per thread
constexpr int RPT = 4;             // rows per lane per pass (unrolled)
constexpr int TM_TARGET = 32;      // rows per staged tile when lanes are few
constexpr int MAX_CG = 16;         // channel micro-tiles per output tile (64 channels)
constexpr int MAX_LANES = 16;      // row lanes per micro-tile (one register tree)
constexpr int MIN_ROWS = 8;        // rows per split at least
constexpr int MAX_BLOCKS = 1024;   // grid cap (co-residency caps it lower)
constexpr long MAX_SMEM = 227 * 1024;

// Launch plan, computed on the host and passed by value.
struct Plan {
  int M, K, C;
  int nkg, ncg;            // micro-tiles per output tile along k and c
  int lanes, groups, tm;   // row lanes; passes per tile; rows per tile = lanes*RPT*groups
  int tiles_k, tiles_c;    // output tiles
  int slots, splits, rows; // grid = splits x slots; rows per split
  int planes, params;      // history planes per side (1 or depth); parameter floats per side
  // dynamic shared memory (bytes): two raw stages, the magnitudes, the parameters
  int post_at, pre_hist_at, post_hist_at, pre_plane, post_plane, stage, mag_at, param_at, smem;
};

// cp.async of one G-byte granule (G = 16 or 4), of which the first `bytes`
// are read and the rest zero-filled.
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Byte offset of `p` within its aligned G-byte granule.
template <int G = 16>
__device__ __forceinline__ int head(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & (G - 1));
}

// Asynchronously copy the n bytes at src into shared memory: the aligned
// G-byte granules covering them land at dst (G-aligned), so byte i is at
// dst + head<G>(src) + i.  The granule holding the first byte is read whole
// (an aligned granule cannot cross a page); the last one only up to the
// range's end.  Float operands copied in 4-byte granules have no head.
template <int G = 16>
__device__ __forceinline__ void copy_range(char* dst, const void* src, int n) {
  if (n <= 0) return;
  const char* base = static_cast<const char*>(src) - head<G>(src);
  const int total = head<G>(src) + n;
  for (int w = threadIdx.x; G * w < total; w += THREADS) {
    const int left = total - G * w;
    cp_async<G>(dst + G * w, base + G * w, left < G ? left : G);
  }
}

// The kernel body: block b = (slot, split) sums rows [split*rows, +rows) into
// its output tiles' partials; after the grid sync every block sums splits.
// Hist is the history element (uint8_t word or float bitplane); plane d of a
// side lies d*M*X elements after its start.
template <class Hist, class Mag>
__device__ __forceinline__ void contract(float* __restrict__ out, double* __restrict__ partial,
                                         const float* __restrict__ pre,
                                         const float* __restrict__ post,
                                         const Hist* __restrict__ pre_hist,
                                         const Hist* __restrict__ post_hist,
                                         const float* __restrict__ param_ltp,
                                         const float* __restrict__ param_ltd, const Plan p,
                                         const Mag& mag, char* smem) {
  const int tid = threadIdx.x;
  const int M = p.M, K = p.K, C = p.C;
  const int n_micro = p.nkg * p.ncg;
  const int lane = tid / n_micro, u = tid - lane * n_micro;
  const bool active = lane < p.lanes;
  const int kg = u / p.ncg, cg = u - kg * p.ncg;
  const int tkp = RK * p.nkg, tcp = RC * p.ncg;
  const int split = blockIdx.x % p.splits, slot = blockIdx.x / p.splits;
  const int m_begin = min(split * p.rows, M), m_end = min(m_begin + p.rows, M);
  const int row_tiles = (m_end - m_begin + p.tm - 1) / p.tm;
  const int pre_plane = p.pre_plane / static_cast<int>(sizeof(Hist));
  const int post_plane = p.post_plane / static_cast<int>(sizeof(Hist));
  // the magnitudes, a row's k = RK*kg + q at [row][q][kg] (and c likewise),
  // and the lanes' sums at [slot][thread], so the threads of a warp touch
  // neighbouring words: no bank conflicts
  double2* s_pre_side = reinterpret_cast<double2*>(smem + p.mag_at);  // {ltp, -pre}
  double2* s_post_side = s_pre_side + p.tm * tkp;                     // {post, ltd}
  double* s_red = reinterpret_cast<double*>(smem + p.mag_at);
  const int n_threads = p.lanes * n_micro;
  const int n_slots = n_micro * RK * RC;
  // History planes are copied in 16-byte granules when every plane has the
  // same head (one plane of words, or M*X a multiple of 4 floats), else in
  // 4-byte ones (float planes then have no head at all).
  const bool pre_wide = p.planes == 1 || static_cast<long>(M) * K % 4 == 0;
  const bool post_wide = p.planes == 1 || static_cast<long>(M) * C % 4 == 0;

  auto stage = [&](int s, int m0) {  // cp.async rows [m0, m0+tm) into raw stage s
    char* st = smem + s * p.stage;
    const int rows = min(p.tm, m_end - m0);
    copy_range(st, pre + static_cast<size_t>(m0) * K, rows * K * 4);
    copy_range(st + p.post_at, post + static_cast<size_t>(m0) * C, rows * C * 4);
    for (int d = 0; d < p.planes; ++d) {   // every plane at the same offset
      const Hist* pre_h = pre_hist + (static_cast<size_t>(d) * M + m0) * K;
      const Hist* post_h = post_hist + (static_cast<size_t>(d) * M + m0) * C;
      char* pre_dst = st + p.pre_hist_at + d * p.pre_plane;
      char* post_dst = st + p.post_hist_at + d * p.post_plane;
      pre_wide ? copy_range<16>(pre_dst, pre_h, rows * K * sizeof(Hist))
               : copy_range<4>(pre_dst, pre_h, rows * K * sizeof(Hist));
      post_wide ? copy_range<16>(post_dst, post_h, rows * C * sizeof(Hist))
                : copy_range<4>(post_dst, post_h, rows * C * sizeof(Hist));
    }
  };

  if (row_tiles > 0) {   // the magnitudes' parameters, in the first rows' copy group
    copy_range<4>(smem + p.param_at, param_ltp, 4 * p.params);
    copy_range<4>(smem + p.param_at + 4 * p.params, param_ltd, 4 * p.params);
  }
  // this thread's first element of a magnitude pass, and its stride, as
  // (row, column) steps: no division in the loops
  const int pre_r0 = tid / tkp, pre_x0 = tid - pre_r0 * tkp;
  const int pre_dr = THREADS / tkp, pre_dx = THREADS - pre_dr * tkp;
  const int post_r0 = tid / tcp, post_x0 = tid - post_r0 * tcp;
  const int post_dr = THREADS / tcp, post_dx = THREADS - post_dr * tcp;
  for (int t = slot; t < p.tiles_k * p.tiles_c; t += p.slots) {
    const int k0 = (t / p.tiles_c) * tkp, c0 = (t % p.tiles_c) * tcp;
    double acc[RK][RC];
#pragma unroll
    for (int a = 0; a < RK; ++a)
#pragma unroll
      for (int b = 0; b < RC; ++b) acc[a][b] = 0.0;

    if (row_tiles > 0) stage(0, m_begin);
    cp_async_commit();
    for (int it = 0; it < row_tiles; ++it) {
      const int m0 = m_begin + it * p.tm;
      if (it + 1 < row_tiles) stage((it + 1) & 1, m0 + p.tm);
      cp_async_commit();
      cp_async_wait_one();   // this tile's copies have landed
      __syncthreads();

      // each element's gated magnitude, once per tile
      const char* st = smem + (it & 1) * p.stage;
      const float* r_pre =
          reinterpret_cast<const float*>(st + head(pre + static_cast<size_t>(m0) * K));
      const float* r_post = reinterpret_cast<const float*>(
          st + p.post_at + head(post + static_cast<size_t>(m0) * C));
      const Hist* pre_h = pre_hist + static_cast<size_t>(m0) * K;
      const Hist* post_h = post_hist + static_cast<size_t>(m0) * C;
      const Hist* r_pre_hist = reinterpret_cast<const Hist*>(
          st + p.pre_hist_at + (pre_wide ? head<16>(pre_h) : head<4>(pre_h)));
      const Hist* r_post_hist = reinterpret_cast<const Hist*>(
          st + p.post_hist_at + (post_wide ? head<16>(post_h) : head<4>(post_h)));
#pragma unroll 1   // one element at a time: the accumulators stay in registers
      for (int e = tid, r = pre_r0, x = pre_x0; e < p.tm * tkp; e += THREADS) {
        const int k = k0 + x;
        double2 v = make_double2(0.0, 0.0);
        if (m0 + r < m_end && k < K) {
          const int i = r * K + k;
          const float s = r_pre[i];
          const float m = mag.pre(r_pre_hist + i, pre_plane);
          const float g = __fmul_rn(__fsub_rn(1.0f, s), m);
          v = make_double2(static_cast<double>(g), -static_cast<double>(s));
        }
        s_pre_side[r * tkp + (x % RK) * p.nkg + x / RK] = v;
        r += pre_dr;
        x += pre_dx;
        if (x >= tkp) {
          x -= tkp;
          ++r;
        }
      }
#pragma unroll 1
      for (int e = tid, r = post_r0, x = post_x0; e < p.tm * tcp; e += THREADS) {
        const int c = c0 + x;
        double2 v = make_double2(0.0, 0.0);
        if (m0 + r < m_end && c < C) {
          const int i = r * C + c;
          const float s = r_post[i];
          const float m = mag.post(r_post_hist + i, post_plane);
          const float g = __fmul_rn(__fsub_rn(1.0f, s), m);
          v = make_double2(static_cast<double>(s), static_cast<double>(g));
        }
        s_post_side[r * tcp + (x % RC) * p.ncg + x / RC] = v;
        r += post_dr;
        x += post_dx;
        if (x >= tcp) {
          x -= tcp;
          ++r;
        }
      }
      __syncthreads();

      if (active) {
        for (int g = 0; g < p.groups; ++g) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = (g * RPT + i) * p.lanes + lane;
            const double2* a = s_pre_side + r * tkp + kg;
            const double2* b = s_post_side + r * tcp + cg;
            double2 bv[RC];
#pragma unroll
            for (int y = 0; y < RC; ++y) bv[y] = b[y * p.ncg];
#pragma unroll
            for (int x = 0; x < RK; ++x) {
              const double2 av = a[x * p.nkg];
#pragma unroll
              for (int y = 0; y < RC; ++y) {
                acc[x][y] = fma(av.x, bv[y].x, acc[x][y]);   // + ltp * post
                acc[x][y] = fma(av.y, bv[y].y, acc[x][y]);   // - pre * ltd
              }
            }
          }
        }
      }
      __syncthreads();   // the stage and the magnitudes are free again
    }

    // the lanes' accumulators, added in a fixed pairwise tree
    if (active) {
#pragma unroll
      for (int x = 0; x < RK; ++x)
#pragma unroll
        for (int y = 0; y < RC; ++y) s_red[(x * RC + y) * n_threads + tid] = acc[x][y];
    }
    __syncthreads();
    for (int q = tid; q < n_slots; q += THREADS) {   // q = (x*RC + y) * n_micro + u
      double v[MAX_LANES];   // lanes past p.lanes add an exact 0
      const int xy = q / n_micro, uu = q - xy * n_micro;
#pragma unroll
      for (int l = 0; l < MAX_LANES; ++l) {
        v[l] = l < p.lanes ? s_red[xy * n_threads + l * n_micro + uu] : 0.0;
      }
#pragma unroll
      for (int step = 1; step < MAX_LANES; step *= 2)
#pragma unroll
        for (int l = 0; l + step < MAX_LANES; l += 2 * step) v[l] += v[l + step];
      const int kk = uu / p.ncg;
      const int k = k0 + RK * kk + xy / RC;
      const int c = c0 + RC * (uu - kk * p.ncg) + xy % RC;
      if (k < K && c < C) partial[(static_cast<size_t>(k) * C + c) * p.splits + split] = v[0];
    }
    __syncthreads();   // s_red is the next tile's magnitude buffer
  }

  cooperative_groups::this_grid().sync();

  // every output summed over its splits: one warp each, each lane's loads in
  // flight 16 at a time (one round trip up to 512 splits), then added in a
  // fixed order
  const int warp = tid / 32, wl = tid % 32;
  for (int o = blockIdx.x * WARPS + warp; o < K * C; o += gridDim.x * WARPS) {
    const double* src = partial + static_cast<size_t>(o) * p.splits;
    double sum = 0.0;
    for (int base = wl; base < p.splits; base += 32 * 16) {
      double v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[j] = base + 32 * j < p.splits ? __ldcg(src + base + 32 * j) : 0.0;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) sum += v[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (wl == 0) out[o] = __double2float_rn(sum);
  }
}

inline int ceil_div(long a, long b) { return static_cast<int>((a + b - 1) / b); }
inline int align16(long n) { return static_cast<int>((n + 15) / 16 * 16); }

inline void tile_shape(int K, int C, int* nkg, int* ncg, int* tiles_k, int* tiles_c) {
  *ncg = ceil_div(C, RC) < MAX_CG ? ceil_div(C, RC) : MAX_CG;
  *nkg = ceil_div(K, RK) < THREADS / *ncg ? ceil_div(K, RK) : THREADS / *ncg;
  *tiles_k = ceil_div(K, RK * *nkg);
  *tiles_c = ceil_div(C, RC * *ncg);
}

// The most splits a launch of this shape uses: the wrapper's scratch holds
// K * C * max_splits(M, K, C) doubles.
inline int max_splits(int M, int K, int C) {
  int nkg, ncg, tiles_k, tiles_c;
  tile_shape(K, C, &nkg, &ncg, &tiles_k, &tiles_c);
  const int slots = tiles_k * tiles_c < MAX_BLOCKS ? tiles_k * tiles_c : MAX_BLOCKS;
  const int by_rows = ceil_div(M, MIN_ROWS);
  const int by_grid = MAX_BLOCKS / slots;
  const int s = by_rows < by_grid ? by_rows : by_grid;
  return s > 1 ? s : 1;
}

// Shared memory of the plan's tile (fills the layout fields); bytes or -1.
inline long layout(Plan& p, int hist_bytes) {
  const long tm = p.tm;
  const long pre_plane = align16(tm * p.K * hist_bytes + 16);   // + a chunk's head
  const long post_plane = align16(tm * p.C * hist_bytes + 16);
  const long post_at = align16(tm * p.K * 4 + 16);
  const long pre_hist_at = post_at + align16(tm * p.C * 4 + 16);
  const long post_hist_at = pre_hist_at + p.planes * pre_plane;
  const long stage = post_hist_at + p.planes * post_plane;
  const long mag = tm * (RK * p.nkg + RC * p.ncg) * 16;
  const long red = static_cast<long>(p.lanes) * p.nkg * p.ncg * RK * RC * 8;
  const long param_at = 2 * stage + (mag > red ? mag : red);
  const long smem = param_at + align16(2L * 4 * p.params);
  if (smem > MAX_SMEM) return -1;
  p.pre_plane = static_cast<int>(pre_plane);
  p.post_plane = static_cast<int>(post_plane);
  p.post_at = static_cast<int>(post_at);
  p.pre_hist_at = static_cast<int>(pre_hist_at);
  p.post_hist_at = static_cast<int>(post_hist_at);
  p.stage = static_cast<int>(stage);
  p.mag_at = static_cast<int>(2 * stage);
  p.param_at = static_cast<int>(param_at);
  p.smem = static_cast<int>(smem);
  return smem;
}

// Blocks of `kernel` with `smem` bytes of dynamic shared memory that fit on
// the card at once (at most MAX_BLOCKS).  The answer depends only on the
// kernel, the card and smem, so the host keeps it (and sets the kernel's
// shared-memory limit once); a launch then costs no runtime queries.
template <class Kernel>
cudaError_t co_resident(Kernel kernel, int device, int smem, int* blocks) {
  static std::mutex mutex;
  static std::map<std::tuple<const void*, int, int>, int> known;
  const std::lock_guard<std::mutex> lock(mutex);
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), device, smem);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(MAX_SMEM));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms < MAX_BLOCKS ? per_sm * sms : MAX_BLOCKS;
  if (*blocks < 1) return cudaErrorInvalidConfiguration;
  known[key] = *blocks;
  return cudaSuccess;
}

// Plans and launches `kernel(args..., plan)` on `stream` as one cooperative
// grid.  hist_bytes: 1 (uint8 words) or 4 (float32 bitplanes); planes: 1 or
// depth; params: parameter floats per side staged in shared memory.  Returns
// the cudaError_t (0 = success); K or C of 0 launches nothing.  A shape whose
// smallest row tile (RPT rows of every operand, twice) does not fit in shared
// memory, (K + C) * (4 + planes * hist_bytes) above ~14 KB, is refused with
// cudaErrorInvalidValue.
template <class... KArgs, class... Args>
int launch(void (*kernel)(KArgs...), int M, int K, int C, int hist_bytes, int planes,
           int params, int device, void* stream, Args... args) {
  if (K <= 0 || C <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p{};
  p.M = M;
  p.K = K;
  p.C = C;
  p.planes = planes;
  p.params = params;
  tile_shape(K, C, &p.nkg, &p.ncg, &p.tiles_k, &p.tiles_c);
  p.lanes = THREADS / (p.nkg * p.ncg) < MAX_LANES ? THREADS / (p.nkg * p.ncg) : MAX_LANES;
  p.groups = TM_TARGET / (p.lanes * RPT) > 1 ? TM_TARGET / (p.lanes * RPT) : 1;
  p.tm = p.lanes * RPT * p.groups;
  while (layout(p, hist_bytes) < 0) {   // fit the staged rows into shared memory
    if (p.groups > 1) {
      --p.groups;
    } else if (p.lanes > 1) {
      --p.lanes;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.tm = p.lanes * RPT * p.groups;
  }
  int resident = 0;
  err = co_resident(kernel, device, p.smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the M split: every co-resident block, at least MIN_ROWS rows each
  const int tiles = p.tiles_k * p.tiles_c;
  p.slots = tiles < resident ? tiles : resident;
  const int cap = max_splits(M, K, C);
  p.splits = resident / p.slots < cap ? resident / p.slots : cap;
  if (M == 0) {
    p.splits = 1;
    p.rows = 0;
  } else {
    p.rows = ceil_div(M, p.splits);
    if (p.rows > p.tm) p.rows = ceil_div(p.rows, p.tm) * p.tm;
    p.splits = ceil_div(M, p.rows);
  }
  if (p.rows < p.tm) {   // a split of fewer rows than a tile: a tile of just its rows
    const int rows = p.rows > 0 ? p.rows : 1;
    const int lanes = ceil_div(rows, RPT);
    p.lanes = lanes < p.lanes ? lanes : p.lanes;
    const int groups = ceil_div(rows, p.lanes * RPT);
    p.groups = groups < p.groups ? groups : p.groups;
    p.tm = p.lanes * RPT * p.groups;
    layout(p, hist_bytes);   // no larger than the planned tile, so it fits
  }

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits * p.slots);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args..., p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gated
