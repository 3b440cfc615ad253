// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces: repro/kernels/ssd_scan.py::ssd_scan (`_kernel`), the Pallas
// kernel of the Mamba2 mixer's prefill (models/mamba2.py::ssd_chunked).
//
// Computes, for each row b and head h, chunk by chunk in order, with the
// fp32 state H [hd, ds] carried across chunks (H starts at h0[b, h]):
//   cum_i = sum_{t <= i} dt_t A_h                       (within the chunk)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) H C_i
//   H    <- exp(cum_last) H + sum_j x_j (B_j dt_j exp(cum_last - cum_j))^T
// x [Bt, S, nh, hd] and B, C [Bt, S, ds] are read in the model's dtype
// (float32 or bfloat16) and computed in fp32; dt [Bt, S, nh], A [nh], y
// [Bt, S, nh, hd] and the state are fp32. S is a multiple of the chunk
// (the wrapper zero-pads, as ssd_chunked does).
//
// Bound: operations, at the fp32 rate of the CUDA cores. Per chunk of c
// tokens the dual form needs about c^2/2 (ds + nh hd) multiply-adds for
// C.B^T and the weighted sum, and 2 c nh hd ds for the state's two
// terms: about 1.6 GFLOP for one 1024-token row at full width, 25 us at
// 67 TFLOP/s, against 15 MB of inputs and outputs, 4.4 us at 3.35 TB/s.
//
// Design: the Pallas grid (B, nh, chunks) runs its chunk axis in order on
// one core and keeps the state in VMEM scratch. On Hopper blocks run in no
// order, so the chunk axis becomes a loop inside one block, and the state
// lives in shared memory for the whole row. Output column d of a head
// depends only on x[..., d] and state row H[d, :], so the head dim splits
// into slices of 16 columns, one block each, with no communication: a
// prefill row at full width (nh 32, hd 64) gives 128 blocks for the 132
// SMs instead of 32. C.B^T is the same for every head (one group) and
// every slice, so a first kernel computes it once per (row, chunk), over
// the lower-triangle 64 x 64 tile pairs only, into a scratch buffer in
// device memory (c^2 floats a chunk, 1 MB for a 1024-token row); the
// first version recomputed it in every (head, slice) block, which was
// most of its multiply-adds. A whole chunk of B and C in fp32 (2 x 128 KB
// at c = 256, ds = 128) does not fit beside the rest, so the scan cuts
// the chunk into 64-row tiles: for each tile of rows i, the tiles of
// columns j <= i are visited in turn, their C.B^T read from the buffer,
// masked to j <= i before the exp (the exponent is positive above the
// diagonal and would overflow), scaled into W in shared memory and
// multiplied into the tile's 64 x 16 outputs, which stay in registers
// until the carried state's term is added. The last row tile visits
// every column tile, so the state update is accumulated there, in
// registers, and written once the old state has served the last tile.
// The chunk's cumulative decay comes from a warp scan. Products are fp32
// FMAs on the CUDA cores and tiles are loaded without overlap; tensor
// cores (TF32 or bf16 inputs) and double-buffered TMA loads are for a
// later change.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // chunk rows (and columns) per tile
constexpr int kSlice = 16;     // head-dim columns per block

// Load kTile rows of a row-major [*, DS] matrix of T, from src on, into a
// padded fp32 tile [kTile][DS + 1] in shared memory, 16 bytes at a time.
template <typename T, int DS>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* tile) {
  constexpr int VEC = Vec16<T>::N;
  for (int v = threadIdx.x; v < kTile * DS / VEC; v += kThreads) {
    const int row = v / (DS / VEC), col = (v % (DS / VEC)) * VEC;
    float tmp[VEC];
    load16(src + (size_t)row * DS + col, tmp);
#pragma unroll
    for (int e = 0; e < VEC; ++e) tile[row * (DS + 1) + col + e] = tmp[e];
  }
}

// cb[b, k, i, j] = C_i . B_j within chunk k of row b, for the tile pairs
// (i-tile, j-tile) with j-tile <= i-tile; grid (pairs, chunks, Bt). Each
// thread forms a 4 x 4 micro-tile (rows ti + 16 r, columns tj + 16 c).
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                  float* __restrict__ cb, int S, int chunk) {
  constexpr int RS = DS + 1;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= (int)blockIdx.x) ++it;
  const int jt = blockIdx.x - it * (it + 1) / 2;
  const int k = blockIdx.y, b = blockIdx.z;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* Cs = smem;                      // [kTile][RS]
  float* Bs = Cs + kTile * RS;           // [kTile][RS]
  const size_t row0 = (size_t)b * S + (size_t)k * chunk;
  load_tile<T, DS>(Cm + (row0 + it * kTile) * DS, Cs);
  load_tile<T, DS>(Bm + (row0 + jt * kTile) * DS, Bs);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int s = 0; s < DS; ++s) {
    float cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = Cs[(ti + 16 * r) * RS + s];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = Bs[(tj + 16 * c) * RS + s];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
  }
  float* out = cb + ((size_t)b * (S / chunk) + k) * chunk * chunk;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[(size_t)(it * kTile + ti + 16 * r) * chunk + jt * kTile + tj +
          16 * c] = acc[r][c];
}

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ cb,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ hout, int S, int nh, int hd,
                    int chunk) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int RS = DS + 1;             // padded row of a B / C tile
  constexpr int WS = kTile + 1;          // padded row of W
  constexpr int DSTEP = kThreads / DS;   // state rows per pass of threads
  constexpr int NH = kSlice / DSTEP;     // state entries per thread
  static_assert(kThreads % DS == 0 && kSlice % DSTEP == 0, "DS");

  const int d0 = blockIdx.x * kSlice;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float A_h = A[h];

  extern __shared__ float smem[];
  float* Cs = smem;                      // [kTile][RS]  C rows i
  float* Bs = Cs + kTile * RS;           // [kTile][RS]  B rows j
  float* Xs = Bs + kTile * RS;           // [kTile][kSlice]  x rows j
  float* Ws = Xs + kTile * kSlice;       // [kTile][WS]  W[i][j]
  float* Hs = Ws + kTile * WS;           // [kSlice][RS]  the state slice
  float* cum = Hs + kSlice * RS;         // [chunk]
  float* dtv = cum + chunk;              // [chunk]
  float* sc = dtv + chunk;               // [chunk] dt_j exp(cum_last - cum_j)

  // thread roles: W entries (rows ti + 16 r, columns tj + 16 c); outputs
  // y[yi + 16 r][yd]; state entries H[sd + DSTEP r][ss]
  const int ti = tid / 16, tj = tid % 16;
  const int yi = tid / 16, yd = tid % 16;
  const int ss = tid % DS, sd = tid / DS;

  const size_t head_state = ((size_t)b * nh + h) * hd + d0;   // row of h0
  for (int e = tid; e < kSlice * DS; e += kThreads)
    Hs[(e / DS) * RS + e % DS] = h0[(head_state + e / DS) * DS + e % DS];

  const int n_tiles = chunk / kTile;
  for (int t0 = 0; t0 < S; t0 += chunk) {
    const float* cbk = cb + ((size_t)b * S + t0) * chunk;   // [chunk][chunk]
    __syncthreads();                     // the previous chunk is consumed
    for (int i = tid; i < chunk; i += kThreads)
      dtv[i] = dt[((size_t)b * S + t0 + i) * nh + h];
    __syncthreads();
    if (tid < 32) {                      // cumsum of dt A: a warp scan
      const int per = chunk / 32, base = lane * per;
      float run = 0.f;
      for (int q = 0; q < per; ++q) {
        run += dtv[base + q] * A_h;
        cum[base + q] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float excl = incl - run;
      for (int q = 0; q < per; ++q) cum[base + q] += excl;
    }
    __syncthreads();
    const float last = cum[chunk - 1];
    for (int i = tid; i < chunk; i += kThreads)
      sc[i] = dtv[i] * expf(last - cum[i]);

    float hacc[NH];
#pragma unroll
    for (int r = 0; r < NH; ++r) hacc[r] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      const bool last_tile = it == n_tiles - 1;   // sees every j: the state
      __syncthreads();                   // Cs of the previous tile is read
      load_tile<T, DS>(Cm + ((size_t)b * S + t0 + i0) * DS, Cs);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        if (jt > 0) __syncthreads();     // Bs, Xs, Ws of jt - 1 are read
        if (last_tile) load_tile<T, DS>(Bm + ((size_t)b * S + t0 + j0) * DS,
                                        Bs);
        for (int v = tid; v < kTile * kSlice / VEC; v += kThreads) {
          const int row = v / (kSlice / VEC);
          const int col = (v % (kSlice / VEC)) * VEC;
          float tmp[VEC];
          load16(x + (((size_t)b * S + t0 + j0 + row) * nh + h) * hd + d0 +
                     col,
                 tmp);
#pragma unroll
          for (int e = 0; e < VEC; ++e) Xs[row * kSlice + col + e] = tmp[e];
        }
        // W[i][j] = (C_i . B_j) L[i][j] dt_j, L masked to j <= i before exp
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tj + 16 * c;
            const float L = j <= i ? expf(cum[i] - cum[j]) : 0.f;
            Ws[(ti + 16 * r) * WS + tj + 16 * c] =
                cbk[(size_t)i * chunk + j] * L * dtv[j];
          }
        }
        __syncthreads();

        // y[i][d] += sum_j W[i][j] x[j][d]
        for (int jj = 0; jj < kTile; ++jj) {
          const float xv = Xs[jj * kSlice + yd];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r] = fmaf(Ws[(yi + 16 * r) * WS + jj], xv, acc[r]);
        }
        if (last_tile) {
          for (int jj = 0; jj < kTile; ++jj) {
            const float bw = Bs[jj * RS + ss] * sc[j0 + jj];
#pragma unroll
            for (int r = 0; r < NH; ++r)
              hacc[r] = fmaf(Xs[jj * kSlice + sd + DSTEP * r], bw, hacc[r]);
          }
        }
      }

      // the carried state's term: exp(cum_i) (H C_i)[d], then store y
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int il = yi + 16 * r;
        float dot = 0.f;
#pragma unroll 8
        for (int s = 0; s < DS; ++s)
          dot = fmaf(Cs[il * RS + s], Hs[yd * RS + s], dot);
        y[(((size_t)b * S + t0 + i0 + il) * nh + h) * hd + d0 + yd] =
            acc[r] + dot * expf(cum[i0 + il]);
      }
    }

    __syncthreads();                     // the old state has been read
    const float decay = expf(last);
#pragma unroll
    for (int r = 0; r < NH; ++r) {
      float* hp = Hs + (sd + DSTEP * r) * RS + ss;
      *hp = decay * *hp + hacc[r];
    }
  }

  __syncthreads();
  for (int e = tid; e < kSlice * DS; e += kThreads)
    hout[(head_state + e / DS) * DS + e % DS] = Hs[(e / DS) * RS + e % DS];
}

template <typename T, int DS>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0, void* y,
                   void* hout, void* cb, int Bt, int S, int nh, int hd,
                   int chunk, cudaStream_t stream) {
  if (chunk % kTile || hd % kSlice || S % chunk) return cudaErrorInvalidValue;
  const int nt = chunk / kTile;
  const size_t cb_smem = (size_t)2 * kTile * (DS + 1) * sizeof(float);
  auto cb_kernel = ssd_cb_kernel<T, DS>;
  cudaError_t err = allow_smem(cb_kernel, cb_smem);
  if (err != cudaSuccess) return err;
  cb_kernel<<<dim3(nt * (nt + 1) / 2, S / chunk, Bt), kThreads, cb_smem,
              stream>>>(static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                        static_cast<float*>(cb), S, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = (size_t)(2 * kTile * (DS + 1) + kTile * kSlice +
                               kTile * (kTile + 1) + kSlice * (DS + 1) +
                               3 * chunk) *
                      sizeof(float);
  auto kernel = ssd_scan_kernel<T, DS>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(hd / kSlice, nh, Bt), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(cb),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hout), S, nh, hd, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C share it). ds: 64 or 128;
// chunk a multiple of 64 dividing S; hd a multiple of 16 (the wrapper
// checks all of them). cb: fp32 scratch of Bt * S * chunk floats, which
// the first kernel fills with C.B^T and the scan reads.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* h0, void* y, void* hout,
                               void* cb, int Bt, int S, int nh, int hd,
                               int ds, int chunk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && ds == 64)
    return launch<float, 64>(x, dt, A, Bm, Cm, h0, y, hout, cb, Bt, S, nh,
                             hd, chunk, s);
  if (dtype == 0 && ds == 128)
    return launch<float, 128>(x, dt, A, Bm, Cm, h0, y, hout, cb, Bt, S, nh,
                              hd, chunk, s);
  if (dtype == 1 && ds == 64)
    return launch<__nv_bfloat16, 64>(x, dt, A, Bm, Cm, h0, y, hout, cb, Bt,
                                     S, nh, hd, chunk, s);
  if (dtype == 1 && ds == 128)
    return launch<__nv_bfloat16, 128>(x, dt, A, Bm, Cm, h0, y, hout, cb, Bt,
                                      S, nh, hd, chunk, s);
  return cudaErrorInvalidValue;
}
