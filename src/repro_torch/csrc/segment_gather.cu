// Segment gather-sum over a CSR for Hopper (sm_90a): the GNN's mean
// aggregation and its gradient.
//
// Replaces no TPU kernel.  The reference aggregates with jnp.take of the
// source rows and jax.ops.segment_sum by destination
// (src/repro/models/gnn.py, _aggregate), which XLA fuses.  Done the plain
// way on the card it materialises the (E, d) messages (24.7 GB at
// ogb_products' layer 0, 31.7 GB at layer 1, kept for the backward),
// and index_add_ sums through atomics in an order that changes from run
// to run.  This kernel keeps no (E, d) buffer, sums each segment in edge
// order, and is its own backward over the transposed CSR.
//
// x (N, d) fp32, idx (E,) int32 grouped by segment, ptr (R + 1,) int64,
// scale (R,) fp32 or null; out (R, d) fp32; ticket: one uint32 of
// scratch, zeroed here on the stream:
//   out[r] = scale[r] * sum_{e in [ptr[r], ptr[r+1])} x[idx[e]]
// in fp32 in e's order; an id outside [0, N) adds nothing
// (segment_gather.cuh).
//
// What bounds it on an H100: bytes, and most of them are not compulsory.
// Each edge reads one row of x (400 B at d = 100, 512 B at d = 128) at a
// data-dependent address.  Two bounds, both over 3.35 TB/s:
// - compulsory: x, idx, ptr and scale read once, out written once
//   (2.24 GB, 0.67 ms at ogb_products' layer 0);
// - gathered rows: every edge's row read, less the share the 50 MB L2
//   can serve when sources are uniform (L2 / |x|, 5% at d = 100), plus
//   idx, ptr, scale and out: 24.7 GB, 7.4 ms at d = 100; 9.5 ms at
//   d = 128.
// So the kernel is a random-read stream, and its rate is set by the
// bytes it keeps in flight (Little's law: 3.35 TB/s x ~1-2 us of loaded
// latency is 25-50 KB an SM) and by how little of its time the SMs spend
// waiting on anything but rows.
//
// Design:
// - a persistent one-wave grid whose warps take tickets by an atomicAdd:
//   first, group by group, each heavy segment (more than SG_HEAVY
//   edges) alone, then each group's runs of consecutive light segments
//   (segment_gather.cuh, the work order).  In-degrees are skewed (the
//   largest is hundreds of times the mean), and a warp sums a segment
//   at the rate its rows in flight allow, so a heavy segment started
//   late in the index would set the tail: started first, it overlaps
//   the rest;
// - a run's segment ends and scales loaded once, a lane each, and its
//   edges walked as one stream: ids 32 a round, the next round's
//   loaded under this round's rows, and rows SG_DEPTH a lane in flight
//   (every load of a batch issued, predicated on a valid id, before the
//   first add), segments stored where the stream crosses their ends, so
//   the median segment of ~8 edges costs no dependent round trip of its
//   own (the kernel before it paid three: ptr, ids, then rows, one row
//   in flight a warp);
// - lanes along the columns (one float4 a lane where d % 4 == 0 and the
//   pointers are 16-byte aligned, so a warp reads a 512-byte row in one
//   instruction, else one float a lane, in passes of 32 columns);
// - one accumulator a column, one store per output element, no atomics
//   on out: the sum order is each segment's edge order, as before, so
//   the bits equal the plain version's and two launches give the same
//   bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_gather.cuh"

template <int V>
__global__ void __launch_bounds__(SG_THREADS) segment_gather_kernel(
    const float* __restrict__ x, const int* __restrict__ idx,
    const int64_t* __restrict__ ptr, const float* __restrict__ scale,
    float* __restrict__ out, int64_t n, int64_t d, int64_t r_count,
    unsigned int* __restrict__ ticket) {
  const int lane = threadIdx.x & (SG_WARP - 1);
  const int64_t tickets = sg_tickets(r_count);
  for (;;) {
    unsigned int t = 0;
    if (lane == 0) t = atomicAdd(ticket, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    if ((int64_t)t >= tickets) return;
    sg_ticket_lane<V>(x, idx, ptr, scale, out, n, d, r_count, t, lane);
  }
}

template <int V>
static cudaError_t sg_blocks_per_sm(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, segment_gather_kernel<V>, SG_THREADS, 0);
}

// CTAs a streaming multiprocessor holds on the 16-byte path (vec != 0)
// or the scalar one: the grid is that many a multiprocessor.
extern "C" int segment_gather_blocks_per_sm(int vec, int* blocks) {
  return (int)(vec ? sg_blocks_per_sm<4>(blocks) : sg_blocks_per_sm<1>(blocks));
}

extern "C" int segment_gather_launch(const void* x, const void* idx,
                                     const void* ptr, const void* scale,
                                     void* out, int64_t n, int64_t d,
                                     int64_t r_count, void* ticket,
                                     void* stream_) {
  if (r_count == 0 || d == 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_;
  const bool vec = sg_vector_path(d, (uintptr_t)x, (uintptr_t)out);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = vec ? sg_blocks_per_sm<4>(&per_sm) : sg_blocks_per_sm<1>(&per_sm);
  if (err != cudaSuccess) return (int)err;
  const int64_t per_cta = SG_THREADS / SG_WARP;
  const int64_t want = (sg_tickets(r_count) + per_cta - 1) / per_cta;
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);   // one wave
  const int grid = (int)(want < most ? want : most);
  err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  const float* xs = (const float*)x;
  const int* ids = (const int*)idx;
  const int64_t* ps = (const int64_t*)ptr;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  unsigned int* tk = (unsigned int*)ticket;
  if (vec)
    segment_gather_kernel<4><<<grid, SG_THREADS, 0, stream>>>(
        xs, ids, ps, sc, o, n, d, r_count, tk);
  else
    segment_gather_kernel<1><<<grid, SG_THREADS, 0, stream>>>(
        xs, ids, ps, sc, o, n, d, r_count, tk);
  return (int)cudaGetLastError();
}
