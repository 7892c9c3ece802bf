// Trial forms of the E = 1 column route of the EmbeddingBag (fp32 table,
// int32 ids, no weights, sum), for tools/bag_gather_probe.py.  Every form
// adds a bag's ids in ascending order with eb_bag_column's expression, so
// all give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "embedding_bag.cuh"

__device__ __forceinline__ float ld_plain(const float* p) { return *p; }
// A row read that leaves the L1 to the ids.
__device__ __forceinline__ float ld_no_alloc(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float finish(float sum, int past) {
  return past ? __int_as_float(0x7fffffff) : sum;
}

// The column route's loop (eb_bag_column), with a CTA barrier every SYNC
// ids (0: none).
template <int THREADS, int SYNC, bool NO_ALLOC>
__global__ void __launch_bounds__(THREADS) k_loop(
    const float* __restrict__ t, const int* __restrict__ idx,
    const float* __restrict__, float* __restrict__ out, int64_t V, int B,
    int L) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  const bool live = b < B;
  if (SYNC == 0 && !live) return;
  const int* id = idx + (int64_t)(live ? b : 0) * L;
  float sum = 0.0f;
  int count = 0, past = 0;
#pragma unroll 8
  for (int i = 0; i < L; ++i) {
    if (SYNC && i && i % SYNC == 0) __syncthreads();
    const int r = live ? id[i] : -1;
    if (r >= 0 && r < V) {
      sum += 1.0f * (NO_ALLOC ? ld_no_alloc(t + r) : ld_plain(t + r));
      ++count;
    }
    past += r >= V;
  }
  if (live) out[b] = finish(sum, past);
}

// One pass over ids [i0, i1) of every bag, the running sum carried in
// global memory between passes (the same float, so the same bits).
template <bool NO_ALLOC>
__global__ void __launch_bounds__(256) k_pass(
    const float* __restrict__ t, const int* __restrict__ idx,
    const float* __restrict__, float* __restrict__ out, float* __restrict__ st_sum,
    int* __restrict__ st_past, int64_t V, int B, int L, int i0, int i1) {
  const int b = blockIdx.x * 256 + threadIdx.x;
  if (b >= B) return;
  const int* id = idx + (int64_t)b * L;
  float sum = i0 ? st_sum[b] : 0.0f;
  int past = i0 ? st_past[b] : 0;
#pragma unroll 8
  for (int i = i0; i < i1; ++i) {
    const int r = id[i];
    if (r >= 0 && r < V)
      sum += 1.0f * (NO_ALLOC ? ld_no_alloc(t + r) : ld_plain(t + r));
    past += r >= V;
  }
  if (i1 == L) out[b] = finish(sum, past);
  else { st_sum[b] = sum; st_past[b] = past; }
}

// The column route as the port builds it (eb_bag_column), whole bags.
// w: the weights, null at run time (as the port's launch takes them).
__global__ void __launch_bounds__(256) k_port(
    const float* __restrict__ t, const int* __restrict__ idx,
    const float* __restrict__ w, float* __restrict__ out, int64_t V, int B,
    int L) {
  const int b = blockIdx.x * 256 + threadIdx.x;
  if (b >= B) return;
  const int64_t o = (int64_t)b * L;
  out[b] = eb_bag_column(t, V, 1, idx + o, w ? w + o : nullptr, L, 0, 0);
}

// eb_bag_column's loop over ids [i0, i1) of every bag, the sum, count
// and ids past V carried in global memory between passes.
__global__ void __launch_bounds__(256) k_port_pass(
    const float* __restrict__ t, const int* __restrict__ idx,
    const float* __restrict__ wts, float* __restrict__ out,
    float* __restrict__ st_sum, int* __restrict__ st_past, int64_t V, int B,
    int L, int i0, int i1) {
  const int b = blockIdx.x * 256 + threadIdx.x;
  if (b >= B) return;
  const int* id = idx + (int64_t)b * L;
  const float* w = wts ? wts + (int64_t)b * L : nullptr;
  float sum = i0 ? st_sum[b] : 0.0f;
  int count = i0 ? st_past[b + B] : 0, past = i0 ? st_past[b] : 0;
#pragma unroll 8
  for (int i = i0; i < i1; ++i) {
    const int r = id[i];
    if (r >= 0 && r < V) {
      sum += (w ? w[i] : 1.0f) * eb_load(t + (int64_t)r);
      ++count;
    }
    past += r >= V;
  }
  if (i1 == L) {
    const EbPart s = {sum, count + past, past};
    out[b] = eb_finish(s, 0);
  } else {
    st_sum[b] = sum;
    st_past[b] = past;
    st_past[b + B] = count;
  }
}

typedef void (*Loop)(const float*, const int*, const float*, float*, int64_t,
                     int, int);
typedef void (*Pass)(const float*, const int*, const float*, float*, float*,
                     int*, int64_t, int, int, int, int);
struct Form { const char* name; Loop loop; int threads; Pass pass; int ids; };
static const Form forms[] = {
  {"loop", k_loop<256, 0, false>, 256, nullptr, 0},
  {"loop, rows L1::no_allocate", k_loop<256, 0, true>, 256, nullptr, 0},
  {"loop, CTA barrier every 8 ids", k_loop<256, 8, false>, 256, nullptr, 0},
  {"loop, CTA barrier every id", k_loop<256, 1, false>, 256, nullptr, 0},
  {"loop, 1024-thread CTA, barrier every 8 ids", k_loop<1024, 8, false>, 1024, nullptr, 0},
  {"loop, barrier every 8 ids, no_allocate", k_loop<256, 8, true>, 256, nullptr, 0},
  {"passes of 4 ids", nullptr, 256, k_pass<false>, 4},
  {"passes of 8 ids", nullptr, 256, k_pass<false>, 8},
  {"passes of 16 ids", nullptr, 256, k_pass<false>, 16},
  {"passes of 8 ids, no_allocate", nullptr, 256, k_pass<true>, 8},
  {"port: eb_bag_column", k_port, 256, nullptr, 0},
  {"port: passes of 4 ids", nullptr, 256, k_port_pass, 4},
  {"port: passes of 8 ids", nullptr, 256, k_port_pass, 8},
  {"port: passes of 10 ids", nullptr, 256, k_port_pass, 10},
  {"port: passes of 13 ids", nullptr, 256, k_port_pass, 13},
  {"port: passes of 16 ids", nullptr, 256, k_port_pass, 16},
  {"port: passes of 20 ids", nullptr, 256, k_port_pass, 20},
};
extern "C" int n_forms() { return sizeof(forms) / sizeof(forms[0]); }
extern "C" const char* form_name(int f) { return forms[f].name; }
// st_sum, st_past: B floats and 2 B ints of scratch for the pass forms.
extern "C" int run_form(int f, const float* t, const int* idx, float* out,
                        float* st_sum, int* st_past, int64_t V, int B, int L,
                        void* stream) {
  const Form& m = forms[f];
  const cudaStream_t s = (cudaStream_t)stream;
  const int grid = (B + m.threads - 1) / m.threads;
  if (m.loop) {
    m.loop<<<grid, m.threads, 0, s>>>(t, idx, nullptr, out, V, B, L);
  } else {
    for (int i0 = 0; i0 < L; i0 += m.ids) {
      const int i1 = i0 + m.ids < L ? i0 + m.ids : L;
      m.pass<<<grid, 256, 0, s>>>(t, idx, nullptr, out, st_sum, st_past, V, B, L, i0,
                                 i1);
    }
  }
  return (int)cudaGetLastError();
}
