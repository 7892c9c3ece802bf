"""The rule kernel's core (``csrc/block_scan_rule.cuh``) against the
``block_scan`` backend's host loop, bit for bit.

The kernel (``csrc/block_scan_rule.cu``) runs one lane's whole rule
execution in a CTA.  Its per-block, per-thread and per-round logic is in
``__host__ __device__`` functions, which g++ builds here into a harness
that replays every CTA round by round, warp by warp and thread by thread
on the CPU: the plane slots from the rule's votes, each warp's block
(the warp core's 16-byte or scalar word ownership, the old matched
words, the new words), the stop from the warps' v_inc, the threads' runs
of new words and their candidate slots, the matched words, the threads'
top lists.  What only the card has is replaced by its plain meaning: a
ballot by the OR of the replayed lanes' votes, a warp sum by adding,
the CTA's prefix by adding in thread order, the warp merge of the top
lists by inserting them one after another.  Every ``EnvState`` field
the harness ends at must equal the host loop's (``BlockScanBackend``
on CPU tensors, itself held to the JAX reference by
``tests/test_torch_scan_backends.py``), ``matched`` included, and the
harness reads no word outside the occupancy and matched arrays.  The
kernel itself is held to the host loop on a GPU by
``tests/test_torch_gpu.py``.
"""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core.environment import EnvConfig, EnvState, env_reset
from repro_torch.core.scan_backends import BlockScanBackend
from repro_torch.kernels.block_scan import block_scan_rule
from repro_torch.kernels.native import CSRC_DIR

FIELDS = ("block_ptr", "u", "v", "matched", "cand", "cand_cnt", "topn", "done")

_HARNESS = r"""
#include <stdint.h>
#include <math.h>
#include <vector>
// Every word a replayed lane loads, by array: occupancy, matched, or
// outside both.
static const uint32_t* g_occ[2];
static const uint32_t* g_mat[2];
static int64_t g_reads[3];
#define BS_HOST_READ(p)                                         \
  do {                                                          \
    const uint32_t* q_ = (p);                                   \
    if (q_ >= g_occ[0] && q_ < g_occ[1]) ++g_reads[0];          \
    else if (q_ >= g_mat[0] && q_ < g_mat[1]) ++g_reads[1];     \
    else ++g_reads[2];                                          \
  } while (0)
#include "block_scan_rule.cuh"

// Host replay of block_scan_rule.cu's grid: one CTA per lane, its rounds
// one after another; in a round every warp's 32 lanes, then the stop,
// then every thread's run of words.
extern "C" void bs_host_rule(
    const uint32_t* occ, const uint8_t* allowed, const uint8_t* required,
    const uint8_t* present, const float* scores, const int32_t* du,
    const int32_t* dv, const int32_t* bp_in, const int32_t* u_in,
    const int32_t* v_in, const int32_t* cnt_in, const uint8_t* done,
    const int32_t* cand_in, const float* topn_in, uint32_t* matched,
    int32_t* small_out, int32_t* cand_out, float* topn_out, int64_t* reads,
    int32_t* rounds, int batch, int nb, int tf_planes, int F, int W,
    int n_terms, int64_t n_pad, int K, int n_top, int u_budget, int vec) {
  g_occ[0] = occ;
  g_occ[1] = occ + (int64_t)batch * nb * tf_planes * W;
  g_mat[0] = matched;
  g_mat[1] = matched + (int64_t)batch * nb * W;
  g_reads[0] = g_reads[1] = g_reads[2] = 0;
  std::vector<uint32_t> s_new((size_t)BS_RULE_WARPS * W);
  for (int b = 0; b < batch; ++b) {
    BsRuleState s;
    s.bp = bp_in[b];
    s.u = s.u0 = u_in[b];
    s.v = s.v0 = v_in[b];
    s.cnt = cnt_in[b];
    s.du = du[b];
    s.dv = dv[b];
    s.done = done[b] != 0;
    int32_t* cout = cand_out + (int64_t)b * K;
    for (int i = 0; i < K; ++i) cout[i] = cand_in[(int64_t)b * K + i];
    // The lane's top-n (in the kernel: shared memory, or past
    // BS_RULE_MAX_TOP the lane's topn row).
    const bool long_top = n_top > BS_RULE_MAX_TOP;
    std::vector<float> s_top(n_top);
    for (int i = 0; i < n_top; ++i) s_top[i] = topn_in[(int64_t)b * n_top + i];

    // The plane list as warp 0's ballots build it: slots in plane order.
    int32_t s_off[BS_RULE_SLOT_ROWS] = {0}, s_term[BS_RULE_SLOT_ROWS] = {0};
    const uint8_t* a = allowed + (int64_t)b * tf_planes;
    const uint8_t* p = present + (int64_t)b * n_terms;
    int u_inc = 0;
    for (int g = 0; g < tf_planes; g += BS_WARP) {
      for (int l = 0; l < BS_WARP; ++l) {
        if (bs_plane_vote(a, p, tf_planes, F, g + l)) {
          s_off[u_inc] = (g + l) * W;
          s_term[u_inc] = (g + l) / F;
          ++u_inc;
        }
      }
    }
    uint32_t req_mask = 0u;
    for (int l = 0; l < BS_WARP; ++l)
      if (bs_req_vote(required + (int64_t)b * n_terms, p, n_terms, l))
        req_mask |= 1u << l;

    rounds[b] = 0;
    if (u_inc == 0) {
      if (bs_rule_scans(s, 0, s.v, 0, nb, u_budget)) s.bp = nb;
    } else {
      const uint32_t* occ_lane = occ + (int64_t)b * nb * tf_planes * W;
      uint32_t* matched_lane = matched + (int64_t)b * nb * W;
      const float* scores_lane = scores + (int64_t)b * n_pad;
      const BsRuleSlots off{s_off}, term{s_term};
      while (bs_rule_scans(s, 0, s.v, u_inc, nb, u_budget)) {
        ++rounds[b];
        int32_t s_vinc[BS_RULE_WARPS];
        for (int w = 0; w < BS_RULE_WARPS; ++w) {
          s_vinc[w] = 0;
          if (!bs_rule_scans(s, w, s.v, u_inc, nb, u_budget)) continue;
          const int64_t blk = s.bp + w;
          for (int l = 0; l < BS_WARP; ++l)
            s_vinc[w] += vec
                ? bs_rule_block<true>(occ_lane + blk * tf_planes * W,
                                      matched_lane + blk * W, &s_new[w * W],
                                      W, l, off, term, u_inc, req_mask,
                                      n_terms)
                : bs_rule_block<false>(occ_lane + blk * tf_planes * W,
                                       matched_lane + blk * W, &s_new[w * W],
                                       W, l, off, term, u_inc, req_mask,
                                       n_terms);
        }
        int32_t v_end;
        const int n = bs_rule_stop(s, s_vinc, u_inc, nb, u_budget, &v_end);
        int first[BS_RULE_THREADS], n_new = 0;
        for (int t = 0; t < BS_RULE_THREADS; ++t) {
          int lo, len;
          bs_warp_span(n * W, t, BS_RULE_THREADS, &lo, &len);
          first[t] = s.cnt + n_new;
          n_new += bs_rule_count(s_new.data(), lo, lo + len);
        }
        const int64_t doc0 = (int64_t)s.bp * W * 32;
        float merged[BS_RULE_MAX_TOP];
        for (int i = 0; i < n_top && !long_top; ++i) merged[i] = s_top[i];
        for (int t = 0; t < BS_RULE_THREADS; ++t) {
          int lo, len;
          bs_warp_span(n * W, t, BS_RULE_THREADS, &lo, &len);
          float top[BS_RULE_MAX_TOP];
          for (int i = 0; i < BS_RULE_MAX_TOP; ++i) top[i] = -INFINITY;
          bs_rule_emit(s_new.data(), lo, lo + len, first[t], K, doc0,
                       matched_lane + (int64_t)s.bp * W, cout, scores_lane,
                       n_pad, s_top[n_top - 1], top, long_top ? 0 : n_top);
          for (int i = 0; i < n_top && !long_top; ++i)
            bs_top_insert(merged, n_top, top[i]);
        }
        if (long_top)
          bs_rule_merge_long(s_new.data(), n * W, doc0, scores_lane, n_pad,
                             s_top.data(), n_top);
        else
          for (int i = 0; i < n_top; ++i) s_top[i] = merged[i];
        bs_rule_advance(&s, n, u_inc, v_end, n_new, K);
      }
    }
    small_out[b] = s.bp;
    small_out[batch + b] = s.u;
    small_out[2 * batch + b] = s.v;
    small_out[3 * batch + b] = s.cnt;
    for (int i = 0; i < n_top; ++i) topn_out[(int64_t)b * n_top + i] = s_top[i];
  }
  for (int i = 0; i < 3; ++i) reads[i] = g_reads[i];
}

extern "C" float bs_host_top_insert(const float* xs, int n_xs, int n_top,
                                    float* top) {
  for (int i = 0; i < n_xs; ++i)
    if (n_top > BS_RULE_MAX_TOP)
      bs_top_insert_long(top, n_top, xs[i]);
    else
      bs_top_insert(top, n_top, xs[i]);
  return top[0];
}
"""


@pytest.fixture(scope="module")
def host_rule(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the rule kernel's core is not checked")
    d = tmp_path_factory.mktemp("bs_rule_host")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libbs_rule_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.bs_host_rule.argtypes = ([P] * 20 + [I] * 6 + [ctypes.c_int64]
                                + [I] * 4)
    so.bs_host_rule.restype = None
    so.bs_host_top_insert.argtypes = [P, I, I, P]
    so.bs_host_top_insert.restype = ctypes.c_float
    return so


@dataclasses.dataclass
class Case:
    cfg: EnvConfig
    occ: torch.Tensor          # (B, nb, T, F, W) int32
    scores: torch.Tensor       # (B, n_pad) float32
    tp: torch.Tensor           # (B, T) bool
    state: EnvState
    allowed: torch.Tensor      # (B, T, F) bool
    required: torch.Tensor     # (B, T) bool
    du: torch.Tensor           # (B,) int32
    dv: torch.Tensor           # (B,) int32


def _occ(rng, b, nb, t, f, w, ands):
    """Random words, each the AND of ``ands`` draws (density 2^-ands)."""
    x = rng.integers(0, 2**32, (b, nb, t, f, w), dtype=np.uint32)
    for _ in range(ands - 1):
        x &= rng.integers(0, 2**32, (b, nb, t, f, w), dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32))


def _full(b, x):
    return torch.full((b,), x, dtype=torch.int32)


def _base(seed, b=6, nb=12, t=4, f=4, w=4, ands=2, k=64, n_top=5,
          u_budget=4096, planes=None, req=None, du=10**6, dv=10**6,
          score_values=None):
    """A case of B lanes from the start state: every lane the same rule
    (``planes``: the (t, f) allowed, all by default; ``req``: the
    required terms, all by default)."""
    rng = np.random.default_rng(seed)
    cfg = EnvConfig(n_blocks=nb, block_docs=32 * w, k_rules=6,
                    max_candidates=k, n_top=n_top, u_budget=u_budget)
    allowed = np.zeros((b, t, f), bool)
    for tt, ff in (planes if planes is not None
                   else [(i, j) for i in range(t) for j in range(f)]):
        allowed[:, tt, ff] = True
    required = np.zeros((b, t), bool)
    required[:, list(range(t)) if req is None else list(req)] = True
    if score_values is None:
        scores = rng.normal(size=(b, nb * 32 * w)).astype(np.float32)
    else:
        scores = rng.choice(np.asarray(score_values, np.float32),
                            size=(b, nb * 32 * w))
    return Case(cfg, _occ(rng, b, nb, t, f, w, ands), torch.from_numpy(scores),
                torch.ones((b, t), dtype=torch.bool), env_reset(cfg, b, "cpu"),
                torch.from_numpy(allowed), torch.from_numpy(required),
                _full(b, du), _full(b, dv))


def _midway(seed, **kw):
    """A mid-episode state: a first rule run from the start, the block
    pointer rewound to 0 for a second pass, the quotas counted from the
    state's own u and v."""
    c = _base(seed, **kw)
    first = dataclasses.replace(c, allowed=c.allowed.clone(),
                                required=c.required.clone(),
                                du=_full(len(c.du), 48))
    first.allowed[:, :, 1:3] = False
    first.required[:, 2:] = False
    s1 = BlockScanBackend().host_loop(c.cfg, c.occ, c.scores, c.tp, c.state,
                                      first.allowed, first.required, first.du,
                                      c.dv)
    s1 = dataclasses.replace(s1, block_ptr=torch.zeros_like(s1.block_ptr))
    assert (s1.cand_cnt > 0).all() and torch.isfinite(s1.topn).all()
    c.allowed[:, 2:] = False
    c.required[:, 1:] = False
    return dataclasses.replace(c, state=s1)


def _per_lane(seed):
    """Every lane its own random rule, quotas, start block and done flag,
    with the degenerate lanes: no plane, no required term, no term
    present, a start past the last block, a done lane and zero quotas."""
    c = _base(seed, b=10, nb=12, ands=3)
    rng = np.random.default_rng(seed + 1)
    b = 10
    c.allowed[:] = torch.from_numpy(rng.random((b, 4, 4)) < 0.5)
    c.required[:] = torch.from_numpy(rng.random((b, 4)) < 0.6)
    c.tp[:] = torch.from_numpy(rng.random((b, 4)) < 0.85)
    c.du[:] = torch.from_numpy(rng.integers(1, 60, b).astype(np.int32))
    c.dv[:] = torch.from_numpy(rng.integers(1, 600, b).astype(np.int32))
    c.state.block_ptr[:] = torch.from_numpy(rng.integers(0, 12, b).astype(np.int32))
    c.allowed[0] = False                     # no plane
    c.required[1] = False                    # no required term
    c.tp[2] = False                          # no term present
    c.state.block_ptr[3] = 12                # past the last block
    c.state.done[4] = True                   # done
    c.du[5] = 0                              # zero quotas
    c.dv[6] = 0
    return c


def _cases():
    out = {
        "du_bound": lambda: _base(1, du=40),
        "dv_mid_chunk": lambda: _base(2, dv=150),
        "u_budget": lambda: _base(3, u_budget=40),
        "end_of_index": lambda: _base(4, nb=20, ands=4),
        "zero_plane_sweeps_to_nb": lambda: _base(5, planes=[]),
        "shallow_two_planes": lambda: _base(6, planes=[(0, 1), (0, 3)],
                                            req=[0], du=30),
        "no_required_term": lambda: _base(7, req=[], du=1000),
        "per_lane_rules_done_zero_quotas": lambda: _per_lane(8),
        "midway_matched_bits_set": lambda: _midway(9, ands=3),
        "cand_cnt_clamped_at_k": lambda: _base(10, k=7, ands=2),
        "topn_ties_and_inf_pads": lambda: _base(
            11, ands=6, req=[0, 1], n_top=8,
            score_values=[1.0, 2.0, 2.0, 0.5, -np.inf]),
        "many_planes_32": lambda: _base(12, t=4, f=8, du=100, ands=4),
        "many_planes_64": lambda: _base(13, t=4, f=16, du=200, ands=5),
        "topn_long_list_16": lambda: _base(14, n_top=16, ands=2, du=60),
        "topn_long_ties_and_inf_pads": lambda: _base(
            15, ands=6, req=[0, 1], n_top=40,
            score_values=[1.0, 2.0, 2.0, 0.5, -np.inf]),
    }
    return out


CASES = _cases()


def _harness(so, c: Case, vec: int):
    """The harness's rule execution of case ``c``: (EnvState, reads
    (occupancy, matched, outside), rounds a lane)."""
    b, nb, t, f, w = c.occ.shape
    cfg, s = c.cfg, c.state
    matched = s.matched.clone()
    small = torch.empty((4, b), dtype=torch.int32)
    cand = torch.empty((b, cfg.max_candidates), dtype=torch.int32)
    topn = torch.empty((b, cfg.n_top), dtype=torch.float32)
    reads = torch.empty(3, dtype=torch.int64)
    rounds = torch.empty(b, dtype=torch.int32)
    ins = [x.contiguous() for x in (
        c.occ, c.allowed, c.required, c.tp, c.scores, c.du, c.dv,
        s.block_ptr, s.u, s.v, s.cand_cnt, s.done, s.cand, s.topn)]
    so.bs_host_rule(*(x.data_ptr() for x in ins), matched.data_ptr(),
                    small.data_ptr(), cand.data_ptr(), topn.data_ptr(),
                    reads.data_ptr(), rounds.data_ptr(), b, nb, t * f, f, w,
                    t, c.scores.shape[1], cfg.max_candidates, cfg.n_top,
                    cfg.u_budget, vec)
    bp, u, v, cnt = small
    return (EnvState(bp, u, v, matched, cand, cnt, topn, s.done.clone()),
            reads.tolist(), rounds)


def _host_loop(c: Case) -> EnvState:
    return BlockScanBackend(chunk=3).host_loop(c.cfg, c.occ, c.scores, c.tp,
                                               c.state, c.allowed, c.required,
                                               c.du, c.dv)


def _assert_equal(got: EnvState, want: EnvState, msg=""):
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), \
            f"{msg}:{name}"


@pytest.mark.parametrize("vec", [1, 0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_rule_core_matches_host_loop(host_rule, case, vec):
    """Every EnvState field of the replayed kernel equals the host loop's;
    the lanes read nothing outside the occupancy and matched, and every
    plane word they read is an active plane's of a block they could
    still scan."""
    c = CASES[case]()
    want = _host_loop(c)
    got, (occ_reads, matched_reads, outside), rounds = _harness(host_rule, c,
                                                                vec)
    _assert_equal(got, want, case)
    assert outside == 0
    w = c.occ.shape[-1]
    n_active = (c.allowed & c.tp[:, :, None]).sum((1, 2))
    scanned = want.block_ptr - c.state.block_ptr.clamp(max=c.occ.shape[1])
    live = n_active > 0
    # at least the scanned blocks' planes, at most a round of 8 more
    lo = int((n_active * scanned)[live].sum()) * w
    hi = int((n_active * (scanned + 8 * (rounds > 0)))[live].sum()) * w
    assert lo <= occ_reads <= hi, (lo, occ_reads, hi)
    assert matched_reads * int(n_active.max().clamp(min=1)) >= occ_reads \
        or occ_reads == 0
    if case == "zero_plane_sweeps_to_nb":
        assert occ_reads == matched_reads == 0
        assert (got.block_ptr == c.cfg.n_blocks).all() and (got.u == 0).all()
    if case in ("du_bound", "u_budget"):
        assert occ_reads == lo                  # Δu and the budget are exact
    if case == "cand_cnt_clamped_at_k":
        assert (got.cand_cnt == c.cfg.max_candidates).all()
    if case == "end_of_index":
        assert (got.block_ptr == c.cfg.n_blocks).all() and (rounds == 3).all()
    if case in ("topn_ties_and_inf_pads", "topn_long_ties_and_inf_pads"):
        assert torch.isinf(got.topn).any() and (got.topn == 2.0).sum() > 1
    if case == "topn_long_list_16":
        assert torch.isfinite(got.topn).all()   # the whole list filled
    if case == "per_lane_rules_done_zero_quotas":
        for lane in (3, 4, 5, 6):               # no scan: the state as it was
            for name in ("block_ptr", "u", "v", "cand_cnt"):
                assert getattr(got, name)[lane] == getattr(c.state, name)[lane]


@pytest.mark.parametrize("w,vec", [(2, 0), (8, 0), (33, 0), (128, 1),
                                   (256, 1), (256, 0)])
def test_host_rule_core_word_paths(host_rule, w, vec):
    """The core on its 16-byte and scalar word paths at one to two
    128-word strips a block, W = 33 scalar only, against the host loop."""
    for c in (_base(20 + w, w=w, du=40, dv=w * 40, ands=3),
              _per_lane(30 + w) if w == 4 else _base(40 + w, w=w, nb=10,
                                                     ands=4)):
        got, reads, _ = _harness(host_rule, c, vec)
        _assert_equal(got, _host_loop(c), f"w={w}")
        assert reads[2] == 0


def test_host_rule_top_insert_orders_like_topk(host_rule):
    """The top-n insert keeps torch.topk's values: descending, ties kept
    as values, -inf pads, a NaN above every number; past BS_RULE_MAX_TOP
    the list in memory (``bs_top_insert_long``) keeps the same."""
    rng = np.random.default_rng(0)
    for n_top in (1, 5, 8, 9, 40):
        for xs in (rng.normal(size=40), np.array([2.0, 2.0, 1.0, 2.0, -np.inf]),
                   np.array([1.0, np.nan, 3.0, -np.inf, 3.0]),
                   np.array([-np.inf] * 3)):
            xs = xs.astype(np.float32)
            top = np.full(n_top, -np.inf, np.float32)
            host_rule.bs_host_top_insert(xs.ctypes.data, len(xs), n_top,
                                         top.ctypes.data)
            want = torch.topk(torch.from_numpy(np.concatenate(
                [xs, np.full(n_top, -np.inf, np.float32)])), n_top).values
            np.testing.assert_array_equal(top, want.numpy())


def test_wrapper_on_cpu_is_the_host_loop():
    """On CPU tensors the rule execution is the kernel's plain version,
    the host loop: ``run_rule`` takes it there (``inplace`` or not, the
    caller's state keeps every field), and ``block_scan_rule`` itself
    runs on CUDA and meta tensors only."""
    c = _midway(50, ands=3)
    want = _host_loop(c)
    assert not torch.equal(c.state.matched, want.matched)
    before = {n: getattr(c.state, n).clone() for n in FIELDS}
    for inplace in (False, True):
        got = BlockScanBackend(chunk=3).run_rule(
            c.cfg, c.occ, c.scores, c.tp, c.state, c.allowed, c.required,
            c.du, c.dv, inplace=inplace)
        _assert_equal(got, want)
        for n in FIELDS:
            assert torch.equal(getattr(c.state, n), before[n]), n
    with pytest.raises(ValueError, match="unsupported device cpu"):
        block_scan_rule(c.cfg, c.occ, c.scores, c.tp, c.state, c.allowed,
                        c.required, c.du, c.dv)


def _to_meta(c: Case) -> dict:
    """Case ``c``'s fields with every tensor on ``meta``."""
    meta = torch.device("meta")
    m = {f.name: getattr(c, f.name).to(meta) if isinstance(
        getattr(c, f.name), torch.Tensor) else getattr(c, f.name)
        for f in dataclasses.fields(Case)}
    m["state"] = EnvState(*(getattr(c.state, n).to(meta) for n in FIELDS))
    return m


def test_wrapper_on_meta_reports_the_worst_case():
    """On meta the wrapper gives the outputs' shapes and dtypes, launches
    nothing and reports one call of its kernel at its worst case: every
    plane of every block read."""
    from repro_torch.kernels.block_scan import BLOCK_SCAN_RULE_KERNEL
    from repro_torch.kernels.block_scan.block_scan_rule import rule_cost
    from repro_torch.launch.dryrun import counting

    c = _base(60)
    m = _to_meta(c)
    before = BLOCK_SCAN_RULE_KERNEL.launches
    with counting() as counter:
        got = block_scan_rule(m["cfg"], m["occ"], m["scores"], m["tp"],
                              m["state"], m["allowed"], m["required"],
                              m["du"], m["dv"])
    assert BLOCK_SCAN_RULE_KERNEL.launches == before
    want = _host_loop(c)
    for n in FIELDS:
        g, w = getattr(got, n), getattr(want, n)
        assert (g.device.type, g.shape, g.dtype) == ("meta", w.shape, w.dtype)
    k = counter.kernels[BLOCK_SCAN_RULE_KERNEL.name]
    b, nb, t, f, w = c.occ.shape
    cost = rule_cost(np.full(b, t * f), np.full(b, nb), nb, t, f, w,
                     c.cfg.max_candidates, c.cfg.n_top)
    assert k["launches"] == 1 and k["worst_case"]
    assert (k["flops"], k["bytes"]) == (cost.flops, cost.bytes)


def test_wrapper_rejects_unsupported_inputs():
    """Bad shapes, dtypes and sizes are refused before a launch (checked
    on meta tensors, which the wrapper takes as the card's)."""
    m = _to_meta(_base(70))
    cfg, occ, scores, tp, state, allowed, required, du, dv = (
        m["cfg"], m["occ"], m["scores"], m["tp"], m["state"], m["allowed"],
        m["required"], m["du"], m["dv"])
    with pytest.raises(ValueError, match="int32"):
        block_scan_rule(cfg, occ.to(torch.int64), scores, tp, state,
                        allowed, required, du, dv)
    with pytest.raises(ValueError, match="n_top"):
        block_scan_rule(dataclasses.replace(cfg, n_top=0), occ, scores, tp,
                        state, allowed, required, du, dv)
    with pytest.raises(ValueError, match="du_quota"):
        block_scan_rule(cfg, occ, scores, tp, state, allowed, required,
                        du[:2], dv)
    with pytest.raises(ValueError, match="scores"):
        block_scan_rule(cfg, occ, scores[:, None], tp, state, allowed,
                        required, du, dv)
    with pytest.raises(ValueError, match="block_docs"):
        block_scan_rule(dataclasses.replace(cfg, block_docs=64), occ, scores,
                        tp, state, allowed, required, du, dv)


def test_cpu_route_keeps_the_host_loop_spans_and_counts():
    """On CPU tensors ``run_rule`` is the host loop: its ``rule`` span
    holds a ``chunk`` span a round and a ``sync`` span a read, it counts
    a host sync a read and launches no rule kernel."""
    from repro_torch.kernels.block_scan import BLOCK_SCAN_RULE_KERNEL
    from repro_torch.obs import Tracer, host_syncs, tracing

    c = _base(80, du=40)
    want = _host_loop(c)
    syncs, rules = host_syncs(), BLOCK_SCAN_RULE_KERNEL.launches
    tracer = Tracer()
    with tracing(tracer):
        got = BlockScanBackend(chunk=2).run_rule(
            c.cfg, c.occ, c.scores, c.tp, c.state, c.allowed, c.required,
            c.du, c.dv, inplace=True)
    assert (host_syncs() - syncs,
            BLOCK_SCAN_RULE_KERNEL.launches - rules) == (3, 0)
    _assert_equal(got, want)
    spans = tracer.log.snapshot()
    names = sorted(e["name"] for e in spans)
    rule = [e for e in spans if e["name"] == "rule"]
    assert len(rule) == 1 and rule[0]["args"] == {"chunk": 2, "rounds": 2}
    assert names == ["chunk", "chunk", "rule", "sync", "sync", "sync"]


@pytest.mark.parametrize("case", ["du_bound", "u_budget", "end_of_index",
                                  "dv_mid_chunk", "zero_plane_sweeps_to_nb",
                                  "per_lane_rules_done_zero_quotas"])
def test_card_cost_bounds_the_blocks_scanned(case):
    """The blocks the card's cost counts a lane (Δu, the budget and the
    index, before the launch): the blocks the lane scans where Δv does
    not stop it, at least those where it does, none for a lane that
    reads no plane or whose condition fails at entry."""
    from repro_torch.kernels.block_scan.block_scan_rule import _u_bound_blocks

    c = CASES[case]()
    want = _host_loop(c)
    n_active = (c.allowed & c.tp[:, :, None]).sum((1, 2)).numpy()
    blocks = _u_bound_blocks(c.cfg, c.occ.shape[1], c.state, n_active, c.du,
                             c.dv)
    scanned = (want.block_ptr - c.state.block_ptr).clamp(min=0).numpy()
    scanned = np.where(n_active > 0, scanned, 0)
    assert (blocks >= scanned).all()
    if case in ("du_bound", "u_budget", "end_of_index"):
        assert (blocks == scanned).all()
    if case == "zero_plane_sweeps_to_nb":
        assert (blocks == 0).all()
