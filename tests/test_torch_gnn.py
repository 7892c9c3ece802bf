"""The port's GraphSAGE (``repro_torch.models.gnn``) and its segment
gather-sum kernel against the JAX reference, on the CPU.

Inputs come from numpy seeds and go to both packages.  Tolerances:

- forwards (aggregates, logits): 1e-5, absolute and relative.  The
  port's mean is ``scale · Σ`` summed in edge order (the kernel's order,
  ``csrc/segment_gather.cu``), the reference's ``Σ / deg`` through
  XLA's scatter: a few float32 roundings apart;
- gradients (``jax.vjp`` of ``_aggregate``) and the one-step parameter
  leaves and gradient leaves of the GNN cells: 1e-5 relative L2, for the
  same reason, through two layers, a norm and the AdamW step;
- ``sample_blocks``: bit-equal (the same numpy generator drives both);
- the g++ harness of ``segment_gather.cuh``: bit-equal to the plain
  version, which adds in the kernel's order (``ref.py``).
"""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.steps import build_cell as jax_build_cell
from repro.models import gnn as jgnn
from repro.models.layers import dense_init as jax_dense_init
from repro_torch.configs import get_arch
from repro_torch.kernels.native import CSRC_DIR, csrc_define
from repro_torch.kernels.segment_gather import (SegmentCSR, segment_gather_sum,
                                                segment_gather_sum_ref,
                                                segment_mean)
from repro_torch.launch.steps import build_cell, minibatch_budgets
from repro_torch.models import gnn as tgnn
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.tree import tree_leaves
from repro_torch.weights import gnn_params_from_reference

from test_torch_train_step import _rel_l2, one_torch_thread  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-5


def _graph(seed, n=40, e=300, n_dst=None, d=6, dummy_src=True,
           dummy_dst=True):
    """Random edges into n_dst segments with dummy srcs (== n) and dummy
    dsts (== n_dst) mixed in, and one segment left empty."""
    rng = np.random.default_rng(seed)
    n_dst = n if n_dst is None else n_dst
    h = rng.normal(size=(n, d)).astype(np.float32)
    src = rng.integers(0, n + int(dummy_src), e).astype(np.int32)
    dst = rng.integers(0, n_dst + int(dummy_dst), e).astype(np.int32)
    dst[dst == 1] = 0                     # segment 1 has no edge
    return h, src, dst, n_dst


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ aggregate
@pytest.mark.parametrize("aggregator", ["mean", "max"])
@pytest.mark.parametrize("seed,n,e,n_dst,d", [
    (0, 40, 300, None, 6),
    (1, 64, 1000, 20, 33),           # bipartite, many edges a segment
    (2, 10, 5, 10, 4),               # few edges: most segments empty
])
def test_aggregate_matches_reference(aggregator, seed, n, e, n_dst, d):
    h, src, dst, n_dst = _graph(seed, n, e, n_dst, d)
    want = np.asarray(jgnn._aggregate(jnp.asarray(h), jnp.asarray(src),
                                      jnp.asarray(dst), n_dst, aggregator))
    got = tgnn._aggregate(_t(h), _t(src), _t(dst), n_dst, aggregator).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_aggregate_padding_cases():
    """A dummy src (== N) is a zero row that counts in deg; a dummy dst
    (== n_dst) is dropped; an empty segment is 0 (mean), -inf (max)."""
    h = torch.tensor([[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]])
    src = torch.tensor([0, 3, 1, 2], dtype=torch.int32)
    dst = torch.tensor([0, 0, 2, 2])
    mean = tgnn._aggregate(h, src, dst, 2, "mean")
    assert torch.equal(mean, torch.tensor([[0.0, 0.5], [0.0, 0.0]]))
    mx = tgnn._aggregate(h, src, dst, 2, "max")
    assert torch.equal(mx[0], torch.tensor([0.0, 1.0]))
    assert torch.isinf(mx[1]).all() and (mx[1] < 0).all()
    jmx = jgnn._aggregate(jnp.asarray(h.numpy()), jnp.asarray(src.numpy()),
                          jnp.asarray(dst.numpy()), 2, "max")
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_aggregate_gradient_matches_jax_vjp(aggregator):
    h, src, dst, n_dst = _graph(3, 30, 200, 25, 5)
    g = np.random.default_rng(4).normal(size=(n_dst, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jgnn._aggregate(
        x, jnp.asarray(src), jnp.asarray(dst), n_dst, aggregator), jnp.asarray(h))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    ht = _t(h).requires_grad_()
    out = tgnn._aggregate(ht, _t(src), _t(dst), n_dst, aggregator)
    (got,) = torch.autograd.grad(out, ht, grad_outputs=_t(g))
    assert _rel_l2(got.numpy(), want) <= GRAD_TOL


def test_max_ties_share_the_gradient():
    """Two rows tied at a segment's max get half its gradient each, as
    ``jax.ops.segment_max``'s do."""
    h = torch.tensor([[1.0], [1.0], [0.5]], requires_grad=True)
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    out = tgnn._aggregate(h, src, torch.tensor([0, 0, 0]), 1, "max")
    (g,) = torch.autograd.grad(out.sum(), h)
    assert g.flatten().tolist() == [0.5, 0.5, 0.0]


# ------------------------------------------------------------- the kernel
def test_segment_mean_is_one_gather_each_way_and_drops_outside():
    """The CSR groups by dst in edge order; the backward's CSR by src,
    a dropped edge's dst as n_dst (past the gradient's rows); ids
    outside the rows add nothing."""
    h, src, dst, n_dst = _graph(5, 12, 60, 9, 3)
    csr = SegmentCSR(_t(src), _t(dst), 12, n_dst)
    assert csr.idx.dtype == torch.int32 and csr.ptr.dtype == torch.int64
    keep = dst < n_dst
    assert int(csr.ptr[-1]) == int(keep.sum())
    for r in range(n_dst):
        seg = csr.idx[csr.ptr[r]:csr.ptr[r + 1]].numpy()
        np.testing.assert_array_equal(seg, src[dst == r])      # edge order
    idx_t, ptr_t = csr.transposed()
    assert int(ptr_t[-1]) == int((src < 12).sum())
    for s in range(12):
        np.testing.assert_array_equal(idx_t[ptr_t[s]:ptr_t[s + 1]].numpy(),
                                      np.where(keep, dst, n_dst)[src == s])
    x = _t(np.random.default_rng(6).normal(size=(5, 4)).astype(np.float32))
    out = segment_gather_sum(x, torch.tensor([0, 7, -1, 4], dtype=torch.int32),
                             torch.tensor([0, 3, 4]))
    assert torch.equal(out, torch.stack([x[0] + 0.0, x[4]]))


def test_wrapper_rejects_unsupported_inputs():
    x = torch.zeros((4, 3))
    idx = torch.zeros(2, dtype=torch.int32)
    ptr = torch.tensor([0, 2])
    with pytest.raises(ValueError, match="x dtype"):
        segment_gather_sum(x.double(), idx, ptr)
    with pytest.raises(ValueError, match="idx int32"):
        segment_gather_sum(x, idx.long(), ptr)
    with pytest.raises(ValueError, match="scale"):
        segment_gather_sum(x, idx, ptr, torch.ones(3))
    with pytest.raises(ValueError, match="want x"):
        segment_gather_sum(x[0], idx, ptr)
    # meta is a dry run's device: the output's shape, no launch
    from repro_torch.kernels.segment_gather import SEGMENT_GATHER_KERNEL

    before = SEGMENT_GATHER_KERNEL.launches
    out = segment_gather_sum(x.to("meta"), idx.to("meta"), ptr.to("meta"))
    assert out.device.type == "meta" and out.shape == (1, 3)
    assert out.dtype == torch.float32
    assert SEGMENT_GATHER_KERNEL.launches == before


_HARNESS = r"""
// Every x value the replayed lanes read, and how many lie outside x.
static const float* g_x = nullptr;
static long g_n = 0, g_reads = 0, g_outside = 0;
static void sg_host_read(const float* p) {
  ++g_reads;
  g_outside += p < g_x || p >= g_x + g_n;
}
#define SG_HOST_READ(p) sg_host_read(p)
#include "segment_gather.cuh"
// Host replay of the CUDA kernel: the tickets in the given order (on the
// card, the order the warps take them), every lane of each ticket's
// warp, through the kernel's own per-lane code, on the path the launch
// takes (vec: the 16-byte path).  counts: {x values read, of them
// outside}.
extern "C" void sg_host(const float* x, const int* idx, const long* ptr,
                        const float* scale, float* out, long n, long d,
                        long r_count, int vec, const long* order,
                        long* counts) {
  g_x = x, g_n = n * d, g_reads = g_outside = 0;
  for (long i = 0; i < sg_tickets(r_count); ++i) {
    for (int lane = 0; lane < SG_WARP; ++lane) {
      if (vec)
        sg_ticket_lane<4>(x, idx, ptr, scale, out, n, d, r_count, order[i], lane);
      else
        sg_ticket_lane<1>(x, idx, ptr, scale, out, n, d, r_count, order[i], lane);
    }
  }
  counts[0] = g_reads, counts[1] = g_outside;
}
extern "C" long sg_host_tickets(long r_count) { return sg_tickets(r_count); }
extern "C" int sg_host_depth() { return SG_DEPTH; }
extern "C" int sg_host_vector_path(long d, unsigned long x, unsigned long out) {
  return sg_vector_path(d, x, out);
}
"""
DEPTH = csrc_define("segment_gather.cuh", "SG_DEPTH")      # rows in flight
GROUP = csrc_define("segment_gather.cuh", "SG_GROUP")      # segments a group
HEAVY = csrc_define("segment_gather.cuh", "SG_HEAVY")      # past it: first


def _build_harness(gxx, where, depth):
    (where / "harness.cpp").write_text(_HARNESS)
    lib = where / f"libsg_host_{depth}.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    f"-DSG_DEPTH={depth}", "-I", str(CSRC_DIR), "-o", str(lib),
                    str(where / "harness.cpp")], check=True)
    out = ctypes.CDLL(str(lib))
    P, L = ctypes.c_void_p, ctypes.c_long
    out.sg_host.argtypes = [P, P, P, P, P, L, L, L, ctypes.c_int, P, P]
    out.sg_host.restype = None
    out.sg_host_tickets.argtypes = [L]
    out.sg_host_tickets.restype = L
    out.sg_host_vector_path.argtypes = [L, ctypes.c_ulong, ctypes.c_ulong]
    return out


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{rows in flight: the harness built at that depth}: the kernel's
    own SG_DEPTH and two others."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the per-lane core is not checked")
    d = tmp_path_factory.mktemp("sg_host")
    return {k: _build_harness(gxx, d, k) for k in sorted({DEPTH, 4, 16})}


def _replay_case(seed, u):
    """A first group of segments of 0, 1, U - 1, U, U + 1, 31-33, 70 and
    15,000 edges, SG_HEAVY and one more (the first heavy one), short
    ones, and a heavy one last; a second group that starts with two heavy
    ones; more short ones, a group of empty ones and a last group cut
    short; the dummy row (N) and -1 among the ids, in the heaviest
    segment too."""
    rng = np.random.default_rng(seed)
    first = [0, 1, u - 1, u, u + 1, 31, 32, 33, 70, 0, 5, 64, 15_000, HEAVY,
             HEAVY + 1]
    lengths = np.concatenate([
        first, rng.integers(0, 12, GROUP - len(first) - 1), [2 * HEAVY],
        [HEAVY + 7, 3 * HEAVY], rng.integers(0, 12, 40),
        np.zeros(GROUP + 3, np.int64), rng.integers(0, 3, 10)]).astype(np.int64)
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    n = 50
    idx = rng.integers(0, n, ptr[-1]).astype(np.int32)
    idx[3] = idx[ptr[12] + 7] = n                 # the dummy row
    idx[40] = idx[ptr[12] + 9000] = -1
    return n, lengths, ptr, idx


def _replay(lib, x, idx, ptr, scale, vec, order):
    n, d = x.shape
    r = len(ptr) - 1
    out = np.full((r, d), np.nan, np.float32)
    counts = np.zeros(2, np.int64)
    order = np.ascontiguousarray(order, np.int64)
    lib.sg_host(x.ctypes.data, idx.ctypes.data, ptr.ctypes.data,
                None if scale is None else scale.ctypes.data, out.ctypes.data,
                n, d, r, int(vec), order.ctypes.data, counts.ctypes.data)
    return out, counts


@pytest.mark.parametrize("d,vec", [(128, True), (100, True), (16, True),
                                   (1433, False), (602, False), (7, False),
                                   (128, False)])
@pytest.mark.parametrize("scaled", [False, True])
def test_host_core_matches_plain(host_libs, d, vec, scaled):
    """Every lane of every ticket's warp, replayed by g++ through
    ``sg_ticket_lane`` at the kernel's depth, the tickets in order and
    shuffled, bit-equal to the plain version, on segments of 0, 1, U - 1,
    U, U + 1 and 15,000 edges, heavy ones (past SG_HEAVY) at a group's
    first and last place, more than one round of 32 ids, a group of
    empty segments and a last group cut short, dummy ids (N and -1) and
    the GNN's widths on both load paths; every x value read lies in x and
    is the row of a valid id, each read once (E_valid × d reads: a heavy
    segment is summed once, not again in its group's light runs)."""
    lib = host_libs[DEPTH]
    n, lengths, ptr, idx = _replay_case(d + 7 * scaled, DEPTH)
    rng = np.random.default_rng(d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    scale = (1.0 / np.maximum(lengths, 1)).astype(np.float32) if scaled else None
    want = segment_gather_sum_ref(_t(x), _t(idx), _t(ptr),
                                  None if scale is None else _t(scale)).numpy()
    tickets = lib.sg_host_tickets(len(lengths))
    assert tickets == 2 * -(-len(lengths) // GROUP) >= 8
    assert (lengths[:GROUP] > HEAVY).sum() == 3 and lengths[GROUP] > HEAVY
    for order in (np.arange(tickets), rng.permutation(tickets)):
        out, counts = _replay(lib, x, idx, ptr, scale, vec, order)
        np.testing.assert_array_equal(out, want)
        assert counts[1] == 0
        assert counts[0] == int(((idx >= 0) & (idx < n)).sum()) * d
    assert lib.sg_host_vector_path(d, 4096, 8192) == (d % 4 == 0)
    assert not lib.sg_host_vector_path(128, 4100, 8192)


@pytest.mark.parametrize("d,vec", [(100, True), (7, False)])
def test_host_core_same_bits_at_any_depth(host_libs, d, vec):
    """The rows in flight change when the adds wait, not their order:
    the harness built at 4, the kernel's and 16 rows a lane gives the
    plain version's bits, the tickets taken last to first (the light
    runs before the heavy segments)."""
    rng = np.random.default_rng(11)
    want = None
    for depth, lib in host_libs.items():
        n, lengths, ptr, idx = _replay_case(5, depth)
        x = rng.normal(size=(n, d)).astype(np.float32) if want is None else x
        scale = (1.0 / np.maximum(lengths, 1)).astype(np.float32)
        want = segment_gather_sum_ref(_t(x), _t(idx), _t(ptr), _t(scale)).numpy()
        order = np.arange(lib.sg_host_tickets(len(lengths)))[::-1]
        out, _ = _replay(lib, x, idx, ptr, scale, vec, order)
        np.testing.assert_array_equal(out, want, err_msg=f"depth {depth}")
    assert len(host_libs) == 3


# ------------------------------------------------------------- forwards
def _params(seed, cfg, readout_classes=None):
    """The reference's init, and the same values in the port's tree."""
    jp = jgnn.sage_init(jax.random.key(seed), cfg)
    if readout_classes is not None:
        jr = {"w": jax_dense_init(jax.random.key(seed + 1),
                                  (cfg.n_classes, readout_classes)),
              "b": jnp.zeros((readout_classes,))}
        jp = (jp, jr)
    tp = gnn_params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                   cfg, device="cpu")
    return jp, tp


def _cfgs(d_in=6, d_hidden=16, n_classes=5, **kw):
    return (jgnn.SAGEConfig(d_in, d_hidden, n_classes, **kw),
            tgnn.SAGEConfig(d_in, d_hidden, n_classes, **kw))


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_full_forward_matches_reference(aggregator):
    jcfg, tcfg = _cfgs(aggregator=aggregator)
    h, src, dst, _ = _graph(7, 40, 300)
    edges = np.stack([src, dst])
    jp, tp = _params(0, jcfg)
    want = np.asarray(jgnn.sage_full_forward(jp, jcfg, jnp.asarray(h),
                                             jnp.asarray(edges)))
    got = tgnn.sage_full_forward(tp, tcfg, _t(h), _t(edges)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def _sampled(seed, n=120, deg_max=12, seeds=8, fanouts=(4, 3)):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, deg_max, n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nbrs = rng.integers(0, n, indptr[-1]).astype(np.int64)
    seed_ids = rng.choice(n, seeds, replace=False)
    return indptr, nbrs, seed_ids, fanouts


def test_sample_blocks_bit_equal():
    indptr, nbrs, seed_ids, fanouts = _sampled(8)
    jf, jb = jgnn.sample_blocks(indptr, nbrs, seed_ids, fanouts,
                                np.random.default_rng(9))
    tf, tb = tgnn.sample_blocks(indptr, nbrs, seed_ids, fanouts,
                                np.random.default_rng(9))
    np.testing.assert_array_equal(tf, jf)
    assert tf.dtype == jf.dtype and len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        assert a.n_dst == b.n_dst
        for f in ("src", "dst"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype


def test_block_forward_matches_reference():
    jcfg, tcfg = _cfgs()
    indptr, nbrs, seed_ids, fanouts = _sampled(10)
    frontier, blocks = jgnn.sample_blocks(indptr, nbrs, seed_ids, fanouts,
                                          np.random.default_rng(11))
    feats = np.random.default_rng(12).normal(
        size=(len(frontier) + 1, 6)).astype(np.float32)   # a pad row too
    jb = [(jnp.asarray(b.src), jnp.asarray(b.dst), b.n_dst) for b in blocks]
    tb = [(_t(b.src), _t(b.dst), b.n_dst) for b in blocks]
    jp, tp = _params(1, jcfg)
    want = np.asarray(jgnn.sage_block_forward(jp, jcfg, jnp.asarray(feats), jb))
    got = tgnn.sage_block_forward(tp, tcfg, _t(feats), tb).numpy()
    assert got.shape == (len(seed_ids), 5)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_graph_forward_matches_reference():
    jcfg, tcfg = _cfgs(n_classes=3)
    rng = np.random.default_rng(13)
    n_graphs, npg = 6, 7
    feats = rng.normal(size=(n_graphs * npg, 6)).astype(np.float32)
    graph_id = np.repeat(np.arange(n_graphs), npg).astype(np.int32)
    graph_id[-npg:] = n_graphs - 2          # graph n_graphs - 1 has no node
    src = rng.integers(0, npg, (n_graphs, 10)) + np.arange(n_graphs)[:, None] * npg
    dst = rng.integers(0, npg, (n_graphs, 10)) + np.arange(n_graphs)[:, None] * npg
    edges = np.stack([src.ravel(), dst.ravel()]).astype(np.int32)
    jp, tp = _params(2, jcfg, readout_classes=2)
    want = np.asarray(jgnn.sage_graph_forward(
        jp[0], jcfg, jnp.asarray(feats), jnp.asarray(edges),
        jnp.asarray(graph_id), n_graphs, jp[1]))
    got = tgnn.sage_graph_forward(tp[0], tcfg, _t(feats), _t(edges),
                                  _t(graph_id), n_graphs, tp[1]).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


# ----------------------------------------------------------- cell steps
def _cell_inputs(shape, seed=14):
    """A batch for the reduced cell from a numpy seed: edges with the
    dummy src and dst in the fixed-budget arrays, labels a function of
    the features (as chip_smoke.py makes them)."""
    rng = np.random.default_rng(seed)
    kind = jax_get_arch("graphsage-reddit").shape(shape).kind
    from repro.launch.steps import REDUCED_SHAPES
    sp = REDUCED_SHAPES[kind]
    if kind == "train_graph":
        n, e = sp["n_nodes"], sp["n_edges"]
        feats = rng.normal(size=(n, sp["d_feat"])).astype(np.float32)
        edges = rng.integers(0, n, (2, e)).astype(np.int32)
        labels = (np.argmax(feats[:, :sp["n_classes"]], 1)).astype(np.int32)
        mask = (rng.random(n) < 0.5).astype(np.float32)
        return feats, edges, labels, mask
    if kind == "train_minibatch":
        bn = sp["batch_nodes"]
        e1, fr1, e0, fr0 = minibatch_budgets(bn, sp["fanout"])
        feats = rng.normal(size=(fr0, sp["d_feat"])).astype(np.float32)
        src0 = rng.integers(0, fr0 + 1, e0).astype(np.int32)     # fr0: dummy
        dst0 = rng.integers(0, fr1 + 1, e0).astype(np.int32)     # fr1: dummy
        src1 = rng.integers(0, fr1 + 1, e1).astype(np.int32)
        dst1 = rng.integers(0, bn + 1, e1).astype(np.int32)
        labels = np.argmax(feats[:bn, :sp["n_classes"]], 1).astype(np.int32)
        return feats, src0, dst0, src1, dst1, labels
    bsz, npg, epg = sp["batch"], sp["n_nodes"], sp["n_edges"]
    feats = rng.normal(size=(bsz * npg, sp["d_feat"])).astype(np.float32)
    base = np.repeat(np.arange(bsz) * npg, epg)
    edges = np.stack([base + rng.integers(0, npg, bsz * epg),
                      base + rng.integers(0, npg, bsz * epg)]).astype(np.int32)
    graph_id = np.repeat(np.arange(bsz), npg).astype(np.int32)
    labels = rng.integers(0, sp["n_classes"], bsz).astype(np.int32)
    return feats, edges, graph_id, labels


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
def test_gnn_cell_step_matches_reference(shape):
    """One step of the reduced cell from the reference's init and zero
    AdamW state: the loss within 1e-5, every new parameter leaf within
    1e-5 relative L2 of the reference cell's, in place."""
    jcell = jax_build_cell("graphsage-reddit", shape, reduced=True)
    cell = build_cell("graphsage-reddit", shape, reduced=True)
    batch = _cell_inputs(shape)
    molecule = shape == "molecule"
    n_state = 3 if molecule else 2
    assert cell.donate_argnums == jcell.donate_argnums
    leaves, treedef = jax.tree_util.tree_flatten(jcell.args[:n_state - 1])
    jparams = jax.tree_util.tree_unflatten(treedef, [
        0.3 * jax.random.normal(jax.random.key(i), a.shape, a.dtype)
        for i, a in enumerate(leaves)])
    jopt = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                                  jcell.args[n_state - 1])
    jout = jax.jit(jcell.fn)(*jparams, jopt, *[jnp.asarray(b) for b in batch])
    tparams = gnn_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams),
        get_arch("graphsage-reddit").model_cfg(True), device="cpu")
    opt = adamw_init(tparams if molecule else tparams[0], AdamWConfig(lr=1e-3))
    out = cell.fn(*tparams, opt, *[_t(b) for b in batch])
    np.testing.assert_allclose(float(out[-1]), float(jout[-1]),
                               rtol=FWD_TOL, atol=FWD_TOL)
    new = tree_leaves(out[:n_state - 1])
    want = jax.tree_util.tree_leaves(jout[:n_state - 1])
    assert [tuple(a.shape) for a in new] == [b.shape for b in want]
    for a, b in zip(new, want):
        assert _rel_l2(a.numpy(), np.asarray(b)) <= GRAD_TOL
    assert new[0] is tree_leaves(tparams)[0]               # in place
    assert int(opt["count"]) == 1


def test_gnn_cell_gradients_match_reference():
    """The gradients of the reduced full-graph cell's loss against
    ``jax.grad`` of the reference's: 1e-5 relative L2 a leaf."""
    from repro_torch.launch.steps import ce_loss, value_and_grad

    jcfg, tcfg = _cfgs(d_in=16, d_hidden=32, n_classes=7)
    feats, edges, labels, mask = _cell_inputs("full_graph_sm")
    jp, tp = _params(3, jcfg)

    def jloss(p):
        logits = jgnn.sage_full_forward(p, jcfg, jnp.asarray(feats),
                                        jnp.asarray(edges))
        logp = jax.nn.log_softmax(logits)
        gold = jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1)[:, 0]
        return -jnp.sum(gold * mask) / jnp.maximum(mask.sum(), 1.0)

    want = jax.grad(jloss)(jp)
    loss, got = value_and_grad(lambda p: ce_loss(
        tgnn.sage_full_forward(p, tcfg, _t(feats), _t(edges)), _t(labels),
        _t(mask)), tp)
    np.testing.assert_allclose(float(loss), float(jloss(jp)), rtol=FWD_TOL)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert _rel_l2(a.numpy(), np.asarray(b)) <= GRAD_TOL


def test_segment_mean_gradient_equals_plain_autograd():
    """The autograd function's backward (the kernel's plain version over
    the transposed CSR) against autograd of a plain gather and
    index_add_: 1e-6 (the same sums, other order)."""
    h, src, dst, n_dst = _graph(15, 30, 400, 20, 4)
    g = np.random.default_rng(16).normal(size=(n_dst, 4)).astype(np.float32)
    csr = SegmentCSR(_t(src), _t(dst), 30, n_dst)
    x = _t(h).requires_grad_()
    (got,) = torch.autograd.grad(segment_mean(x, csr), x, _t(g))
    x2 = _t(h).requires_grad_()
    hd = torch.cat([x2, torch.zeros(1, 4)])
    keep = _t(dst) < n_dst
    msgs = hd[_t(src).long()[keep]]
    s = torch.zeros(n_dst, 4).index_add(0, _t(dst).long()[keep], msgs)
    plain = s * csr.scale[:, None]
    (want,) = torch.autograd.grad(plain, x2, _t(g))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
