"""The one generator of the websearch cells' inputs, from a traffic mix
(``traffic/<name>.json``), a configuration and a seed, made on the
device in a few large calls (``chip_smoke.py``'s ``ws_inputs``, copied,
with the query profile read from the traffic file).

The traffic's ``query_pool`` queries each have between ``query_terms``
present terms (the rest of the ``query_terms_max`` slots empty); each
(query, term, field) plane of occupancy has background bit density 2^-k,
k in ``plane_density_log2``, made as the AND of k random words.  Where
the mix has ``planted`` documents, each query has, in every block, a
number of documents from ``planted.docs_per_block`` that hold every
present term: in each field of ``planted.field_share`` with that
probability (``data/querylog.py`` draws a CAT1 query's terms from one
document's body, so matching documents exist by construction).  Every
seed gets the same set of sizes in another order: the term counts, the
planes' k and the queries' planted counts take each value of their range
equally often (to within one), placed by a seeded permutation.

A call's batch is ``query_batch`` consecutive queries of the pool,
starting at ``pool_stride`` times the call's number, modulo the pool's
variants (``Inputs.batch``): contiguous views, so that successive calls
read different planes and no copy is made.  Scores are normal, one row a
batch slot.

A served Q table has the rules' values ``q_init.base`` (the trainer's
init) plus normal times ``q_init.scale``, as a trained table's moved
cells, ranked in each state by an order drawn from ``q_init.order_seed``
and not from the seed: every seed serves the same rule in each state, so
a query's work does not change with the seed, only the gaps between the
rules do.  Reset and stop sit ``q_init.margin`` below the row's lowest rule, except
that stop is ``margin`` above its best rule in every state whose u
stratum starts at 2^``stop_from_u_log2`` or more, and reset in every
``reset_every_v_bin``-th v bin of the other states (never the start
state): the same states for every seed.  A learner starts from the
constant ``q_init.constant`` that the trainer starts from.  The state
bins' edges are geometric; the production plan's step rewards are normal
times their scale; a learner's ε-greedy draws, one set a step, are made
here too."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

OCC_SLICE = 16          # queries per occupancy fill (a 537 MB temporary at full size)
FIELDS = ("anchor", "url", "body", "title")


@dataclasses.dataclass
class Inputs:
    q: torch.Tensor                   # (p, n_actions) float32
    u_edges: torch.Tensor             # (pu - 1,) float32
    v_edges: torch.Tensor             # (pu, pv - 1) float32
    occ: torch.Tensor                 # (pool, n_blocks, T, F, W) int32
    scores: torch.Tensor              # (B, n_blocks * block_docs) float32
    term_present: torch.Tensor        # (pool, T) bool
    prod_rewards: torch.Tensor        # (B, t_max) float32
    explore: Optional[torch.Tensor]   # (steps, t_max, B) int32
    uniform: Optional[torch.Tensor]   # (steps, t_max, B) float32
    batch_size: int
    stride: int

    @property
    def variants(self) -> int:
        return (self.occ.shape[0] - self.batch_size) // self.stride + 1

    def batch(self, call: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Call ``call``'s (occ, term_present): views of the pool."""
        start = self.stride * (call % self.variants)
        rows = slice(start, start + self.batch_size)
        return self.occ[rows], self.term_present[rows]

    def draws(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        i = step % self.explore.shape[0]
        return self.explore[i], self.uniform[i]


def spread(lo: int, hi: int, n: int, gen, device) -> torch.Tensor:
    """n values of lo..hi, each equally often (to within one), in an order
    drawn from ``gen``."""
    values = lo + torch.arange(n, device=device) % (hi - lo + 1)
    return values[torch.randperm(n, generator=gen, device=device)]


def bin_edges(cfg: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Geometric state-bin edges: pu - 1 over u from 2^a to 2^b, and, in
    every u stratum, pv - 1 over v from 2^c to 2^d."""
    pu = int(math.isqrt(cfg["p_bins"]))
    pv = cfg["p_bins"] // pu
    (ua, ub), (va, vb) = (cfg["state_bins"]["u_edges_log2"],
                          cfg["state_bins"]["v_edges_log2"])
    u_edges = torch.logspace(ua, ub, pu - 1, base=2.0, device=device)
    v_edges = torch.logspace(va, vb, pv - 1, base=2.0, device=device)
    return u_edges, v_edges.repeat(pu, 1)


def _pack(bits_at: torch.Tensor, keep: torch.Tensor, words: int) -> torch.Tensor:
    """int32 words (..., words) with the bits ``bits_at`` (..., m) set
    where ``keep``; no two kept bits of a row coincide."""
    value = torch.where(keep, torch.ones_like(bits_at) << (bits_at % 32), 0)
    out = torch.zeros(bits_at.shape[:-1] + (words,), dtype=torch.int64,
                      device=bits_at.device)
    out.scatter_add_(-1, bits_at // 32, value)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def plant(part: torch.Tensor, count: torch.Tensor, planted: dict, gen,
          block_docs: int):
    """ORs into ``part`` (n, nb, T, F, W) ``count`` (n,) planted
    documents a block, each in its own stratum of the block's documents
    (so no two share a bit), holding every term in each field of
    ``planted['field_share']`` with that probability."""
    most = planted["docs_per_block"][1]
    n, nb, _, _, w = part.shape
    width = block_docs // most
    pos = torch.randint(0, width, (n, nb, most), generator=gen,
                        device=part.device, dtype=torch.int64)
    pos += width * torch.arange(most, device=part.device)
    keep = torch.arange(most, device=part.device) < count[:, None, None]
    for name, share in planted["field_share"].items():
        held = keep
        if share < 1.0:
            held = keep & (torch.rand((n, nb, most), generator=gen,
                                      device=part.device) < share)
        part[:, :, :, FIELDS.index(name)] |= _pack(pos, held, w)[:, :, None]


def served_table(cfg: dict, u_edges: torch.Tensor, gen, device) -> torch.Tensor:
    """The served Q table (see the module's text); row s = stratum x pv +
    v bin, as the state bins number them."""
    init, k = cfg["q_init"], cfg["k_rules"]
    p, pv = cfg["p_bins"], cfg["p_bins"] // int(math.isqrt(cfg["p_bins"]))
    q = torch.empty((p, k + 2), device=device)
    values = init["scale"] * torch.randn((p, k), generator=gen, device=device)
    order = torch.Generator(device=device)
    order.manual_seed(init["order_seed"])
    rank = torch.rand((p, k), generator=order, device=device).argsort(1).argsort(1)
    q[:, :k] = init["base"] + values.sort(1, descending=True).values.gather(1, rank)
    low = q[:, :k].amin(1) - init["margin"]
    high = q[:, :k].amax(1) + init["margin"]
    stratum = torch.arange(p, device=device) // pv
    within = torch.arange(p, device=device) % pv
    floor = torch.cat([torch.zeros(1, device=device), u_edges])[stratum]
    stop = floor >= 2.0 ** init["stop_from_u_log2"]
    every = init["reset_every_v_bin"]
    reset = ~stop & (within % every == every - 1)
    q[:, k] = torch.where(reset, high, low)
    q[:, k + 1] = torch.where(stop, high, low)
    return q


def websearch_inputs(cfg: dict, traffic: dict, seed: int, device,
                     draw_steps: int = 0) -> Inputs:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    b, nb = cfg["query_batch"], cfg["n_blocks"]
    pool = max(b, traffic.get("query_pool", b))
    t, f, w = cfg["query_terms_max"], cfg["fields"], cfg["block_docs"] // 32
    n_act = cfg["k_rules"] + 2
    lo, hi = traffic["plane_density_log2"]
    t_lo, t_hi = traffic["query_terms"]
    k = spread(lo, hi, pool * t * f, gen, device).reshape(pool, 1, t, f, 1)
    n_terms = spread(t_lo, t_hi, pool, gen, device)
    tp = torch.arange(t, device=device)[None] < n_terms[:, None]
    planted = traffic.get("planted")
    if planted:
        p_lo, p_hi = planted["docs_per_block"]
        n_planted = spread(p_lo, p_hi, pool, gen, device)
    occ = torch.empty((pool, nb, t, f, w), dtype=torch.int32, device=device)
    for q0 in range(0, pool, OCC_SLICE):
        part = occ[q0:q0 + OCC_SLICE]
        part.fill_(-1)
        kk = k[q0:q0 + OCC_SLICE]
        for i in range(1, hi + 1):
            words = torch.randint(-2**31, 2**31, part.shape, generator=gen,
                                  device=device, dtype=torch.int32)
            part &= torch.where(kk >= i, words, -1)
        if planted:
            plant(part, n_planted[q0:q0 + OCC_SLICE], planted, gen,
                  cfg["block_docs"])
        part &= torch.where(tp[q0:q0 + OCC_SLICE, None, :, None, None], -1, 0)
    scores = torch.randn((b, nb * cfg["block_docs"]), generator=gen,
                         device=device)
    u_edges, v_edges = bin_edges(cfg, device)
    if "constant" in cfg["q_init"]:     # a learner's start: the trainer's init_q
        q = torch.full((cfg["p_bins"], n_act), cfg["q_init"]["constant"],
                       device=device)
    else:                               # a served policy, standing for a trained one
        q = served_table(cfg, u_edges, gen, device)
    prod_r = cfg["production_step_reward_scale"] * torch.randn(
        (b, cfg["t_max"]), generator=gen, device=device)
    explore = uniform = None
    if draw_steps:
        explore = torch.randint(0, n_act, (draw_steps, cfg["t_max"], b),
                                generator=gen, device=device, dtype=torch.int32)
        uniform = torch.rand((draw_steps, cfg["t_max"], b), generator=gen,
                             device=device)
    return Inputs(q, u_edges, v_edges, occ, scores, tp, prod_r, explore,
                  uniform, b, traffic.get("pool_stride", b))
