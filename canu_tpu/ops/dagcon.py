"""Tag-chain (DAG) consensus — the pbdagcon / alignment-graph role.

Per-column plurality (votepile._finalize_plurality) calls every column
independently, which breaks on piles that need consistency ACROSS
columns: mixed-haplotype evidence (the winning call must come from ONE
haplotype's chain, not a per-column vote mix) and insertions longer than
the vote format's two per-column slots.  The reference handles these
with an alignment graph (/root/reference/src/utgcns/libpbutgcns/
AlnGraphBoost.C) and alignment-tag chain DP (/root/reference/src/
correction/falconConsensus-alignTag.C): every read contributes a chain
of (column, delta, base) tags, edges between consecutive tags are
counted, and the consensus is the heaviest consistent source-to-sink
path.

Device design: the expensive part — base-level alignment of every evidence
window onto the backbone — runs on device with the same window-frame DP
the vote engine uses (trace.align_positions_lean); what comes back per
job is the optimal-path evidence position j*(i) for every template row
plus the oriented evidence window (a few KB per job).  The cheap part —
tag extraction, edge counting, and the heaviest-chain DP — is
vectorized numpy on host: tags of all reads of a segment are built in
one lexsort, edges counted with np.unique, and the DP walks unique
graph nodes once (node count ~ 5x segment length).  This mode is
selected with cnsConsensus=dag (reference utgcns -pbdagcon vs -quick,
/root/reference/src/utgcns/utgcns.C:60-530); the plurality engine
remains the default (cnsConsensus=plurality).

Measured host-DP throughput (r5, this 2-core box under load): 7.4 ms
per 512-base segment at 40x evidence = ~14 s per Mb of backbone per
polish round — ~65 s for an E. coli-sized assembly, fine for the
opt-in mode; a whole 140 Mb genome would spend ~30 min here, so dag
stays non-default at that scale until the chain DP is batched across
segments (the edge structure — (pos,d)->(pos,d+1) and (pos,*)->
(pos+1,0) — admits a column-sweep vectorization over all segments at
once; not done, measured instead).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .trace import align_positions_lean
from .votepile import _gather_window

# deletion pseudo-base in tag space (real bases are 0..3)
DEL_BASE = 4
# max insertion tags kept between two template columns (falcon's
# alignTag delta cap role); longer inserts are truncated — iterative
# repileup absorbs the tail exactly like the plurality path does
MAX_DELTA = 12


@partial(jax.jit, static_argnames=("band", "n_rows"))
def _paths_many(
    t_words, t_lengths, e_words, e_lengths,
    cols,  # int32[7, B]: t_idx, e_idx, t_bgn, t_span, e_lo, e_span, flipped
    band: int, n_rows: int,
):
    """Alignment paths for one chunk of evidence jobs.

    Returns (j_star int32[B, n_rows+1], e_sub uint8[B, W_e]): the
    per-template-row evidence positions and the oriented evidence
    window they index into.  Mirrors the front half of
    votepile._vote_chunk_core, but ships the PATHS to the host instead
    of folding votes on device — the DAG needs per-read chains, not
    per-column aggregates.
    """
    t_idx, e_idx = cols[0], cols[1]
    t_bgn, t_span = cols[2], cols[3]
    e_lo, e_span = cols[4], cols[5]
    flipped = cols[6] != 0
    W_e = n_rows + max(band, n_rows // 2)
    t_sub = _gather_window(t_words, t_lengths, t_idx, t_bgn, None, n_rows)
    e_sub = _gather_window(e_words, e_lengths, e_idx, e_lo, flipped, W_e)
    e_span = jnp.minimum(e_span, W_e - 1)
    js, _ = align_positions_lean(
        t_sub, t_span, e_sub, e_span, band, n_rows, ends_free=True
    )
    return js, e_sub


def paths_for_jobs(
    t_words, t_lengths, e_words, e_lengths, jobs, Lt: int, band: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Run every job through the path kernel; returns host arrays
    (js int32[n, Lt+1], e_sub uint8[n, W_e]).  Chunked like
    votepile.pile_votes: one chunk per dispatch, async dispatches,
    results fetched in arrival order."""
    from .votepile import CHUNK_CELL_BUDGET

    n = len(jobs)
    n_rows = Lt
    W_e = n_rows + max(min(band, 256), n_rows // 2)
    js_out = np.zeros((n, n_rows + 1), np.int32)
    es_out = np.zeros((n, W_e), np.uint8)
    if n == 0:
        return js_out, es_out
    B = max(32, min(256, CHUNK_CELL_BUDGET // n_rows))
    band_c = min(band, 256)
    C_total = -(-n // B)
    pad_n = C_total * B - n
    packed = np.zeros((C_total, 7, B), np.int32)
    fields = (jobs.t_idx, jobs.e_idx, jobs.t_bgn, jobs.t_span,
              jobs.e_lo, jobs.e_span, jobs.flipped)
    for fi, v in enumerate(fields):
        v = v.astype(np.int32)
        if pad_n:
            v = np.concatenate([v, np.zeros(pad_n, np.int32)])
        packed[:, fi, :] = v.reshape(C_total, B)
    # Bounded in-flight window: dispatch ahead but fetch as we go so at
    # most MAX_INFLIGHT chunks of js/e_sub device buffers are alive at
    # once (a whole-backbone dag polish job would otherwise hold every
    # chunk's buffers in HBM simultaneously).
    MAX_INFLIGHT = 8
    pending: list[tuple[int, object, object]] = []

    def _drain_one() -> None:
        c0, js_d, es_d = pending.pop(0)
        lo, hi = c0 * B, min((c0 + 1) * B, n)
        js_out[lo:hi] = np.asarray(js_d)[: hi - lo]
        es_out[lo:hi] = np.asarray(es_d)[: hi - lo]

    for c0 in range(C_total):
        js_d, es_d = _paths_many(
            t_words, t_lengths, e_words, e_lengths,
            jnp.asarray(packed[c0]), band_c, n_rows,
        )
        pending.append((c0, js_d, es_d))
        if len(pending) >= MAX_INFLIGHT:
            _drain_one()
    while pending:
        _drain_one()
    return js_out, es_out


def _job_tags(
    t_bgn: int, t_span: int, js: np.ndarray, e_row: np.ndarray, e_span: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tags (pos, delta, base) for one aligned evidence window, in chain
    order.  pos is the template column IN SEGMENT COORDINATES; delta=0
    tags are the base (or DEL_BASE) aligned at pos; delta=k>=1 tags are
    insertion bases between pos and pos+1 (attached to the PRECEDING
    column, matching alignTag convention)."""
    js = js[: t_span + 1].astype(np.int64)
    dj = js[1:] - js[:-1]
    i = np.arange(t_span)
    active = (js[1:] > 0) & (js[:-1] < e_span)
    cols = t_bgn + i
    # base / deletion tags at (col, 0)
    bidx = np.clip(js[1:] - 1, 0, len(e_row) - 1)
    base = np.where(dj >= 1, e_row[bidx], DEL_BASE).astype(np.int64)
    keep_b = active
    pos0, d0, b0 = cols[keep_b], np.zeros(keep_b.sum(), np.int64), base[keep_b]
    # insertion tags: bases e_row[js[i] .. js[i+1]-2] attach to (col-1, k)
    nins = np.clip(dj - 1, 0, MAX_DELTA)
    keep_i = active & (nins > 0) & (cols > t_bgn)  # no preceding tag -> drop
    if keep_i.any():
        cnt = nins[keep_i]
        posI = np.repeat(cols[keep_i] - 1, cnt)
        within = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        dI = within + 1
        src = np.repeat(js[:-1][keep_i], cnt) + within
        bI = e_row[np.clip(src, 0, len(e_row) - 1)].astype(np.int64)
        pos = np.concatenate([pos0, posI])
        dd = np.concatenate([d0, dI])
        bb = np.concatenate([b0, bI])
    else:
        pos, dd, bb = pos0, d0, b0
    order = np.lexsort((dd, pos))
    return pos[order], dd[order], bb[order]


def tag_chain_consensus(
    template: np.ndarray,
    tag_sets: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    min_cov: int = 2,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Heaviest-consistent-chain consensus for one segment.

    tag_sets: one (pos, delta, base) triple per evidence read (chain
    order).  Columns whose delta-0 coverage is below min_cov keep the
    template base (and break chains, like the plurality path's
    keep_template columns).  Returns (consensus codes, per-output-base
    evidence coverage, n_edits) — the coverage lets correction-style
    callers split the output at unsupported columns."""
    S = len(template)
    if not tag_sets or S == 0:
        return template.copy(), np.zeros(S, np.int64), 0
    # ---- coverage gate ------------------------------------------------
    cov = np.zeros(S, np.int64)
    for pos, dd, _ in tag_sets:
        at0 = pos[dd == 0]
        np.add.at(cov, at0[(at0 >= 0) & (at0 < S)], 1)
    good = cov >= max(1, min_cov)
    # ---- flatten tags, drop gated columns, count edges per read -------
    D1 = MAX_DELTA + 2
    all_key, all_read = [], []
    for r, (pos, dd, bb) in enumerate(tag_sets):
        ok = (pos >= 0) & (pos < S)
        ok &= good[np.clip(pos, 0, S - 1)]
        if not ok.any():
            continue
        key = (pos[ok] * D1 + dd[ok]) * 5 + bb[ok]
        all_key.append(key)
        all_read.append(np.full(len(key), r, np.int64))
    if not all_key:
        return template.copy(), cov, 0
    keys = np.concatenate(all_key)
    reads = np.concatenate(all_read)
    same = reads[1:] == reads[:-1]
    e_src = keys[:-1][same]
    e_dst = keys[1:][same]
    # only ADJACENT transitions are graph edges: (pos, d) -> (pos, d+1)
    # (insertion chain) or (pos, d) -> (pos+1, 0).  A gated/inactive
    # column must BREAK the read's chain, not be bridged by a spurious
    # edge that would skip its template base entirely.
    sp, sd = e_src // (D1 * 5), (e_src // 5) % D1
    dp_, dd_ = e_dst // (D1 * 5), (e_dst // 5) % D1
    adj = ((dp_ == sp) & (dd_ == sd + 1)) | ((dp_ == sp + 1) & (dd_ == 0))
    e_src, e_dst = e_src[adj], e_dst[adj]
    if len(e_src) == 0:
        return template.copy(), cov, 0
    # ---- unique nodes + edges -----------------------------------------
    nodes = np.unique(keys)
    n_nodes = len(nodes)
    edge_key = e_src * (nodes[-1] + 1) + e_dst  # src always < dst
    uedge, ecnt = np.unique(edge_key, return_counts=True)
    usrc = np.searchsorted(nodes, uedge // (nodes[-1] + 1))
    udst = np.searchsorted(nodes, uedge % (nodes[-1] + 1))
    # ---- heaviest-chain DP over nodes in key order --------------------
    # edges always go key_src < key_dst ((pos, delta) strictly increases
    # along a read's chain), so ascending-key node order is topological.
    order = np.argsort(udst, kind="stable")
    usrc, udst, ecnt = usrc[order], udst[order], ecnt[order]
    bounds = np.searchsorted(udst, np.arange(n_nodes + 1))
    usrc_l, ecnt_l = usrc.tolist(), ecnt.tolist()
    bounds_l = bounds.tolist()
    score_l = [0] * n_nodes
    prev_l = [-1] * n_nodes
    for d in range(n_nodes):
        b0, b1 = bounds_l[d], bounds_l[d + 1]
        best, barg = 0, -1
        for e in range(b0, b1):
            s = score_l[usrc_l[e]] + ecnt_l[e]
            if s > best:
                best, barg = s, usrc_l[e]
        score_l[d] = best
        prev_l[d] = barg
    score = np.asarray(score_l)
    best_prev = np.asarray(prev_l)
    # ---- backtrack from the global best end node ----------------------
    end = int(np.argmax(score))
    if score[end] <= 0:
        return template.copy(), cov, 0
    path = []
    cur = end
    while cur >= 0:
        path.append(cur)
        cur = int(best_prev[cur])
    path.reverse()
    pkeys = nodes[path]
    ppos = pkeys // (D1 * 5)
    pd = (pkeys // 5) % D1
    pbase = pkeys % 5
    # ---- emit: template outside the path's span, chain inside ---------
    # a path starting on an insertion tag contributes bases AFTER column
    # ppos[0]'s own base, so the template prefix must include that column
    lo = int(ppos[0]) + (1 if int(pd[0]) > 0 else 0)
    hi = int(ppos[-1])
    keep = pbase != DEL_BASE
    emit = pbase[keep].astype(np.uint8)
    out = np.concatenate([template[:lo], emit, template[hi + 1 :]])
    out_cov = np.concatenate(
        [cov[:lo], cov[np.clip(ppos[keep], 0, S - 1)], cov[hi + 1 :]]
    )
    n_edits = int(
        np.sum(pd > 0)
        + np.sum(pbase == DEL_BASE)
        + np.sum((pd == 0) & (pbase != DEL_BASE)
                 & (pbase != template[np.clip(ppos, 0, S - 1)]))
    )
    return out, out_cov, n_edits


def dag_segments(
    seg_codes: list[np.ndarray],
    t_words, t_len_d, e_words, e_len_d,
    jobs, Lt: int, band: int, min_cov: int,
) -> tuple[list[np.ndarray], int]:
    """DAG-consensus every segment of a backbone given its evidence
    jobs (VoteJobs with t_idx = segment index, t_bgn/e_lo in segment /
    oriented-evidence coordinates).  Device: batched path alignment;
    host: per-segment tag-chain DP."""
    js, e_sub = paths_for_jobs(t_words, t_len_d, e_words, e_len_d, jobs,
                               Lt, band)
    n_seg = len(seg_codes)
    per_seg: list[list[int]] = [[] for _ in range(n_seg)]
    for jidx in range(len(jobs)):
        si = int(jobs.t_idx[jidx])
        if 0 <= si < n_seg:
            per_seg[si].append(jidx)
    new_segs: list[np.ndarray] = []
    n_edits = 0
    for si in range(n_seg):
        tmpl = np.asarray(seg_codes[si], np.uint8)
        if not per_seg[si] or len(tmpl) == 0:
            new_segs.append(tmpl)
            continue
        tag_sets = []
        for jidx in per_seg[si]:
            tag_sets.append(_job_tags(
                int(jobs.t_bgn[jidx]), int(jobs.t_span[jidx]),
                js[jidx], e_sub[jidx], int(jobs.e_span[jidx]),
            ))
        seg, _cov, ed = tag_chain_consensus(tmpl, tag_sets, min_cov=min_cov)
        new_segs.append(seg)
        n_edits += ed
    return new_segs, n_edits
