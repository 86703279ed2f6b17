"""Overlap error adjustment: RED + OEA (findErrors / correctOverlaps).

Re-implements the reference's assembly-phase error adjustment:

  * findErrors ("RED", /root/reference/src/overlapErrorAdjustment/
    findErrors.C:374-510): every read is re-examined against its overlap
    pile; positions where the evidence plurality contradicts the read's
    own base with enough support (Vote_Qualify) are recorded as
    corrections;
  * correctOverlaps ("OEA", /root/reference/src/overlapErrorAdjustment/
    correctOverlaps.C:156-215): corrections are applied to BOTH reads of
    every overlap and the alignment is recomputed; the revised erates
    become the overlap store's `evalues` sidecar
    (OverlapErrorAdjustment.pm:632 updateOverlapStore).

Device shape: RED runs on the device vote-pile engine (ops.votepile —
batched fwd+bwd banded DPs, on-device vote accumulation + decision, one
packed byte per read position back to host); corrections are
SUBSTITUTION-only (indels were already handled by falcon correction
upstream; the reference's indel votes mostly fire on raw reads).  OEA
then rebuilds the corrected reads (bit surgery on the packed words, no
repack), re-verifies every overlap with the Myers kernel in one batch,
and installs the recomputed erates — matching the reference's
"recompute, don't just lower" semantics, with a span guard so a
re-verification that banded badly (span collapse) cannot corrupt a row.

The payoff matches the reference's: adjusted erates approximate TRUE
sequence divergence (net of correctable sequencing error), which lets
bogart's deviation filters separate repeats at much tighter thresholds.
"""

from __future__ import annotations

import numpy as np

from ..stores.overlaps import OverlapStore
from ..stores.readset import ReadSet
from .falcon import evidence_vote_jobs, run_vote_blocks, select_evidence_rows
from .votepile import _finalize_red


def detect_read_errors(
    rs: ReadSet,
    st: OverlapStore,
    max_evidence_coverage: int = 40,
    min_alt_votes: int = 4,
    max_own_votes: int = 1,
    band: int = 256,
    batch: int = 0,  # unused (device engine sizes its own chunks)
) -> dict[int, np.ndarray]:
    """RED: per-read substitution corrections from overlap-pile votes.

    Returns {read_id: int32[M, 2] of (position, corrected_base_code)}.
    A position is corrected when an alternative base gets >=
    min_alt_votes while the read's own base keeps <= max_own_votes
    (the Vote_Qualify support test of findErrors.C).
    """
    per = st.n_overlaps_per_read()
    ids = (np.flatnonzero(per > 0) + 1).astype(np.int32)
    if len(ids) == 0:
        return {}
    rows = select_evidence_rows(st, ids, rs.length, max_evidence_coverage, 0)
    jobs = evidence_vote_jobs(st, rows, rs.length)
    has_ev = np.zeros(rs.n_reads + 1, bool)
    has_ev[jobs.t_idx + 1] = True
    ids = ids[has_ev[ids]]
    if len(ids) == 0:
        return {}

    def finalize(words_d, len_d, t_idx, votes, Lt):
        return _finalize_red(
            words_d, len_d, t_idx, votes,
            float(min_alt_votes), float(max_own_votes), Lt,
        )

    out: dict[int, np.ndarray] = {}
    for _bi, bt, packed in run_vote_blocks(rs, jobs, ids, band, finalize):
        live = packed[: len(bt)]
        gg, pp = np.nonzero((live >> 2) & 1)  # fix positions (masked on device)
        if len(gg) == 0:
            continue
        alt = (live[gg, pp] & 3).astype(np.int32)
        cut = np.searchsorted(gg, np.arange(len(bt) + 1))
        for g in np.unique(gg):
            s, e = cut[g], cut[g + 1]
            out[int(bt[g])] = np.stack(
                [pp[s:e].astype(np.int32), alt[s:e]], axis=1
            )
    return out


def apply_corrections(rs: ReadSet, corrections: dict[int, np.ndarray]) -> ReadSet:
    """Corrected copy of the read set (substitutions in place, so all
    overlap coordinates stay valid — the property OEA relies on).

    Substitutions are applied as bit surgery on the packed word array
    (grouped by within-word lane so scatter writes never collide)."""
    words = rs.words.copy()
    if corrections:
        rid = np.concatenate(
            [np.full(len(v), k, np.int64) for k, v in corrections.items()]
        )
        pos = np.concatenate([v[:, 0] for v in corrections.values()]).astype(np.int64)
        base = np.concatenate([v[:, 1] for v in corrections.values()]).astype(np.uint32)
        w = rs.word_off[rid - 1] + pos // 16
        lane = (pos % 16).astype(np.int64)
        for sh in range(16):
            m = lane == sh
            if not m.any():
                continue
            wi = w[m]
            mask = np.uint32(~(np.uint32(3) << np.uint32(2 * sh)) & 0xFFFFFFFF)
            words[wi] = (words[wi] & mask) | (base[m] << np.uint32(2 * sh))
    names = list(rs.names) if rs.names else None
    return ReadSet(words, rs.word_off, rs.length, names,
                   rs.source_id, rs.source_bgn)


def adjust_overlap_erates(
    rs: ReadSet,
    st: OverlapStore,
    corrections: dict[int, np.ndarray],
    band: int = 128,
    chunk: int = 512,
    engine: str | None = None,
    only_changed: bool = False,
) -> np.ndarray:
    """OEA: re-verify overlaps between corrected reads.

    Returns the new uint16 erate_q array aligned with the store's rows
    (both mirror copies), ready for st.update_erates — the evalues
    sidecar install of the reference.  Erates are RECOMPUTED (they can
    rise, matching correctOverlaps.C); a row keeps its old value only
    when the re-verification's span collapsed below half the stored
    span (a banding failure, not a measurement).

    only_changed=True re-verifies ONLY overlaps where at least one read
    received >= 1 RED correction — the reference applies corrections per
    frag and redoes only affected overlaps (correctOverlaps.C:156-178
    Correct_Frags -> Redo_Olaps); an overlap between two untouched reads
    keeps its stored erate, which the SAME verify kernel produced in the
    overlap stage.
    """
    from .align import verify_overlaps
    from .minhash import OverlapCandidates
    from .minimizers import corrected_read_index, get_read_index

    if not len(st.a_id):
        return st.erate_q.copy()
    rs_fixed = apply_corrections(rs, corrections)
    # substitutions keep lengths + syncmer geometry: reuse the original
    # readset's (cached) seed index with the corrected word plane
    # instead of re-extracting syncmers
    idx = corrected_read_index(get_read_index(rs, k=16), rs_fixed)
    half = st.a_id < st.b_id  # one direction; mirror rows share the erate
    if only_changed:
        changed = np.zeros(st.n_reads + 1, bool)
        for rid in corrections:
            changed[rid] = True
        half = half & (changed[st.a_id] | changed[st.b_id])
        if not half.any():
            return st.erate_q.copy()
    z = np.zeros(int(half.sum()), np.int32)
    cand = OverlapCandidates(
        a_id=st.a_id[half].astype(np.int32),
        b_id=st.b_id[half].astype(np.int32),
        flipped=st.flipped[half],
        diag=z, n_shared=z, a_lo=z, a_hi=z, b_lo=z, b_hi=z,
    )
    ov = verify_overlaps(
        rs_fixed, cand, band=band, max_erate=1.0, min_overlap=0,
        chunk=chunk, engine=engine, index=idx,
    )
    out = st.erate_q.copy()
    if len(ov) == 0:
        return out
    M = np.int64(st.n_reads + 1)
    a64 = ov.a_id.astype(np.int64)
    b64 = ov.b_id.astype(np.int64)
    ov_key = np.minimum(a64, b64) * M + np.maximum(a64, b64)
    ov_span = np.minimum(ov.a_end - ov.a_bgn, ov.b_end - ov.b_bgn).astype(np.int64)
    sk = np.argsort(ov_key, kind="stable")
    ov_key_s = ov_key[sk]
    sa64 = st.a_id.astype(np.int64)
    sb64 = st.b_id.astype(np.int64)
    st_key = np.minimum(sa64, sb64) * M + np.maximum(sa64, sb64)
    pos = np.searchsorted(ov_key_s, st_key)
    posc = np.minimum(pos, len(sk) - 1)
    found = ov_key_s[posc] == st_key
    match = sk[posc]
    old_span = (st.a_end - st.a_bgn).astype(np.int64)
    ok = found & (ov_span[match] * 2 >= old_span)
    out[ok] = ov.erate_q[match[ok]]
    return out
