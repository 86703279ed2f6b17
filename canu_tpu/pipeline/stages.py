"""Pipeline stage implementations (the L5 layer of the reference).

Each phase re-runs gatekeeper -> meryl -> overlap first, exactly like the
reference's per-phase call sequences (/root/reference/src/pipelines/
canu.pl:660-680 correct, :699-712 trim, :731-762 assemble), then its own
stages.  Stage done-ness is file existence (resume contract, see
driver.py).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import Config
from ..stores.readset import ReadSet
from ..stores.overlaps import OverlapStore
from ..stores.tigs import CLASS_CONTIG, CLASS_UNASSEMBLED, TigStore
from ..utils import bitpack
from ..utils.intervals import largest_covered
from .driver import AssemblyCtx, run_stage

TAG_DIR = {"cor": "correction", "obt": "trimming", "utg": "unitigging"}


def sharded_enabled(cfg) -> bool:
    """True when the meryl/candidate stages should run on the device mesh
    (config shardedCompute: auto = whenever >1 device is visible)."""
    v = str(cfg.get("shardedCompute")).strip().lower()
    if v == "auto":
        import jax

        return jax.device_count() > 1
    return v in ("1", "true", "yes", "on")


# ---- shared per-phase stages ------------------------------------------------


def gatekeeper(ctx: AssemblyCtx, tag: str, inputs: list[str]) -> ReadSet:
    """Load reads into the phase store (gatekeeperCreate equivalent,
    /root/reference/src/stores/gatekeeperCreate.C)."""
    d = ctx.phase_dir(TAG_DIR[tag])
    store = os.path.join(d, f"{ctx.prefix}.gkpStore")

    def done() -> bool:
        return os.path.isdir(store)

    def fn() -> None:
        min_len = int(ctx.cfg.get("minReadLength"))
        rs, stats = ReadSet.from_fastx(inputs, min_read_length=min_len)
        if rs.n_reads == 0:
            raise RuntimeError(f"gatekeeper[{tag}]: no reads loaded from {inputs}")
        if (
            bool(ctx.cfg.get("stopOnReadQuality"))
            and stats.n_input > 0
            and stats.n_skipped_short > stats.n_loaded
        ):
            # Gatekeeper.pm:302-312 stopOnReadQuality: most of the input
            # was discarded — almost always wrong minReadLength/wrong file
            raise RuntimeError(
                f"gatekeeper[{tag}]: {stats.n_skipped_short} of "
                f"{stats.n_input} input reads discarded as shorter than "
                f"minReadLength={min_len}; fix the input or set "
                f"stopOnReadQuality=false to continue anyway"
            )
        qv_line = ""
        if rs.has_quals:
            from ..utils.quality import quality_clear_ranges, read_quality_histogram

            qhist = read_quality_histogram(rs.mean_quals())
            qv_line = f"\nmean-QV histogram (bin 2): {qhist.tolist()}"
            if bool(ctx.cfg.get("qvTrim")):
                # initial QV clear ranges (trimReads-quality role) applied
                # before any overlap work, like the reference's initial
                # clear at store build
                b, e = quality_clear_ranges(
                    rs.length, rs.quals, rs.qual_off,
                    min_qv=float(ctx.cfg.get("qvTrimMinQuality")),
                    window=int(ctx.cfg.get("qvTrimWindow")),
                )
                n_trim = int(np.sum((b > 0) | (e < rs.length)))
                if n_trim:
                    before = rs.n_reads
                    keep = (e - b) >= min_len
                    rs = rs.sliced(np.where(keep, b, 0), np.where(keep, e, 0))
                    qv_line += (
                        f"\nQV trim: {n_trim} reads trimmed, "
                        f"{before - rs.n_reads} dropped below minReadLength"
                    )
        rs.save(store)
        hist = rs.length_histogram(1000)
        ctx.report.add(
            f"{tag}.gatekeeper",
            f"reads loaded {stats.n_loaded} / input {stats.n_input}; "
            f"bases {stats.bases_loaded}; split-at-N {stats.n_split_at_n}; "
            f"short discards {stats.n_skipped_short}\n"
            f"length histogram (kb): {hist.tolist()}" + qv_line,
        )

    run_stage(ctx, f"{tag}-gatekeeper", done, fn)
    return ReadSet.load(store)


def meryl(ctx: AssemblyCtx, tag: str, rs: ReadSet):
    """k-mer counting + frequent-mer table (Meryl.pm equivalent)."""
    from ..ops import kmer as K

    d = ctx.phase_dir(TAG_DIR[tag])
    k = int(ctx.cfg.get(tag + "MerSize"))
    out = os.path.join(d, f"{ctx.prefix}.ms{k}.frequent.npz")

    def done() -> bool:
        return os.path.exists(out)

    def fn() -> None:
        if sharded_enabled(ctx.cfg):
            # distributed meryl: hash-range all_to_all over the mesh
            # (identical counts — every k-mer lands on one owner shard);
            # k <= 16 routes one uint32 lane, k <= 32 exact 2-lane
            from ..parallel.shard_overlap import sharded_count_readset

            kc = sharded_count_readset(rs, k=k)
        else:
            # merylMemory scales the HBM instance budget before the
            # host counter takes over (~16 B/instance across the sort)
            mm = int(ctx.cfg.get("merylMemory"))
            kc = K.count_readset_device(
                rs, k=k, block_size=256,
                max_instances=mm * (1 << 26) if mm > 0 else None,
            )
        hist = kc.histogram(1000)
        n_distinct = int(hist[1:].sum())
        mode = str(ctx.cfg.get(tag + "MerThreshold"))
        how = mode

        def by_distinct():
            return K.frequent_kmers(
                kc, distinct_fraction=float(ctx.cfg.get(tag + "MerDistinct"))
            )

        if mode.isdigit():
            fk = K.frequent_kmers(kc, threshold=int(mode))
        elif mode == "auto":
            # 'auto' starts from the reference's MHAP ignore rule:
            # minCount = filterThreshold * totalMers where totalMers =
            # 2 * distinct canonical mers (Meryl.pm:672-695).  BUT the
            # reference only DOWN-WEIGHTS those mers inside MHAP's
            # tf-idf (--repeat-weight 0.9); our sketches EXCLUDE them,
            # so a low threshold (small genomes / corrected reads round
            # the formula down to ~2) would swallow the genomic bulk
            # and collapse overlap sensitivity (differential e2e found
            # median 1 overlap/read at 14x).  Floor the threshold with
            # the distinct-fraction rule so the ignore set stays a
            # repeat tail, never the genome.
            thr = int(float(ctx.cfg.get("mhapFilterThreshold")) * 2 * n_distinct)
            thr_floor = K.threshold_from_distinct_fraction(
                kc, float(ctx.cfg.get(tag + "MerDistinct"))
            )
            if thr >= max(2, thr_floor):
                fk = K.frequent_kmers(kc, threshold=thr)
                how = "auto(mhap total-fraction)"
            else:
                fk = K.frequent_kmers(kc, threshold=max(2, int(thr_floor)))
                how = "auto->distinct-floor"
        elif mode == "estimate":
            # valley/peak coverage estimate — the reference's
            # estimate-mer-threshold used by its ovl overlapper
            fk = K.frequent_kmers(kc, threshold=K.estimate_coverage_threshold(kc))
            how = "estimate(valley/peak)"
        else:
            fk = by_distinct()
        custom = str(ctx.cfg.get(tag + "OvlFrequentMers")).strip()
        if custom:
            # user-supplied always-ignore mers (reference OvlFrequentMers)
            fk = K.union_frequent(fk, K.frequent_from_fasta(custom, k))
        from ..parallel.launch import is_writer

        if is_writer():  # every process computed fk (collectives); one writes
            np.savez(
                out + ".WORKING.npz",
                kmers=fk.kmers,
                fraction=fk.fraction,
                threshold=np.array([fk.threshold]),
                total=np.array([fk.total_kmers]),
                k=np.array([k]),
            )
            os.replace(out + ".WORKING.npz", out)
            if bool(ctx.cfg.get("saveMerCounts")):
                # full count table artifact (reference saveMerCounts)
                kh = kc.to_host() if hasattr(kc, "to_host") else kc
                cp = os.path.join(d, f"{ctx.prefix}.ms{k}.counts.npz")
                np.savez_compressed(
                    cp + ".WORKING.npz", kmers=kh.unique, counts=kh.counts,
                    k=np.array([k]),
                )
                os.replace(cp + ".WORKING.npz", cp)
            ctx.report.add(
                f"{tag}.meryl",
                f"k={k} threshold {fk.threshold} ({how}); "
                f"{fk.n} frequent mers of {n_distinct} distinct",
            )

    run_stage(ctx, f"{tag}-meryl", done, fn,
              collective=sharded_enabled(ctx.cfg))
    with np.load(out) as z:
        return K.FrequentKmers(
            k=int(z["k"][0]),
            kmers=z["kmers"],
            fraction=z["fraction"],
            threshold=int(z["threshold"][0]),
            total_kmers=int(z["total"][0]),
        )


def _cor_evidence_budget(ctx: AssemblyCtx, rs: ReadSet) -> int:
    """Effective per-template evidence coverage: corMaxEvidenceCoverage
    capped by the Global/Local '<N.N>x' coverage-multiple knobs
    (reference filterCorrectionOverlaps corMaxEvidenceCoverageGlobal /
    generateCorrectionLayouts ...Local, CorrectReads.pm:83-117)."""
    base = int(ctx.cfg.get("corMaxEvidenceCoverage"))
    est = rs.total_bases / max(1.0, float(ctx.cfg.get("genomeSize")))
    lo = ctx.cfg.coverage_multiple("corMaxEvidenceCoverageLocal", est)
    return max(1, min(base, int(round(lo))))


def _minimap_candidates(ctx: AssemblyCtx, tag: str, rs: ReadSet,
                        d: str) -> np.ndarray:
    """overlapper=minimap: run the external minimap2 binary all-vs-all
    and use its PAF hits as CANDIDATE pairs for the device verification
    kernel (reference OverlapMMap.pm runs minimap2 + mmapConvert; the
    ${tag}ReAlign step is our verify pass, which recomputes exact
    hangs/erate — reference overlapPair role).  Requires minimap2 on
    PATH or minimap2Path= pointing at it."""
    import shutil
    import subprocess

    from ..io.fastx import write_fasta

    mm2 = str(ctx.cfg.get("minimap2Path"))
    if shutil.which(mm2) is None:
        raise PipelineError(
            f"{tag}Overlapper=minimap but {mm2!r} is not executable; "
            "install minimap2 or set minimap2Path="
        )
    fa = os.path.join(d, f"{ctx.prefix}.mmap-reads.fasta")
    if not os.path.exists(fa):
        write_fasta(fa + ".WORKING", ((f"{i}", rs.get_seq(i))
                                      for i in range(1, rs.n_reads + 1)))
        os.replace(fa + ".WORKING", fa)
    preset = "ava-ont" if str(ctx.cfg.get("readType")) == "nanopore" \
        else "ava-pb"
    mmap_k = int(ctx.cfg.get(tag + "MMapMerSize"))
    paf = os.path.join(d, f"{ctx.prefix}.mmap.paf")
    with open(paf + ".WORKING", "w") as oh:
        r = subprocess.run(
            [mm2, "-x", preset, "-k", str(mmap_k), fa, fa],
            stdout=oh, stderr=subprocess.PIPE, text=True,
        )
    if r.returncode != 0:
        raise PipelineError(
            f"minimap2 failed rc={r.returncode}: {r.stderr[-500:]}")
    os.replace(paf + ".WORKING", paf)
    pairs = set()
    with open(paf) as fh:
        for line in fh:
            f = line.split("\t", 6)
            if len(f) < 6:
                continue
            try:
                a, b = int(f[0]), int(f[5])
            except ValueError:
                continue
            if a != b and 1 <= a <= rs.n_reads and 1 <= b <= rs.n_reads:
                pairs.add((min(a, b), max(a, b)))
    ctx.log.info(f"{tag}-overlap: minimap2 produced {len(pairs)} "
                 f"candidate pairs ({preset}, k={mmap_k})")
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.array(sorted(pairs), np.int64)


def overlap(ctx: AssemblyCtx, tag: str, rs: ReadSet, fk) -> OverlapStore:
    """Sketch -> candidates -> place -> banded verify -> OverlapStore.

    The whole overlap computation + store build of the reference
    (OverlapMhap.pm + overlapInCore + OverlapStore.pm) as device passes.
    """
    from ..ops import align as AL
    from ..ops import minhash as MH

    d = ctx.phase_dir(TAG_DIR[tag])
    store = os.path.join(d, f"{ctx.prefix}.ovlStore")

    def done() -> bool:
        return os.path.isdir(store)

    def fn() -> None:
        import time as _time

        sub: dict[str, float] = {}  # sub-stage wall breakdown
        t_mark = _time.monotonic()

        def _lap(name: str) -> None:
            nonlocal t_mark
            now = _time.monotonic()
            sub[name] = round(sub.get(name, 0.0) + (now - t_mark), 1)
            t_mark = now

        cfg = ctx.cfg
        k = int(cfg.get(tag + "MerSize"))
        coverage = rs.total_bases / max(1.0, cfg.get("genomeSize"))
        n_hashes, min_matches = cfg.sketch_preset(tag, coverage)
        # sub-stage checkpoint: the candidate list is minutes of device
        # work at E. coli scale — persist it so an OOM retry (or an
        # external relaunch) resumes at verification instead of
        # replaying sketch+match (the reference's only-failed-indices
        # retry granularity, Execution.pm:1036-1276)
        pairs_ckpt = os.path.join(d, f"{ctx.prefix}.candidates.npy")
        if os.path.exists(pairs_ckpt):
            pairs = np.load(pairs_ckpt)
            ctx.log.info(
                f"{tag}-overlap: resuming from checkpointed candidates "
                f"({len(pairs)} pairs, {pairs_ckpt})"
            )
        elif str(cfg.get(tag + "Overlapper")) == "minimap":
            # external overlapper path (OverlapMMap.pm role): minimap2
            # proposes pairs, the device kernel verifies them
            pairs = _minimap_candidates(ctx, tag, rs, d)
            from ..parallel.launch import is_writer

            if is_writer():
                np.save(pairs_ckpt + ".WORKING.npy", pairs)
                os.replace(pairs_ckpt + ".WORKING.npy", pairs_ckpt)
            _lap("match")
        else:
            sk = MH.build_sketches(rs, k=k, n_hashes=n_hashes, frequent=fk,
                                   block_size=int(cfg.get("mhapBlockSize")))
            _lap("sketch")
            if sharded_enabled(cfg):
                # ring all-vs-all over the device mesh: same candidate SET
                # as the single-device block x block pass, O(N/n)/device
                from ..parallel.shard_overlap import sharded_find_candidates

                pairs = sharded_find_candidates(sk, min_matches=min_matches)
            else:
                me = str(cfg.get("mhapMatchEngine")).lower()
                # auto threshold (not measured on the H100): the device
                # block matrix is O(N^2) in block pairs while the host
                # join is an O(N*H) sort; the block path wins only for
                # small read sets where dispatch overhead dominates the
                # join's d2h fetch
                if me == "join" or (me == "auto" and rs.n_reads > 5_000):
                    # LSH hash-join: the block matrix is O(N^2) in block
                    # pairs and unusable at the 140 Mb read count
                    pairs = MH.find_candidates_join(
                        np.asarray(sk), min_matches=min_matches)
                else:
                    pairs = MH.find_candidates(
                        sk, min_matches=min_matches, block_size=1024)
            del sk  # sketches are HBM-heavy and dead past this point
            from ..parallel.launch import is_writer

            if is_writer():
                np.save(pairs_ckpt + ".WORKING.npy", pairs)
                os.replace(pairs_ckpt + ".WORKING.npy", pairs_ckpt)
            _lap("match")
        # beyond-RAM scale: stream verified chunks to a spill file and
        # build the store with the native external merge sort instead of
        # accumulating the table in memory
        from .configure import configure_resources

        res = configure_resources(cfg, ctx.log)
        from ..parallel.launch import is_writer

        spill = None
        sink = None
        # ovsMethod (reference sequential/parallel build selection):
        # memory forces the in-RAM build, spill forces the external sort
        ovs = str(cfg.get("ovsMethod")).lower()
        want_spill = (
            len(pairs) >= res.spill_pairs if ovs == "auto" else ovs == "spill"
        )
        import jax

        if (sharded_enabled(cfg) and jax.process_count() > 1
                and str(cfg.get("ovsShardExchange")).lower() == "range"):
            # range exchange streams per-process shards + memmap merge;
            # the spill path would be a second, redundant disk copy
            want_spill = False
        if want_spill and is_writer():
            # writer-only: in a collective (sharded) run every process
            # reaches this line, and a second open('wb') would truncate
            # the writer's spill file
            from ..stores.overlaps import OverlapSpill

            spill = OverlapSpill(os.path.join(d, f"{ctx.prefix}.ovl.spill"))
            sink = spill.append
            ctx.log.info(
                f"{tag}-overlap: store via spill + external sort "
                f"(ovsMethod={ovs}, {len(pairs)} candidate pairs)"
            )
        # orientation vote + anchor chains + banded verification in ONE
        # device pass (place_candidates is folded into verify_overlaps)
        verify_kwargs = dict(
            k=k,
            band=int(cfg.get(tag + "OvlBandWidth")),
            max_erate=float(cfg.get(tag + "OvlErrorRate")),
            min_overlap=int(cfg.get("minOverlapLength")),
            chunk=512,
            min_shared=int(cfg.get(tag + "MinShared")),
            # cor/obt use partial (forOBT-style) overlaps so chimeric
            # reads still contribute their good arms as evidence; utg
            # wants pure dovetails for the best-overlap graph
            # (overlapInCore -G mode is used by the reference for
            # correction and trimming, not unitigging)
            partial=tag in ("cor", "obt"),
            # obt additionally verifies palindromic pairs in both
            # orientations: duplicate opposite-orientation overlaps are
            # the subread-loop junction signature splitReads keys on
            palindromic_min=(
                int(cfg.get(tag + "MinShared")) if tag == "obt" else 0
            ),
        )
        import jax

        from ..parallel.launch import is_writer

        built_sharded = False
        if sharded_enabled(cfg) and jax.process_count() > 1:
            # each process verifies only ITS slice of the candidates
            exchange = str(cfg.get("ovsShardExchange")).lower()
            if exchange == "range":
                # a_id-range all_to_all: no process ever holds the full
                # table (reference bucketize/sort/index build,
                # SURVEY.md §3.3); shards stream to disk, the writer
                # merges them column-wise via memmaps
                from ..parallel.launch import barrier as _barrier
                from ..parallel.shard_overlap import (
                    process_sharded_store_rows,
                )

                rows = process_sharded_store_rows(rs, pairs, **verify_kwargs)
                pi = jax.process_index()
                shard = store + f".shard{pi:04d}.npy"
                np.save(shard + ".WORKING.npy", rows)
                os.replace(shard + ".WORKING.npy", shard)
                ctx.log.info(
                    f"{tag}-overlap: range exchange -> {len(rows)} rows "
                    f"held on process {pi} (no full-table allgather)"
                )
                del rows
                _barrier(f"{tag}-ovl-shards")
                ov = None
                built_sharded = True
                if is_writer():
                    import glob as _glob

                    shard_paths = sorted(_glob.glob(store + ".shard*.npy"))
                    OverlapStore.save_from_row_shards(
                        shard_paths, rs.n_reads, store)
                    for sp in shard_paths:
                        os.remove(sp)
            else:  # allgather: every process holds the full store input
                from ..parallel.shard_overlap import process_sharded_verify

                ov = process_sharded_verify(rs, pairs, **verify_kwargs)
                if sink is not None and is_writer():
                    sink(ov)
                    ov = None
        else:
            ov = AL.verify_overlaps(rs, pairs, sink=sink, **verify_kwargs)
        _lap("verify")
        verify_prof = dict(AL.LAST_PROFILE)
        if not is_writer():
            return  # readers re-load the writer's store after the barrier
        if built_sharded:
            st = OverlapStore.load(store)
        elif spill is not None:
            st = OverlapStore.build_spilled(spill, rs.n_reads,
                                            mem_budget=res.sort_mem_bytes,
                                            n_threads=res.sort_threads)
            st.save(store)
        else:
            st = OverlapStore.build(ov, rs.n_reads)
            st.save(store)
        _lap("store")
        # persist the sub-stage breakdown (VERDICT r4 weak #3: where
        # does overlap wall go at scale — sketch, candidate matching,
        # verify dispatch, device wait, or host consume?)
        try:
            import json as _json

            with open(ctx.path(f"{ctx.prefix}.stage-times.jsonl"), "a") as fh:
                _json.dump({"stage": f"{tag}-overlap.sub", "sub_walls_s": sub,
                            "verify_profile": verify_prof,
                            "t_end": round(_time.time(), 1)}, fh)
                fh.write("\n")
        except OSError:
            pass
        ctx.log.info(f"{tag}-overlap sub-walls: {sub}; verify: {verify_prof}")
        if os.path.exists(pairs_ckpt):
            os.remove(pairs_ckpt)  # checkpoint superseded by the store
        per_read = st.n_overlaps_per_read()
        # errorEstimate equivalent: summarize the observed error
        # distribution (ErrorEstimate.pm role; ours is post-hoc exact)
        from ..ops.errorest import estimate_error_rates

        est = estimate_error_rates(st.erate)
        ctx.report.add(
            f"{tag}.overlap",
            f"sketch H={n_hashes} mm={min_matches}; candidate pairs {len(pairs)}; "
            f"verified {st.n_overlaps}; "
            f"median overlaps/read {int(np.median(per_read))}; "
            f"median erate {est.median_erate:.4f}; est read error "
            f"{est.read_error:.4f}; suggested gate {est.suggested_ovl_erate:.3f}",
        )

    run_stage(ctx, f"{tag}-overlap", done, fn,
              collective=sharded_enabled(ctx.cfg))
    return OverlapStore.load(store)


# ---- correction phase -------------------------------------------------------


def correction_phase(ctx: AssemblyCtx, raw_inputs: list[str]) -> None:
    """Raw reads -> corrected reads (CorrectReads.pm + falconsense).

    Correction runs as RESUMABLE template blocks: each block's corrected
    reads land in ``correction/blocks/block_NNNNN.fasta.gz`` (atomic
    ``.WORKING`` rename), and a re-run skips completed blocks — the
    reference's per-jobid batch arrays with only-failed-indices retry
    (CorrectReads.pm:122-141, Execution.pm convertToJobRange).  This also
    bounds the damage of a wedged remote-device fetch to one block.
    """
    from ..ops.falcon import correct_reads_blocks

    d = ctx.phase_dir("correction")
    out = os.path.join(d, f"{ctx.prefix}.correctedReads.fasta.gz")
    blocks_dir = os.path.join(d, "blocks")
    if os.path.exists(out):
        # phase-level short-circuit: with saveOverlaps=false the
        # intermediate stores are gone, so the sub-stages must not be
        # consulted (they would rebuild them)
        ctx.log.info("correction phase complete, skipping")
        _cleanup_phase_stores(ctx, d)
        return
    rs = gatekeeper(ctx, "cor", raw_inputs)
    fk = meryl(ctx, "cor", rs)
    st = overlap(ctx, "cor", rs, fk)

    def done() -> bool:
        return os.path.exists(out)

    def fn() -> None:
        os.makedirs(blocks_dir, exist_ok=True)
        done_blocks = {
            int(f[6:11])
            for f in os.listdir(blocks_dir)
            if f.startswith("block_") and f.endswith(".fasta.gz")
        }
        from ..io.fastx import write_fasta
        from ..parallel.launch import barrier, is_writer

        import jax

        pi, n_proc = jax.process_index(), jax.process_count()

        class _SkipSet:
            """done blocks + blocks owned by other processes: correction
            blocks are independent jobs, so a multi-process run strides
            them across processes (each writes only its own block files
            — the reference's job-array partitioning,
            CorrectReads.pm:122-141)."""

            def __contains__(self, bi: int) -> bool:
                return bi in done_blocks or (n_proc > 1 and bi % n_proc != pi)

        n_blocks = len(done_blocks)
        for bi, items in correct_reads_blocks(
            rs, st,
            genome_size=float(ctx.cfg.get("genomeSize")),
            out_coverage=int(ctx.cfg.get("corOutCoverage")),
            max_evidence_coverage=_cor_evidence_budget(ctx, rs),
            min_evidence_length=int(ctx.cfg.get("corMinEvidenceLength")),
            band=int(ctx.cfg.get("corBandWidth")),
            min_cov=int(ctx.cfg.get("corMinCoverage")),
            qv_weight=bool(ctx.cfg.get("qvEvidenceWeight")),
            done_blocks=_SkipSet(),
            max_evidence_erate=float(ctx.cfg.get("corMaxEvidenceErate")),
            mode="dag" if str(ctx.cfg.get("corConsensus")).lower() == "dag"
            else "falcon",
            template_filter=str(ctx.cfg.get("corFilter")),
        ):
            p = os.path.join(blocks_dir, f"block_{bi:05d}.fasta.gz")
            write_fasta(p + ".WORKING.gz", items)
            os.replace(p + ".WORKING.gz", p)
            n_blocks += 1
            ctx.log.info(
                "correction block %d done (%d reads, %d blocks total)",
                bi, len(items), n_blocks,
            )
        barrier("correction-blocks")  # all processes' block files landed
        if not is_writer():
            return  # the writer concatenates; readers re-check done()
        # concatenate block gzips (gzip members concatenate legally)
        n = 0
        with open(out + ".WORKING.gz", "wb") as oh:
            for f in sorted(os.listdir(blocks_dir)):
                if not (f.startswith("block_") and f.endswith(".fasta.gz")):
                    continue
                with open(os.path.join(blocks_dir, f), "rb") as ih:
                    oh.write(ih.read())
        import gzip as _gz

        with _gz.open(out + ".WORKING.gz", "rt") as fh:
            n = sum(1 for line in fh if line.startswith(">"))
        os.replace(out + ".WORKING.gz", out)
        if not bool(ctx.cfg.get("saveReadCorrections")):
            import shutil

            shutil.rmtree(blocks_dir, ignore_errors=True)  # concatenated
        ctx.report.add(
            "cor.correct",
            f"corrected {n} reads in {n_blocks} blocks -> {out}",
        )

    from ..parallel.launch import is_distributed, is_writer as _isw

    run_stage(ctx, "correction", done, fn, collective=is_distributed())
    if _isw():
        _cleanup_phase_stores(ctx, d)


def _cleanup_phase_stores(ctx: AssemblyCtx, phase_dir: str) -> None:
    """saveOverlaps=false: drop the phase's overlap store + spill once
    the phase output exists (the reference deletes intermediate overlap
    outputs unless saveOverlaps is set, Defaults.pm saveOverlaps)."""
    if bool(ctx.cfg.get("saveOverlaps")):
        return
    import glob
    import shutil

    for p in glob.glob(os.path.join(phase_dir, f"{ctx.prefix}.ovlStore*")) + \
            glob.glob(os.path.join(phase_dir, f"{ctx.prefix}.ovl.spill*")):
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        else:
            try:
                os.unlink(p)
            except OSError:
                pass
        ctx.log.info("saveOverlaps=false: removed %s", p)


def _auto_erate_feedback(
    ctx: AssemblyCtx, st: OverlapStore, target_tag: str, phase_dir: str
) -> None:
    """Feed the measured corrected-read error distribution into the next
    phase's overlap gate (the reference's auto error-rate loop:
    ErrorEstimate.pm + Meryl.pm auto thresholds).  Only applies when the
    user did not set the gate explicitly; the decision is persisted so a
    resumed run (whose store may be deleted) applies the same gate."""
    key = f"{target_tag}ovlerrorrate"
    if key in ctx.cfg.explicit or len(st) == 0:
        return
    from ..ops.errorest import estimate_error_rates

    est = estimate_error_rates(st.erate)
    gate = float(np.clip(est.suggested_ovl_erate, 0.03, 0.30))
    import json

    with open(os.path.join(phase_dir, "autoerate.json"), "w") as fh:
        json.dump({"key": key, "gate": gate}, fh)
    before = float(ctx.cfg.get(key))
    if abs(gate - before) < 1e-9:
        return
    ctx.cfg.values[key] = gate
    ctx.report.add(
        f"{target_tag}.autoerate",
        f"{target_tag}OvlErrorRate auto-set {before:.3f} -> {gate:.3f} "
        f"(median obt erate {est.median_erate:.4f}, est read error "
        f"{est.read_error:.4f})",
    )


def _apply_saved_autoerate(ctx: AssemblyCtx, phase_dir: str) -> None:
    p = os.path.join(phase_dir, "autoerate.json")
    if not os.path.exists(p):
        return
    import json

    with open(p) as fh:
        saved = json.load(fh)
    if saved["key"] not in ctx.cfg.explicit:
        ctx.cfg.values[saved["key"]] = float(saved["gate"])


# ---- trimming phase ---------------------------------------------------------


def trimming_phase(ctx: AssemblyCtx, corrected_inputs: list[str]) -> None:
    """Corrected reads -> trimmed reads (OverlapBasedTrimming.pm:
    largest-covered-interval clear ranges applied on dump)."""
    d = ctx.phase_dir("trimming")
    out = os.path.join(d, f"{ctx.prefix}.trimmedReads.fasta.gz")
    if os.path.exists(out):
        ctx.log.info("trimming phase complete, skipping")
        _apply_saved_autoerate(ctx, d)
        _cleanup_phase_stores(ctx, d)
        return
    rs = gatekeeper(ctx, "obt", corrected_inputs)
    fk = meryl(ctx, "obt", rs)
    st = overlap(ctx, "obt", rs, fk)
    _auto_erate_feedback(ctx, st, "utg", d)

    def done() -> bool:
        return os.path.exists(out)

    def fn() -> None:
        # reference defaults (Defaults.pm:881-882): coverage 1 keeps any
        # read a single good overlap covers — low-coverage reads survive
        # trimming like the reference's largest-covered with minCoverage=1
        min_cov = int(ctx.cfg.get("trimReadsCoverage"))
        min_len = int(ctx.cfg.get("minReadLength"))
        min_ovl = max(int(ctx.cfg.get("minOverlapLength")),
                      int(ctx.cfg.get("trimReadsOverlap")))
        from ..io.fastx import write_fasta

        from ..utils.intervals import covered_intervals_all
        from .splitreads import detect_bad_regions, subtract_regions

        # hang-pattern subread-loop junctions from opposite-orientation
        # duplicate overlap pairs (splitReads-subReads.C semantics)
        bad_regions = detect_bad_regions(st)

        # every well-covered interval becomes a read: coverage gaps
        # inside a read indicate chimeric junctions / unsplit subreads
        # (the reference's splitReads role,
        # /root/reference/src/overlapBasedTrimming/splitReads.H:50) —
        # one columnar sweep over the whole store, no per-read loop
        long_enough = (st.a_end - st.a_bgn) >= min_ovl
        iv_rid, iv_bgn, iv_end = covered_intervals_all(
            st.a_id[long_enough], st.a_bgn[long_enough], st.a_end[long_enough],
            min_cov,
        )
        if bad_regions:
            # junction subtraction touches only flagged reads
            touched = np.isin(iv_rid, np.fromiter(bad_regions, np.int64))
            keep_rows = [
                (iv_rid[~touched], iv_bgn[~touched], iv_end[~touched])
            ]
            for rid in sorted(bad_regions):
                m = iv_rid == rid
                iv = subtract_regions(
                    list(zip(iv_bgn[m].tolist(), iv_end[m].tolist())),
                    bad_regions[rid],
                )
                if iv:
                    b = np.array([x[0] for x in iv], np.int64)
                    e = np.array([x[1] for x in iv], np.int64)
                    keep_rows.append((np.full(len(iv), rid, np.int64), b, e))
            iv_rid = np.concatenate([r[0] for r in keep_rows])
            iv_bgn = np.concatenate([r[1] for r in keep_rows])
            iv_end = np.concatenate([r[2] for r in keep_rows])
            order = np.lexsort((iv_bgn, iv_rid))
            iv_rid, iv_bgn, iv_end = iv_rid[order], iv_bgn[order], iv_end[order]
        ok = (iv_end - iv_bgn) >= min_len
        iv_rid, iv_bgn, iv_end = iv_rid[ok], iv_bgn[ok], iv_end[ok]

        pieces_of = np.bincount(iv_rid, minlength=rs.n_reads + 1)
        n_dropped = int(np.sum(pieces_of[1:] == 0))
        n_split = int(np.sum(pieces_of[1:] > 1))
        n_trimmed = int(
            np.sum((iv_end - iv_bgn) < rs.length[iv_rid - 1])
        )
        n_junction = len(bad_regions)

        def records():
            last_rid, codes, pi = 0, None, 0
            for i in range(len(iv_rid)):
                rid = int(iv_rid[i])
                if rid != last_rid:
                    codes = rs.get_codes(rid)
                    last_rid, pi = rid, 0
                bgn, end = int(iv_bgn[i]), int(iv_end[i])
                suffix = f"_s{pi}" if pieces_of[rid] > 1 else ""
                pi += 1
                yield (f"{rs.name(rid)}_trim_{bgn}_{end}{suffix}",
                       bitpack.codes_to_seq(codes[bgn:end]))

        n_kept = write_fasta(out + ".WORKING.gz", records())
        os.replace(out + ".WORKING.gz", out)
        ctx.report.add(
            "obt.trim",
            f"kept {n_kept} reads ({n_trimmed} trimmed, {n_split} split, "
            f"{n_junction} subread junctions), dropped {n_dropped}",
        )

    run_stage(ctx, "trimming", done, fn)
    _cleanup_phase_stores(ctx, d)


# ---- assembly phase ---------------------------------------------------------


def assembly_phase(ctx: AssemblyCtx, trimmed_inputs: list[str]) -> None:
    """Trimmed reads -> contigs (unitigging + consensus + outputs)."""
    from ..graph import build_unitigs
    from ..ops.consensus import quick_mosaic

    d = ctx.phase_dir("unitigging")
    rs = gatekeeper(ctx, "utg", trimmed_inputs)
    fk = meryl(ctx, "utg", rs)
    st = overlap(ctx, "utg", rs, fk)

    # overlap error adjustment (RED + OEA, OverlapErrorAdjustment.pm):
    # re-vote read errors from the overlap pile, re-verify overlaps
    # between corrected reads, install the adjusted erates sidecar
    if bool(ctx.cfg.get("enableOEA")):
        oea_store = os.path.join(d, f"{ctx.prefix}.ovlStore.adjusted")

        def oea_done() -> bool:
            return os.path.isdir(oea_store)

        def oea_fn() -> None:
            import time as _time

            from ..ops.oea import adjust_overlap_erates, detect_read_errors

            t0 = _time.monotonic()
            corr = detect_read_errors(
                rs, st,
                min_alt_votes=int(ctx.cfg.get("oeaMinAltVotes")),
                max_own_votes=int(ctx.cfg.get("oeaMaxOwnVotes")),
                band=int(ctx.cfg.get("utgBandWidth")) * 2,
            )
            t_red = _time.monotonic() - t0
            t0 = _time.monotonic()
            new_q = adjust_overlap_erates(
                rs, st, corr, band=int(ctx.cfg.get("utgBandWidth")),
                chunk=int(ctx.cfg.get("oeaBatchSize")),
                only_changed=bool(ctx.cfg.get("oeaOnlyChanged")),
            )
            t_adj = _time.monotonic() - t0
            try:
                import json as _json

                with open(ctx.path(f"{ctx.prefix}.stage-times.jsonl"),
                          "a") as fh:
                    _json.dump({"stage": "oea.sub", "sub_walls_s": {
                        "red": round(t_red, 1), "adjust": round(t_adj, 1)},
                        "changed_reads": len(corr),
                        "t_end": round(_time.time(), 1)}, fh)
                    fh.write("\n")
            except OSError:
                pass
            ctx.log.info(f"oea sub-walls: red={t_red:.1f}s "
                         f"adjust={t_adj:.1f}s changed={len(corr)}")
            n_fix = sum(len(v) for v in corr.values())
            before = float(np.median(st.erate)) if len(st) else 0.0
            st.update_erates(new_q)
            st.save(oea_store)
            ctx.report.add(
                "utg.oea",
                f"RED corrected {n_fix} bases in {len(corr)} reads; "
                f"median erate {before:.4f} -> {float(np.median(st.erate)):.4f}",
            )

        run_stage(ctx, "oea", oea_done, oea_fn)
        st = OverlapStore.load(oea_store)

    ctg_dir = os.path.join(d, f"{ctx.prefix}.ctgStore")

    def tigs_done() -> bool:
        return TigStore.latest_version(ctg_dir) >= 1

    utg_dir = os.path.join(d, f"{ctx.prefix}.utgStore")

    def tigs_fn() -> None:
        bat_gb = int(ctx.cfg.get("batMemory"))
        # flag-gated per-phase graph logs (bogart logFileFlags role)
        lf = frozenset(
            s.strip().lower()
            for s in str(ctx.cfg.get("logFileFlags")).split(",") if s.strip()
        )
        log_dir = os.path.join(d, "unitigger-logs") if lf else None
        tigs = build_unitigs(
            st, rs.length,
            max_erate=float(ctx.cfg.get("utgOvlErrorRate")),
            min_span=int(ctx.cfg.get("minOverlapLength")),
            min_reads_per_contig=int(ctx.cfg.get("contigFilterMinReads")),
            deviation=float(ctx.cfg.get("utgGraphDeviation")),
            # ~48 B per overlap row across the graph phase's columns
            max_rows=(bat_gb << 30) // 48 if bat_gb > 0 else 0,
            log_dir=log_dir, log_flags=lf,
        )
        # unitigs = the graph tigs BEFORE repeat breaking (the reference
        # keeps separate utgStore/ctgStore, bogart.C:562-598); saved here
        # so outputs can dump a real .unitigs.fasta, not a contig copy
        tigs.save(utg_dir, version=1)
        n_regions = n_broken = 0
        if bool(ctx.cfg.get("repeatDetect")):
            # bogart markRepeatReads + splitDiscontinuous (bogart.C:498-560)
            from ..graph import mark_repeats

            tigs, regions = mark_repeats(
                tigs, st, rs.length,
                min_evidence=int(ctx.cfg.get("repeatMinEvidence")),
                confused_absolute=float(ctx.cfg.get("repeatConfusedAbsolute")),
                confused_percent=float(ctx.cfg.get("repeatConfusedPercent")),
                min_reads_per_contig=int(ctx.cfg.get("contigFilterMinReads")),
            )
            n_regions = len(regions)
            n_broken = sum(1 for r in regions if r.broke)
            if log_dir and "repeats" in lf:
                os.makedirs(log_dir, exist_ok=True)
                with open(os.path.join(log_dir, "repeats.log"), "w") as fh:
                    fh.write("#tig\tbgn\tend\tbroke\n")
                    for r in regions:
                        fh.write(f"{r.tig_id}\t{r.bgn}\t{r.end}\t"
                                 f"{int(r.broke)}\n")
        # contigFilter length/low-coverage classification (the reference's
        # contigFilter 5-tuple beyond minReads, Defaults.pm contigFilter:
        # "minReads minLength singleReadSpan lowCovFraction lowCovDepth")
        min_len_f = int(ctx.cfg.get("contigFilterMinLength"))
        srs = float(ctx.cfg.get("contigFilterSingleReadSpan"))
        lc_frac = float(ctx.cfg.get("contigFilterLowCovFraction"))
        lc_depth = int(ctx.cfg.get("contigFilterLowCovDepth"))
        n_filtered = 0
        for t in tigs:
            if t.tig_class != CLASS_CONTIG:
                continue
            L = max(t.length, 1)
            if min_len_f and L < min_len_f:
                t.tig_class = CLASS_UNASSEMBLED
                n_filtered += 1
                continue
            # singleReadSpan member of the reference contigFilter 5-tuple:
            # a tig mostly spanned by ONE read is that read, not assembly
            if 0 < srs <= 1.0 and t.n_reads >= 1:
                span_max = int((t.end - t.bgn).max())
                if span_max >= srs * L and t.n_reads <= 2:
                    t.tig_class = CLASS_UNASSEMBLED
                    n_filtered += 1
                    continue
            if lc_depth > 0 and 0 < lc_frac < 1:
                depth = np.zeros(L + 1, np.int32)
                np.add.at(depth, t.bgn, 1)
                np.add.at(depth, t.end, -1)
                below = np.cumsum(depth[:L]) < lc_depth
                if float(below.mean()) > lc_frac:
                    t.tig_class = CLASS_UNASSEMBLED
                    n_filtered += 1
        tigs.save(ctg_dir, version=1)
        n_contig = sum(1 for t in tigs if t.tig_class == CLASS_CONTIG)
        ctx.report.add(
            "utg.unitig",
            f"{len(tigs)} tigs ({n_contig} contigs), N50 {tigs.n50()}; "
            f"repeat regions {n_regions} ({n_broken} broke a contig)",
        )

    run_stage(ctx, "unitig", tigs_done, tigs_fn)

    def cns_done() -> bool:
        return TigStore.latest_version(ctg_dir) >= 2

    def cns_fn() -> None:
        from ..ops.consensus import polish_tig

        tigs = TigStore.load(ctg_dir, version=1)
        polish = bool(ctx.cfg.get("cnsPolish"))
        # cnsConsensus: plurality (vote-pile engine) | dag (tag-chain /
        # pbdagcon role, ops.dagcon) | quick (mosaic only, utgcns -quick)
        algo = str(ctx.cfg.get("cnsConsensus")).lower()
        if algo == "quick":
            polish = False
        for t in tigs:
            backbone = quick_mosaic(rs, t)
            if polish and t.tig_class == CLASS_CONTIG and t.n_reads >= 2:
                t.consensus = polish_tig(
                    rs, t, backbone,
                    band=int(ctx.cfg.get("utgBandWidth")) * 2,
                    min_cov=int(ctx.cfg.get("cnsMinCoverage")),
                    rounds=int(ctx.cfg.get("cnsPolishRounds")),
                    max_coverage=int(ctx.cfg.get("cnsMaxCoverage")),
                    mode="dag" if algo == "dag" else "plurality",
                )
            else:
                t.consensus = backbone
        tigs.save(ctg_dir, version=2)

    run_stage(ctx, "consensus", cns_done, cns_fn)

    # outputs (Output.pm:56-160: contigs/unassembled fasta + layouts)
    fasta_out = ctx.path(f"{ctx.prefix}.contigs.fasta")

    def out_done() -> bool:
        return os.path.exists(fasta_out)

    def out_fn() -> None:
        from ..io.fastx import write_fasta

        tigs = TigStore.load(ctg_dir, version=2)
        contigs, unassembled = [], []
        layout_lines = []
        for t in tigs:
            seq = bitpack.codes_to_seq(t.consensus) if t.consensus is not None else ""
            name = f"tig{t.tig_id:08d}"
            rec = (f"{name} len={len(seq)} reads={t.n_reads}", seq)
            (contigs if t.tig_class == CLASS_CONTIG else unassembled).append(rec)
            for i in range(t.n_reads):
                layout_lines.append(
                    f"{name}\t{int(t.read_id[i])}\t{int(t.bgn[i])}\t{int(t.end[i])}\t"
                    f"{'-' if t.rev[i] else '+'}"
                )
        write_fasta(fasta_out + ".WORKING", contigs)
        os.replace(fasta_out + ".WORKING", fasta_out)
        un = ctx.path(f"{ctx.prefix}.unassembled.fasta")
        write_fasta(un + ".WORKING", unassembled)
        os.replace(un + ".WORKING", un)
        # .unitigs.fasta (Output.pm:56-160): the pre-repeat-break graph
        # tigs at mosaic (draft) quality — the reference dumps utgStore
        # consensus separately from ctgStore; polish effort goes to the
        # contigs, unitigs document the graph structure
        ut = ctx.path(f"{ctx.prefix}.unitigs.fasta")
        if os.path.isdir(utg_dir):
            utigs = TigStore.load(utg_dir, version=1)
            urecs = []
            for t in utigs:
                if t.tig_class != CLASS_CONTIG:
                    continue
                seq = bitpack.codes_to_seq(quick_mosaic(rs, t))
                urecs.append((f"utg{t.tig_id:08d} len={len(seq)} reads={t.n_reads}", seq))
        else:
            urecs = contigs
        write_fasta(ut + ".WORKING", urecs)
        os.replace(ut + ".WORKING", ut)
        lay = ctx.path(f"{ctx.prefix}.layout.tsv")
        with open(lay + ".WORKING", "w") as fh:
            fh.write("\n".join(layout_lines) + ("\n" if layout_lines else ""))
        os.replace(lay + ".WORKING", lay)
        from ..io.gfa import write_gfa

        write_gfa(ctx.path(f"{ctx.prefix}.contigs.gfa"), tigs, rs, st,
                  verify_edges=True)
        lens = sorted((len(s) for _, s in contigs), reverse=True)
        ctx.report.add(
            "utg.output",
            f"{len(contigs)} contigs, {len(unassembled)} unassembled; "
            f"sizes {lens[:10]}",
        )
        from .html import build_html

        build_html(ctx.work_dir, ctx.prefix)

    run_stage(ctx, "outputs", out_done, out_fn)
