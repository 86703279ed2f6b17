"""Round-5 parameter surface: aliases, meta keys, stubs, and the
external-overlapper/frequent-mers/corFilter mechanisms."""

import os
import stat
import sys

import numpy as np
import pytest

from canu_tpu.config.registry import Config, ConfigError


def test_registry_size_and_aliases():
    c = Config()
    assert len(c.registry) >= 200, len(c.registry)
    c.set("genomeSize", "1m")
    c.set("obtErrorRate", 0.05)
    assert c.get("obtOvlErrorRate") == 0.05
    c.set("corErrorRate", 0.25)
    assert c.get("corOvlErrorRate") == 0.25
    c.set("utgRepeatConfusedBP", 3000)
    assert c.get("repeatConfusedAbsolute") == 3000
    c.validate()


def test_contig_filter_meta():
    c = Config()
    c.set("contigFilter", "3 1000 0.9 0.4 4")
    assert c.get("contigFilterMinReads") == 3
    assert c.get("contigFilterMinLength") == 1000
    assert c.get("contigFilterSingleReadSpan") == 0.9
    assert c.get("contigFilterLowCovFraction") == 0.4
    assert c.get("contigFilterLowCovDepth") == 4
    with pytest.raises(ConfigError):
        c.set("contigFilter", "1 2 3")
    # explicit member survives a later meta assignment
    c2 = Config()
    c2.set("contigFilterMinReads", 7)
    c2.set("contigFilter", "3 1000 0.9 0.4 4")
    assert c2.get("contigFilterMinReads") == 7


def test_grid_engine_stubs_error():
    c = Config()
    c.set("genomeSize", "1m")
    c.set("gridEngine", "sge")
    with pytest.raises(ConfigError, match="n/a stub"):
        c.validate()


def test_coverage_multiple_parsing():
    c = Config()
    c.set("corMaxEvidenceCoverageLocal", "1.5x")
    assert c.coverage_multiple("corMaxEvidenceCoverageLocal", 20) == 30.0
    c.set("corMaxEvidenceCoverageLocal", "35")
    assert c.coverage_multiple("corMaxEvidenceCoverageLocal", 20) == 35.0
    c.set("corMaxEvidenceCoverageLocal", "bogus")
    with pytest.raises(ConfigError):
        c.coverage_multiple("corMaxEvidenceCoverageLocal", 20)


def test_unitigger_and_realign_validation():
    c = Config()
    c.set("genomeSize", "1m")
    c.set("unitigger", "bog")
    with pytest.raises(ConfigError, match="bogart"):
        c.validate()
    c2 = Config()
    c2.set("genomeSize", "1m")
    c2.set("reAlign", "false")  # fans to all three tags
    with pytest.raises(ConfigError, match="ReAlign"):
        c2.validate()


def test_frequent_mers_union_and_fasta(tmp_path):
    from canu_tpu.ops import kmer as K
    from canu_tpu.sim.simulate import random_genome
    from canu_tpu.stores.readset import ReadSet
    from canu_tpu.utils.bitpack import codes_to_seq

    g = random_genome(2000, seed=3)
    fa = tmp_path / "mers.fasta"
    fa.write_text(">m1\n" + codes_to_seq(g[:50]) + "\n")
    fk2 = K.frequent_from_fasta(str(fa), 16)
    assert fk2.n == 50 - 16 + 1 - (len(np.unique(fk2.kmers)) - fk2.n)
    rs = ReadSet.from_codes_list([g], ["r1"])
    kc = K.count_readset_host(rs, 16)
    fk1 = K.frequent_kmers(kc, distinct_fraction=0.9)
    u = K.union_frequent(fk1, fk2)
    assert max(fk1.n, fk2.n) <= u.n <= fk1.n + fk2.n
    assert (np.diff(u.kmers.astype(np.int64)) > 0).all()
    # k=22 path folds exact mers too
    fk22 = K.frequent_from_fasta(str(fa), 22)
    assert fk22.n > 0 and fk22.kmers_exact is not None


def test_cor_filter_expensive_ranks_by_covered_length():
    """corFilter=expensive must prefer a well-covered read over a longer
    read whose tail has no evidence (filterCorrectionLayouts role)."""
    from canu_tpu.ops.falcon import (
        select_templates,
        select_templates_expensive,
    )
    from canu_tpu.sim.simulate import random_genome
    from canu_tpu.stores.overlaps import OverlapStore
    from canu_tpu.stores.readset import ReadSet
    from canu_tpu.ops.align import OverlapTable

    g = random_genome(30_000, seed=8)
    # read 1: 8 kb, fully covered by evidence; read 2: 10 kb, only 2 kb
    # covered (chimeric-junk tail); reads 3-4: evidence
    codes = [g[:8000], np.concatenate([g[10000:12000], (g[:8000] + 1) % 4]),
             g[:6000], g[2000:8000], g[10000:12500]]
    rs = ReadSet.from_codes_list(codes, [f"r{i+1}" for i in range(5)])
    t = OverlapTable(
        a_id=np.array([1, 1, 2], np.int32),
        b_id=np.array([3, 4, 5], np.int32),
        flipped=np.zeros(3, bool),
        a_bgn=np.array([0, 2000, 0], np.int32),
        a_end=np.array([6000, 8000, 2000], np.int32),
        b_bgn=np.array([0, 0, 0], np.int32),
        b_end=np.array([6000, 6000, 2000], np.int32),
        erate_q=np.full(3, 100, np.uint16),
    )
    st = OverlapStore.build(t, rs.n_reads)
    quick = select_templates(rs, 30_000, 1)
    # quick budget: longest-first => read 2 (10 kb) ranks first
    assert quick[0] == 2 or 2 in quick[:2]
    exp = select_templates_expensive(rs, st, 8000, 1)
    # expensive: read 1 (8 kb covered) must outrank read 2 (2 kb covered)
    assert list(exp).index(1) >= 0
    covered = {int(i) for i in exp}
    assert 1 in covered
    # with a 1x8000 budget, read 1 alone fills it; read 2 excluded
    assert exp[0] == 1


@pytest.mark.slow
def test_minimap_overlapper_runner(tmp_path):
    """overlapper=minimap drives an external binary (faked here) whose
    PAF hits become verification candidates — the OverlapMMap.pm flow
    with the device kernel as the ReAlign step."""
    from canu_tpu.io.fastx import write_fasta
    from canu_tpu.sim.simulate import random_genome, simulate_reads
    import subprocess

    g = random_genome(9_000, seed=60)
    rs, truth = simulate_reads(
        g, coverage=12, mean_len=1200, min_len=900, max_len=1600,
        error_rate=0.03, seed=61, circular=False,
    )
    fa = tmp_path / "r.fasta"
    write_fasta(str(fa), ((f"read{i}", rs.get_seq(i))
                          for i in range(1, rs.n_reads + 1)))
    # fake minimap2: reads the FASTA it is given and emits PAF rows for
    # every read pair whose TRUE genome intervals overlap >= 300 bases
    spans = np.stack([truth.start, truth.end], axis=1)
    np.save(tmp_path / "spans.npy", spans)
    mm2 = tmp_path / "minimap2"
    mm2.write_text(f"""#!{sys.executable}
import sys, numpy as np
spans = np.load({str(tmp_path / 'spans.npy')!r})
n = len(spans)
for i in range(n):
    for j in range(i + 1, n):
        lo = max(spans[i, 0], spans[j, 0])
        hi = min(spans[i, 1], spans[j, 1])
        if hi - lo >= 300:
            L1 = spans[i, 1] - spans[i, 0]
            L2 = spans[j, 1] - spans[j, 0]
            print(f"{{i+1}}\\t{{L1}}\\t0\\t{{hi-lo}}\\t+\\t{{j+1}}\\t{{L2}}\\t0\\t{{hi-lo}}\\t{{hi-lo}}\\t{{hi-lo}}\\t60")
""")
    mm2.chmod(mm2.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wd = tmp_path / "wd"
    r = subprocess.run(
        [sys.executable, "-m", "canu_tpu", "-p", "asm", "-d", str(wd),
         "genomeSize=9k", "overlapper=minimap",
         f"minimap2Path={mm2}", "stopAfter=cor-overlap",
         "-pacbio-raw", str(fa)],
        env=env, capture_output=True, text=True, timeout=560,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    from canu_tpu.stores.overlaps import OverlapStore

    st = OverlapStore.load(str(wd / "correction" / "asm.ovlStore"))
    assert st.n_overlaps > 20, st.n_overlaps
    assert os.path.exists(wd / "correction" / "asm.mmap.paf")
