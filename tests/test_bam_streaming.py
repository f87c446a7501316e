"""Streamed BAM intake (native/bamio.cpp streamed mode): window-ranged
decode over the first-pass block index must be (a) result-identical to
the whole-file decode on every channel, and (b) memory-bounded — only
the current window's records resident (the reference shape is
per-window htslib range queries, reader.cpp:483-559).
"""
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

MEI_BAM = "/root/reference/demo/simulated_MEI/aln.sorted.bam"


def _scene_bam(tmp_path, chrom_len=120_000, n_events=10):
    """Multi-window BAM: paired reads over a chromosome long enough for
    several 10 kb windows."""
    from pindel_tpu.testing.bamwriter import write_bam

    from pindel_tpu.testing.simulate import standard_scene, write_fasta
    from pindel_tpu.testing.bamwriter import anchored_pair
    d = str(tmp_path)
    ref, events, reads = standard_scene(
        seed=77, chrom_len=chrom_len,
        kinds=["DEL", "SI", "DI", "INV", "TD"] * (n_events // 5),
        reads_per_event=8, n_noise=40, chrom="chrT")
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrT", ref)])
    lines = open_reads(reads)
    recs = []
    for name, seq, meta in lines:
        dstr, pos, mq = meta[0], int(meta[2]), int(meta[3])
        anchor_pos = pos if dstr == "+" else pos - 100
        if anchor_pos < 0 or anchor_pos + 100 > len(ref):
            continue
        recs.extend(anchored_pair(name[1:-2], anchor_pos, seq, ref,
                                  anchor_reverse=(dstr == "-"), mapq=mq))
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    return d, fa, bam, len(ref)


def open_reads(reads):
    # SimReads.metas rows are (d, chr, pos, mq, ins, tag) tuples
    return [(reads.names[i], reads.seqs[i], reads.metas[i])
            for i in range(len(reads.names))]


def _collect_all(br, chrom, length, windows):
    sr, rr, rp = [], [], []
    for (s, e) in windows:
        a, b = br.collect_sr(chrom, s, e, 500, "S1", length,
                             min_anchor_quality=0, nm=2,
                             max_mismatch_rate=0.02)
        sr.append([(r.name, r.seq, r.matched_d, r.matched_rel_pos, r.ms)
                   for r in a])
        rr.append([(x.pos, x.read_length) for x in b])
        c, d = br.collect_rp(chrom, s, e, 500, "S1",
                             min_anchor_quality=0)
        rp.append([(x.pos_a, x.pos_b, x.da, x.db) for x in c])
    return sr, rr, rp


def test_streamed_equals_wholefile(tmp_path):
    from pindel_tpu.bam import BamReader
    d, fa, bam, length = _scene_bam(tmp_path)
    windows = [(s, min(s + 10_000, length)) for s in range(0, length,
                                                           10_000)]
    whole = BamReader(bam, streamed=False)
    stream = BamReader(bam, streamed=True)
    assert stream.n_records == whole.n_records > 0
    got_w = _collect_all(whole, "chrT", length, windows)
    got_s = _collect_all(stream, "chrT", length, windows)
    assert got_s == got_w
    # depth channel too
    for (s, e) in windows[:4]:
        assert (stream._lib.ptbam_depth_sum(stream._h, 0, s, e, 0)
                == whole._lib.ptbam_depth_sum(whole._h, 0, s, e, 0))


def test_streamed_memory_bounded(tmp_path):
    """Resident record count tracks the window, not the file."""
    from pindel_tpu.bam import BamReader
    d, fa, bam, length = _scene_bam(tmp_path)
    stream = BamReader(bam, streamed=True)
    total = stream.n_records
    residents = []
    for s in range(0, length, 10_000):
        stream.collect_sr("chrT", s, min(s + 10_000, length), 500, "S1",
                          length, min_anchor_quality=0, nm=2,
                          max_mismatch_rate=0.02)
        residents.append(stream._lib.ptbam_resident_records(stream._h))
    assert max(residents) < total, (residents, total)
    # each window holds roughly its share of the file (+ the overlap
    # buffer), far from the whole read set
    assert max(residents) <= total // 2


@pytest.mark.skipif(not os.path.exists(MEI_BAM),
                    reason="demo BAM not available")
def test_streamed_equals_wholefile_real_bam():
    """Real aligner-produced BGZF (not our writer): streamed windows
    must reproduce the whole-file decode exactly."""
    from pindel_tpu.bam import BamReader
    whole = BamReader(MEI_BAM, streamed=False)
    stream = BamReader(MEI_BAM, streamed=True)
    assert stream.ref_names == whole.ref_names
    assert stream.n_records == whole.n_records > 0
    length = whole.ref_lens[0]
    chrom = whole.ref_names[0]
    windows = [(s, min(s + 2_000, length)) for s in range(0, length,
                                                          2_000)]
    got_w = _collect_all(whole, chrom, length, windows)
    got_s = _collect_all(stream, chrom, length, windows)
    assert got_s == got_w


def test_streamed_multi_chromosome(tmp_path):
    """tid boundaries: streamed windows on a 3-chromosome BAM (including
    one with no records) must match the whole-file decode — the block
    index spans tids and ensure_window must not bleed records across
    them."""
    import dataclasses

    from pindel_tpu.testing.bamwriter import write_bam

    from pindel_tpu.bam import BamReader
    from pindel_tpu.testing.simulate import random_seq
    from pindel_tpu.testing.bamwriter import anchored_pair
    rng = np.random.default_rng(5)
    refs = {"chrA": random_seq(rng, 40_000), "chrC": random_seq(rng, 30_000)}
    names = ["chrA", "chrB", "chrC"]          # chrB stays empty
    lens = {"chrA": 40_000, "chrB": 5_000, "chrC": 30_000}
    recs = []
    for tid, name in enumerate(names):
        if name not in refs:
            continue
        ref = refs[name]
        for k in range(60):
            pos = 500 + k * ((len(ref) - 1200) // 60)
            frag = ref[pos + 150:pos + 250]
            pair = anchored_pair(f"r{name}{k}", pos, frag, ref, mapq=60)
            recs.extend(dataclasses.replace(r, tid=tid, mate_tid=tid)
                        for r in pair)
    bam = os.path.join(str(tmp_path), "multi.bam")
    write_bam(bam, [(n, lens[n]) for n in names], recs)
    whole = BamReader(bam, streamed=False)
    stream = BamReader(bam, streamed=True)
    assert stream.ref_names == names
    for name in names:
        length = lens[name]
        windows = [(s, min(s + 8_000, length))
                   for s in range(0, length, 8_000)]
        got_w = _collect_all(whole, name, length, windows)
        got_s = _collect_all(stream, name, length, windows)
        assert got_s == got_w, name
    # jumping back to an earlier chromosome re-materializes correctly
    a_again_w = _collect_all(whole, "chrA", lens["chrA"], [(0, 8_000)])
    a_again_s = _collect_all(stream, "chrA", lens["chrA"], [(0, 8_000)])
    assert a_again_s == a_again_w
