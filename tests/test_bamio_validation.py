"""Independent validation of the native BAM decoder (native/bamio.cpp).

Two attack angles on the risk that a shared decode bug in hts_stub +
bamio.cpp is invisible to the golden suite:

1. The full ``-i`` discovery pipeline on the ONE real aligner-produced
   BAM in the tree (/root/reference/demo/simulated_MEI/aln.sorted.bam,
   written by samtools-era htslib, not by our tools/bamwriter.py) is
   compared byte-for-byte against the compiled reference.  A decode
   disagreement between real-world BGZF/BAM bytes and either side's
   parser would desynchronize read sets and change the reports.

2. A BAM fixture is hand-assembled HERE from the BAM/BGZF specs
   (struct.pack level, no shared writer code): multi-block BGZF with a
   record split across block boundaries, CIGAR ops M/I/D/N/S/H/P/=/X,
   and an aux region containing every tag type (A c C s S i I f Z H Bc
   BI).  Expected values are stated literally, so the decode ground
   truth comes from the spec, not from any decoder in this repo.
   Reference semantics exercised: reader.cpp:483-559 (range scan),
   :661-690 (isWeirdRead), :799-898 (build_record_SR).
"""
import os
import struct
import subprocess
import sys
import zlib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from test_golden_vs_reference import ORACLE, assert_identical, oracle  # noqa

MEI_DIR = "/root/reference/demo/simulated_MEI"


@pytest.mark.skipif(not os.path.exists(f"{MEI_DIR}/aln.sorted.bam"),
                    reason="demo BAM not available")
@pytest.mark.parametrize("bd", [False, True])
def test_real_bam_full_discovery_matches_reference(tmp_path, oracle, bd):
    d = str(tmp_path)
    fa = os.path.join(d, "reference.fa")
    with open(fa, "w") as out:
        out.write(open(f"{MEI_DIR}/reference.fa").read())
    from make_fai import make_fai
    make_fai(fa)
    cfg = os.path.join(d, "cfg.txt")
    with open(cfg, "w") as fh:
        fh.write(f"{MEI_DIR}/aln.sorted.bam\t500\tS_MEI\n")
    extra = ["-b", f"{MEI_DIR}/bd.txt"] if bd else []
    r = subprocess.run(
        [oracle, "-f", fa, "-i", cfg, "-o", os.path.join(d, "gold"),
         "-c", "ALL", "-l", "-k", "-s", *extra],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:]
    from pindel_tpu.__main__ import main
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, "ours"),
                 "-l", "-k", "-s", "--backend", "numpy", *extra]) == 0
    assert_identical(d, ["CloseEndMapped", "D", "SI", "TD", "INV",
                         "LI", "BP"])
    # the scene must actually exercise the SR channel
    assert open(os.path.join(d, "gold_CloseEndMapped")).read() != ""


# --------------------------------------------------------- spec fixture

def bgzf_block(payload: bytes) -> bytes:
    """One BGZF block per the SAM spec §4.1: gzip member with BC extra
    field holding BSIZE (total block size - 1)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    xlen = 6
    bsize = 12 + xlen + len(comp) + 8
    head = struct.pack(
        "<BBBBIBBH", 0x1f, 0x8b, 8, 4, 0, 0, 0xff, xlen)
    extra = struct.pack("<ccHH", b"B", b"C", 2, bsize - 1)
    tail = struct.pack("<II", zlib.crc32(payload) & 0xffffffff,
                       len(payload))
    return head + extra + comp + tail


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_CIGAR_OPS = "MIDNSHP=X"


def bam_record(name: str, flag: int, tid: int, pos: int, mapq: int,
               cigar, seq: str, qual: int, mate_tid: int, mate_pos: int,
               tlen: int, aux: bytes = b"") -> bytes:
    """Serialize one alignment per BAM spec §4.2 (hand-rolled)."""
    rn = name.encode() + b"\0"
    cig = b"".join(struct.pack("<I", (ln << 4) | _CIGAR_OPS.index(op))
                   for ln, op in cigar)
    sq = bytearray()
    for i in range(0, len(seq), 2):
        hi = _SEQ_NIBBLE[seq[i]] << 4
        lo = _SEQ_NIBBLE[seq[i + 1]] if i + 1 < len(seq) else 0
        sq.append(hi | lo)
    ql = bytes([qual] * len(seq))
    bin_ = 4680                      # reg2bin(0, 1) — value irrelevant here
    body = struct.pack(
        "<iiBBHHHiiii", tid, pos, len(rn), mapq, bin_, len(cigar),
        flag, len(seq), mate_tid, mate_pos, tlen) \
        + rn + cig + bytes(sq) + ql + aux
    return struct.pack("<i", len(body)) + body


# every aux tag type from SAM spec §4.2.4; values chosen to be
# round-trip-distinct
ALL_TAGS = (
    b"XaAx"                                   # A: printable char
    + b"Xbc" + struct.pack("<b", -5)          # c: int8
    + b"XcC" + struct.pack("<B", 250)         # C: uint8
    + b"Xds" + struct.pack("<h", -300)        # s: int16
    + b"XeS" + struct.pack("<H", 60000)       # S: uint16
    + b"NMi" + struct.pack("<i", 1)           # i: int32 (NM=1: weird read)
    + b"XgI" + struct.pack("<I", 3_000_000_000)   # I: uint32
    + b"Xhf" + struct.pack("<f", 1.5)         # f: float
    + b"RGZ" + b"grp1\0"                      # Z: string
    + b"XiH" + b"DEAD\0"                      # H: hex string
    + b"XjB" + b"c" + struct.pack("<i", 3) + struct.pack("<3b", 1, -2, 3)
    + b"XkB" + b"I" + struct.pack("<i", 2) + struct.pack("<2I", 7, 8)
)


def build_fixture_bam(path: str, ref_name: str, ref_len: int,
                      records, split_offset: int = 100) -> None:
    """Write records as BGZF with the stream cut at an arbitrary byte
    offset so headers/records straddle block boundaries."""
    header_text = f"@SQ\tSN:{ref_name}\tLN:{ref_len}\n"
    payload = (b"BAM\x01"
               + struct.pack("<i", len(header_text))
               + header_text.encode()
               + struct.pack("<i", 1)
               + struct.pack("<i", len(ref_name) + 1)
               + ref_name.encode() + b"\0"
               + struct.pack("<i", ref_len))
    for r in records:
        payload += r
    with open(path, "wb") as fh:
        # cut the byte stream into blocks at arbitrary offsets —
        # including mid-record — which a correct BGZF layer must hide
        for lo in range(0, len(payload), split_offset):
            fh.write(bgzf_block(payload[lo:lo + split_offset]))
        fh.write(BGZF_EOF)


ANCHOR_SEQ = "ACGTACGTACGTACGTACGTACGTACGTACGTACGT"
MATE_SEQ = "TTTTGGGGCCCCAAAATTTTGGGGCCCCAAAATTTT"


def test_handbuilt_bam_decode(tmp_path):
    """Decode a spec-assembled BAM: multi-block BGZF with mid-record
    splits, exotic CIGAR ops and every aux tag type, then check the SR
    channel against literally-stated expectations.

    The anchor's non-M CIGAR makes it 'weird' (isWeirdRead,
    reader.cpp:661-690), so the reference emits THREE records per pair:
    a self-build at first sight, a second self-build at pair time (the
    fetch_func_SR quirk, reader.cpp:1117-1130), then the anchored
    build.  Positions stay 0-based raw BAM pos (build_record_SR,
    reader.cpp:858)."""
    ref_len = 10_000
    anchor = bam_record(
        "pairA", 0x1 | 0x2 | 0x8, 0, 1000, 60,
        [(4, "S"), (10, "M"), (2, "I"), (8, "M"), (3, "D"), (5, "N"),
         (6, "M"), (1, "P"), (4, "="), (2, "X"), (3, "H")],
        ANCHOR_SEQ, 30, 0, 1000, 0,
        ALL_TAGS)
    # unmapped mate (READ2) carries the split sequence, not reversed
    mate = bam_record(
        "pairA", 0x1 | 0x4 | 0x80, 0, 1000, 0, [],
        MATE_SEQ, 25, 0, 1000, 0,
        b"RGZgrp1\0")
    bam = os.path.join(str(tmp_path), "hand.bam")
    from pindel_tpu.bam import BamReader
    for split in (64, 100, 8191):
        build_fixture_bam(bam, "chrH", ref_len, [anchor, mate],
                          split_offset=split)
        rd = BamReader(bam)
        assert rd.ref_names == ["chrH"]
        reads, ref_reads = rd.collect_sr(
            "chrH", 0, ref_len, 500, "S1", ref_len,
            min_anchor_quality=20, nm=1, max_mismatch_rate=0.1)
        got = [(r.name, r.seq, r.matched_d, r.matched_rel_pos, r.ms)
               for r in reads]
        assert got == [
            ("@pairA", ANCHOR_SEQ, "+", 1000, 60),     # self, first sight
            ("@pairA", ANCHOR_SEQ, "+", 1000, 60),     # self, pair time
            ("@pairA/2", MATE_SEQ, "+", 1000, 60),     # anchored build
        ], f"split={split}: {got}"
        assert all(r.insert_size == 500 and r.tag == "S1" for r in reads)
        assert ref_reads == []          # weird mate is never a ref read
        rd.close()


def test_handbuilt_bam_reverse_anchor_and_mate(tmp_path):
    """'-' anchor position uses the reference's quirky bam_cigar2len
    (M+I+S add, D subtracts, N ignored — reader.cpp:1319-1333) and a
    reverse-flagged unmapped mate comes out reverse-complemented
    (build_record_SR, reader.cpp:852-856)."""
    # query length 4S+20M+2I+10M = 36 = l_qseq; cigar2len = 4+20+2+10-3
    anchor = bam_record(
        "pairB", 0x1 | 0x8 | 0x10, 0, 2000, 45,
        [(4, "S"), (20, "M"), (3, "D"), (2, "I"), (5, "N"), (10, "M")],
        ANCHOR_SEQ, 30, 0, 2000, 0,
        b"NMi" + struct.pack("<i", 1))
    mate = bam_record(
        "pairB", 0x1 | 0x4 | 0x10 | 0x40, 0, 2000, 0, [],
        "AACCGGTTAACCGGTTAACCGGTTAACCGGTTAACC", 25, 0, 2000, 0)
    bam = os.path.join(str(tmp_path), "hand2.bam")
    build_fixture_bam(bam, "chrH", 10_000, [anchor, mate],
                      split_offset=57)
    from pindel_tpu.bam import BamReader
    from pindel_tpu.dna import revcomp_str
    rd = BamReader(bam)
    reads, _ = rd.collect_sr("chrH", 0, 10_000, 500, "S1", 10_000,
                             min_anchor_quality=20, nm=1,
                             max_mismatch_rate=0.1)
    pos = 2000 + (4 + 20 + 2 + 10 - 3)
    got = [(r.name, r.seq, r.matched_d, r.matched_rel_pos, r.ms)
           for r in reads]
    # the reverse-flagged anchor self-builds as RC of itself
    rc_anchor = revcomp_str(ANCHOR_SEQ)
    rc_mate = revcomp_str("AACCGGTTAACCGGTTAACCGGTTAACCGGTTAACC")
    assert got == [
        ("@pairB", rc_anchor, "-", pos, 45),
        ("@pairB", rc_anchor, "-", pos, 45),
        ("@pairB/1", rc_mate, "-", pos, 45),
    ], got
    rd.close()
