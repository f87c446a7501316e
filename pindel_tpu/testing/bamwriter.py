"""Minimal BAM writer (test and benchmark tooling): composes
BGZF-compressed BAM files from explicit alignment records so the native
reader and the BAM channel can be exercised without external aligners or
htslib.

BAM/BGZF layout per the SAM spec (htslib not used; everything from the
published format): BGZF = gzip members with a BC extra field carrying the
block size; records are little-endian packed.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"

FLAG_PAIRED = 0x1
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1          # total block size - 1
    header = struct.pack("<BBBBIBBHBBHH",
                         0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                         ord("B"), ord("C"), 2, bsize)
    return header + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                       len(data) & 0xFFFFFFFF)


def bgzf_compress(data: bytes, block: int = 60000) -> bytes:
    out = bytearray()
    for i in range(0, len(data), block):
        out += _bgzf_block(data[i:i + block])
    out += _BGZF_EOF
    return bytes(out)


@dataclasses.dataclass
class BamRecord:
    qname: str
    flag: int
    tid: int
    pos: int                       # 0-based
    mapq: int = 0
    cigar: Sequence[Tuple[int, str]] = ()   # [(length, op), ...]
    mate_tid: int = -1
    mate_pos: int = -1
    tlen: int = 0
    seq: str = ""
    qual: Optional[bytes] = None
    tags: Dict[str, object] = dataclasses.field(default_factory=dict)

    def pack(self) -> bytes:
        name = self.qname.encode() + b"\0"
        cig = b"".join(struct.pack("<I", (ln << 4) | CIGAR_OPS.index(op))
                       for ln, op in self.cigar)
        seq4 = bytearray((len(self.seq) + 1) // 2)
        for i, base in enumerate(self.seq):
            code = SEQ_NT16.index(base) if base in SEQ_NT16 else 15
            seq4[i // 2] |= code << (4 if i % 2 == 0 else 0)
        qual = self.qual if self.qual is not None else b"\xff" * len(self.seq)
        aux = b""
        for tag, value in self.tags.items():
            if isinstance(value, int):
                aux += tag.encode() + b"i" + struct.pack("<i", value)
            else:
                aux += tag.encode() + b"Z" + str(value).encode() + b"\0"
        body = struct.pack(
            "<iiBBHHHiiii", self.tid, self.pos,
            len(name), self.mapq, 0, len(self.cigar), self.flag,
            len(self.seq), self.mate_tid, self.mate_pos, self.tlen)
        body += name + cig + bytes(seq4) + qual + aux
        return struct.pack("<i", len(body)) + body


def write_bam(path: str, refs: List[Tuple[str, int]],
              records: List[BamRecord]) -> None:
    """refs: [(name, length)]; records are written in the given order."""
    payload = bytearray()
    text = b"@HD\tVN:1.6\tSO:coordinate\n" + b"".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n".encode() for n, ln in refs)
    payload += b"BAM\x01" + struct.pack("<i", len(text)) + text
    payload += struct.pack("<i", len(refs))
    for name, length in refs:
        nm = name.encode() + b"\0"
        payload += struct.pack("<i", len(nm)) + nm + struct.pack("<i",
                                                                 length)
    for rec in records:
        payload += rec.pack()
    with open(path, "wb") as fh:
        fh.write(bgzf_compress(bytes(payload)))


def anchored_pair(qname: str, anchor_pos: int, mate_seq: str, ref: str,
                  anchor_reverse: bool = False, read_len: int = 100,
                  mate_first: bool = False, mapq: int = 60
                  ) -> List[BamRecord]:
    """An anchored pair: clean mapped anchor + unmapped split mate."""
    flag_a = FLAG_PAIRED | (FLAG_REVERSE if anchor_reverse else 0)
    anchor = BamRecord(qname, flag_a, 0, anchor_pos, mapq,
                       [(read_len, "M")], 0, anchor_pos, 0,
                       ref[anchor_pos:anchor_pos + read_len],
                       tags={"NM": 0})
    mate = BamRecord(qname, FLAG_PAIRED | FLAG_UNMAP | FLAG_READ1,
                     0, anchor_pos, 0, [], 0, anchor_pos, 0, mate_seq)
    return [mate, anchor] if mate_first else [anchor, mate]


def split_read_pairs(reads, ref: str, read_len: int = 100
                     ) -> List[BamRecord]:
    """Anchored BAM pairs for simulated split reads (``SimReads``): the
    anchor mate maps at the read's anchor position, the split mate is
    unmapped.  Reads whose anchor would leave the reference are dropped;
    records come sorted by position."""
    recs: List[BamRecord] = []
    for name, seq, meta in zip(reads.names, reads.seqs, reads.metas):
        dstr, _chrom, pos, mq = meta[:4]
        anchor_pos = pos if dstr == "+" else pos - read_len
        if anchor_pos < 0 or anchor_pos + read_len > len(ref):
            continue
        recs.extend(anchored_pair(name[:-2], anchor_pos, seq, ref,
                                  anchor_reverse=(dstr == "-"),
                                  read_len=read_len, mapq=mq))
    recs.sort(key=lambda r: r.pos)
    return recs
