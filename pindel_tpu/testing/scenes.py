"""Seeded input scenes shared by the driver entry points and the smoke
run on the card."""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from pindel_tpu.testing.bamwriter import split_read_pairs, write_bam
from pindel_tpu.testing.simulate import (Event, SimReads, Simulator,
                                         random_seq, write_fasta)


def bam_breakdancer_scene(d: str) -> Tuple[str, str, str]:
    """BAM + BreakDancer scene over 60 kb: a 9 kb deletion beyond the -x2
    geometric ladder that only the BD evidence window can find (BD
    windows are live for BAM input only, as in the reference's UpdateBD
    gate, pindel.cpp:1838-1847).  Writes the files into ``d``; returns
    (fasta, bam config, BreakDancer calls)."""
    rng = np.random.default_rng(99)
    ref = random_seq(rng, 60_000)
    out = SimReads([], [], [])
    ev = Event("DEL", "chrU", 24_000, size=9_000)
    Simulator(rng).reads_for_event(ref, "chrU", ev, 10, out)
    Simulator(rng).ref_noise_reads(ref, "chrU", 20, out)
    fa = os.path.join(d, "bd_ref.fa")
    write_fasta(fa, [("chrU", ref)])
    bam = os.path.join(d, "bd.bam")
    write_bam(bam, [("chrU", len(ref))], split_read_pairs(out, ref))
    cfg = os.path.join(d, "bd.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t500\tS1\n")
    bd = os.path.join(d, "bd_calls.txt")
    with open(bd, "w") as fh:
        fh.write("chrU\t24000\t20+20-\tchrU\t33000\t18+19-\tDEL\t9000"
                 "\t99\n")
    return fa, cfg, bd
