"""bam2pindel converter: BAM -> Pindel text, then discovery on the
converted text must match discovery on the BAM directly (the Perl tool's
purpose: feed BAMs to a pindel that only reads text)."""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from pindel_tpu.testing.bamwriter import write_bam  # noqa: E402
from make_fai import make_fai  # noqa: E402
from pindel_tpu.testing.bamwriter import anchored_pair  # noqa: E402

from pindel_tpu.testing.simulate import random_seq, rc, write_fasta  # noqa: E402


def test_bam2pindel_roundtrip(tmp_path):
    rng = np.random.default_rng(21)
    ref = random_seq(rng, 30_000)
    bp, size = 15_000, 120
    d = str(tmp_path)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrQ", ref)])
    make_fai(fa)
    recs = []
    for k in range(6):
        flank = 35 + k * 5
        frag = ref[bp - flank: bp] + ref[bp + size: bp + size + 100 - flank]
        anchor_pos = bp - flank - 150 - 100
        recs.extend(anchored_pair(f"r{k}", anchor_pos, rc(frag), ref))
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, [("chrQ", len(ref))], recs)

    from pindel_tpu.bam2pindel import main as b2p
    assert b2p(["-i", bam, "-o", os.path.join(d, "conv"),
                "-s", "S1", "-m", "400"]) == 0
    txt = os.path.join(d, "conv_chrQ")
    assert os.path.exists(txt)
    body = open(txt).read()
    assert body.count("@") >= 6 and "\tchrQ\t" in body

    # discovery on converted text == discovery on the BAM directly
    from pindel_tpu.__main__ import main
    cfg = os.path.join(d, "bam.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t400\tS1\n")
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, "fam"),
                 "--backend", "numpy"]) == 0
    assert main(["-f", fa, "-p", txt, "-o", os.path.join(d, "txt"),
                 "--backend", "numpy"]) == 0
    for suf in ("D", "SI", "TD", "INV"):
        a = open(os.path.join(d, f"fam_{suf}")).read()
        b = open(os.path.join(d, f"txt_{suf}")).read()
        assert a == b, f"_{suf} differs between BAM and converted text"
    assert open(os.path.join(d, "fam_D")).read()    # deletion was called
